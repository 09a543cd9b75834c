"""LoRA adapter (additive low-rank), for API parity.

Counterpart of the JAX package's adapters/lora.py. The reference ships
LoRALayer / apply_lora_to_ViT / unfreeze_lora_layers although every entry
point applies DoRA only. Its quirks are kept: BOTH lora_A and lora_B are
kaiming-uniform at init (so the adapter moves the model from step 0), and
dropout acts on the activations feeding the low-rank path. Weights are
[in, out], as ``ops.nn.dense`` takes them; the products accumulate in f32.
"""
from __future__ import annotations

import torch

from ..ops.dora import DropoutKey, _kaiming_uniform, dropout_keep_mask


def lora_init(generator: torch.Generator, in_features: int,
              out_features: int, r: int, device=None) -> dict:
    """{lora_A: [r, out], lora_B: [in, r]}, both kaiming-uniform(a=sqrt(5))
    drawn from `generator`. alpha is not baked in: lora_linear and
    lora_merged_weight apply alpha / r at call time, as the reference's
    LoRALayer keeps it as an attribute."""
    return {"lora_A": _kaiming_uniform((r, out_features), generator, device),
            "lora_B": _kaiming_uniform((in_features, r), generator, device)}


def lora_linear(x: torch.Tensor, base_w: torch.Tensor,
                base_b: torch.Tensor | None, lora: dict, *, alpha: int,
                r: int, dropout_p: float = 0.0,
                dropout_key: DropoutKey | None = None,
                deterministic: bool = True,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W + b + dropout(x) @ B @ A * (alpha / r), in x's dtype.

    Products of x's dtype are exact in f32, so f32 operands give the JAX
    layer's f32-accumulating dots; the low-rank input is rounded to x's
    dtype between its two products, as there. Dropout runs when not
    `deterministic` and dropout_p > 0, with the keep-mask `keep` if given,
    else one drawn from `dropout_key`."""
    scaling = alpha / r
    y = torch.matmul(x.float(), base_w.to(x.dtype).float())
    if base_b is not None:
        y = y + base_b.float()
    xd = x
    if not deterministic and dropout_p > 0.0:
        if keep is None:
            if dropout_key is None:
                raise ValueError("lora_linear with dropout_p > 0 and "
                                 "deterministic=False requires a dropout_key")
            keep = dropout_keep_mask(x.shape, dropout_p, dropout_key,
                                     x.device)
        xd = torch.where(keep, x / (1.0 - dropout_p),
                         torch.zeros((), dtype=x.dtype, device=x.device))
    low = torch.matmul(xd.float(), lora["lora_B"].to(x.dtype).float())
    low = torch.matmul(low.to(x.dtype).float(),
                       lora["lora_A"].to(x.dtype).float()) * scaling
    return (y + low).to(x.dtype)


def lora_merged_weight(base_w: torch.Tensor, lora: dict, *, alpha: int,
                       r: int) -> torch.Tensor:
    """The merged [in, out] weight (the reference LoRALayer.weight)."""
    return base_w + torch.matmul(lora["lora_B"].float(),
                                 lora["lora_A"].float()) * (alpha / r)
