"""DoRA (Weight-Decomposed Low-Rank Adaptation), the reference's semantics.

Counterpart of the JAX package's ops/dora.py. Weights are [in, out] (the
transposed view of a torch Linear weight); the direction matrix D has
unit-norm columns over the in axis and the magnitude m is per output column.
ΔA and ΔB are kaiming-uniform(a=sqrt(5)) at init, so the adapted weight at
step 0 is not the pretrained weight. Serving bakes the adapted weight once
(adapters/dora.py bake), so only the deterministic weight is needed here.
"""
from __future__ import annotations

import torch

EPS = 1e-8


def _kaiming_uniform(shape: tuple[int, int], generator: torch.Generator,
                     device) -> torch.Tensor:
    """torch kaiming_uniform_(a=sqrt(5)) on a 2-D tensor: U(-b, b) with
    b = 1/sqrt(fan_in), fan_in = shape[1]."""
    bound = 1.0 / (shape[1] ** 0.5)
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -bound, bound, generator=generator)


def dora_init(generator: torch.Generator, w: torch.Tensor, r: int):
    """Decompose a pretrained [in, out] weight into DoRA parameters.

    Returns (trainable, buffers):
      trainable = {m: [out], delta_D_A: [r, out], delta_D_B: [in, r]}
      buffers   = {D: [in, out]}  (frozen unit-column direction matrix)
    """
    w = w.float()
    in_f, out_f = w.shape
    S = torch.linalg.vector_norm(w, dim=0)
    # an all-zero column keeps D at 0 instead of NaN
    D = w / torch.where(S == 0.0, torch.ones_like(S), S)
    trainable = {
        "m": S,
        "delta_D_A": _kaiming_uniform((r, out_f), generator, w.device),
        "delta_D_B": _kaiming_uniform((in_f, r), generator, w.device),
    }
    return trainable, {"D": D}


def dora_weight(trainable: dict, D: torch.Tensor, *, alpha: int,
                r: int) -> torch.Tensor:
    """Adapted [in, out] weight m * colnorm(D + B @ A * alpha/r), in f32
    (dropout off: the serving and evaluation form)."""
    delta = torch.matmul(trainable["delta_D_B"].float(),
                         trainable["delta_D_A"].float()) * (alpha / r)
    D_new = D.float() + delta
    norms = torch.linalg.vector_norm(D_new, dim=0, keepdim=True) + EPS
    return (D_new / norms) * trainable["m"].float()


def count_params(trainable_tree: dict) -> int:
    """Total parameter count of a nested {..: tensor} DoRA tree (183,040 for
    ViT-L/14 with rank 32 on 2 vision + 1 text block)."""
    if isinstance(trainable_tree, dict):
        return sum(count_params(v) for v in trainable_tree.values())
    return int(trainable_tree.numel())
