"""DoRA (Weight-Decomposed Low-Rank Adaptation), the reference's semantics.

Counterpart of the JAX package's ops/dora.py. Weights are [in, out] (the
transposed view of a torch Linear weight); the direction matrix D has
unit-norm columns over the in axis and the magnitude m is per output column.
ΔA and ΔB are kaiming-uniform(a=sqrt(5)) at init, so the adapted weight at
step 0 is not the pretrained weight. Dropout acts on the low-rank weight
update ΔD, not on the activations (the reference's deliberate choice,
ref :467-468).

Dropout draws from a ``torch.Generator`` seeded by a ``DropoutKey``
(``core.prng.Key``): a path of integers (dropout_seed, epoch, batch, tower,
block) folded in the order of the JAX package's ``fold_in`` chain
(train/clip_loop.py:724,809,441, models/clip.py:295-304,
models/vit.py:494-496). A resume replays the same masks; the bits differ
from JAX's, so tests use p=0 or pass the keep-mask.
"""
from __future__ import annotations

import torch

from ..core.prng import Key as DropoutKey  # noqa: F401  (re-export)
from . import nn as vnn

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


def dropout_keep_mask(shape, p: float, key: DropoutKey,
                      device) -> torch.Tensor:
    """Bernoulli(1 - p) keep-mask of `shape` drawn from `key`'s stream."""
    u = torch.rand(shape, generator=key.generator(device), device=device)
    return u < (1.0 - p)


def dora_weight(trainable: dict, D: torch.Tensor, *, alpha: int, r: int,
                dropout_p: float = 0.0, dropout_key: DropoutKey | None = None,
                deterministic: bool = True,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """Adapted [in, out] weight m * colnorm(D + dropout(B @ A * alpha/r)),
    in f32. Dropout runs when not `deterministic` and dropout_p > 0, with
    the keep-mask `keep` if given, else one drawn from `dropout_key`."""
    delta = torch.matmul(trainable["delta_D_B"].float(),
                         trainable["delta_D_A"].float()) * (alpha / r)
    if not deterministic and dropout_p > 0.0:
        if keep is None:
            if dropout_key is None:
                raise ValueError(
                    "dora_weight: deterministic=False with dropout_p > 0 "
                    "requires a dropout_key")
            keep = dropout_keep_mask(delta.shape, dropout_p, dropout_key,
                                     delta.device)
        delta = torch.where(keep, delta / (1.0 - dropout_p),
                            torch.zeros((), device=delta.device))
    D_new = D.float() + delta
    norms = torch.linalg.vector_norm(D_new, dim=0, keepdim=True) + EPS
    return (D_new / norms) * trainable["m"].float()


def dora_linear(x: torch.Tensor, trainable: dict, buffers: dict, *,
                alpha: int, r: int, dropout_p: float = 0.0,
                dropout_key: DropoutKey | None = None,
                deterministic: bool = True,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W_adapted + bias; buffers {D: [in, out], bias: [out] or
    absent}. The weight is computed in f32 and the product runs in x's
    type (the JAX package's dora_linear)."""
    w = dora_weight(trainable, buffers["D"], alpha=alpha, r=r,
                    dropout_p=dropout_p, dropout_key=dropout_key,
                    deterministic=deterministic, keep=keep)
    return vnn.dense(x, w, buffers.get("bias"))


def count_params(trainable_tree: dict) -> int:
    """Total parameter count of a nested {..: tensor} DoRA tree (183,040 for
    ViT-L/14 with rank 32 on 2 vision + 1 text block)."""
    if isinstance(trainable_tree, dict):
        return sum(count_params(v) for v in trainable_tree.values())
    return int(trainable_tree.numel())
