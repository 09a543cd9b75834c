"""Core neural-net ops on tensors (counterparts of the JAX package's ops/nn.py).

Weights given to ``dense`` are [in, out], as in the JAX package; the modules
in ``models/`` keep OpenAI's [out, in] layout and pass transposed views,
which cuBLAS reads without a copy. Activations run in the caller's dtype
(bf16 when serving) with matmuls accumulating in f32; LayerNorm is computed
in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b), w [in, out]. The output stays in x.dtype.

    One cuBLAS call with the bias in its epilogue: the bias is added to the
    f32 accumulator before the single rounding to x.dtype (the JAX package
    rounds the product, then adds the bias in x.dtype; the two agree
    exactly in f32)."""
    return F.linear(x, w.t().to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, returned in x.dtype.

    With scale and bias already in x.dtype (bf16 serving) this is one
    PyTorch kernel, which computes the statistics and the affine map in f32
    and rounds once; otherwise x and the affine parameters are upcast to
    f32 first, so an f32 scale is never rounded to x.dtype."""
    if scale.dtype == x.dtype and bias.dtype == x.dtype:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU x * sigmoid(1.702 x), the activation of OpenAI CLIP."""
    return x * torch.sigmoid(1.702 * x)


def mlp(x: torch.Tensor, fc1_w: torch.Tensor, fc1_b: torch.Tensor,
        fc2_w: torch.Tensor, fc2_b: torch.Tensor) -> torch.Tensor:
    """CLIP's transformer MLP: dense -> QuickGELU -> dense (weights
    [in, out])."""
    return dense(quick_gelu(dense(x, fc1_w, fc1_b)), fc2_w, fc2_b)


def patch_embed(images: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                patch: int) -> torch.Tensor:
    """Patchify + embed as ONE matmul (a conv with stride == kernel == patch).

    images: [B, H, W, C] (NHWC) -> [B, (H/p)*(W/p), D]; w: [p*p*C, D], rows in
    (ph, pw, c) order; b: [D] or None. Written as reshape + matmul rather
    than a convolution: cuDNN would run an f32 convolution in TF32."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)             # [B, gh, gw, p, p, C]
    x = x.reshape(B, gh * gw, patch * patch * C)
    return dense(x, w, b)


def conv_kernel_to_patch_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """A torch conv kernel [D, C, p, p] -> the [p*p*C, D] patch matrix in the
    (ph, pw, c) row order of ``patch_embed``."""
    D, C, ph, pw = kernel.shape
    return kernel.permute(2, 3, 1, 0).reshape(ph * pw * C, D)
