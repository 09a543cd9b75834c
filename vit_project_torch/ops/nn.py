"""Core neural-net ops on tensors (counterparts of the JAX package's ops/nn.py).

Weights given to ``dense`` are [in, out], as in the JAX package; the modules
in ``models/`` keep OpenAI's [out, in] layout and pass transposed views,
which cuBLAS reads without a copy. Activations run in the caller's dtype
(bf16 when serving) with matmuls accumulating in f32; LayerNorm is computed
in f32.

``dense`` and ``mlp`` take a per-call ``fused_dw``: with it, a dense layer
that has a bias takes its weight and bias gradients from the fused dW+db
kernel (``ops/fused_dw.py``). The JAX package switches this with a
process-wide flag read at trace time; here each caller says it, so one
model cannot leak the choice into another.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None, *,
          fused_dw: bool = False) -> torch.Tensor:
    """x @ w (+ b), w [in, out]. The output stays in x.dtype.

    One cuBLAS call with the bias in its epilogue: the bias is added to the
    f32 accumulator before the single rounding to x.dtype (the JAX package
    rounds the product, then adds the bias in x.dtype; the two agree
    exactly in f32). With `fused_dw` and a bias, the same forward runs
    inside ``fused_dw.DenseDwFused``, whose backward produces (dW, db) in
    float32 with one kernel."""
    if fused_dw and b is not None:
        from . import fused_dw as _fdw
        return _fdw.dense_dw_fused(x, w, b)
    return F.linear(x, w.t().to(x.dtype), None if b is None else b.to(x.dtype))


def trunc_normal(shape, std: float = 0.02, *,
                 generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """timm-style truncated-normal init in float32: a normal of deviation
    `std` cut at two deviations, as the JAX package draws it (its cut is on
    the standard normal before scaling; torch's bounds are absolute, hence
    +-2 * std here)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch.nn.GELU's default."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (the JAX package's ViT default)."""
    return F.gelu(x, approximate="tanh")


def mlp(x: torch.Tensor, fc1_w: torch.Tensor, fc1_b: torch.Tensor,
        fc2_w: torch.Tensor, fc2_b: torch.Tensor, *, act=quick_gelu,
        fused_dw: bool = False) -> torch.Tensor:
    """Transformer MLP: dense -> act -> dense (weights [in, out]); QuickGELU
    unless the caller names another activation."""
    h = act(dense(x, fc1_w, fc1_b, fused_dw=fused_dw))
    return dense(h, fc2_w, fc2_b, fused_dw=fused_dw)


def patch_embed(images: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                patch: int, *, fused_dw: bool = False) -> torch.Tensor:
    """Patchify + embed as ONE matmul (a conv with stride == kernel == patch).

    images: [B, H, W, C] (NHWC) -> [B, (H/p)*(W/p), D]; w: [p*p*C, D], rows in
    (ph, pw, c) order; b: [D] or None. Written as reshape + matmul rather
    than a convolution: cuDNN would run an f32 convolution in TF32."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)             # [B, gh, gw, p, p, C]
    x = x.reshape(B, gh * gw, patch * patch * C)
    return dense(x, w, b, fused_dw=fused_dw)


def patch_embed_affine(images_raw: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None, patch: int, *, mean, std,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Patchify + embed with the per-channel input normalization folded into
    the patch matrix: ((x/255 - mean)/std) @ W + b == x @ (a*W) + (b +
    pix_b @ W) with a_c = 1/(255 std_c), pix_b_c = -mean_c/std_c.

    images_raw: [B, H, W, 3] in raw uint8 scale (uint8 or float 0..255);
    w: [p*p*3, D] in (ph, pw, c) row order. One einsum over the image in
    the compute dtype, no separate normalization pass (the training hot
    path; it never goes through the fused dW kernel)."""
    B, H, W, C = images_raw.shape
    gh, gw = H // patch, W // patch
    D = w.shape[-1]
    std_t = torch.tensor(std, dtype=torch.float32, device=w.device)
    a = 1.0 / (255.0 * std_t)                                      # [C]
    pix_b = -torch.tensor(mean, dtype=torch.float32, device=w.device) / std_t
    w4 = w.reshape(patch * patch, C, D)
    wf = (w4 * a[None, :, None]).reshape(patch, patch, C, D)
    bias = torch.einsum("c,pcd->d", pix_b, w4)
    if b is not None:
        bias = bias + b
    x = images_raw.reshape(B, gh, patch, gw, patch, C).to(compute_dtype)
    t = torch.einsum("bhpwqc,pqcd->bhwd", x, wf.to(compute_dtype))
    return (t + bias.to(compute_dtype)).reshape(B, gh * gw, D)


def conv_kernel_to_patch_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """A torch conv kernel [D, C, p, p] -> the [p*p*C, D] patch matrix in the
    (ph, pw, c) row order of ``patch_embed``."""
    D, C, ph, pw = kernel.shape
    return kernel.permute(2, 3, 1, 0).reshape(ph * pw * C, D)
