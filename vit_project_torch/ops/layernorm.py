"""LayerNorm over the last axis with a one-pass backward (counterpart of the
JAX package's ops/layernorm.py).

``layer_norm_fused(x, scale, bias, eps)`` computes what ``ops.nn.layer_norm``
computes (statistics in float32, the variance centred, the output rounded
once to x's dtype). Its backward makes dx and the per-block partial sums of
dscale and dbias in one pass over x and dy; the partials, one float32 row
per block of rows (256 in the plain version, as in JAX; 32-256 in the
kernel, as many as fill the card), are summed afterwards. No model calls it: as in the JAX
package, ``ops.nn.layer_norm`` is the models' LayerNorm.

Two versions of each half:

- CUDA kernels, ``csrc/layernorm.cu`` (entries ``ln_fwd`` and ``ln_bwd``,
  built by ``ops/cuda_build.py``), launched for a tensor on the card. They
  take float32 or bfloat16 x with D a multiple of 8 from 8 to 4,096, and
  raise on anything else;
- plain PyTorch, ``ln_fwd_reference`` and ``ln_bwd_reference``, taken only
  for a tensor on the CPU, where every float dtype and width is accepted; on
  the card they are the kernels' oracle.

``LayerNormFused`` is the ``torch.autograd.Function`` joining the two halves
(the JAX custom_vjp ``_ln_fused_fn``). dscale and dbias come back in the
dtypes of scale and bias.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import cuda_build
from .attention import _dispatch

# Launches of the kernel wrappers. Each adds one where it launches its kernel
# and nowhere else; the CPU path adds nothing.
LAUNCHES = {"ln_fwd": 0, "ln_bwd": 0}
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_ROWS = 256     # rows per partial row of the plain version (the TPU's R)
MAX_D = 4096         # the widest row the kernels hold (csrc/layernorm.cu)
# blocks the backward kernel aims for: two per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 264


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# -- plain versions -----------------------------------------------------------

def ln_fwd_reference(x2d: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5):
    """(y [N, D] in x's dtype, mean [N, 1] f32, rstd [N, 1] f32)."""
    x = x2d.float()
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    y = (xc * rstd) * scale.float() + bias.float()
    return y.to(x2d.dtype), mean, rstd


def ln_bwd_reference(x2d: torch.Tensor, scale: torch.Tensor,
                     mean: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor):
    """(dx [N, D] in x's dtype, dscale partials [n_b, D] f32, dbias partials
    [n_b, D] f32), with one partial row per BLOCK_ROWS rows, n_b =
    ceil(N / BLOCK_ROWS); a partial sums over its block's real rows only."""
    x = x2d.float()
    dyf = dy.float()
    mean, rstd = mean.reshape(-1, 1), rstd.reshape(-1, 1)
    xhat = (x - mean) * rstd
    g = dyf * scale.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    dx = ((g - m1 - xhat * m2) * rstd).to(x2d.dtype)
    N, D = x.shape
    n_b = -(-N // BLOCK_ROWS)

    def blocks(t):
        return F.pad(t, (0, 0, 0, n_b * BLOCK_ROWS - N)).view(
            n_b, BLOCK_ROWS, D).sum(1)
    return dx, blocks(dyf * xhat), blocks(dyf)


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """The [n_b, D] per-block partials summed over the blocks, in f32."""
    return partials.sum(0)


# -- the kernels ----------------------------------------------------------------

def bwd_block_rows(N: int) -> int:
    """Rows per block of the backward kernel, each block one partial row:
    the most of 256, 128 and 64 that still gives _TARGET_BLOCKS blocks,
    else 32."""
    for rows in (256, 128, 64):
        if -(-N // rows) >= _TARGET_BLOCKS:
            return rows
    return 32


def _check(name: str, x2d: torch.Tensor, *vectors: torch.Tensor) -> None:
    if x2d.ndim != 2:
        raise ValueError(f"{name}: expected x2d [N, D], got {tuple(x2d.shape)}")
    for v in vectors:
        if tuple(v.shape) != (x2d.shape[1],):
            raise ValueError(f"{name}: expected [D] = [{x2d.shape[1]}] "
                             f"vectors, got {tuple(v.shape)}")
        if v.device != x2d.device:
            raise ValueError(f"{name}: x2d on {x2d.device}, a vector on "
                             f"{v.device}")


def _check_kernel(name: str, x2d: torch.Tensor) -> None:
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x2d.dtype}")
    D = x2d.shape[1]
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"{name} kernel takes D a multiple of 8 from 8 to "
                         f"{MAX_D}, got D={D}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t itself if contiguous with a 16-byte aligned start (the kernels'
    vector loads), else a contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


_ARGTYPES = {
    "ln_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p],
    "ln_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}
_entries: dict = {}


def _entry(name: str):
    """The C entry `name` of the built library, its argument types set."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("layernorm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _count(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES[name] += 1


def _launch_fwd(x2d, scale, bias, eps):
    _check_kernel("ln_fwd", x2d)
    x2d = _rows(x2d)
    N, D = x2d.shape
    y = torch.empty_like(x2d)
    mean, rstd = torch.empty(2, N, 1, dtype=torch.float32,
                             device=x2d.device).unbind(0)
    if N == 0:
        return y, mean, rstd
    scale, bias = _rows(scale.float()), _rows(bias.float())  # f32: no copy
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = _entry("ln_fwd")(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), N, D, float(eps),
            _DTYPE_CODES[x2d.dtype], stream)
    _count("ln_fwd", err)
    return y, mean, rstd


def _launch_bwd(x2d, scale, mean, rstd, dy):
    _check_kernel("ln_bwd", x2d)
    x2d = _rows(x2d)
    dy = _rows(dy.to(x2d.dtype))     # an expanded or sliced cotangent: copied
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    N, D = x2d.shape
    dx = torch.empty_like(x2d)
    dsb = (torch.zeros if N == 0 else torch.empty)(
        2 * D, dtype=torch.float32, device=x2d.device)
    if N == 0:
        return dx, dsb[:D], dsb[D:]
    scale = _rows(scale.float())
    # `parts` may be freed when this returns: the caching allocator hands its
    # memory only to work queued after the kernels on the same stream
    rows = bwd_block_rows(N)
    parts = torch.empty(-(-N // rows), 2 * D, dtype=torch.float32,
                        device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = _entry("ln_bwd")(
            x2d.data_ptr(), scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), parts.data_ptr(), dsb.data_ptr(),
            N, D, rows, _DTYPE_CODES[x2d.dtype], stream)
    _count("ln_bwd", err)
    return dx, dsb[:D], dsb[D:]


def ln_fwd(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5):
    """(y [N, D] in x's dtype, mean, rstd [N, 1] f32) from x2d [N, D] and
    scale, bias [D]."""
    _check("ln_fwd", x2d, scale, bias)
    return _dispatch("ln_fwd", x2d,
                     lambda: _launch_fwd(x2d, scale, bias, eps),
                     lambda: ln_fwd_reference(x2d, scale, bias, eps))


def ln_bwd(x2d: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
           rstd: torch.Tensor, dy: torch.Tensor):
    """(dx [N, D] in x's dtype, dscale [D] f32, dbias [D] f32) from the
    forward's x2d, scale, mean and rstd and the cotangent dy [N, D]."""
    _check("ln_bwd", x2d, scale)
    N = x2d.shape[0]
    if (tuple(dy.shape) != tuple(x2d.shape) or mean.numel() != N
            or rstd.numel() != N):
        raise ValueError(f"ln_bwd: expected dy {tuple(x2d.shape)} and mean, "
                         f"rstd of {N} rows, got {tuple(dy.shape)}, "
                         f"{tuple(mean.shape)}, {tuple(rstd.shape)}")
    if any(t.device != x2d.device for t in (dy, mean, rstd)):
        raise ValueError(f"ln_bwd: dy, mean and rstd must lie on x2d's "
                         f"device, {x2d.device}")

    def plain():
        dx, dsc_p, dbi_p = ln_bwd_reference(x2d, scale, mean, rstd, dy)
        return dx, sum_partials(dsc_p), sum_partials(dbi_p)
    return _dispatch("ln_bwd", x2d,
                     lambda: _launch_bwd(x2d, scale, mean, rstd, dy), plain)


class LayerNormFused(torch.autograd.Function):
    """y = LayerNorm(x2d) from ``ln_fwd``, saving (x2d, scale, mean, rstd);
    the backward is ``ln_bwd``, with dscale and dbias summed in f32 and cast
    to the dtypes of scale and bias (the JAX custom_vjp's f_fwd / f_bwd)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        y, mean, rstd = ln_fwd(x2d, scale, bias, eps)
        ctx.save_for_backward(x2d, scale, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, scale, mean, rstd = ctx.saved_tensors
        dx, dsc, dbi = ln_bwd(x2d, scale, mean, rstd, dy)
        return dx, dsc.to(scale.dtype), dbi.to(ctx.bias_dtype), None


def layer_norm_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x [..., D] with the one-pass backward;
    y in x's shape and dtype. scale and bias [D] are float32 or x's dtype.
    The leading axes are flattened into rows. A CUDA tensor launches the
    kernels (or raises); a CPU tensor takes the plain versions."""
    shape = x.shape
    y = LayerNormFused.apply(x.reshape(-1, shape[-1]), scale, bias, eps)
    return y.reshape(shape)
