"""LayerNorm over the last axis with a one-pass backward (counterpart of the
JAX package's ops/layernorm.py).

``layer_norm_fused(x, scale, bias, eps)`` computes what ``ops.nn.layer_norm``
computes (statistics in float32, the variance centred, the output rounded
once to x's dtype). Its backward makes dx and the partial sums of dscale and
dbias in one pass over x and dy; the partials, one float32 row per block of
rows, are summed afterwards. No model calls it: as in the JAX package,
``ops.nn.layer_norm`` is the models' LayerNorm.

Two versions of each half:

- CUDA kernels, ``csrc/layernorm.cu`` (entries ``ln_fwd`` and ``ln_bwd``,
  built by ``ops/cuda_build.py``), launched for a tensor on the card. They
  replace the TPU kernels ``_ln_fwd_kernel`` and ``_ln_bwd_kernel``, take
  float32 or bfloat16 x with D a multiple of 8 from 8 to 4,096, and raise on
  anything else. Both are bound by bytes (each element of x, y, dy, dx moved
  once). The forward runs a row per warp from registers. The backward is one
  persistent launch over ``bwd_schedule``'s partition (at most 264 blocks,
  each one contiguous range of rows, a function of N alone, so the bits do
  not depend on the card): each row group keeps its next rows in flight in
  a ring of shared-memory stages (1-D bulk copies), every block writes one
  partial row, and after a grid barrier (the launch is cooperative) the
  grid sums the partials in a fixed order, in the same launch. The host
  path of a call is one pass of checks, the current raw stream, one ctypes
  call (the C entry sets the device only where it differs) and the output
  allocations;
- plain PyTorch, ``ln_fwd_reference`` and ``ln_bwd_reference`` (JAX's
  partials, one row per 256 rows), taken only for a tensor on the CPU, where
  every float dtype and width is accepted; on the card they are the
  kernels' oracle.

``LayerNormFused`` is the ``torch.autograd.Function`` joining the two halves
(the JAX custom_vjp ``_ln_fused_fn``). dscale and dbias come back in the
dtypes of scale and bias.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_build

# Launches of the kernel wrappers. Each adds one where it launches its kernel
# and nowhere else; the CPU path adds nothing.
LAUNCHES = {"ln_fwd": 0, "ln_bwd": 0}
_launch_lock = threading.Lock()

_F32 = torch.float32
_DTYPE_CODES = {_F32: 0, torch.bfloat16: 1}
BLOCK_ROWS = 256     # rows per partial row of the plain version (the TPU's R)
MAX_D = 4096         # the widest row the kernels hold (csrc/layernorm.cu)
# The backward kernel's schedule, csrc/layernorm.cu's constants of the same
# meaning (kBwdMaxBlocks, kBwdMinRows, kBwdMaxStages, kBwdRingBytes; a CPU
# test ties them):
BWD_MAX_BLOCKS = 264          # the grid's cap: two blocks per SM of an H100
BWD_MIN_ROWS = 8              # rows a block at least: one per warp
BWD_MAX_STAGES = 4            # shared-memory ring stages per row group
BWD_RING_BYTES = 96 * 1024    # ring bytes per block, at most
_WARPS = 8                    # warps per block


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

class BwdSchedule(NamedTuple):
    """The backward kernel's launch for (N, D, dtype): ``blocks`` blocks of
    ``rows`` contiguous rows (the last range ragged, none empty), ``stages``
    ring stages per row group, ``smem`` bytes of dynamic shared memory and
    ``scratch`` float32 elements of scratch: the blocks' partial rows, one
    [2D] row per block."""
    blocks: int
    rows: int
    stages: int
    smem: int
    scratch: int


def _warps_per_row(D: int) -> int:
    """Warps that read one row (csrc/layernorm.cu width_config)."""
    chunks = D // 8
    return 1 if chunks <= 128 else 2 if chunks <= 256 else 4


def bwd_schedule(N: int, D: int, dtype: torch.dtype) -> BwdSchedule:
    """The persistent backward's partition and resources (the C source's
    ``bwd_schedule``, exported as ``ln_bwd_schedule``): min(BWD_MAX_BLOCKS,
    ceil(N / BWD_MIN_ROWS)) blocks, each owning ceil(N / blocks) rows. It is
    a function of (N, D, dtype) alone, never of the card, so the bits of
    dscale and dbias are not either."""
    blocks = min(BWD_MAX_BLOCKS, -(-max(N, 1) // BWD_MIN_ROWS))
    rows = -(-max(N, 1) // blocks)
    blocks = -(-N // rows) if N > 0 else 0
    groups = _WARPS // _warps_per_row(D)
    row_pair = 2 * D * (2 if dtype == torch.bfloat16 else 4)
    stages = max(1, min(BWD_MAX_STAGES, BWD_RING_BYTES // (groups * row_pair)))
    # the ring, the row groups' sums, or the final sum's staging (a float4
    # column of BWD_MAX_BLOCKS partials a warp)
    smem = max(groups * stages * row_pair, groups * 2 * D * 4,
               _WARPS * BWD_MAX_BLOCKS * 16)
    return BwdSchedule(blocks, rows, stages, smem, blocks * 2 * D)


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


def _check_kernel(name: str, x2d: torch.Tensor) -> int:
    """The kernels' dtype code for x2d; raises on a dtype or width they do
    not take."""
    code = _DTYPE_CODES.get(x2d.dtype)
    if code is None:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x2d.dtype}")
    D = x2d.shape[1]
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"{name} kernel takes D a multiple of 8 from 8 to "
                         f"{MAX_D}, got D={D}")
    return code


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t itself if contiguous with a 16-byte aligned start (the kernels'
    vector loads), else a contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _f32(t: torch.Tensor, aligned: bool = True) -> torch.Tensor:
    """t as contiguous float32 (16-byte aligned where `aligned`: the vector
    loads), converted or copied only if it is not."""
    if t.dtype != torch.float32:
        t = t.float()
    if aligned:
        return _rows(t)
    return t if t.is_contiguous() else t.contiguous()


_ARGTYPES = {
    "ln_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p],
    "ln_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "ln_bwd_schedule": [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ln_bwd_resident": [ctypes.c_int] * 3}
_entries: dict = {}
_stream_of = None


def _entry(name: str):
    """The C entry `name` of the built library, its argument types set."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("layernorm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _stream(index: int) -> int:
    """The raw cudaStream_t of the current stream of CUDA device `index`,
    without building a torch.cuda.Stream where PyTorch has the raw getter."""
    global _stream_of
    if _stream_of is None:
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _stream_of = raw or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _stream_of(index)


def native_bwd_schedule(N: int, D: int, dtype: torch.dtype) -> BwdSchedule:
    """``bwd_schedule`` as the built C library computes it (needs the
    card's toolchain; a CUDA run holds it equal to the Python mirror)."""
    out = (ctypes.c_long * 5)()
    err = _entry("ln_bwd_schedule")(N, D, _DTYPE_CODES[dtype], out)
    if err:
        raise ValueError(f"ln_bwd_schedule: CUDA error {err} for D={D}, "
                         f"{dtype}")
    return BwdSchedule(*out)


def _plain_only(name: str, x2d: torch.Tensor) -> None:
    """A CUDA tensor launches the kernels (or raises); a CPU tensor takes the
    plain versions; no other device has a version."""
    if x2d.device.type != "cpu":
        raise ValueError(f"{name}: no version for device {x2d.device}")


def bwd_resident(D: int, dtype: torch.dtype, device=None) -> int:
    """Backward blocks the CUDA device holds at once at width D (the C
    entry's occupancy query): where it is at least bwd_schedule's blocks,
    ln_bwd is one cooperative launch; else a plain launch and a second
    kernel sum the partials, in the same order."""
    index = torch.device("cuda", torch.cuda.current_device()
                         if device is None else device).index
    return _entry("ln_bwd_resident")(D, _DTYPE_CODES[dtype], index)


def _count(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES[name] += 1


def _launch_fwd(x2d, scale, bias, eps):
    """The forward on the card. One pass of cheap checks; only a call that
    fails one takes the long checks, which raise."""
    code = _DTYPE_CODES.get(x2d.dtype)
    if code is None or x2d.ndim != 2:
        _check("ln_fwd", x2d, scale, bias)
        _check_kernel("ln_fwd", x2d)
    N, D = x2d.shape
    index = x2d.get_device()
    if (D % 8 or not 8 <= D <= MAX_D or scale.shape != (D,)
            or bias.shape != (D,) or scale.get_device() != index
            or bias.get_device() != index):
        _check("ln_fwd", x2d, scale, bias)
        _check_kernel("ln_fwd", x2d)
    px = x2d.data_ptr()
    if px & 15 or not x2d.is_contiguous():
        x2d = _rows(x2d)
        px = x2d.data_ptr()
    device = x2d.device
    y = torch.empty_like(x2d)
    # two allocations: on the H100 host each costs less than a view of one
    # shared buffer (chip_smoke.py's host-path line)
    mean = torch.empty(N, 1, dtype=_F32, device=device)
    rstd = torch.empty(N, 1, dtype=_F32, device=device)
    if N == 0:
        return y, mean, rstd
    ps, pb = scale.data_ptr(), bias.data_ptr()
    if ps & 15 or scale.dtype is not _F32 or not scale.is_contiguous():
        scale = _f32(scale)
        ps = scale.data_ptr()
    if pb & 15 or bias.dtype is not _F32 or not bias.is_contiguous():
        bias = _f32(bias)
        pb = bias.data_ptr()
    err = _entry("ln_fwd")(px, ps, pb, y.data_ptr(), mean.data_ptr(),
                           rstd.data_ptr(), N, D, eps, code, index,
                           _stream(index))
    _count("ln_fwd", err)
    return y, mean, rstd


def _launch_bwd(x2d, scale, mean, rstd, dy):
    code = _check_kernel("ln_bwd", x2d)
    x2d = _rows(x2d)
    if dy.dtype != x2d.dtype:
        dy = dy.to(x2d.dtype)
    dy = _rows(dy)                   # an expanded or sliced cotangent: copied
    mean, rstd = _f32(mean, False), _f32(rstd, False)   # read a float a row
    N, D = x2d.shape
    dx = torch.empty_like(x2d)
    if N == 0:
        dsb = torch.zeros(2 * D, dtype=torch.float32, device=x2d.device)
        return dx, dsb[:D], dsb[D:]
    dsb = torch.empty(2 * D, dtype=torch.float32, device=x2d.device)
    scale = _f32(scale)
    # `scratch` may be freed when this returns: the caching allocator hands
    # its memory only to work queued after the kernel on the same stream
    scratch = torch.empty(bwd_schedule(N, D, x2d.dtype).scratch,
                          dtype=torch.float32, device=x2d.device)
    index = x2d.device.index
    err = _entry("ln_bwd")(
        x2d.data_ptr(), scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), scratch.data_ptr(), dsb.data_ptr(),
        N, D, code, index, _stream(index))
    _count("ln_bwd", err)
    return dx, dsb[:D], dsb[D:]


def ln_fwd(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5):
    """(y [N, D] in x's dtype, mean, rstd [N, 1] f32) from x2d [N, D] and
    scale, bias [D]."""
    if x2d.is_cuda:
        return _launch_fwd(x2d, scale, bias, eps)
    _check("ln_fwd", x2d, scale, bias)
    _plain_only("ln_fwd", x2d)
    return ln_fwd_reference(x2d, scale, bias, eps)


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
    if x2d.is_cuda:
        return _launch_bwd(x2d, scale, mean, rstd, dy)
    _plain_only("ln_bwd", x2d)
    dx, dsc_p, dbi_p = ln_bwd_reference(x2d, scale, mean, rstd, dy)
    return dx, sum_partials(dsc_p), sum_partials(dbi_p)


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
