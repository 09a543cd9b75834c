"""Fused multi-head attention: the port of the JAX package's ``ops/attention.py``.

Three layouts, one per-head softmax attention:

- ``flash_mha_packed_qkv``: one packed [B, S, 3D] qkv tensor. Lanes [0:D] of
  the last axis are q PRESCALED by 1/sqrt(dh), [D:2D] k and [2D:3D] v, and
  heads are dh-lane slices within each third (exactly the layout one [D, 3D]
  projection emits). The result is [B, S, D] with head h at lanes h*dh; the
  backward returns one packed [B, S, 3D] cotangent. The model blocks use it.
- ``flash_mha_packed``: the same on three [B, S, D] tensors (q prescaled);
  the backward returns dq, dk and dv.
- ``attention_core`` over [B, H, S, dh] and ``attention_core_bshd`` over
  [B, S, H, dh]: the scale 1/sqrt(dh) is applied to the scores. By default
  they run the fused plain path (``mha_fused``, ``mha_fused_bshd``);
  ``use_kernel=True`` takes the whole-sequence kernels (``mha_fwd``, and
  ``mha_bwd``, which recomputes the softmax statistics and keeps p and ds in
  float32).

Each kernel wrapper has two versions:

- a CUDA kernel, built from ``csrc/flash3_fwd.cu`` (entries ``flash3_fwd``,
  ``flash_fwd``, ``mha_fwd``) and ``csrc/flash3_bwd.cu`` (``flash3_bwd``,
  ``flash_bwd``, ``mha_bwd``) by ``ops/cuda_build.py``, launched for a tensor
  on the card. The kernels read every operand where it lies, by strides;
- plain PyTorch in the TPU kernels' order of operations
  (``flash_mha_packed_qkv_reference``, ``flash_mha_packed_reference``,
  ``mha_reference`` and their backward counterparts). A wrapper takes it
  only for a tensor on the CPU; on the card it is the kernel's oracle.

The entry points are differentiable through ``torch.autograd.Function``s
whose backward is a kernel wrapper too. Without a gradient to record
(serving under ``torch.inference_mode``) they call the forward alone.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

NEG_INF = -1e30        # the TPU kernels' mask value (_NEG_INF)
KERNEL_HEAD_DIM = 64   # the head width the CUDA kernels have a template for
# bf16 flash3_bwd / flash_bwd / mha_bwd up to this S run the whole-head route
# of csrc/flash3_bwd.cu (kWholeHeadMaxS there): one launch, no scratch
BWD_WHOLE_HEAD_MAX_S = 432
# bf16 forwards up to this S run the whole-head route of csrc/flash3_fwd.cu
# (kFwdWholeHeadMaxS there): one block per head, its q, k, v read once
FWD_WHOLE_HEAD_MAX_S = 288

# Launches of each kernel wrapper in this module. A wrapper adds one where it
# launches its kernel and nowhere else; the CPU path adds nothing.
LAUNCHES = {"flash3_fwd": 0, "flash3_bwd": 0, "flash_fwd": 0, "flash_bwd": 0,
            "mha_fwd": 0, "mha_bwd": 0}
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _check_packed(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int]:
    if qkv.ndim != 3:
        raise ValueError(f"flash_mha_packed_qkv: expected qkv [B, S, 3D], got "
                         f"{tuple(qkv.shape)}")
    B, S, D3 = qkv.shape
    if D3 % 3 != 0 or (D3 // 3) % num_heads != 0:
        # a misaligned packing shifts every k/v lane slice (or leaves output
        # lanes unwritten) with no error: fail loudly instead
        raise ValueError(f"flash_mha_packed_qkv: last dim {D3} must be 3*D "
                         f"with D divisible by num_heads={num_heads}")
    return B, S, D3 // 3


def _check_packed3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_mha_packed: expected q, k, v [B, S, D] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] % num_heads != 0:  # a partial head would leave lanes unwritten
        raise ValueError(f"flash_mha_packed: D={q.shape[-1]} is not divisible "
                         f"by num_heads={num_heads}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha_packed: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*dh] -> [B, H, S, dh] (a view)."""
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> [B, S, H*dh]."""
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _masked(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scores [..., S, S] with every key past the row set to NEG_INF when
    causal (the TPU kernels' mask)."""
    if not causal:
        return s
    S = s.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
    return s.masked_fill(~keep, NEG_INF)


# -- plain versions ------------------------------------------------------------

def _fwd_heads(q, k, v, causal):
    """The TPU kernels' _attn_fwd_head (JAX ops/attention.py:303-316) on
    [B, H, S, dh] views, q prescaled: (o [B, H, S, dh] f32, lse [B, H, S]).

    Scores in f32 from the working-type operands, masked to NEG_INF; row
    max, exp, row sum; p = e * (1/r) rounded to v's type; o = p @ v
    accumulated in f32; lse = m + log r. Products of bf16 values are exact in
    f32, so upcasting the operands reproduces the f32-accumulating bf16
    dots."""
    s = _masked(torch.matmul(q.float(), k.float().transpose(-1, -2)), causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    r = e.sum(dim=-1, keepdim=True)
    p = (e * (1.0 / r)).to(v.dtype)
    return torch.matmul(p.float(), v.float()), (m + torch.log(r))[..., 0]


def _bwd_heads(q, k, v, g, lse, causal):
    """The TPU kernels' _attn_bwd_head (JAX ops/attention.py:319-341) on
    [B, H, S, dh] views at the working type q.dtype, with g = do in that type
    and the forward's lse [B, H, S]: (dq, dk, dv) [B, H, S, dh] f32.

    s = q k^T in f32, masked to NEG_INF; p = exp(s - lse) replaying the
    forward's statistics; dv = p(working type)^T do; dp = do v^T; c = the row
    sum of p * dp; ds = (p * (dp - c)) in the working type; dq = ds k;
    dk = ds^T q; every product accumulated in f32."""
    wt = q.dtype
    q, k, v, g = (x.float() for x in (q, k, v, g))
    s = _masked(torch.matmul(q, k.transpose(-1, -2)), causal)
    p = torch.exp(s - lse[..., None])
    pb = p.to(wt).float()
    dv = torch.matmul(pb.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    c = torch.sum(dp * p, dim=-1, keepdim=True)
    ds = (p * (dp - c)).to(wt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq, dk, dv


def flash_mha_packed_qkv_reference(qkv: torch.Tensor, num_heads: int,
                                   causal: bool = False):
    """Plain PyTorch forward of ``_flash3_fwd_kernel``: returns (o [B, S, D]
    in qkv.dtype, lse [B, S, H] float32), in _attn_fwd_head's order."""
    B, S, D = _check_packed(qkv, num_heads)
    o, lse = _fwd_heads(*(_heads(qkv[..., i * D:(i + 1) * D], num_heads)
                          for i in range(3)), causal)
    return _unheads(o).to(qkv.dtype), lse.transpose(1, 2).contiguous()


def flash_mha_packed_qkv_bwd_reference(qkv: torch.Tensor, do: torch.Tensor,
                                       lse: torch.Tensor, num_heads: int,
                                       causal: bool = False) -> torch.Tensor:
    """Plain PyTorch backward of ``_flash3_bwd_kernel``: the packed cotangent
    dqkv [B, S, 3D] in qkv.dtype from qkv, do [B, S, D] and the forward's lse
    [B, S, H], in _attn_bwd_head's order."""
    B, S, D = _check_packed(qkv, num_heads)
    grads = _bwd_heads(*(_heads(qkv[..., i * D:(i + 1) * D], num_heads)
                         for i in range(3)),
                       _heads(do.to(qkv.dtype), num_heads),
                       lse.float().transpose(1, 2), causal)
    return torch.cat([_unheads(x).to(qkv.dtype) for x in grads], dim=-1)


def flash_mha_packed_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int,
                               causal: bool = False):
    """Plain PyTorch forward of ``_flash_fwd_kernel`` (JAX
    ops/attention.py:344-355): q (prescaled), k, v [B, S, D] -> (o [B, S, D]
    in q.dtype, lse [B, S, H] float32), in _attn_fwd_head's order."""
    _check_packed3(q, k, v, num_heads)
    o, lse = _fwd_heads(_heads(q, num_heads), _heads(k, num_heads),
                        _heads(v, num_heads), causal)
    return _unheads(o).to(q.dtype), lse.transpose(1, 2).contiguous()


def flash_mha_packed_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, do: torch.Tensor,
                                   lse: torch.Tensor, num_heads: int,
                                   causal: bool = False):
    """Plain PyTorch backward of ``_flash_bwd_kernel`` (JAX
    ops/attention.py:358-371): (dq, dk, dv) [B, S, D] in q.dtype from q, k,
    v, do [B, S, D] and the forward's lse [B, S, H], in _attn_bwd_head's
    order."""
    _check_packed3(q, k, v, num_heads)
    grads = _bwd_heads(_heads(q, num_heads), _heads(k, num_heads),
                       _heads(v, num_heads), _heads(do.to(q.dtype), num_heads),
                       lse.float().transpose(1, 2), causal)
    return tuple(_unheads(x).to(q.dtype) for x in grads)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False) -> torch.Tensor:
    """Softmax attention over [B, H, S, dh] (JAX ops/attention.py:40-54), and
    the plain version of ``_mha_kernel``: scores in f32 times 1/sqrt(dh),
    masked to NEG_INF; softmax in f32; p rounded to v's type; o = p v
    accumulated in f32, in q's type."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _masked(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale,
                causal)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def mha_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, causal: bool = False):
    """The backward of ``mha_reference`` (JAX ops/attention.py:201-222) and
    the plain version of ``_mha_bwd_kernel``: every product in f32, p and ds
    never rounded; (dq, dk, dv) in the inputs' types."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf, vf, g = (x.float() for x in (q, k, v, do))
    s = _masked(torch.matmul(qf, kf.transpose(-1, -2)) * scale, causal)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, vf.transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _softmax_in_f32(s: torch.Tensor, causal: bool, dtype) -> torch.Tensor:
    sf = _masked(s.float(), causal)
    e = torch.exp(sf - sf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(dtype)


def mha_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False) -> torch.Tensor:
    """Attention over [B, H, S, dh] with scores and probabilities stored in
    the input dtype and f32 softmax statistics: the default path of
    ``attention_core``, JAX's ``mha_fused_xla`` (ops/attention.py:228-248) as
    plain PyTorch ops."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    return torch.matmul(_softmax_in_f32(s, causal, q.dtype), v)


def mha_fused_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False) -> torch.Tensor:
    """``mha_fused`` on [B, S, H, dh] tensors, the heads contracted in place
    (JAX ``mha_fused_xla_bshd``, ops/attention.py:587-604)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / q.shape[-1] ** 0.5)
    return torch.einsum("bhqk,bkhd->bqhd", _softmax_in_f32(s, causal, q.dtype),
                        v)


# -- kernel wrappers -----------------------------------------------------------

def _check_kernel_dtype(name: str, dtype) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dtype}")


def _check_head_dim(name: str, dh: int) -> None:
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"{name} kernel has a template for head width "
                         f"{KERNEL_HEAD_DIM} only, got {dh}")


def _check_kernel_args(name: str, qkv: torch.Tensor, num_heads: int):
    B, S, D = _check_packed(qkv, num_heads)
    _check_kernel_dtype(name, qkv.dtype)
    _check_head_dim(name, D // num_heads)
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs a contiguous, 16-byte aligned "
                         f"qkv")
    return B, S, D


def _launch_fwd(qkv: torch.Tensor, num_heads: int, causal: bool):
    B, S, D = _check_kernel_args("flash3_fwd", qkv, num_heads)
    fn = cuda_build.load("flash3_fwd").flash3_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty(B, S, D, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(B, S, num_heads, dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, D,
                 num_heads, int(causal), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash3_fwd launch failed: CUDA error {err}")
    _count_launch("flash3_fwd")
    return o, lse


def _launch_bwd(qkv: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                num_heads: int, causal: bool) -> torch.Tensor:
    B, S, D = _check_kernel_args("flash3_bwd", qkv, num_heads)
    for name, x, shape, dtype in (("do", do, (B, S, D), qkv.dtype),
                                  ("lse", lse, (B, S, num_heads),
                                   torch.float32)):
        if x.device != qkv.device or x.dtype != dtype \
                or tuple(x.shape) != shape:
            raise ValueError(f"flash3_bwd: {name} must be {dtype} {shape} on "
                             f"{qkv.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash3_bwd kernel needs a contiguous, 16-byte "
                             f"aligned {name}")
    fn = cuda_build.load("flash3_bwd").flash3_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dqkv = torch.empty_like(qkv)
    delta = _row_sum_scratch(B, S, num_heads, qkv.dtype, qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 dqkv.data_ptr(), _address(delta), B, S, D, num_heads,
                 int(causal), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash3_bwd launch failed: CUDA error {err}")
    _count_launch("flash3_bwd")
    return dqkv


def fwd_whole_head(S: int, dtype) -> bool:
    """Whether the forward kernels (flash3_fwd, flash_fwd, mha_fwd) at
    sequence length S and operand type dtype take the whole-head route (one
    block per head holding its q, k and v): bf16 up to FWD_WHOLE_HEAD_MAX_S.
    The others stream 64-key tiles. Both routes take one launch and no
    scratch."""
    return dtype == torch.bfloat16 and S <= FWD_WHOLE_HEAD_MAX_S


def bwd_whole_head(S: int, dtype) -> bool:
    """Whether the backward kernels (flash3_bwd, flash_bwd, mha_bwd) at
    sequence length S and operand type dtype take the whole-head route (one
    launch, the head in shared memory): bf16 up to BWD_WHOLE_HEAD_MAX_S. The
    other routes take two launches and float32 [B, S, H] scratch: the row
    sums c, and for mha_bwd the row statistics lse."""
    return dtype == torch.bfloat16 and S <= BWD_WHOLE_HEAD_MAX_S


def _row_sum_scratch(B: int, S: int, H: int, dtype, device):
    """A float32 [B, S, H] scratch for the row sums c where the backward's
    route needs one, else None (the kernel gets a null pointer)."""
    if bwd_whole_head(S, dtype):
        return None
    return torch.empty(B, S, H, dtype=torch.float32, device=device)


def _address(x) -> int:
    return 0 if x is None else x.data_ptr()


def _strides_ok(x: torch.Tensor) -> bool:
    """Whether the strided kernels can read x as it lies: the last dim
    contiguous, every other stride and the base address a multiple of 16
    bytes (the tile loads are 16-byte vectors)."""
    step = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % step == 0 for n, st in zip(x.shape[:-1],
                                                   x.stride()[:-1]) if n > 1))


def _check_views(name: str, views: dict) -> tuple[int, int, int]:
    """Check the [B, H, S, dh] views a strided kernel reads: one device, one
    dtype and one shape, head width 64, and strides it can read in place.
    Raises rather than copying. Returns (B, H, S)."""
    first = next(iter(views.values()))
    _check_kernel_dtype(name, first.dtype)
    _check_head_dim(name, first.shape[-1])
    for label, x in views.items():
        if x.device != first.device or x.dtype != first.dtype \
                or x.shape != first.shape:
            raise ValueError(f"{name}: {label} must be {first.dtype} "
                             f"{tuple(first.shape)} on {first.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not _strides_ok(x):
            raise ValueError(
                f"{name} kernel reads {label} by strides: it needs the last "
                f"dim contiguous and every other stride and the address "
                f"16-byte aligned, got strides {tuple(x.stride())}")
    B, H, S, _ = first.shape
    return B, H, S


def _launch_strided(lib: str, entry: str, ptrs, views, B: int, S: int,
                    H: int, causal: bool, dtype) -> None:
    """Call the C entry ``entry`` of library ``lib`` with an array of
    pointers and the (batch, head, row) strides of each [B, H, S, dh] view."""
    fn = getattr(cuda_build.load(lib), entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    strides = (ctypes.c_longlong * (3 * len(views)))(
        *(s for x in views for s in x.stride()[:3]))
    device = views[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ptr_array, strides, B, S, H, int(causal),
                 _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    _count_launch(entry)


def _launch_flash_fwd(q, k, v, num_heads, causal):
    _check_packed3(q, k, v, num_heads)
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    B, H, S = _check_views("flash_fwd", {"q": qh, "k": kh, "v": vh})
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, S, H, dtype=torch.float32, device=q.device)
    oh = _heads(o, num_heads)
    _launch_strided("flash3_fwd", "flash_fwd",
                    [x.data_ptr() for x in (qh, kh, vh, oh, lse)],
                    [qh, kh, vh, oh], B, S, H, causal, q.dtype)
    return o, lse


def _launch_flash_bwd(q, k, v, do, lse, num_heads, causal):
    _check_packed3(q, k, v, num_heads)
    views = {n: _heads(x, num_heads) for n, x in
             (("q", q), ("k", k), ("v", v), ("do", do))}
    B, H, S = _check_views("flash_bwd", views)
    if lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (B, S, H) or not lse.is_contiguous():
        raise ValueError(f"flash_bwd: lse must be a contiguous float32 "
                         f"{(B, S, H)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    heads = [*views.values(), *(_heads(x, num_heads) for x in grads)]
    delta = _row_sum_scratch(B, S, H, q.dtype, q.device)
    _launch_strided("flash3_bwd", "flash_bwd",
                    [*(x.data_ptr() for x in (*heads, lse)), _address(delta)],
                    heads,
                    B, S, H, causal, q.dtype)
    return grads


def _launch_mha_fwd(q, k, v, causal):
    B, H, S = _check_views("mha_fwd", {"q": q, "k": k, "v": v})
    o = torch.empty_like(q)      # q's layout, [B, H, S, dh] or [B, S, H, dh]
    _launch_strided("flash3_fwd", "mha_fwd",
                    [x.data_ptr() for x in (q, k, v, o)], [q, k, v, o],
                    B, S, H, causal, q.dtype)
    return o


def _launch_mha_bwd(q, k, v, do, causal):
    B, H, S = _check_views("mha_bwd", {"q": q, "k": k, "v": v, "do": do})
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    if bwd_whole_head(S, q.dtype):
        lse = delta = None        # the kernel forms both in shared memory
    else:                         # row statistics and row sums, scratch
        lse, delta = torch.empty(2, B, S, H, dtype=torch.float32,
                                 device=q.device)
    views = [q, k, v, do, *grads]
    _launch_strided("flash3_bwd", "mha_bwd",
                    [*(x.data_ptr() for x in views), _address(lse),
                     _address(delta)], views, B, S, H, causal, q.dtype)
    return grads


def _dispatch(name: str, x: torch.Tensor, kernel, plain):
    """A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version; no other device has a version."""
    if x.device.type == "cuda":
        return kernel()
    if x.device.type == "cpu":
        return plain()
    raise ValueError(f"{name}: no version for device {x.device}")


def flash3_fwd(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """(o [B, S, D], lse [B, S, H] f32) from packed qkv [B, S, 3D] with q
    prescaled. A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes the plain version."""
    return _dispatch("flash3_fwd", qkv,
                     lambda: _launch_fwd(qkv, num_heads, causal),
                     lambda: flash_mha_packed_qkv_reference(qkv, num_heads,
                                                            causal))


def flash3_bwd(qkv: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
               num_heads: int, causal: bool = False) -> torch.Tensor:
    """Packed cotangent dqkv [B, S, 3D] from qkv, do [B, S, D] (qkv's type)
    and the forward's lse [B, S, H] f32. A CUDA tensor launches the kernel
    (or raises); a CPU tensor takes the plain version."""
    return _dispatch("flash3_bwd", qkv,
                     lambda: _launch_bwd(qkv, do, lse, num_heads, causal),
                     lambda: flash_mha_packed_qkv_bwd_reference(
                         qkv, do, lse, num_heads, causal))


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, causal: bool = False):
    """(o [B, S, D], lse [B, S, H] f32) from q (prescaled), k, v [B, S, D],
    each read by strides. A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes the plain version."""
    return _dispatch("flash_fwd", q,
                     lambda: _launch_flash_fwd(q, k, v, num_heads, causal),
                     lambda: flash_mha_packed_reference(q, k, v, num_heads,
                                                        causal))


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, num_heads: int,
              causal: bool = False):
    """(dq, dk, dv) [B, S, D] in q's type from q, k, v, do (q's type) and the
    forward's lse [B, S, H] f32. A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    return _dispatch("flash_bwd", q,
                     lambda: _launch_flash_bwd(q, k, v, do, lse, num_heads,
                                               causal),
                     lambda: flash_mha_packed_bwd_reference(
                         q, k, v, do, lse, num_heads, causal))


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = False) -> torch.Tensor:
    """Whole-sequence attention o [B, H, S, dh] (in q's memory layout) from
    q, k, v [B, H, S, dh] views, the scores scaled by 1/sqrt(dh). A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes
    ``mha_reference``."""
    return _dispatch("mha_fwd", q, lambda: _launch_mha_fwd(q, k, v, causal),
                     lambda: mha_reference(q, k, v, causal=causal))


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, causal: bool = False):
    """(dq, dk, dv) of ``mha_fwd`` from q, k, v and do [B, H, S, dh], the
    counterpart of JAX's ``_mha_bwd_pallas``: no lse from the forward (the
    kernel recomputes the softmax statistics), p and ds in float32. A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes
    ``mha_bwd_reference``."""
    return _dispatch("mha_bwd", q, lambda: _launch_mha_bwd(q, k, v, do, causal),
                     lambda: mha_bwd_reference(q, k, v, do, causal))


# -- autograd and entry points -------------------------------------------------

def _kernel_cotangent(do: torch.Tensor, dtype) -> torch.Tensor:
    """The incoming gradient in the operands' type, copied only where the
    kernels cannot read it by strides (e.g. the expanded gradient of a
    sum)."""
    do = do.to(dtype)
    return do if do.device.type != "cuda" or _strides_ok(do) \
        else do.contiguous()


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class FlashPackedQKV(torch.autograd.Function):
    """o = flash3_fwd(qkv); the backward is flash3_bwd from the saved qkv and
    lse, returning the single packed cotangent (the JAX custom_vjp's f_bwd)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal):
        o, lse = flash3_fwd(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, lse)
        ctx.num_heads = num_heads
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, lse = ctx.saved_tensors
        dqkv = flash3_bwd(qkv, do.to(qkv.dtype).contiguous(), lse,
                          ctx.num_heads, ctx.causal)
        return dqkv, None, None


class FlashPacked(torch.autograd.Function):
    """o = flash_fwd(qs, k, v); saves (qs, k, v, lse) and the backward is
    flash_bwd with do in qs's type (JAX ops/attention.py:414-436)."""

    @staticmethod
    def forward(ctx, qs, k, v, num_heads, causal):
        o, lse = flash_fwd(qs, k, v, num_heads, causal)
        ctx.save_for_backward(qs, k, v, lse)
        ctx.num_heads = num_heads
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(qs, k, v, _kernel_cotangent(do, qs.dtype), lse,
                               ctx.num_heads, ctx.causal)
        return dq, dk, dv, None, None


class MhaWhole(torch.autograd.Function):
    """o = mha_fwd(q, k, v); saves only (q, k, v), as JAX's _mha_fwd does
    (ops/attention.py:191-192), and the backward is mha_bwd, which takes no
    lse (JAX's _mha_bwd, :195-198)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return mha_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, _kernel_cotangent(do, q.dtype),
                             ctx.causal)
        return dq, dk, dv, None


def flash_mha_packed_qkv(qkv_scaled: torch.Tensor, *, num_heads: int,
                         causal: bool = False) -> torch.Tensor:
    """Fused MHSA core on a single packed [B, S, 3D] qkv tensor (q lanes
    PRESCALED by 1/sqrt(dh)). Returns [B, S, D]; differentiable with
    respect to qkv."""
    if _needs_grad(qkv_scaled):
        return FlashPackedQKV.apply(qkv_scaled, num_heads, causal)
    return flash3_fwd(qkv_scaled, num_heads, causal)[0]


def flash_mha_packed(q_scaled: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Fused MHSA core on packed [B, S, D] tensors, heads as dh-lane slices
    (JAX ops/attention.py:439-453). q_scaled MUST already include the
    1/sqrt(dh) score scale. Returns [B, S, D]; differentiable with respect to
    q_scaled, k and v (no [S, S] residual)."""
    _check_packed3(q_scaled, k, v, num_heads)
    if _needs_grad(q_scaled, k, v):
        return FlashPacked.apply(q_scaled, k, v, num_heads, causal)
    return flash_fwd(q_scaled, k, v, num_heads, causal)[0]


def _mha_whole(q, k, v, causal):
    if _needs_grad(q, k, v):
        return MhaWhole.apply(q, k, v, causal)
    return mha_fwd(q, k, v, causal)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """Scaled-dot-product attention over [B, H, S, dh] tensors (JAX
    ops/attention.py:251-263). Default (use_kernel None or False): the fused
    plain path ``mha_fused``. use_kernel=True: the whole-sequence kernels
    (``mha_fwd`` and, for the gradient, ``mha_bwd``), JAX's use_pallas."""
    if use_kernel:
        return _mha_whole(q, k, v, causal)
    return mha_fused(q, k, v, causal=causal)


def attention_core_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False,
                        use_kernel: bool | None = None) -> torch.Tensor:
    """Attention over [B, S, H, dh] tensors, head-minor (JAX
    ops/attention.py:607-620). use_kernel=True hands the kernels [B, H, S, dh]
    views of the same memory (the JAX path transposes at the boundary; the
    kernels read by stride), and the output keeps q's layout."""
    if use_kernel:
        return _mha_whole(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal).transpose(1, 2)
    return mha_fused_bshd(q, k, v, causal=causal)
