"""Flash attention on one packed [B, S, 3D] qkv tensor, forward and backward.

Counterpart of ``flash_mha_packed_qkv`` in the JAX package's
``ops/attention.py``: lanes [0:D] of the last axis are q PRESCALED by
1/sqrt(dh), [D:2D] k and [2D:3D] v, and heads are dh-lane slices within each
third (exactly the layout one [D, 3D] projection emits). The result is
[B, S, D] with head h at lanes h*dh, plus the per-head row log-sum-exp
[B, S, H] in float32. The backward returns one packed [B, S, 3D] cotangent.

Each direction has two versions:

- a CUDA kernel, ``csrc/flash3_fwd.cu`` and ``csrc/flash3_bwd.cu`` (built by
  ``ops/cuda_build.py``), launched by ``flash3_fwd`` / ``flash3_bwd`` for a
  tensor on the card;
- plain PyTorch, ``flash_mha_packed_qkv_reference`` and
  ``flash_mha_packed_qkv_bwd_reference``, in the order of operations of the
  TPU kernels' per-head math. A wrapper takes it only for a tensor on the
  CPU; on the card it is the kernel's oracle.

``flash_mha_packed_qkv`` is differentiable through ``FlashPackedQKV``, a
``torch.autograd.Function`` whose backward is ``flash3_bwd``. Without a
gradient to record (serving under ``torch.inference_mode``) it calls
``flash3_fwd`` alone.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

NEG_INF = -1e30        # the TPU kernel's mask value (_NEG_INF)
KERNEL_HEAD_DIM = 64   # the head width the CUDA kernels have a template for

# Launches of each kernel wrapper in this module. A wrapper adds one where it
# launches its kernel and nowhere else; the CPU path adds nothing.
LAUNCHES = {"flash3_fwd": 0, "flash3_bwd": 0}
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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*dh] -> [B, H, S, dh] (a view)."""
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> [B, S, H*dh]."""
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _keep_mask(S: int, causal: bool, device) -> torch.Tensor | None:
    if not causal:
        return None
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def flash_mha_packed_qkv_reference(qkv: torch.Tensor, num_heads: int,
                                   causal: bool = False):
    """Plain PyTorch forward: returns (o [B, S, D] in qkv.dtype, lse
    [B, S, H] float32).

    Mirrors the TPU kernel's per-head math (_attn_fwd_head): scores in f32
    from the working-type operands, masked to NEG_INF; row max, exp, row
    sum; p = e * (1/r) rounded to v's type; o = p @ v accumulated in f32;
    lse = m + log r. Products of bf16 values are exact in f32, so upcasting
    the operands reproduces the f32-accumulating bf16 dots."""
    B, S, D = _check_packed(qkv, num_heads)
    q, k, v = (_heads(qkv[..., i * D:(i + 1) * D], num_heads)
               for i in range(3))                            # [B, H, S, dh]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))  # [B, H, S, S]
    keep = _keep_mask(S, causal, qkv.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    r = e.sum(dim=-1, keepdim=True)
    p = (e * (1.0 / r)).to(v.dtype)
    o = _unheads(torch.matmul(p.float(), v.float())).to(qkv.dtype)
    lse = (m + torch.log(r))[..., 0].transpose(1, 2).contiguous()  # [B, S, H]
    return o, lse


def flash_mha_packed_qkv_bwd_reference(qkv: torch.Tensor, do: torch.Tensor,
                                       lse: torch.Tensor, num_heads: int,
                                       causal: bool = False) -> torch.Tensor:
    """Plain PyTorch backward: the packed cotangent dqkv [B, S, 3D] in
    qkv.dtype from qkv, do [B, S, D] and the forward's lse [B, S, H].

    In the order of the TPU kernel's _attn_bwd_head, at the working type:
    s = q k^T in f32, masked to NEG_INF; p = exp(s - lse) replaying the
    forward's statistics; dv = p(working type)^T do; dp = do v^T; c = the
    row sum of p * dp; ds = (p * (dp - c)) in the working type; dq = ds k;
    dk = ds^T q; every product accumulated in f32."""
    B, S, D = _check_packed(qkv, num_heads)
    wt = qkv.dtype
    q, k, v = (_heads(qkv[..., i * D:(i + 1) * D], num_heads).float()
               for i in range(3))                            # [B, H, S, dh]
    g = _heads(do.to(wt), num_heads).float()
    s = torch.matmul(q, k.transpose(-1, -2))                 # [B, H, S, S]
    keep = _keep_mask(S, causal, qkv.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.float().transpose(1, 2)[..., None])
    pb = p.to(wt).float()
    dv = torch.matmul(pb.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    c = torch.sum(dp * p, dim=-1, keepdim=True)
    ds = (p * (dp - c)).to(wt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([_unheads(x).to(wt) for x in (dq, dk, dv)], dim=-1)


def _check_kernel_args(name: str, qkv: torch.Tensor, num_heads: int):
    B, S, D = _check_packed(qkv, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{qkv.dtype}")
    if D // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"{name} kernel has a template for head width "
                         f"{KERNEL_HEAD_DIM} only, got {D // num_heads}")
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
    delta = torch.empty(B, S, num_heads, dtype=torch.float32,
                        device=qkv.device)               # row sums c, scratch
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 dqkv.data_ptr(), delta.data_ptr(), B, S, D, num_heads,
                 int(causal), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash3_bwd launch failed: CUDA error {err}")
    _count_launch("flash3_bwd")
    return dqkv


def flash3_fwd(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """(o [B, S, D], lse [B, S, H] f32) from packed qkv [B, S, 3D] with q
    prescaled. A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes the plain version."""
    if qkv.device.type == "cuda":
        return _launch_fwd(qkv, num_heads, causal)
    if qkv.device.type == "cpu":
        return flash_mha_packed_qkv_reference(qkv, num_heads, causal)
    raise ValueError(f"flash3_fwd: no version for device {qkv.device}")


def flash3_bwd(qkv: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
               num_heads: int, causal: bool = False) -> torch.Tensor:
    """Packed cotangent dqkv [B, S, 3D] from qkv, do [B, S, D] (qkv's type)
    and the forward's lse [B, S, H] f32. A CUDA tensor launches the kernel
    (or raises); a CPU tensor takes the plain version."""
    if qkv.device.type == "cuda":
        return _launch_bwd(qkv, do, lse, num_heads, causal)
    if qkv.device.type == "cpu":
        return flash_mha_packed_qkv_bwd_reference(qkv, do, lse, num_heads,
                                                  causal)
    raise ValueError(f"flash3_bwd: no version for device {qkv.device}")


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


def flash_mha_packed_qkv(qkv_scaled: torch.Tensor, *, num_heads: int,
                         causal: bool = False) -> torch.Tensor:
    """Fused MHSA core on a single packed [B, S, 3D] qkv tensor (q lanes
    PRESCALED by 1/sqrt(dh)). Returns [B, S, D]; differentiable with
    respect to qkv."""
    if torch.is_grad_enabled() and qkv_scaled.requires_grad:
        return FlashPackedQKV.apply(qkv_scaled, num_heads, causal)
    return flash3_fwd(qkv_scaled, num_heads, causal)[0]
