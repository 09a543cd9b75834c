"""Flash attention forward on one packed [B, S, 3D] qkv tensor.

Counterpart of ``flash_mha_packed_qkv`` in the JAX package's
``ops/attention.py``: lanes [0:D] of the last axis are q PRESCALED by
1/sqrt(dh), [D:2D] k and [2D:3D] v, and heads are dh-lane slices within each
third (exactly the layout one [D, 3D] projection emits). The result is
[B, S, D] with head h at lanes h*dh, plus the per-head row log-sum-exp
[B, S, H] in float32.

Two versions compute it:

- the CUDA kernel in ``csrc/flash3_fwd.cu`` (built by ``ops/cuda_build.py``),
  launched by ``flash3_fwd`` for a tensor on the card;
- ``flash_mha_packed_qkv_reference``, plain PyTorch in the order of
  operations of the TPU kernel's per-head math. ``flash3_fwd`` takes it only
  for a tensor on the CPU; on the card it is the kernel's oracle.

Only the forward exists here: serving runs under ``torch.inference_mode``.
The backward kernel comes with the training path.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

NEG_INF = -1e30        # the TPU kernel's mask value (_NEG_INF)
KERNEL_HEAD_DIM = 64   # the head width csrc/flash3_fwd.cu has a template for

# Launches of each kernel wrapper in this module. A wrapper adds one where it
# launches its kernel and nowhere else; the CPU path adds nothing.
LAUNCHES = {"flash3_fwd": 0}
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


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


def flash_mha_packed_qkv_reference(qkv: torch.Tensor, num_heads: int,
                                   causal: bool = False):
    """Plain PyTorch version: returns (o [B, S, D] in qkv.dtype, lse [B, S, H]
    float32).

    Mirrors the TPU kernel's per-head math (_attn_fwd_head): scores in f32
    from the working-type operands, masked to NEG_INF; row max, exp, row
    sum; p = e * (1/r) rounded to v's type; o = p @ v accumulated in f32;
    lse = m + log r. Products of bf16 values are exact in f32, so upcasting
    the operands reproduces the f32-accumulating bf16 dots."""
    B, S, D = _check_packed(qkv, num_heads)
    dh = D // num_heads
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, S, num_heads, dh)
               .transpose(1, 2) for i in range(3))           # [B, H, S, dh]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))  # [B, H, S, S]
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=qkv.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    r = e.sum(dim=-1, keepdim=True)
    p = (e * (1.0 / r)).to(v.dtype)
    o = torch.matmul(p.float(), v.float())
    o = o.transpose(1, 2).reshape(B, S, D).to(qkv.dtype)
    lse = (m + torch.log(r))[..., 0].transpose(1, 2).contiguous()  # [B, S, H]
    return o, lse


def _launch_kernel(qkv: torch.Tensor, num_heads: int, causal: bool):
    B, S, D = _check_packed(qkv, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash3_fwd kernel takes float32 or bfloat16, got "
                        f"{qkv.dtype}")
    if D // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"flash3_fwd kernel has a template for head width "
                         f"{KERNEL_HEAD_DIM} only, got {D // num_heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash3_fwd kernel needs a contiguous, 16-byte "
                         "aligned qkv")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("flash3_fwd has no backward kernel yet: call it "
                           "under torch.inference_mode() or no_grad()")
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
    with _launch_lock:
        LAUNCHES["flash3_fwd"] += 1
    return o, lse


def flash3_fwd(qkv: torch.Tensor, num_heads: int, causal: bool = False):
    """(o [B, S, D], lse [B, S, H] f32) from packed qkv [B, S, 3D] with q
    prescaled. A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes the plain version."""
    if qkv.device.type == "cuda":
        return _launch_kernel(qkv, num_heads, causal)
    if qkv.device.type == "cpu":
        return flash_mha_packed_qkv_reference(qkv, num_heads, causal)
    raise ValueError(f"flash3_fwd: no version for device {qkv.device}")


def flash_mha_packed_qkv(qkv_scaled: torch.Tensor, *, num_heads: int,
                         causal: bool = False) -> torch.Tensor:
    """Fused MHSA core on a single packed [B, S, 3D] qkv tensor (q lanes
    PRESCALED by 1/sqrt(dh)). Returns [B, S, D]."""
    return flash3_fwd(qkv_scaled, num_heads, causal)[0]
