"""Fused weight and bias gradient of a dense layer (counterpart of the JAX
package's ops/fused_dw.py).

``dw_db(x2d, g2d)`` returns dW = x2d^T g2d [Din, Dout] and db = the row sum
of g2d [Dout], both float32, from x2d [N, Din] and g2d [N, Dout] in float32
or bfloat16. dW is never rounded to bfloat16: that is the difference from
the plain backward of a bf16 ``dense``, and why the JAX package's fused path
trains on slightly different numbers.

Two versions:

- a CUDA kernel, ``csrc/dw_db.cu`` (built by ``ops/cuda_build.py``),
  launched for a tensor on the card. Large row counts are split over several
  blocks per output tile for occupancy; each split writes a float32 partial
  and a second pass sums them in split order, so the result is the same
  bits on every launch;
- plain PyTorch, ``dw_db_reference``, taken only for a tensor on the CPU; on
  the card it is the kernel's oracle.

``DenseDwFused`` is the ``torch.autograd.Function`` that ``ops.nn.dense``
uses when a caller asks for ``fused_dw``: the forward is the plain dense,
the input gradient stays one cuBLAS product, and (dW, db) come from
``dw_db``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

# Launches of the kernel wrapper. It adds one where it launches the kernel and
# nowhere else; the CPU path adds nothing.
LAUNCHES = {"dw_db": 0}
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's tiles (csrc/dw_db.cu): dW tile edge and rows per step, by dtype
_TILE = {torch.bfloat16: (128, 32), torch.float32: (64, 16)}
# blocks the row split aims for: two per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 264


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def dw_db_reference(x2d: torch.Tensor, g2d: torch.Tensor):
    """Plain PyTorch: (x2d^T g2d, row sum of g2d), both float32."""
    return x2d.float().t() @ g2d.float(), g2d.float().sum(0)


def row_splits(N: int, Din: int, Dout: int, dtype: torch.dtype) -> int:
    """How many blocks share the rows of each dW tile: enough for about two
    blocks per SM, never more than the row steps there are."""
    tile, step = _TILE[dtype]
    tiles = -(-Din // tile) * -(-Dout // tile)
    steps = -(-N // step)
    return max(1, min(-(-_TARGET_BLOCKS // tiles), steps))


def _check(x2d: torch.Tensor, g2d: torch.Tensor):
    if x2d.ndim != 2 or g2d.ndim != 2 or x2d.shape[0] != g2d.shape[0]:
        raise ValueError(f"dw_db: expected x2d [N, Din] and g2d [N, Dout], got "
                         f"{tuple(x2d.shape)} and {tuple(g2d.shape)}")
    if x2d.dtype != g2d.dtype:
        raise TypeError(f"dw_db: x2d and g2d must share a dtype, got "
                        f"{x2d.dtype} and {g2d.dtype}")


def _launch(x2d: torch.Tensor, g2d: torch.Tensor):
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"dw_db kernel takes float32 or bfloat16, got "
                        f"{x2d.dtype}")
    if g2d.device != x2d.device:
        raise ValueError(f"dw_db: x2d on {x2d.device}, g2d on {g2d.device}")
    if not (x2d.is_contiguous() and g2d.is_contiguous()):
        raise ValueError("dw_db kernel needs contiguous x2d and g2d")
    (N, Din), Dout = x2d.shape, g2d.shape[1]
    fn = cuda_build.load("dw_db").dw_db
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = row_splits(N, Din, Dout, x2d.dtype)
    # `parts` may be freed when this returns: the caching allocator hands its
    # memory only to work queued after the kernel on the same stream
    out = torch.empty(Din * Dout + Dout, dtype=torch.float32,
                      device=x2d.device)
    parts = (torch.empty(splits, Din * Dout + Dout, dtype=torch.float32,
                         device=x2d.device) if splits > 1 else None)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), g2d.data_ptr(), out.data_ptr(),
                 None if parts is None else parts.data_ptr(), N, Din, Dout,
                 splits, _DTYPE_CODES[x2d.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dw_db launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES["dw_db"] += 1
    return out[:Din * Dout].view(Din, Dout), out[Din * Dout:]


def dw_db(x2d: torch.Tensor, g2d: torch.Tensor):
    """(dW [Din, Dout], db [Dout]), float32, from x2d [N, Din] and g2d
    [N, Dout]. A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes the plain version."""
    _check(x2d, g2d)
    if x2d.device.type == "cuda":
        return _launch(x2d, g2d)
    if x2d.device.type == "cpu":
        return dw_db_reference(x2d, g2d)
    raise ValueError(f"dw_db: no version for device {x2d.device}")


class DenseDwFused(torch.autograd.Function):
    """y = x @ w + b (w [in, out]) as ``ops.nn.dense`` computes it; the
    backward takes dx = g w^T from cuBLAS and (dW, db) from ``dw_db``, cast
    to the parameters' dtypes (the JAX custom_vjp's _fwd/_bwd)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return torch.nn.functional.linear(x, w.t().to(x.dtype), b.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.t().to(g.dtype)
        dw, db = dw_db(x.reshape(-1, x.shape[-1]).contiguous(),
                       g.reshape(-1, g.shape[-1]).contiguous())
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype)


def dense_dw_fused(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with (dW, db) produced by one ``dw_db`` in the backward."""
    return DenseDwFused.apply(x, w, b)
