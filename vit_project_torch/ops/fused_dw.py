"""Fused weight and bias gradient of a dense layer (counterpart of the JAX
package's ops/fused_dw.py).

``dw_db(x2d, g2d)`` returns dW = x2d^T g2d [Din, Dout] and db = the row sum
of g2d [Dout], both float32, from x2d [N, Din] and g2d [N, Dout] in float32
or bfloat16. dW is never rounded to bfloat16: that is the difference from
the plain backward of a bf16 ``dense``, and why the JAX package's fused path
trains on slightly different numbers.

Two versions:

- a CUDA kernel, ``csrc/dw_db.cu`` (built by ``ops/cuda_build.py``),
  launched for a tensor on the card. ``route`` picks its route from dtype,
  shape and alignment ("tma": wgmma on TMA-loaded tiles, every bf16 shape
  whose Din and Dout are multiples of 8 on 16-byte aligned bases; "mma":
  mma.sync for the other bf16 shapes; "fma": exact float32 FMAs).
  ``schedule`` cuts each dW tile's rows into equal splits; a persistent
  grid takes the (split, tile) items in split-major order, each writes a
  float32 partial, and a fix-up pass sums each tile's partials in split
  order, so the result is the same bits on every launch;
- plain PyTorch, ``dw_db_reference``, taken only for a tensor on the CPU; on
  the card it is the kernel's oracle.

``DenseDwFused`` is the ``torch.autograd.Function`` that ``ops.nn.dense``
uses when a caller asks for ``fused_dw``: the forward is the plain dense,
the input gradient stays one cuBLAS product, and (dW, db) come from
``dw_db``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from . import cuda_build

# Launches of the kernel wrapper. It adds one where it launches the kernel and
# nowhere else; the CPU path adds nothing.
LAUNCHES = {"dw_db": 0}
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Route:
    """One route of the kernel (csrc/dw_db.cu ``kTile``): its code, dW tile
    rows (Din) and columns (Dout), input rows per step, blocks of the
    persistent grid, and the cost of one work item in steps (its start, the
    partial it writes and the fix-up's read of it), which weighs splits
    against waves; the TMA route's is fitted to the times of forced split
    counts at the ViT-B/16 shapes on an H100
    (``tools/compare_dwdb_builds.py --splits``)."""
    code: int
    bm: int
    bn: int
    bk: int
    blocks: int
    item_cost: int


ROUTES = {
    "fma": Route(code=0, bm=128, bn=128, bk=16, blocks=264, item_cost=2),
    "mma": Route(code=1, bm=128, bn=128, bk=32, blocks=264, item_cost=4),
    "tma": Route(code=2, bm=128, bn=256, bk=64, blocks=132, item_cost=25),
}


def route(x2d: torch.Tensor, g2d: torch.Tensor) -> str:
    """The kernel's route for x2d [N, Din] and g2d [N, Dout]. TMA needs
    16-byte aligned bases and row strides (Din, Dout multiples of 8 in bf16);
    bf16 inputs that fail take mma.sync. A route by shape, not a fallback:
    either raises if it fails."""
    if x2d.dtype == torch.float32:
        return "fma"
    if (x2d.shape[1] % 8 == 0 and g2d.shape[1] % 8 == 0
            and x2d.data_ptr() % 16 == 0 and g2d.data_ptr() % 16 == 0):
        return "tma"
    return "mma"


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How one launch cuts the work: tiles_m x tiles_n dW tiles, `steps` row
    steps of `route`'s bk rows, each tile's steps cut into `splits` ranges of
    `steps_per_split` (the last may be shorter, none empty). Item i is
    (split i // tiles, tile i % tiles), tile t = (t // tiles_n, t % tiles_n);
    block b of the persistent grid takes items b, b + blocks, ... Each item
    writes a dW partial of its tile and a db partial of the rows
    ``db_rows(tile_m)`` of its steps."""
    route: str
    tiles_m: int
    tiles_n: int
    steps: int
    splits: int
    steps_per_split: int

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def items(self) -> int:
        return self.tiles * self.splits

    @property
    def blocks(self) -> int:
        return min(ROUTES[self.route].blocks, self.items)

    @property
    def slot_floats(self) -> int:
        r = ROUTES[self.route]
        return r.bm * r.bn + r.bn

    def item(self, i: int):
        """(tile_m, tile_n, split, first row step, end row step) of item i."""
        split, tile = divmod(i, self.tiles)
        s0 = split * self.steps_per_split
        return (tile // self.tiles_n, tile % self.tiles_n, split, s0,
                min(s0 + self.steps_per_split, self.steps))

    def block_items(self, b: int) -> range:
        return range(b, self.items, self.blocks)

    def fixup_order(self, tile: int) -> list[int]:
        """The items whose dW partials the fix-up sums for `tile`, in order."""
        return [j * self.tiles + tile for j in range(self.splits)]

    def db_rows(self, tile_m: int) -> tuple[int, int]:
        """The rows [lo, hi) of every step whose g values the items of Din
        tile `tile_m` add to their db partial (csrc/dw_db.cu ``db_row``): the
        items of one Dout tile load the same g tiles, so they share its sum."""
        bk = ROUTES[self.route].bk
        return bk * tile_m // self.tiles_m, bk * (tile_m + 1) // self.tiles_m

    def db_order(self, tile_n: int) -> list[int]:
        """The items whose db partials the fix-up sums for Dout tile
        `tile_n`, in order: split-major, then Din tile."""
        return [j * self.tiles + tm * self.tiles_n + tile_n
                for j in range(self.splits) for tm in range(self.tiles_m)]


@functools.lru_cache(maxsize=256)
def schedule(N: int, Din: int, Dout: int, route_name: str) -> Schedule:
    """The cuts of one launch, from the shape and the route alone (so the
    bits are fixed): the number of splits that minimises waves of items times
    (steps per item + the item's fixed cost), the fewest splits on a tie."""
    r = ROUTES[route_name]
    tiles_m, tiles_n = -(-Din // r.bm), -(-Dout // r.bn)
    steps = -(-N // r.bk)
    best = None
    for want in range(1, steps + 1):
        per = -(-steps // want)
        splits = -(-steps // per)          # no empty split
        waves = -(-(tiles_m * tiles_n * splits) // r.blocks)
        cost = waves * (per + r.item_cost)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return Schedule(route_name, tiles_m, tiles_n, steps, best[1], best[2])


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def dw_db_reference(x2d: torch.Tensor, g2d: torch.Tensor):
    """Plain PyTorch: (x2d^T g2d, row sum of g2d), both float32."""
    return x2d.float().t() @ g2d.float(), g2d.float().sum(0)


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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    name = route(x2d, g2d)
    sched = schedule(N, Din, Dout, name)
    # `parts` may be freed when this returns: the caching allocator hands its
    # memory only to work queued after the kernel on the same stream
    out = torch.empty(Din * Dout + Dout, dtype=torch.float32,
                      device=x2d.device)
    parts = torch.empty(sched.items * sched.slot_floats, dtype=torch.float32,
                        device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), g2d.data_ptr(), out.data_ptr(),
                 parts.data_ptr(), parts.numel(), N, Din, Dout,
                 _DTYPE_CODES[x2d.dtype], ROUTES[name].code, sched.splits,
                 stream)
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
