"""Multi-process runtime (counterpart of the JAX package's parallel/dist.py).

One process per card, launched by ``torchrun``: the reference's env-var
rendezvous and NCCL process group (setup_distributed, train_vit_sgd.py:13-27),
where JAX has one process driving a mesh. ``setup_distributed`` reads
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) and joins the default process group. The
backend follows the device: NCCL on a card, gloo on the CPU (the tests).
There is no backend flag (JAX has none), and no fallback: a failed NCCL
init raises, it never retries with gloo or on the CPU.

Every collective here runs on the default group, or on the subgroup a
caller passes (``group``: a tensor-parallel run's data or model group,
from its DeviceMesh, ``parallel/mesh.make_mesh``), on tensors on the
backend's device (the card for NCCL, the CPU for gloo; gloo's all-reduce
also takes a card's tensors, through the host).

Sequence parallelism's two token collectives over a model group
(``parallel/mesh.SeqShard``): ``GatherSeq``, the all-gather of the ranks'
token shards along S, and ``ring_shift`` / ``RingHop``, the hop of ring
attention (each rank sends to the next rank of the group and receives from
the one before). Under gloo a card's tensors go through host buffers for
both (the arithmetic stays on the card); NCCL takes them where they are.

The pipeline's stage hop over a stage group (``parallel/pipeline.py``):
``stage_send`` / ``stage_recv``, one microbatch's activations (or, going
back, their gradient) from one stage rank to its neighbour, behind a tag
the receiver checks, and ``broadcast_from``, the last stage's pooled
features to the group. Through the host under gloo as well.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as tdist


def launched() -> bool:
    """torchrun (or a launcher like it) named this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def setup_distributed(device="cuda") -> tuple[int, int]:
    """Join the default process group when torchrun launched this process;
    returns (rank, world_size).

    - No rendezvous environment: initializes nothing and returns (0, 1).
    - A group that already exists is left alone (the counterpart of JAX
      absorbing "should only be called once"): a caller may have built it
      with its own backend.
    - Otherwise ``device`` picks the backend: "cuda" (or "cuda:N") sets the
      current card (``LOCAL_RANK`` unless the device names one) before the
      NCCL init; "cpu" takes gloo. A rendezvous failure re-raises: a
      swallowed one would turn N ranks into N independent rank-0 runs
      writing the same files.
    """
    if is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    if not launched():
        return 0, 1
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: a CUDA run under "
                               "torchrun needs one card per rank (pass "
                               "--device cpu for gloo on the CPU)")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", "0")))
        tdist.init_process_group(
            backend="nccl",
            device_id=torch.device("cuda", torch.cuda.current_device()))
    elif dev.type == "cpu":
        tdist.init_process_group(backend="gloo")
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    return tdist.get_rank(), tdist.get_world_size()


@contextlib.contextmanager
def process_group(device="cuda"):
    """``setup_distributed(device)`` around a CLI's work; the group it
    created (none when there was one already, or no torchrun) is destroyed
    on the way out. Yields (rank, world_size)."""
    owned = not is_initialized() and launched()
    ranks = setup_distributed(device)
    try:
        yield ranks
    finally:
        if owned and is_initialized():
            tdist.destroy_process_group()


def local_device(device="cuda") -> torch.device:
    """`device` with the card torchrun gave this rank: "cuda" becomes
    cuda:LOCAL_RANK (cuda:0 without torchrun); anything else is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def is_primary() -> bool:
    """Rank-0 gating of checkpoint, CSV and log writes (the reference's
    local_rank == 0). Before (or without) the process group it answers from
    ``RANK`` and initializes nothing, so a dispatcher that never joins a
    group can ask it."""
    if is_initialized():
        return tdist.get_rank() == 0
    return os.environ.get("RANK", "0") in ("", "0")


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under NCCL, the CPU otherwise."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """All ranks meet here (reference dist.barrier, train_vit_sgd.py:279);
    nothing without a group."""
    if is_initialized() and tdist.get_world_size() > 1:
        tdist.barrier()


def all_gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """[P, *local.shape]: every rank's `local` (equal shapes) of `group`, in
    its rank order, on `local`'s device."""
    world = tdist.get_world_size(group)
    out = torch.empty(world * local.numel(), dtype=local.dtype,
                      device=local.device)
    # the concatenated form (gloo takes no stacked output)
    tdist.all_gather_into_tensor(out, local.contiguous().reshape(-1),
                                 group=group)
    return out.view((world,) + tuple(local.shape))


_HOST_MESHES: dict = {}


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on its device (``t.full_tensor()``). Under
    gloo a card's shards go through host copies, on a CPU mesh of the same
    ranks: DTensor's own gather of CUDA tensors over gloo (a functional
    collective) crashed 4 gloo ranks sharing an H100 with SIGSEGV. A
    collective over the DTensor's mesh."""
    if not (t.is_cuda and tdist.get_backend(t.device_mesh.get_group(0))
            == "gloo"):
        return t.full_tensor()
    return _full_on_host(t).to(t.device)


def _full_on_host(t: torch.Tensor) -> torch.Tensor:
    """``full_tensor`` of a DTensor's host copy, on the CPU."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh = t.device_mesh
    host = _HOST_MESHES.get(id(mesh))
    if host is None:
        host = _HOST_MESHES[id(mesh)] = (mesh, DeviceMesh(
            "cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names))
    on_host = DTensor.from_local(t.to_local().detach().cpu(), host[1],
                                 t.placements, run_check=False,
                                 shape=t.shape, stride=t.stride())
    return on_host.full_tensor()


def ordered_allgather_strided(local, n_total: int, group=None):
    """Gather the ranks' rows back into DATASET order.

    Rank p of `group` holds the rows of a strided shard: dataset indices
    p, p+P, p+2P, ... (the loaders' num_shards contract, wrap-padded so
    every rank holds the same count). The shards are gathered and
    interleaved so row i of the result is dataset item i, then the wrap
    padding is trimmed to `n_total` rows.

    This fixes the reference's RSA gather (SURVEY.md section 0): its
    all_gather concatenates the shards in rank order and takes [:48], so
    under an interleaving DistributedSampler the rows do not follow the
    reference RDM's image order (measure...effect.py:327-334).

    `local` is a tensor (the result is a tensor on its device) or an array
    (the result is a numpy array); one process returns it trimmed."""
    if not is_initialized():
        return local[:n_total]
    as_numpy = not isinstance(local, torch.Tensor)
    t = torch.as_tensor(np.asarray(local)) if as_numpy else local
    stacked = all_gather_rows(t.to(collective_device()), group)
    out = stacked.transpose(0, 1).reshape((-1,) + tuple(t.shape[1:]))
    out = out[:n_total].to(t.device)
    return out.numpy() if as_numpy else out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` summed over the ranks of `group`, in place; unchanged without a
    process group."""
    if is_initialized():
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    return t


@torch.no_grad()
def check_replicas_equal(tensors: list, what: str, group=None) -> None:
    """Raise unless every rank of `group` holds its first rank's `tensors`
    bit for bit (the ranks build them from one seed or load one
    checkpoint; replicated updates keep them equal). The tensors may lie
    on several devices (a restored AdamW keeps its step count on the CPU
    beside moments on the card); each is compared where the collectives
    run. Nothing in one process."""
    if not is_initialized() or tdist.get_world_size(group) == 1:
        return
    dev = collective_device()
    src = 0 if group is None else tdist.get_global_rank(group, 0)
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32)
                      for t in tensors])
    size = torch.tensor([flat.numel()], device=dev)
    tdist.broadcast(size, src=src, group=group)
    same = int(size) == flat.numel()
    if same:
        ref = flat.clone()
        tdist.broadcast(ref, src=src, group=group)
        same = torch.equal(ref, flat)
    if not same:
        raise RuntimeError(f"rank {rank()} starts from other {what} than "
                           f"rank {src}")


class CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the gradient
    over `group` (each rank's part of the layer after it contributed one
    part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the forward sums the ranks' partial results over
    `group`; the backward is the identity (every rank's part gets the
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _via_host(t: torch.Tensor, group) -> bool:
    """gloo moves a card's tensor through a host copy of it."""
    return t.is_cuda and tdist.get_backend(group) == "gloo"


class GatherSeq(torch.autograd.Function):
    """The whole sequence from the model group's token shards: x [B, s_t,
    ...], this rank's tokens ``seq.bounds(S)``, -> [B, S, ...] on every
    rank. The ragged shards pad to ``seq.shard_len(S)`` for one all-gather,
    and the padding is trimmed. Each rank's consumer of the whole sequence
    reads it for its own part of the work, so the backward sums the
    gradient of the whole sequence over the group (an all-reduce: gloo has
    no reduce-scatter) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, seq, S):
        ctx.seq, ctx.S = seq, S
        per = seq.shard_len(S)
        if x.shape[1] != per:
            pad = x.new_zeros((x.shape[0], per - x.shape[1], *x.shape[2:]))
            x = torch.cat([x, pad], dim=1)
        host = _via_host(x, seq.group)
        rows = all_gather_rows(x.cpu() if host else x, seq.group)
        out = rows.movedim(0, 1).reshape(x.shape[0], seq.n * per,
                                         *x.shape[2:])[:, :S]
        return out.to(x.device) if host else out.contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        tdist.all_reduce(g, group=ctx.seq.group)
        lo, hi = ctx.seq.bounds(ctx.S)
        return g[:, lo:hi], None, None


def ring_shift(tensors: list, seq, step: int = 1) -> list:
    """Ring attention's hop: `tensors` sent to model rank index + `step` of
    the group, and the same shapes received from index - `step`, as one
    byte buffer a hop (one send and one receive, whatever the dtypes)."""
    to = tdist.get_global_rank(seq.group, (seq.index + step) % seq.n)
    frm = tdist.get_global_rank(seq.group, (seq.index - step) % seq.n)
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(parts)
    host = _via_host(buf, seq.group)
    send = buf.cpu() if host else buf
    recv = torch.empty_like(send)
    for w in tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, send, to, seq.group),
            tdist.P2POp(tdist.irecv, recv, frm, seq.group)]):
        w.wait()
    recv = recv.to(buf.device)
    out, off = [], 0
    for t, p in zip(tensors, parts):
        part = recv[off:off + p.numel()]
        if off % t.element_size():      # a view needs an aligned start
            part = part.clone()
        off += p.numel()
        out.append(part.view(t.dtype).view(t.shape))
    return out


class RingHop(torch.autograd.Function):
    """``ring_shift`` of one tensor one step on, differentiable: the
    backward sends the gradient one step back."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return ring_shift([x], seq)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_shift([g], ctx.seq, step=-1)[0], None


_TAG_BYTES = 8


def stage_send(t: torch.Tensor, group, to: int, tag: int):
    """The stage hop's sending side: `t` to index `to` of `group`, behind
    an int64 `tag` that ``stage_recv`` checks (a hop out of the schedule's
    order fails loudly there instead of handing over the wrong tensor).
    Posted, not awaited: returns the work and its buffer, which must live
    until ``wait_sends``."""
    payload = t.detach().contiguous().reshape(-1).view(torch.uint8)
    head = torch.tensor([tag], dtype=torch.int64).view(torch.uint8)
    buf = torch.cat([head.to(payload.device), payload])
    if _via_host(buf, group):
        buf = buf.cpu()
    return tdist.isend(buf, tdist.get_global_rank(group, to), group), buf


def wait_sends(pending: list) -> None:
    """Wait for every ``stage_send`` in `pending`, and empty it."""
    for work, _ in pending:
        work.wait()
    pending.clear()


def stage_recv(shape, dtype, device, group, frm: int,
               tag: int) -> torch.Tensor:
    """The stage hop's receiving side: a tensor of `shape` and `dtype` from
    index `frm` of `group`, on `device`; raises unless it came with
    `tag`."""
    device = torch.device(device)
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    host = device.type == "cuda" and tdist.get_backend(group) == "gloo"
    buf = torch.empty(_TAG_BYTES + n, dtype=torch.uint8,
                      device="cpu" if host else device)
    tdist.recv(buf, tdist.get_global_rank(group, frm), group)
    got = int(buf[:_TAG_BYTES].view(torch.int64).item())
    if got != tag:
        raise RuntimeError(f"stage hop from index {frm}: tag {got} arrived "
                           f"where the schedule expects {tag}")
    return buf[_TAG_BYTES:].view(dtype).view(tuple(shape)).to(device)


def broadcast_from(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of index `src` of `group` on every rank of it, in place (the
    others' `t` is overwritten); through the host under gloo."""
    host = _via_host(t, group)
    buf = t.cpu() if host else t
    tdist.broadcast(buf, tdist.get_global_rank(group, src), group)
    if host:
        t.copy_(buf)
    return t


def primary_values(values: list) -> list:
    """Rank 0's `values` (floats) on every rank: a decision that steers
    collectives then reads the same numbers everywhere, even where the
    ranks computed them apart. Unchanged without a group."""
    if world_size() == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=collective_device())
    tdist.broadcast(t, src=0)
    return t.tolist()
