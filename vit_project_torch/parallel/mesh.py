"""The device mesh and the sharding rules (counterpart of the parts of the
JAX package's parallel/mesh.py that data, tensor, expert and sequence
parallelism use).

JAX drives a mesh from one process and places arrays on it; the port runs
one process per card, and each rank holds its own share. So:

- ``make_mesh(n_data)`` is a 1-D ``("data",)`` DeviceMesh over the ranks
  of the default group (FSDP2 takes it); ``make_mesh(n_model=T)`` is JAX's
  2-D ``("data", "model")`` mesh of shape (W/T, T) over W ranks,
  row-major, so each model group is T consecutive ranks;
  ``make_mesh(n_expert=ep)`` is ("data", "expert") the same way.
  ``n_stage`` (the pipeline) raises: it comes with a later slice of the
  port.
- ``seq_sharding(mesh)`` is JAX's sequence-parallel layout as the port
  holds it: the model group, its size n and this rank's index
  (``SeqShard``), whose ``bounds(S)`` give the rank's tokens. The split is
  GSPMD's ragged one, ceil(S / n) tokens a rank with the last shard short
  (ViT-B/16's 197 tokens are 99 + 98 over 2 ranks).
- ``shard_batch`` and ``replicate`` have no counterpart: each rank's loader
  reads its own strided shard of the global batch (``num_shards`` = the
  data axis, ``shard_id`` = the rank's place on it), and parameters are
  replicated by construction (every rank builds them from the same seed,
  and the trainer checks that they agree).
- ``head_sharding`` and ``batch_head_sharding`` have no counterpart either:
  they are GSPMD pins that keep XLA from re-laying out the attention
  activations, and the port's tensor-parallel layout is explicit (each
  rank computes on its own heads, ``models/vit.classifier_block_tp``).
- ``shard_vit_params_tp`` / ``unshard_vit_params_tp`` are JAX's
  Megatron placement on the port's flat state: a model rank holds whole
  heads of q, k and v (the head-aligned layout), fc1's output rows and
  the input columns of the attention output and fc2.
- ``shard_vit_params_ep`` / ``unshard_vit_params_ep`` are JAX's expert
  placement on the flat state: an expert rank holds its E / ep experts of
  each MoE block's stacked expert leaves (sliced on E); the router and
  every dense leaf stay whole.
- ``zero1_sharding`` and ``fsdp_sharding`` keep JAX's placement rules as
  predicates on one tensor: shard its leading axis over the ranks when the
  world size divides it. The ZeRO-1 momentum (``train/vit_loop.py``)
  follows ``zero1_sharding``. FSDP2's ``fully_shard`` shards every
  parameter on dim 0 and pads the last shard where the world size does not
  divide it, 1-D leaves included: that moves bytes, not numbers, because
  every parameter is gathered whole before it is used and the update is
  elementwise. The torch layout is [out, in] where JAX's is [in, out], so
  "leading axis" names the other dimension of a matrix; the same remark
  holds.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from . import dist

def make_mesh(n_data: int | None = None, n_model: int = 1, n_stage: int = 1,
              n_expert: int = 1, device_type: str | None = None):
    """A DeviceMesh over the default group's ranks (one device per rank):
    ("data",) over all of them, or with `n_model` (`n_expert`) > 1
    ("data", "model") (("data", "expert")) of shape (W / n, n). `n_data`,
    when given, must be the data axis that leaves. `device_type` defaults
    to where the default group's collectives run."""
    from torch.distributed.device_mesh import init_device_mesh
    if n_stage > 1:
        raise NotImplementedError(
            f"make_mesh(n_stage={n_stage}): the pipeline (port slice 9, "
            f"item 13) is not ported to vit_project_torch yet; the port's "
            f"mesh is ('data',), ('data', 'model') or ('data', 'expert')")
    extra = [(a, n) for a, n in (("model", n_model), ("expert", n_expert))
             if n > 1]
    if len(extra) > 1:
        raise ValueError("at most one of n_model/n_stage/n_expert may be > 1 "
                         f"(got {[a for a, _ in extra]})")
    axis, n = extra[0] if extra else ("model", 1)
    world = dist.world_size()
    if world % n != 0:
        raise ValueError(f"{axis} axis ({n}) must divide the device "
                         f"count ({world})")
    if n_data is not None and n_data * n != world:
        raise ValueError(f"n_data ({n_data}) x n_{axis} ({n}) must equal "
                         f"the number of ranks ({world}): one device per rank")
    if device_type is None:
        device_type = dist.collective_device().type
    if n == 1:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=("data",))
    return init_device_mesh(device_type, (world // n, n),
                            mesh_dim_names=("data", axis))


@dataclass(frozen=True)
class SeqShard:
    """A model group's sequence layout: the process group `group`, its
    size `n` and this rank's `index` in it. Rank t holds tokens
    ``bounds(S)`` of a sequence of S, ceil(S / n) of them (the last rank's
    shard short, or empty), so every shard pads to ``shard_len(S)``."""
    group: object
    n: int
    index: int

    def shard_len(self, S: int) -> int:
        return -(-S // self.n)

    def bounds(self, S: int) -> tuple[int, int]:
        per = self.shard_len(S)
        lo = min(self.index * per, S)
        return lo, min(lo + per, S)


def seq_sharding(mesh) -> SeqShard:
    """Sequence parallelism's layout on a ("data", "model") mesh: tokens
    over the "model" axis (Megatron-SP rides the tensor-parallel axis),
    batch over "data" (each model group reads one data shard)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        raise ValueError("sequence parallelism needs a ('data','model') mesh "
                         f"(make_mesh(n_model=...)); got {names}")
    return SeqShard(mesh.get_group("model"), mesh.size(names.index("model")),
                    mesh.get_local_rank("model"))


# the tensor-parallel block leaves: name within a block -> (axis, parts).
# A leaf is split on `axis` into `parts` equal parts (q, k, v for the
# packed projection), and model rank t holds the t-th of n_model slices of
# each part, the parts in order: [q_t | k_t | v_t] for qkv, which is the
# packed [B, S, 3D/T] layout the attention kernel takes. The torch layout
# is [out, in]: fc1 and qkv split their output rows, the attention output
# projection and fc2 their input columns. Their biases, the LayerNorms,
# the embeddings and the head stay whole.
TP_LEAVES = {"attn.qkv.weight": (0, 3), "attn.qkv.bias": (0, 3),
             "attn.proj.weight": (1, 1),
             "mlp.fc1.weight": (0, 1), "mlp.fc1.bias": (0, 1),
             "mlp.fc2.weight": (1, 1)}
_BLOCK_LEAF = re.compile(r"blocks\.\d+\.(.+)")


def tp_layout(name: str) -> tuple[int, int] | None:
    """(axis, parts) of a tensor-parallel leaf of the classifier, None for a
    leaf every rank holds whole."""
    m = _BLOCK_LEAF.fullmatch(name)
    return TP_LEAVES.get(m.group(1)) if m else None


def shard_vit_params_tp(state: dict, n_model: int, index: int,
                        heads: int | None = None) -> dict:
    """Model rank `index`'s share of the classifier's flat state {name:
    tensor} (parameters or momentum) over `n_model` ranks: each
    tensor-parallel leaf's slices (``TP_LEAVES``), in new memory; every
    other leaf as it is (the same tensor). Pass `heads` to check that the
    model axis divides them (whole heads on each rank)."""
    if heads is not None and heads % n_model != 0:
        raise ValueError(f"model axis ({n_model}) must divide heads ({heads}) "
                         "for head-aligned qkv sharding")
    out = {}
    for name, x in state.items():
        layout = tp_layout(name)
        if layout is None:
            out[name] = x
            continue
        axis, parts = layout
        y = x.movedim(axis, 0)
        y = y.reshape(parts, n_model, -1, *y.shape[1:])[:, index]
        out[name] = y.reshape(-1, *y.shape[2:]).movedim(0, axis).clone(
            memory_format=torch.contiguous_format)
    return out


def unshard_vit_params_tp(shards: list) -> dict:
    """The flat state from every model rank's share (`shards[t]` is
    ``shard_vit_params_tp(state, len(shards), t)``): the inverse, bit for
    bit. The whole leaves are taken from rank 0's share."""
    n_model = len(shards)
    out = {}
    for name, x in shards[0].items():
        layout = tp_layout(name)
        if layout is None:
            out[name] = x
            continue
        axis, parts = layout
        y = torch.stack([s[name].movedim(axis, 0) for s in shards])
        y = y.reshape(n_model, parts, -1, *y.shape[2:]).transpose(0, 1)
        out[name] = y.reshape(-1, *y.shape[3:]).movedim(0, axis).contiguous()
    return out


# the expert-parallel leaves: a MoE block's stacked expert FFN tensors
_EXPERT_LEAF = re.compile(r"blocks\.\d+\.moe\.(fc1_w|fc1_b|fc2_w|fc2_b)")


def ep_layout(name: str) -> bool:
    """True for an expert leaf of the classifier (sliced on its leading
    expert axis under expert parallelism), False for a leaf every rank
    holds whole (the routers among them)."""
    return _EXPERT_LEAF.fullmatch(name) is not None


def shard_vit_params_ep(state: dict, n_expert: int, index: int) -> dict:
    """Expert rank `index`'s share of the classifier's flat state {name:
    tensor} (parameters or momentum) over `n_expert` ranks: each expert
    leaf's experts [index * E / n_expert, (index + 1) * E / n_expert), in
    new memory; every other leaf as it is (the same tensor)."""
    out = {}
    for name, x in state.items():
        if not ep_layout(name):
            out[name] = x
            continue
        if x.shape[0] % n_expert != 0:
            raise ValueError(f"expert axis ({n_expert}) must divide the "
                             f"expert count ({x.shape[0]})")
        out[name] = x.chunk(n_expert)[index].clone()
    return out


def unshard_vit_params_ep(shards: list) -> dict:
    """The flat state from every expert rank's share (`shards[j]` is
    ``shard_vit_params_ep(state, len(shards), j)``): the inverse, bit for
    bit. The whole leaves are taken from rank 0's share."""
    return {name: (torch.cat([s[name] for s in shards]) if ep_layout(name)
                   else x) for name, x in shards[0].items()}


def _divides(x, n: int) -> bool:
    return getattr(x, "ndim", 0) >= 1 and x.shape[0] % n == 0


def zero1_sharding(n: int, x) -> bool:
    """ZeRO-1 placement of one optimizer-state leaf over `n` ranks: True
    when its leading axis is split (each rank stores 1/n of it, when n
    divides it), False when it is replicated (a ragged split of a small
    leaf is not worth it)."""
    return _divides(x, n)


def fsdp_sharding(n: int, x) -> bool:
    """JAX's FSDP placement of one parameter leaf: matrices (ndim >= 2)
    split their leading axis when `n` divides it, 1-D leaves (biases,
    LayerNorm scales) stay whole. FSDP2 shards them all on dim 0 (module
    docstring); this rule says which leaves the tests hold to 1/n."""
    return getattr(x, "ndim", 0) >= 2 and _divides(x, n)


def shard_rows(x: torch.Tensor, n: int, index: int) -> torch.Tensor:
    """Rank `index`'s share of a leading-axis split of `x` into `n` (a
    view)."""
    return x.view(n, -1, *x.shape[1:])[index]


def pad_to_multiple(batch_tree, multiple: int):
    """Pad the leading axis of every leaf (a dict, list or tuple of arrays)
    to a multiple of `multiple` with zeros; returns (padded_tree,
    real_count). Loss and metric code weighs by real_count."""
    leaves = (list(batch_tree.values()) if isinstance(batch_tree, dict)
              else list(batch_tree) if isinstance(batch_tree, (list, tuple))
              else [batch_tree])
    n = leaves[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch_tree, n

    def _pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    if isinstance(batch_tree, dict):
        return {k: _pad(v) for k, v in batch_tree.items()}, n
    if isinstance(batch_tree, (list, tuple)):
        return type(batch_tree)(_pad(v) for v in batch_tree), n
    return _pad(batch_tree), n
