"""The data mesh and the sharding rules (counterpart of the parts of the JAX
package's parallel/mesh.py that data parallelism uses).

JAX drives a ('data',) mesh from one process and places arrays on it; the
port runs one process per card, and each rank holds its own share. So:

- ``make_mesh(n_data)`` is a 1-D ``("data",)`` DeviceMesh over the ranks
  of the default group (FSDP2 takes it). The second mesh axes, ``n_model``
  (tensor and sequence parallelism), ``n_stage`` (the pipeline) and
  ``n_expert`` (MoE), raise: they come with later slices of the port.
- ``shard_batch`` and ``replicate`` have no counterpart: each rank's loader
  reads its own strided shard of the global batch (``num_shards`` = the
  world size, ``shard_id`` = the rank), and parameters are replicated by
  construction (every rank builds them from the same seed, and the trainer
  checks that they agree).
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

import numpy as np
import torch

from . import dist

_LATER = {"n_model": "tensor and sequence parallelism (port slice 9b)",
          "n_stage": "the pipeline (port slice 9, item 13)",
          "n_expert": "MoE expert parallelism (port slice 9, item 13)"}


def make_mesh(n_data: int | None = None, n_model: int = 1, n_stage: int = 1,
              n_expert: int = 1, device_type: str | None = None):
    """A 1-D ("data",) DeviceMesh over the default group's ranks (one
    device per rank). `n_data`, when given, must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    for name, size in (("n_model", n_model), ("n_stage", n_stage),
                       ("n_expert", n_expert)):
        if size > 1:
            raise NotImplementedError(
                f"make_mesh({name}={size}): {_LATER[name]} is not ported to "
                f"vit_project_torch yet; the port's mesh is ('data',)")
    world = dist.world_size()
    if n_data is not None and n_data != world:
        raise ValueError(f"n_data ({n_data}) must equal the number of ranks "
                         f"({world}): one device per rank")
    if device_type is None:
        device_type = dist.collective_device().type
    return init_device_mesh(device_type, (world,), mesh_dim_names=("data",))


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
