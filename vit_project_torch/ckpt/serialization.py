"""Checkpoint serialization (counterpart of the JAX package's
ckpt/serialization.py).

File names and containers are the JAX package's, so the two packages read
each other's run trees:

- ``save`` / ``load``: a pickle of numpy trees (``epoch{N}_random_states.pth``,
  ``dataset_split_indices.pth``), written atomically through a pid-unique
  temp file and ``os.replace``;
- ``save_torch`` / ``load_flat``: a flat {name: tensor} torch archive
  (``epoch{N}_dora_params.pth``, which the reference loads with torch.load).

``save_sharded`` / ``load_sharded`` are the per-rank form, the counterpart
of JAX's orbax pair: a collective in which every rank writes only the
shards it holds, into a ``torch.distributed.checkpoint`` (DCP) directory.
The directory is the port's own format; JAX's ``.orbax`` directories are
read by ``ckpt/orbax.py`` (``vit_ckpt.load_checkpoint`` routes them).

The JAX package's random-states pickle holds optax's AdamW state,
``(optax._src.transform.ScaleByAdamState(count, mu, nu),
optax._src.base.EmptyState(), optax._src.base.EmptyState())``. The port
cannot import optax: ``load`` maps those class names to the local stand-ins
below, and ``save`` writes the stand-ins under optax's names, so a JAX run
resumes from a file the port wrote.
"""
from __future__ import annotations

import glob
import os
import contextlib
import pickle
import shutil
import time
import warnings
import zipfile
from typing import Any, NamedTuple

import numpy as np
import torch

from ..parallel import dist


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's ScaleByAdamState: count (int32 scalar array) and
    the first and second moments mu, nu as trees of arrays."""
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """Stand-in for optax's EmptyState (the weight-decay and learning-rate
    stages of optax.adamw keep no state)."""


# (module, name) of the optax classes <-> their stand-ins
_OPTAX_NAMES = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.base", "EmptyState"): EmptyState,
}
_WRITE_AS = {cls: key for key, cls in _OPTAX_NAMES.items()}

# torch's pre-1.6 (non-zip) serialization starts with this magic number,
# pickled with protocol 2 (the bytes below leave out pickle's STOP opcode)
_TORCH_LEGACY_MAGIC = pickle.dumps(0x1950A86A20F9469CFC6C, protocol=2)[:-1]


def _to_host(obj):
    """Recursively convert tensors to numpy arrays for pickling."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_to_host(v) for v in obj]
        if hasattr(obj, "_fields"):  # NamedTuple (the optimizer states)
            return type(obj)(*out)
        return type(obj)(out)
    return obj


class _Writer(pickle._Pickler):
    """Pickler that writes the optimizer-state stand-ins under optax's
    module and class names (the pure-Python pickler, whose save_global can
    be overridden)."""

    def save_global(self, obj, name=None):
        target = _WRITE_AS.get(obj)
        if target is None:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Reader(pickle.Unpickler):
    """Unpickler that resolves optax's state classes to the stand-ins."""

    def find_class(self, module, name):
        cls = _OPTAX_NAMES.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


def reap_stale_temps(path: str) -> None:
    """Delete abandoned `<path>.tmp.*` files older than an hour (a live
    racing writer's in-progress temp survives; the path is glob-escaped)."""
    for stale in glob.glob(glob.escape(path) + ".tmp.*"):
        try:
            if time.time() - os.path.getmtime(stale) > 3600:
                os.unlink(stale)
        except OSError:
            pass


def atomic_write(path: str, write) -> None:
    """`write(tmp)` to a temporary name beside `path`, then ``os.replace``:
    a reader sees the old file or the whole new one, never a torn one."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    reap_stale_temps(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)  # atomic: a crash never leaves a truncated file
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(path: str, tree) -> None:
    """Pickle `tree` (tensors become numpy arrays) to `path`, protocol 4."""
    def write(tmp):
        with open(tmp, "wb") as f:
            _Writer(f, protocol=4).dump(_to_host(tree))
    atomic_write(path, write)


def load(path: str):
    with open(path, "rb") as f:
        return _Reader(f).load()


def save_torch(path: str, flat: dict) -> None:
    """Write a flat {name: array or tensor} mapping as a torch.save archive
    of CPU tensors (loadable with torch.load(weights_only=True))."""
    out = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.array(v)))
           for k, v in flat.items()}
    atomic_write(path, lambda tmp: torch.save(out, tmp))


def load_flat(path: str) -> dict:
    """Load a flat {name: tensor} mapping from a torch archive (zip, or the
    legacy pre-1.6 format). Tensors come back as float32 on the CPU.

    The JAX package also reads its own pickle containers; the port takes
    torch archives only and says so for anything else."""
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            head = f.read(len(_TORCH_LEGACY_MAGIC))
        if head != _TORCH_LEGACY_MAGIC:
            raise ValueError(
                f"{path}: not a torch archive (zip or legacy). Pickle "
                "containers written without torch are read by the JAX "
                "package only; re-save the file with torch.save")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise TypeError(f"{path}: expected a flat dict, got {type(obj)}")
    return {k: (v.detach().float() if isinstance(v, torch.Tensor)
                else torch.as_tensor(v, dtype=torch.float32))
            for k, v in obj.items()}


# -- per-rank sharded checkpoints -----------------------------------------------
# JAX writes a pod's state with orbax: every host its own array shards, and a
# restore re-assembles global arrays against a sharding template. The port's
# counterpart is DCP, which ships with torch: a DTensor records its global
# shape and placement, so each rank writes the chunk it holds, and a load
# into DTensors of the same (or another) placement reads only the chunks it
# needs.

def _saveable(tree):
    """`tree` with numpy arrays as tensors and numpy scalars as Python
    numbers: DCP pickles the leaves that are not tensors, and its loader
    unpickles them with torch.load."""
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


@contextlib.contextmanager
def _dcp_call(path: str):
    """Around a DCP save or load of `path`. Without a process group DCP
    warns that it assumes one process, which is what the port asks of it
    there. DCP reports a failed read or write as a CheckpointException, a
    BaseException that ``except Exception`` would not catch: it is raised
    again as a RuntimeError naming the directory."""
    from torch.distributed.checkpoint.api import CheckpointException
    with warnings.catch_warnings():
        if not dist.is_initialized():
            warnings.filterwarnings("ignore",
                                    message="torch.distributed is disabled")
        try:
            yield
        except CheckpointException as e:
            raise RuntimeError(f"{path}: sharded checkpoint failed: "
                               f"{e}") from None


def save_sharded(path: str, tree: dict) -> None:
    """Write `tree`, a nested dict, as a DCP directory at `path` (replaced
    if it exists).

    Collective over the default group: every rank calls it with its own
    tree. A DTensor leaf (FSDP2's parameters, the ZeRO-1 momentum rows
    viewed as one) goes to the file of the rank that holds each shard,
    ``__{rank}_0.distcp``; a plain tensor must be the same on every rank
    (replicated) and is written once, by one rank; other leaves (epoch,
    losses, the scheduler's dict) are pickled once. The primary writes
    ``.metadata``, each leaf's global shape and where each of its chunks
    lies, after every rank's file is complete, so a directory without it
    is a torn write. Works in one process without a group too."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    if dist.is_primary() and os.path.exists(path):
        shutil.rmtree(path)
    dist.barrier()
    with _dcp_call(path):
        dcp.save(_saveable(tree), storage_writer=dcp.FileSystemWriter(path),
                 no_dist=not dist.is_initialized())


def _add_missing(tree: dict, keys: tuple) -> None:
    """Put a None leaf at the path `keys` of `tree` where the path is
    missing (creating the dicts on the way)."""
    for k in keys[:-1]:
        nxt = tree.setdefault(k, {})
        if not isinstance(nxt, dict):
            return
        tree = nxt
    tree.setdefault(keys[-1], None)


def load_sharded(path: str, template: dict | None = None) -> dict:
    """Read a ``save_sharded`` directory.

    - `template` None: every leaf whole, tensors on the host (no
      collective; each caller reads every file).
    - `template` given: a collective, every rank with its own template.
      Each tensor leaf of the template is restored in place, in its own
      placement: a DTensor reads only the chunks its local shard needs
      (whatever placement wrote them), a plain tensor the whole leaf. The
      leaves that are not tensors come from the file whether or not the
      template holds them. Returns the template."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import BytesStorageMetadata
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, ".metadata")):
        raise FileNotFoundError(
            f"{path}: no .metadata, so not a complete sharded checkpoint (a "
            f"write that did not finish, or not a save_sharded directory)")
    reader = dcp.FileSystemReader(path)
    if template is None:
        from torch.distributed.checkpoint.default_planner import \
            _EmptyStateDictLoadPlanner
        from torch.distributed.checkpoint.state_dict_loader import \
            _load_state_dict
        out: dict = {}
        with _dcp_call(path):
            _load_state_dict(out, storage_reader=reader,
                             planner=_EmptyStateDictLoadPlanner(),
                             no_dist=True)
        return out
    md = reader.read_metadata()
    for fqn, meta in md.state_dict_metadata.items():
        if isinstance(meta, BytesStorageMetadata):
            _add_missing(template, tuple(md.planner_data[fqn]))
    with _dcp_call(path):
        dcp.load(template, storage_reader=reader,
                 no_dist=not dist.is_initialized())
    return template


def shard_files(path: str) -> dict:
    """Where ``save_sharded`` put each piece of a checkpoint, from its
    metadata: {file name: [(leaf name, the chunk's offset in the leaf, or
    None for a leaf that is not a tensor)]}."""
    import torch.distributed.checkpoint as dcp
    md = dcp.FileSystemReader(os.path.abspath(path)).read_metadata()
    out: dict = {}
    for idx, info in md.storage_data.items():
        out.setdefault(info.relative_path, []).append(
            (idx.fqn, None if idx.offset is None else tuple(idx.offset)))
    return out
