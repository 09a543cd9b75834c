"""Checkpoint serialization (counterpart of the JAX package's
ckpt/serialization.py).

File names and containers are the JAX package's, so the two packages read
each other's run trees:

- ``save`` / ``load``: a pickle of numpy trees (``epoch{N}_random_states.pth``,
  ``dataset_split_indices.pth``), written atomically through a pid-unique
  temp file and ``os.replace``;
- ``save_torch`` / ``load_flat``: a flat {name: tensor} torch archive
  (``epoch{N}_dora_params.pth``, which the reference loads with torch.load).

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
import pickle
import time
import zipfile
from typing import Any, NamedTuple

import numpy as np
import torch


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


def _atomic_write(path: str, write) -> None:
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
    _atomic_write(path, write)


def load(path: str):
    with open(path, "rb") as f:
        return _Reader(f).load()


def save_torch(path: str, flat: dict) -> None:
    """Write a flat {name: array or tensor} mapping as a torch.save archive
    of CPU tensors (loadable with torch.load(weights_only=True))."""
    out = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.array(v)))
           for k, v in flat.items()}
    _atomic_write(path, lambda tmp: torch.save(out, tmp))


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
