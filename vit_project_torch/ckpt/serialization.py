"""Flat {name: array} checkpoint loading (counterpart of the torch-archive
branch of the JAX package's ckpt/serialization.py ``load_flat``)."""
from __future__ import annotations

import pickle
import zipfile

import torch

# torch's pre-1.6 (non-zip) serialization starts with this magic number,
# pickled with protocol 2 (the bytes below leave out pickle's STOP opcode)
_TORCH_LEGACY_MAGIC = pickle.dumps(0x1950A86A20F9469CFC6C, protocol=2)[:-1]


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
