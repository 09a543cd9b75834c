"""CLIP-HBA adapter checkpoints (counterpart of the loading half of the JAX
package's ckpt/clip_ckpt.py)."""
from __future__ import annotations

from . import serialization as ser
from ..adapters import dora as adora


def load_dora_parameters(path: str, trainable: dict, spec: dict) -> dict:
    """strict=False load: overlay whatever adapter entries the file has onto
    `trainable` (reference-named torch archives, as the reference and the
    JAX package write them)."""
    flat = ser.load_flat(path)
    loaded = adora.from_reference_names(flat, spec)
    return adora.merge_loaded(trainable, loaded)
