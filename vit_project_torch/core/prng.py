"""Pure, replayable random streams (counterpart of the JAX package's
core/prng.py).

The reference checkpoints five stateful RNG streams per epoch to resume
exactly. JAX makes every draw a pure function of a key; the port does the
same with ``Key``: a path of integers, folded in the order of JAX's
``fold_in`` chain and hashed into a ``torch.Generator`` on the device only
when a draw is made. A resume or a fork that rebuilds the same path draws the
same numbers. The bits differ from JAX's, so tests that compare the two
packages feed JAX's draws to the port.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Key:
    """A pure, replayable random stream: the integers folded in so far."""
    path: tuple[int, ...]

    @classmethod
    def root(cls, seed: int) -> "Key":
        return cls((int(seed),))

    def fold_in(self, i: int) -> "Key":
        return Key(self.path + (int(i),))

    def split(self) -> tuple["Key", "Key"]:
        """Two independent children (the vision and text streams)."""
        return self.fold_in(0), self.fold_in(1)

    def generator(self, device) -> torch.Generator:
        """A generator on `device` seeded by a hash of the path."""
        digest = hashlib.blake2b(repr(self.path).encode(), digest_size=8)
        seed = int.from_bytes(digest.digest(), "little") & ((1 << 63) - 1)
        return torch.Generator(device=device).manual_seed(seed)


def key_from_seed(seed: int) -> Key:
    """Root key from an integer seed."""
    return Key.root(seed)


def perturb_base_key(perturb_seed: int, training_run: int) -> Key:
    """Per-run perturbation base key: the single home of the reference's
    seed arithmetic ``perturb_seed + training_run * 1000`` (reference
    new_cvpr_train_behavior_things_pipeline.py:882,920,939)."""
    return key_from_seed(int(perturb_seed) + int(training_run) * 1000)


def batch_perturb_key(perturb_seed: int, training_run: int,
                      batch_idx: int) -> Key:
    """Per-batch perturbation key: the run's base key with the batch index
    folded in. The epoch is not folded in (as in JAX): a fork that re-runs
    a (run, batch) pair draws the same perturbation as the uninterrupted
    run."""
    return perturb_base_key(perturb_seed, training_run).fold_in(batch_idx)
