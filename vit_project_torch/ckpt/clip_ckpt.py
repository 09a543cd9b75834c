"""CLIP-HBA checkpointing: per-epoch DoRA params + "random states"
(counterpart of the JAX package's ckpt/clip_ckpt.py).

- ``epoch{N}_dora_params.pth``: adapter params under reference module-path
  names, a torch archive; N is 1-indexed.
- ``epoch{N}_random_states.pth``: a pickle of {epoch, optimizer_state,
  data_seed, rng_keys}. The optimizer state is kept in optax's layout,
  ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())`` with mu
  and nu keyed {tower: {block_idx: {m, delta_D_A, delta_D_B}}}, so the two
  packages resume from each other's files. ``optax_state_from_adamw`` and
  ``adamw_state_from_optax`` convert between it and a
  ``torch.optim.AdamW`` (state ``step``, ``exp_avg``, ``exp_avg_sq``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import serialization as ser
from ..adapters import dora as adora


def save_dora_parameters(trainable: dict, dora_parameters_path: str,
                         epoch0: int, logger=None) -> str:
    """Save adapter params for epoch `epoch0` (0-indexed) as the epoch{N+1}
    file, a torch archive the reference's torch.load path reads."""
    os.makedirs(dora_parameters_path, exist_ok=True)
    path = os.path.join(dora_parameters_path,
                        f"epoch{epoch0 + 1}_dora_params.pth")
    ser.save_torch(path, adora.to_reference_names(trainable))
    return path


def load_dora_parameters(path: str, trainable: dict, spec: dict,
                         logger=None, strict: bool = False) -> dict:
    """Overlay whatever adapter entries the file has onto `trainable`
    (reference-named torch archives, as the reference and both packages
    write them): a training resume, strict=False as the reference loads.

    strict=True is for a bake (serving, export): the file must hold an
    adapter for every block of `spec` and none outside it, since a block
    left at its init or a trained adapter dropped from the bake gives wrong
    weights. Raises ValueError otherwise."""
    flat = ser.load_flat(path)
    loaded = adora.from_reference_names(flat, spec)
    if strict:
        missing = [f"{t}:{i}" for t, idxs in spec.items() for i in idxs
                   if int(i) not in {int(k) for k in loaded.get(t, {})}]
        if missing:
            raise ValueError(
                f"{path} is missing adapters for blocks {missing}; check "
                "--vision_layers/--transformer_layers/--rank match the run")
        extra = sorted(adora.checkpoint_module_paths(flat)
                       - adora.spec_module_paths(spec))
        if extra:
            raise ValueError(
                f"{path} contains trained adapters not covered by the "
                f"requested blocks: {extra}. Raise --vision_layers/"
                "--transformer_layers to match the run so every trained "
                "adapter is baked.")
    return adora.merge_loaded(trainable, loaded)


def save_random_states(optimizer_state, epoch0: int, random_state_path: str,
                       data_seed: int, rng_keys: dict, logger=None) -> str:
    log = logger.info if logger else print
    os.makedirs(random_state_path, exist_ok=True)
    path = os.path.join(random_state_path,
                        f"epoch{epoch0 + 1}_random_states.pth")
    ser.save(path, {
        "epoch": epoch0,
        "optimizer_state": optimizer_state,
        "data_seed": int(data_seed),
        "rng_keys": rng_keys,
    })
    log(f"Random states saved: {path}")
    return path


def load_random_states(random_state_path: str, epoch1: int, logger=None):
    """Load the epoch{epoch1} (1-indexed) random-state file, or None (the
    reference warns and goes on without one)."""
    log = logger.info if logger else print
    path = os.path.join(random_state_path, f"epoch{epoch1}_random_states.pth")
    if not os.path.exists(path):
        log(f"Warning: Random state checkpoint not found: {path}")
        return None
    state = ser.load(path)
    log(f"Random states loaded from: {path}")
    return state


# -- AdamW state <-> optax layout --------------------------------------------

def adamw_moments(optimizer: torch.optim.Optimizer, trainable: dict):
    """(count, mu, nu): the optimizer's step count and its moments as trees
    keyed like `trainable`, the tensors where the optimizer keeps them (the
    device). A leaf the optimizer has not stepped yet has zero moments and
    count 0."""
    count = 0
    mu, nu = {}, {}
    for tower, idx, name, leaf in adora.trainable_leaves(trainable):
        st = optimizer.state.get(leaf, {})
        if "step" in st:
            count = int(st["step"])
            m, v = st["exp_avg"], st["exp_avg_sq"]
        else:
            m = v = torch.zeros_like(leaf)
        mu.setdefault(tower, {}).setdefault(idx, {})[name] = m.detach()
        nu.setdefault(tower, {}).setdefault(idx, {})[name] = v.detach()
    for tower in trainable:   # optax keeps empty towers in the tree
        mu.setdefault(tower, {})
        nu.setdefault(tower, {})
    return count, mu, nu


def optax_state_from_moments(count: int, mu: dict, nu: dict) -> tuple:
    """optax.adamw's (count, mu, nu) state tuple of numpy arrays from
    `adamw_moments`' trees, their leaves tensors or host arrays (a
    core/hostcopy.py copy-out)."""
    def host(tree):
        return {k: host(v) if isinstance(v, dict) else (
                    v.cpu().numpy().copy() if isinstance(v, torch.Tensor)
                    else np.asarray(v))
                for k, v in tree.items()}
    return (ser.ScaleByAdamState(np.asarray(count, np.int32), host(mu),
                                 host(nu)),
            ser.EmptyState(), ser.EmptyState())


def optax_state_from_adamw(optimizer: torch.optim.Optimizer,
                           trainable: dict) -> tuple:
    """The optimizer's state as optax.adamw's (count, mu, nu) tuple of numpy
    arrays. `trainable` is the tree whose leaves the optimizer updates."""
    return optax_state_from_moments(*adamw_moments(optimizer, trainable))


def _leaf_keys(tree: dict) -> set:
    return {(t, int(i), n) for t, blocks in tree.items()
            for i, d in blocks.items() for n in d}


def adamw_state_matches(opt_state, trainable: dict) -> bool:
    """Whether an optax-layout state covers exactly `trainable`'s leaves with
    the same shapes (the JAX loop's tree-structure check)."""
    try:
        adam = opt_state[0]
        mu, nu = adam.mu, adam.nu
    except (TypeError, IndexError, AttributeError):
        return False
    want = {(t, i, n): tuple(leaf.shape)
            for t, i, n, leaf in adora.trainable_leaves(trainable)}
    if _leaf_keys(mu) != set(want) or _leaf_keys(nu) != set(want):
        return False
    return all(np.shape(mu[t][i][n]) == s and np.shape(nu[t][i][n]) == s
               for (t, i, n), s in want.items())


def adamw_state_from_optax(optimizer: torch.optim.Optimizer, opt_state,
                           trainable: dict) -> None:
    """Load an optax-layout (count, mu, nu) state into `optimizer`, whose
    params are `trainable`'s leaves. count 0 leaves the optimizer fresh."""
    adam = opt_state[0]
    count = int(np.asarray(adam.count))
    leaves = adora.trainable_leaves(trainable)
    index = {id(p): i for i, p in
             enumerate(p for g in optimizer.param_groups for p in g["params"])}
    state = {}
    if count > 0:
        for tower, idx, name, leaf in leaves:
            state[index[id(leaf)]] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(
                    np.array(adam.mu[tower][idx][name], np.float32)),
                "exp_avg_sq": torch.from_numpy(
                    np.array(adam.nu[tower][idx][name], np.float32)),
            }
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
