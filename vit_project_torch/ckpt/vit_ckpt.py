"""ViT ImageNet full-state checkpointing (counterpart of the JAX package's
ckpt/vit_ckpt.py).

Reference contract (save_checkpoint, train_vit_sgd.py:92-123): every epoch write
`checkpoint_epoch_{N:03d}.pth` + `checkpoint_latest.pth` containing model,
optimizer, scheduler state plus metrics, and append one row to
`training_metrics.csv`. Auto-resume scans for `checkpoint_latest.pth`.

The files are pickles of numpy trees through ``ckpt/serialization.py``, with
`params` and `opt_state` (the SGD momentum) in the JAX package's ViT tree
layout (``models/convert.py vit_jax_from_state_dict``), so either package
resumes the other's runs. In a multi-process run the primary (rank 0)
writes the `.pth` files, the CSV row and the pruning, and the other ranks
meet it at a barrier, so no rank reads a half-written tree. The caller
hands every rank the full state (the ZeRO-1 momentum and the FSDP
parameters gathered first).

``sharded=True`` is the per-rank form, JAX's ``.orbax`` counterpart: a
collective in which every rank writes its own shards
(``serialization.save_sharded``, DCP) into
`checkpoint_epoch_{N:03d}.dcp/`, and the primary points
`checkpoint_latest.dcp.ptr` at it. There `params` and `opt_state` are the
trainer's own flat state (``ViTTrainer.sharded_state``: the port's names
and layout, tensors and DTensors), not JAX-layout trees. JAX defaults to
the sharded form over several processes; the port's default stays the one
`.pth`, which both packages resume. ``load_checkpoint`` of a `.dcp`
without a template returns what a `.pth` holds (JAX-layout numpy trees),
so every reader takes either file; with a template it restores in place,
each rank its own shards.

The pod-sharded `.orbax` directories the JAX package writes (by default
over several processes: `checkpoint_epoch_{N:03d}.orbax/` and
`checkpoint_latest.orbax.ptr`) are read by ``ckpt/orbax.py`` without orbax:
``load_checkpoint`` returns the tree JAX's returns, and
``epoch_checkpoint`` / ``latest_checkpoint`` resolve them by JAX's rule,
so a run begun on a TPU pod resumes, forks, scores and serves here. A
template with an `.orbax` raises: the port places what it restores from
its trainer, not from orbax's shardings.
"""
from __future__ import annotations

import os
import re
import shutil

from . import orbax
from . import serialization as ser
from ..core import csvio
from ..parallel import dist


def _is_multiprocess() -> bool:
    return dist.world_size() > 1


def _primary() -> bool:
    return dist.is_primary()


LATEST_PTR = "checkpoint_latest.dcp.ptr"


def save_checkpoint(epoch: int, params, opt_state, sched_state: dict,
                    train_loss: float, val_loss: float, val_acc: float,
                    output_dir: str, logger=None,
                    sharded: bool = False) -> str:
    """Write checkpoint_epoch_{epoch:03d}.pth and checkpoint_latest.pth (a
    second name for the same bytes), and append the epoch's metrics row.
    `params` and `opt_state` are JAX-layout trees (numpy arrays or
    tensors). Every rank calls it; only the primary writes (module
    docstring).

    With `sharded`, `params` and `opt_state` are the trainer's flat state
    (``ViTTrainer.sharded_state``) and every rank writes its own shards to
    checkpoint_epoch_{epoch:03d}.dcp; the primary then points
    checkpoint_latest.dcp.ptr at it (atomically) and appends the row."""
    if sharded:
        return _write_sharded(epoch, params, opt_state, sched_state,
                              train_loss, val_loss, val_acc, output_dir,
                              logger)
    path = os.path.join(output_dir, f"checkpoint_epoch_{epoch:03d}.pth")
    if _primary():
        _write(path, epoch, params, opt_state, sched_state, train_loss,
               val_loss, val_acc, output_dir, logger)
    if _is_multiprocess():
        dist.barrier()
    return path


def _write_sharded(epoch: int, params, opt_state, sched_state: dict,
                   train_loss: float, val_loss: float, val_acc: float,
                   output_dir: str, logger) -> str:
    path = os.path.join(output_dir, f"checkpoint_epoch_{epoch:03d}.dcp")
    ser.save_sharded(path, {
        "epoch": epoch,
        "params": params,
        "opt_state": opt_state,
        "scheduler_state": sched_state,
        "train_loss": float(train_loss),
        "val_loss": float(val_loss),
        "val_acc": float(val_acc),
    })
    if _primary():
        # 'latest' is a pointer to the epoch directory, not a second
        # collective write of the state (JAX's .orbax.ptr)
        def write(tmp):
            with open(tmp, "w") as f:
                f.write(os.path.basename(path))
        ser.atomic_write(os.path.join(output_dir, LATEST_PTR), write)
        if logger:
            logger.info(f"Saved checkpoint: {os.path.basename(path)}")
        csvio.append_vit_row(os.path.join(output_dir, "training_metrics.csv"),
                             epoch, train_loss, val_loss, val_acc)
    if _is_multiprocess():
        dist.barrier()
    return path


def _write(path: str, epoch: int, params, opt_state, sched_state: dict,
           train_loss: float, val_loss: float, val_acc: float,
           output_dir: str, logger) -> None:
    os.makedirs(output_dir, exist_ok=True)
    ser.save(path, {
        "epoch": epoch,
        "params": params,
        "opt_state": opt_state,
        "scheduler_state": sched_state,
        "train_loss": train_loss,
        "val_loss": val_loss,
        "val_acc": val_acc,
    })
    # 'latest' is a hard link to the epoch file (a byte copy where the
    # filesystem has no links), not a second serialization: the epoch file
    # is never written again, so the two names keep the same bytes. A
    # MoE ViT-B/16's file is 2.3 GB. Temp + rename keeps the replace atomic
    # like ser.save
    latest = os.path.join(output_dir, "checkpoint_latest.pth")
    ser.reap_stale_temps(latest)
    tmp = f"{latest}.tmp.{os.getpid()}"
    try:
        try:
            os.link(path, tmp)
        except OSError:
            shutil.copyfile(path, tmp)
        os.replace(tmp, latest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if logger:
        logger.info(f"Saved checkpoint: {os.path.basename(path)}")
    csvio.append_vit_row(os.path.join(output_dir, "training_metrics.csv"),
                         epoch, train_loss, val_loss, val_acc)


def load_checkpoint(path: str, template: dict | None = None):
    """A checkpoint's dict. A `.pth`: the pickle. A `.dcp` without
    `template`: the same dict a `.pth` holds (every leaf whole, `params`
    and `opt_state` as JAX-layout numpy trees). A `.dcp` with `template`
    (a collective; {"params": ..., "opt_state": ...} in the trainer's
    flat layout and placement, e.g. ``ViTTrainer.sharded_state``): the
    template restored in place, each rank reading its own shards, with the
    checkpoint's other leaves beside it. A JAX-written `.orbax`: the tree
    JAX's ``load_checkpoint`` returns (what a `.pth` holds: JAX-layout
    numpy trees, Python numbers); it takes no template."""
    if path.endswith(".orbax"):
        if template is not None:
            raise ValueError(
                f"{path}: a template is not taken with a .orbax checkpoint; "
                f"the port places the restored state through its trainer")
        return orbax.read_tree(path)
    if not path.endswith(".dcp"):
        return ser.load(path)
    if template is not None:
        return ser.load_sharded(path, template)
    from ..models import convert as vconvert
    ckpt = ser.load_sharded(path)
    for key in ("params", "opt_state"):
        ckpt[key] = vconvert.vit_jax_from_state_dict(ckpt[key])
    return ckpt


def prune_checkpoints(output_dir: str, keep_last: int, current_epoch: int,
                      logger=None) -> list[str]:
    """Delete per-epoch checkpoints older than the last `keep_last` epochs.
    Opt-in retention for pure-training runs (the experimental paradigms need
    every epoch); 'latest' is never touched. Every rank calls it; the
    primary prunes and the others wait for it at a barrier, so none lists
    a checkpoint that is being deleted (the last epoch's prune is the
    training CLI's last write, and a chained cli.vit_rsa_eval lists the
    directory next)."""
    if keep_last <= 0:
        return []
    removed = _prune(output_dir, keep_last, current_epoch, logger) \
        if _primary() else []
    if _is_multiprocess():
        dist.barrier()
    return removed


def _prune(output_dir: str, keep_last: int, current_epoch: int,
           logger) -> list[str]:
    removed: list[str] = []
    pat = re.compile(r"^checkpoint_epoch_(\d{3,})\.(pth|dcp|orbax)$")
    cutoff = current_epoch - keep_last
    for name in os.listdir(output_dir):
        m = pat.match(name)
        if not m or int(m.group(1)) > cutoff:
            continue
        p = os.path.join(output_dir, name)
        try:
            shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)
            removed.append(name)
        except OSError:
            pass  # a vanished/locked old file must not kill training
    if removed and logger:
        logger.info(f"Pruned {len(removed)} old checkpoint(s) "
                    f"(keep_last={keep_last})")
    return removed


def _newest(cands: list) -> str | None:
    """The most recently written of `cands`, (path, the file whose mtime
    dates it) pairs, among those that exist (a `.dcp` only with its
    metadata: without it the write was torn); None without one."""
    dated = [(os.path.getmtime(stamp), path) for path, stamp in cands
             if os.path.exists(path) and os.path.exists(stamp)
             and (not path.endswith(".dcp")
                  or os.path.exists(os.path.join(path, ".metadata")))]
    if not dated:
        return None
    return max(dated)[1]


def epoch_checkpoint(output_dir: str, epoch: int) -> str | None:
    """checkpoint_epoch_{N:03d} as a .pth, a .dcp or a .orbax, the newest
    by mtime when several exist (JAX's rule for .orbax and .pth), or
    None."""
    base = os.path.join(output_dir, f"checkpoint_epoch_{epoch:03d}")
    return _newest([(base + ext, base + ext)
                    for ext in (".pth", ".dcp", ".orbax")])


def latest_checkpoint(output_dir: str) -> str | None:
    """checkpoint_latest.pth, the legacy full checkpoint_latest.orbax
    directory, or the epoch directory that checkpoint_latest.orbax.ptr or
    checkpoint_latest.dcp.ptr names (dated by the pointer): the most
    recently written of those that exist, as JAX picks between its
    formats; or None."""
    cands = [(p, p) for p in (os.path.join(output_dir, n) for n in (
        "checkpoint_latest.pth", "checkpoint_latest.orbax"))]
    for name in ("checkpoint_latest.orbax.ptr", LATEST_PTR):
        ptr = os.path.join(output_dir, name)
        if os.path.exists(ptr):
            with open(ptr) as f:
                cands.append((os.path.join(output_dir, f.read().strip()),
                              ptr))
    return _newest(cands)
