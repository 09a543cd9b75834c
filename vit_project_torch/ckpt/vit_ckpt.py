"""ViT ImageNet full-state checkpointing (the single-process side of the JAX
package's ckpt/vit_ckpt.py).

Reference contract (save_checkpoint, train_vit_sgd.py:92-123): every epoch write
`checkpoint_epoch_{N:03d}.pth` + `checkpoint_latest.pth` containing model,
optimizer, scheduler state plus metrics, and append one row to
`training_metrics.csv`. Auto-resume scans for `checkpoint_latest.pth`.

The files are pickles of numpy trees through ``ckpt/serialization.py``, with
`params` and `opt_state` (the SGD momentum) in the JAX package's ViT tree
layout (``models/convert.py vit_jax_from_state_dict``), so either package
resumes the other's runs. The pod-sharded `.orbax` directories the JAX
package writes from several hosts are not ported yet and are refused.

In a multi-process run the primary (rank 0) writes the `.pth` files, the
CSV row and the pruning, and the other ranks meet it at a barrier, so no
rank reads a half-written tree. The caller hands every rank the full
state (the ZeRO-1 momentum and the FSDP parameters gathered first). The
JAX package writes the sharded `.orbax` form there instead, every host its
own shards; the port keeps the one `.pth` format that both packages resume
from until `save_sharded` is ported.
"""
from __future__ import annotations

import os
import re
import shutil

from . import serialization as ser
from ..core import csvio
from ..parallel import dist


def _is_multiprocess() -> bool:
    return dist.world_size() > 1


def _primary() -> bool:
    return dist.is_primary()


def _refuse_orbax(path: str) -> None:
    if path.endswith(".orbax") or path.endswith(".orbax.ptr"):
        raise NotImplementedError(
            f"{path}: pod-sharded .orbax checkpoints are not ported to "
            f"vit_project_torch yet; the port reads .pth checkpoints")


def save_checkpoint(epoch: int, params, opt_state, sched_state: dict,
                    train_loss: float, val_loss: float, val_acc: float,
                    output_dir: str, logger=None) -> str:
    """Write checkpoint_epoch_{epoch:03d}.pth and checkpoint_latest.pth (a
    second name for the same bytes), and append the epoch's metrics row.
    `params` and
    `opt_state` are JAX-layout trees (numpy arrays or tensors). Every rank
    calls it; only the primary writes (module docstring)."""
    path = os.path.join(output_dir, f"checkpoint_epoch_{epoch:03d}.pth")
    if _primary():
        _write(path, epoch, params, opt_state, sched_state, train_loss,
               val_loss, val_acc, output_dir, logger)
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


def load_checkpoint(path: str):
    _refuse_orbax(path)
    return ser.load(path)


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
    pat = re.compile(r"^checkpoint_epoch_(\d{3,})\.pth$")
    cutoff = current_epoch - keep_last
    for name in os.listdir(output_dir):
        m = pat.match(name)
        if not m or int(m.group(1)) > cutoff:
            continue
        try:
            os.unlink(os.path.join(output_dir, name))
            removed.append(name)
        except OSError:
            pass  # a vanished/locked old file must not kill training
    if removed and logger:
        logger.info(f"Pruned {len(removed)} old checkpoint(s) "
                    f"(keep_last={keep_last})")
    return removed


def _pth_unless_orbax_newer(pth: str, orbax: tuple) -> str | None:
    """`pth` if it exists; an .orbax candidate written after it (or without
    it) would be the JAX package's choice, which the port cannot read, so
    that case raises instead of resuming from a stale file."""
    for p in orbax:
        if os.path.exists(p) and (not os.path.exists(pth) or
                                  os.path.getmtime(p) > os.path.getmtime(pth)):
            _refuse_orbax(p)
    return pth if os.path.exists(pth) else None


def epoch_checkpoint(output_dir: str, epoch: int) -> str | None:
    """checkpoint_epoch_{N:03d}.pth, or None."""
    base = os.path.join(output_dir, f"checkpoint_epoch_{epoch:03d}")
    return _pth_unless_orbax_newer(base + ".pth", (base + ".orbax",))


def latest_checkpoint(output_dir: str) -> str | None:
    """checkpoint_latest.pth, or None."""
    return _pth_unless_orbax_newer(
        os.path.join(output_dir, "checkpoint_latest.pth"),
        tuple(os.path.join(output_dir, n) for n in (
            "checkpoint_latest.orbax.ptr", "checkpoint_latest.orbax")))
