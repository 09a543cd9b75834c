"""CSV output contract of the CLIP per-epoch run (copy of the CLIP part of
the JAX package's core/csvio.py).

The analysis notebooks of the reference parse this byte-exact schema:
epoch,train_loss,test_loss,behavioral_rsa_rho,behavioral_rsa_p_value,
used_random_targets,used_shuffled_targets,used_uniform_images,used_image_noise
(reference new_cvpr_train_behavior_things_pipeline.py:795,1026-1031).
"""
from __future__ import annotations

import csv
import os
from typing import Optional

CLIP_HEADERS = [
    "epoch", "train_loss", "test_loss", "behavioral_rsa_rho",
    "behavioral_rsa_p_value", "used_random_targets", "used_shuffled_targets",
    "used_uniform_images", "used_image_noise",
]


def init_clip_csv(
    training_res_path: str,
    resume_from_epoch: int = 0,
    previous_training_res_path: Optional[str] = None,
    logger=None,
) -> None:
    """Create / pre-populate the CLIP per-epoch CSV.

    Three cases, matching reference train_model (new_cvpr...pipeline.py:796-834):
    1. In-place resume (previous path == this path, file exists): keep file, verify
       header, new rows are appended by `append_clip_row`.
    2. Cross-file resume: write header then copy rows with epoch <= resume_from_epoch
       from the previous run's CSV (the lengths driver's resume-from-shorter-run).
    3. Fresh run: write just the header.
    """
    log = logger.info if logger else print

    resuming_same_file = (
        previous_training_res_path == training_res_path
        and os.path.exists(training_res_path)
        and resume_from_epoch > 0
    )
    if resuming_same_file:
        log("Resuming from existing CSV file - will append new epochs")
        try:
            with open(training_res_path, "r") as f:
                rows = list(csv.reader(f))
            if rows and rows[0] != CLIP_HEADERS:
                log(f"Warning: CSV headers don't match. Expected {CLIP_HEADERS}, "
                    f"found {rows[0] if rows else None}")
            # torn-tree rollback: a resume anchored BEFORE the CSV's last row
            # (checkpoint missing for the tail) must drop the tail rows, or
            # the retrained epochs append as duplicate rows with conflicting
            # values that the analysis readers would plot twice.
            def _keep(row):
                try:
                    return int(row[0]) <= resume_from_epoch
                except Exception:
                    return True
            kept = [rows[0]] + [r for r in rows[1:] if _keep(r)] if rows else []
            if rows and len(kept) < len(rows):
                tmp = f"{training_res_path}.tmp.{os.getpid()}"
                with open(tmp, "w", newline="") as f:
                    csv.writer(f).writerows(kept)
                os.replace(tmp, training_res_path)
                log(f"Dropped {len(rows) - len(kept)} CSV row(s) beyond the "
                    f"rollback epoch {resume_from_epoch} (torn tree)")
        except Exception as e:  # pragma: no cover - defensive
            log(f"Could not verify existing CSV file: {e}")
        return

    d = os.path.dirname(training_res_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(training_res_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CLIP_HEADERS)
        if (previous_training_res_path and resume_from_epoch > 0
                and os.path.exists(previous_training_res_path)):
            try:
                with open(previous_training_res_path, "r") as prev:
                    reader = csv.reader(prev)
                    next(reader, None)
                    for row in reader:
                        try:
                            epoch_val = int(row[0])
                        except Exception:
                            continue
                        if epoch_val <= resume_from_epoch:
                            writer.writerow(row)
            except Exception as e:  # pragma: no cover - defensive
                log(f"Could not pre-populate training CSV from "
                    f"{previous_training_res_path}: {e}")


def append_clip_row(training_res_path: str, epoch1: int, train_loss: float,
                    test_loss: float, rho: float, p_value: float,
                    used_random_targets: bool, used_shuffled_targets: bool,
                    used_uniform_images: bool, used_image_noise: bool) -> None:
    """Append one 1-indexed epoch row."""
    with open(training_res_path, "a", newline="") as f:
        csv.writer(f).writerow([
            epoch1, train_loss, test_loss, rho, p_value,
            used_random_targets, used_shuffled_targets,
            used_uniform_images, used_image_noise,
        ])


def last_completed_epoch0(training_res_path: str) -> int:
    """Scan an existing CLIP CSV for the last completed epoch, 0-indexed.

    Returns -1 if no valid rows. Mirrors the lengths CLI in-place resume scan
    (reference clip_train_behavior_lengths.py:141-160; CSV epochs are 1-indexed).
    """
    last = -1
    if not os.path.exists(training_res_path):
        return last
    with open(training_res_path, "r") as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if row:
                try:
                    last = max(last, int(row[0]) - 1)
                except (ValueError, IndexError):
                    continue
    return last
