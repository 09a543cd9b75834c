"""Perturbation-window arithmetic (copy of the JAX package's perturb/windows.py).

The off-by-one-prone core of the experimental design (reference train_model,
new_cvpr_train_behavior_things_pipeline.py:843-845): `training_run` is the
1-indexed epoch the perturbation starts at; internally epochs are 0-indexed, so the
window is [training_run - 1, training_run - 1 + perturb_length - 1] inclusive.
"""
from __future__ import annotations

PERTURB_TYPES = ("random_target", "label_shuffle", "uniform_images",
                 "image_noise")

VIT_PERTURB_TYPES = ("gaussian", "uniform_gray", "label_shuffle", "target_noise")


def window_bounds(training_run: int, perturb_length: int) -> tuple[int, int]:
    """0-indexed inclusive [start, end] epoch window."""
    start = training_run - 1
    return start, start + perturb_length - 1


def in_window(epoch0: int, training_run: int, perturb_length: int) -> bool:
    start, end = window_bounds(training_run, perturb_length)
    return start <= epoch0 <= end


def epoch_flags(epoch0: int, training_run: int, perturb_length: int,
                perturb_type: str) -> dict:
    """The four used_* CSV flags for one epoch (reference :838-871)."""
    active = (perturb_type in PERTURB_TYPES
              and in_window(epoch0, training_run, perturb_length))
    return {
        "used_random_targets": active and perturb_type == "random_target",
        "used_shuffled_targets": active and perturb_type == "label_shuffle",
        "used_uniform_images": active and perturb_type == "uniform_images",
        "used_image_noise": active and perturb_type == "image_noise",
    }
