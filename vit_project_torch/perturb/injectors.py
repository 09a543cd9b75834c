"""Perturbation statistics (the numpy part of the JAX package's
perturb/injectors.py).

Only ``perturb_distribution_stats`` is ported so far: the baseline run logs
and carries the target distribution's mean and std. The four CLIP-side
injectors come with the port of the paradigm drivers; the training loop
refuses any other perturb_type until then.
"""
from __future__ import annotations

import numpy as np


def perturb_distribution_stats(target_embeddings: np.ndarray,
                               distribution: str) -> tuple[float, float]:
    """mean/std used by random_target ('target') and image_noise
    (reference run_behavioral_training :1100-1105)."""
    if distribution == "normal":
        return 0.0, 1.0
    emb = np.asarray(target_embeddings, np.float32)
    return float(np.mean(emb)), float(np.std(emb))
