"""The perturbation injectors (counterpart of the JAX package's
perturb/injectors.py; reference train_model,
new_cvpr_train_behavior_things_pipeline.py:843-982).

- per-batch determinism from the seed arithmetic perturb_seed +
  training_run*1000 + batch_idx (ref :882,920,939), as a key
  (core.prng.batch_perturb_key): a fork that re-runs (run, batch) applies
  the same perturbation;
- perturbations apply after normalization, to float32 images (the
  reference perturbs tensors that have been through ToTensor+Normalize);
- `random_target`: fresh Gaussian targets, N(0,1) for 'normal' or
  N(mean, std) of the target-embedding distribution for 'target'
  (ref :922-927);
- `label_shuffle`: permute the batch's target rows (ref :731-779);
- `uniform_images`: every pixel of the normalized tensor set to 0.5
  (ref :904-906);
- `image_noise`: images replaced by N(mean, std) noise with the same
  distribution stats (ref :895-897, stats from :1100-1105).

A batched group of forks gates each fork by its own window
(``apply_clip_perturbation_forks``); a data-parallel rank perturbs the
whole batch's targets and draw and keeps its own block
(``apply_clip_perturbation(block=)``). Each random kind is a draw from the
key's generator (``draw_clip``) and a transform of that draw, so a test can
hand the transform JAX's draws. The JAX loop pads every batch to the
configured batch size and draws at that padded shape; the port does not
pad, so it draws at [batch_size, ...] and keeps the first n rows. For
`label_shuffle` the argsort of the valid rows' uniforms is JAX's masked
argsort (invalid rows sort last there).

The ViT-side variants (measure_single_epoch_perturbation_effect.py:36-93)
are dataset/transform-level: batch transforms and index tables.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.prng import Key, batch_perturb_key  # noqa: F401  (re-export)


# -- CLIP-side (in-loop, keyed per batch) -----------------------------------

# kinds that replace the tower's input images (the others change only the
# targets): an epoch where one of these is active cannot use the
# frozen-prefix activation cache, which was built from the clean images
IMAGE_KINDS = frozenset({"uniform_images", "image_noise"})


def draw_clip(perturb_type: str, key: Key, rows: int, images: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor | None:
    """The random numbers one batch's perturbation consumes, drawn from
    `key` at the padded batch shape [rows, ...]: normals like a target row
    (random_target), one uniform a row (label_shuffle), normals like an
    image in the images' dtype (image_noise); None for the other kinds."""
    if perturb_type == "random_target":
        return torch.randn((rows, *targets.shape[1:]), dtype=torch.float32,
                           device=targets.device,
                           generator=key.generator(targets.device))
    if perturb_type == "label_shuffle":
        return torch.rand((rows,), dtype=torch.float32,
                          device=targets.device,
                          generator=key.generator(targets.device))
    if perturb_type == "image_noise":
        return torch.randn((rows, *images.shape[1:]), dtype=images.dtype,
                           device=images.device,
                           generator=key.generator(images.device))
    return None


def random_targets(normals: torch.Tensor, distribution: str, mean: float,
                   std: float) -> torch.Tensor:
    """Targets from standard normals: as drawn for 'normal', else scaled to
    N(mean, std)."""
    if distribution == "target":
        return normals * std + mean
    return normals


def shuffle_targets(targets: torch.Tensor,
                    uniforms: torch.Tensor) -> torch.Tensor:
    """Permute the target rows by the (stable) argsort of one uniform per
    row: a uniformly random permutation, the reference's torch.randperm
    semantics."""
    return targets[torch.argsort(uniforms[:targets.shape[0]], stable=True)]


def uniform_images(images: torch.Tensor) -> torch.Tensor:
    return torch.full_like(images, 0.5)


def image_noise(normals: torch.Tensor, mean: float,
                std: float) -> torch.Tensor:
    return normals * std + mean


def apply_clip_perturbation(perturb_type: str, key: Key | None,
                            images: torch.Tensor, targets: torch.Tensor, *,
                            distribution: str = "target", mean: float = 0.0,
                            std: float = 1.0, rows: int | None = None,
                            drawn: torch.Tensor | None = None,
                            block: tuple[int, int] | None = None):
    """(images, targets) after `perturb_type`'s injector; other kinds pass
    both through. The draw is made from `key` at [rows, ...] (rows defaults
    to the batch's n) unless `drawn` hands it in.

    `block` (lo, hi): one data-parallel rank's share. `images` then holds
    the batch's rows [lo, hi) and `targets` the whole batch's n rows; the
    draw and the targets are perturbed whole (so `label_shuffle` permutes
    across the ranks' blocks) and the result is the block's rows, each the
    one-process batch's row."""
    n = targets.shape[0]
    lo, hi = block or (0, n)
    if drawn is None:
        drawn = draw_clip(perturb_type, key, rows or n, images, targets)
    if perturb_type == "random_target":
        targets = random_targets(drawn[:n], distribution, mean, std)
    elif perturb_type == "label_shuffle":
        targets = shuffle_targets(targets, drawn)
    elif perturb_type == "uniform_images":
        images = uniform_images(images)
    elif perturb_type == "image_noise":
        images = image_noise(drawn[lo:hi], mean, std)
    return images, targets[lo:hi]


def apply_clip_perturbation_forks(perturb_type: str, keys: list,
                                  in_win: list, images: torch.Tensor,
                                  targets: torch.Tensor, *,
                                  distribution: str = "target",
                                  mean: float = 0.0, std: float = 1.0,
                                  rows: int | None = None):
    """The per-fork gate of a batched group (JAX's `in_win`): `images`
    [R*n, ...] holds each fork's rows in fork order and `targets` is
    [R, n, ...]. Fork f inside its window (in_win[f]) gets its own draw from
    keys[f], as its solo step would; a fork outside it keeps its clean
    batch. Target kinds replace that fork's targets, image kinds that
    fork's rows of the images."""
    if perturb_type == "none" or not any(in_win):
        return images, targets
    R, n = targets.shape[:2]
    imgs, tgts = list(images.unflatten(0, (R, n))), list(targets)
    for f in range(R):
        if in_win[f]:
            imgs[f], tgts[f] = apply_clip_perturbation(
                perturb_type, keys[f], imgs[f], tgts[f],
                distribution=distribution, mean=mean, std=std, rows=rows)
    if perturb_type in IMAGE_KINDS:
        images = torch.cat(imgs)
    return images, torch.stack(tgts)


def perturb_distribution_stats(target_embeddings: np.ndarray,
                               distribution: str) -> tuple[float, float]:
    """mean/std used by random_target ('target') and image_noise
    (reference run_behavioral_training :1100-1105)."""
    if distribution == "normal":
        return 0.0, 1.0
    emb = np.asarray(target_embeddings, np.float32)
    return float(np.mean(emb)), float(np.std(emb))


# -- ViT-side (measure_single_epoch_perturbation_effect.py:36-93) ------------

def vit_gaussian_noise(key: Key | None, images: torch.Tensor,
                       epsilon: float = 0.1,
                       drawn: torch.Tensor | None = None) -> torch.Tensor:
    """Image replaced by pure noise eps*N(0,1) (GaussianNoiseTransform)."""
    if drawn is None:
        drawn = torch.randn(images.shape, dtype=images.dtype,
                            device=images.device,
                            generator=key.generator(images.device))
    return drawn * epsilon


def vit_uniform_gray(images: torch.Tensor) -> torch.Tensor:
    """Image replaced by zeros post-normalization (UniformGrayTransform)."""
    return torch.zeros_like(images)


def shuffled_label_table(n: int, shuffle_seed: int = 42) -> np.ndarray:
    """ShuffledLabelsDataset: sample i takes the label of shuffled_indices[i],
    fixed permutation from RandomState(seed)."""
    rng = np.random.RandomState(shuffle_seed)
    return rng.permutation(n)


def random_target_table(n: int, num_classes: int = 1000,
                        noise_seed: int = 42) -> np.ndarray:
    """TargetNoiseDataset: one fixed random class per sample."""
    rng = np.random.RandomState(noise_seed)
    return rng.randint(0, num_classes, n)


def apply_vit_perturbation(perturbation_type: str | None, key: Key | None,
                           images: torch.Tensor, labels: torch.Tensor, *,
                           epsilon: float = 0.1,
                           label_override: torch.Tensor | None = None,
                           drawn: torch.Tensor | None = None):
    """Batch-level dispatch. For label perturbations the caller passes
    `label_override` = labels gathered through the fixed tables above (they
    are index-table semantics, not key semantics, in the reference)."""
    if perturbation_type == "gaussian":
        return vit_gaussian_noise(key, images, epsilon, drawn), labels
    if perturbation_type == "uniform_gray":
        return vit_uniform_gray(images), labels
    if perturbation_type in ("label_shuffle", "target_noise"):
        return images, label_override
    return images, labels
