"""The port's perturbation injectors and perturbation keys against the JAX
package's (perturb/injectors.py, core/prng.py).

Each injector is held against JAX's with JAX's draws fed in: JAX pads a
batch to the configured batch size and draws at that padded shape, the
port draws at [batch_size, ...] and keeps the first n rows, so the port's
transform of JAX's padded draw must equal JAX's result on the n valid rows
(exactly: the transforms are one multiply-add, a gather or a fill in
float32). The port's own draws are pure functions of (perturb_seed, run,
batch) and differ across batches and runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.perturb import injectors as jinj
from vit_project_torch.core import prng as tprng
from vit_project_torch.perturb import injectors as tinj

BATCH = 8   # the configured batch size (JAX's padded width)
N = 5       # the valid rows of a trailing partial batch
MEAN, STD = 0.7, 0.45


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randn(BATCH, 16, 16, 3).astype(np.float32)
    targets = (rs.rand(BATCH, 66) * 2).astype(np.float32)
    return images, targets


def _jax_draw(kind, key, images, targets):
    """The arrays JAX's injectors draw from `key` at the padded shape."""
    if kind == "random_target":
        return jax.random.normal(key, targets.shape, jnp.float32)
    if kind == "label_shuffle":
        return jax.random.uniform(key, (targets.shape[0],))
    if kind == "image_noise":
        return jax.random.normal(key, images.shape, jnp.float32)
    return None


@pytest.mark.parametrize("distribution", ["target", "normal"])
@pytest.mark.parametrize("kind", ["random_target", "label_shuffle",
                                  "uniform_images", "image_noise", "none"])
def test_clip_injector_matches_jax_on_the_valid_rows(kind, distribution):
    images, targets = _batch()
    valid = (np.arange(BATCH) < N).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(42 + 3 * 1000), 2)
    want_i, want_t = jinj.apply_clip_perturbation(
        kind, key, jnp.asarray(images), jnp.asarray(targets),
        distribution=distribution, mean=MEAN, std=STD,
        valid=jnp.asarray(valid))
    drawn = _jax_draw(kind, key, images, targets)
    got_i, got_t = tinj.apply_clip_perturbation(
        kind, None, torch.from_numpy(images[:N]),
        torch.from_numpy(targets[:N]), distribution=distribution, mean=MEAN,
        std=STD, rows=BATCH,
        drawn=None if drawn is None else torch.from_numpy(np.array(drawn)))
    assert got_i.shape == (N, 16, 16, 3) and got_t.shape == (N, 66)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i)[:N])
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t)[:N])


def test_label_shuffle_is_a_permutation_of_the_valid_rows():
    _, targets = _batch(1)
    got = tinj.shuffle_targets(torch.from_numpy(targets[:N]),
                               torch.rand(BATCH, generator=torch.Generator()
                                          .manual_seed(0)))
    assert sorted(map(tuple, got.numpy())) == sorted(map(tuple, targets[:N]))


@pytest.mark.parametrize("kind", ["random_target", "label_shuffle",
                                  "image_noise"])
def test_draws_are_pure_per_seed_run_and_batch(kind):
    """The same (perturb_seed, run, batch) draws the same numbers (a fork
    re-running a batch reproduces the uninterrupted run's perturbation);
    another batch index or another run draws others."""
    images, targets = (torch.from_numpy(a) for a in _batch())

    def draw(seed, run, b):
        return tinj.draw_clip(kind, tprng.batch_perturb_key(seed, run, b),
                              BATCH, images, targets)
    a = draw(42, 3, 5)
    assert a.shape[0] == BATCH
    assert torch.equal(a, draw(42, 3, 5))
    assert not torch.equal(a, draw(42, 3, 6))
    assert not torch.equal(a, draw(42, 4, 5))
    assert not torch.equal(a, draw(43, 3, 5))


def test_perturb_keys_follow_the_reference_seed_arithmetic():
    """perturb_seed + training_run * 1000, the batch index folded in and the
    epoch not (JAX core/prng.py:27-44)."""
    assert tprng.perturb_base_key(42, 3) == tprng.key_from_seed(3042)
    assert tprng.perturb_base_key(1042, 2) == tprng.perturb_base_key(42, 3)
    assert tprng.batch_perturb_key(42, 3, 7) == \
        tprng.perturb_base_key(42, 3).fold_in(7)
    # ops/dora.py keeps its name for the dropout stream's key
    from vit_project_torch.ops import dora as tdora
    assert tdora.DropoutKey is tprng.Key


def test_image_kinds_and_stats_match_jax():
    assert tinj.IMAGE_KINDS == jinj.IMAGE_KINDS
    emb = np.random.RandomState(2).rand(30, 66).astype(np.float32)
    for dist in ("target", "normal"):
        assert tinj.perturb_distribution_stats(emb, dist) == \
            jinj.perturb_distribution_stats(emb, dist)


@pytest.mark.parametrize("kind", ["gaussian", "uniform_gray",
                                  "label_shuffle", "target_noise", None])
def test_vit_injector_matches_jax(kind):
    images, _ = _batch(3)
    labels = np.arange(BATCH) % 10
    override = jinj.random_target_table(BATCH, 10)[labels]
    key = jax.random.PRNGKey(5)
    want_i, want_l = jinj.apply_vit_perturbation(
        kind, key, jnp.asarray(images), jnp.asarray(labels), epsilon=0.2,
        label_override=jnp.asarray(override))
    drawn = jax.random.normal(key, images.shape, jnp.float32)
    got_i, got_l = tinj.apply_vit_perturbation(
        kind, None, torch.from_numpy(images), torch.from_numpy(labels),
        epsilon=0.2, label_override=torch.from_numpy(override),
        drawn=torch.from_numpy(np.array(drawn)))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_vit_index_tables_match_jax():
    np.testing.assert_array_equal(tinj.shuffled_label_table(50, 7),
                                  jinj.shuffled_label_table(50, 7))
    np.testing.assert_array_equal(tinj.random_target_table(50, 1000, 9),
                                  jinj.random_target_table(50, 1000, 9))
    a = tinj.vit_gaussian_noise(tprng.key_from_seed(1),
                                torch.zeros(2, 4, 4, 3))
    assert torch.equal(a, tinj.vit_gaussian_noise(tprng.key_from_seed(1),
                                                  torch.zeros(2, 4, 4, 3)))
