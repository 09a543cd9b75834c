"""The port's compile check and multi-rank dry run (cli/dryrun.py) on the
CPU, against the JAX package's dry run and its trainer step.

One ``dryrun_multichip(4, device="cpu")`` launch serves the module: 4 gloo
ranks and the one-process oracle beside them, started from an environment
that holds a stale torchrun rendezvous (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), which the launch must not inherit. The tests
read its JSON line and printed summary. The dp section's loss is held to
the JAX package's ``ViTTrainer`` step with the same config and draws on a
4-device virtual mesh (tests/conftest.py), from the port's seeded initial
parameters carried into JAX's layout, within LOSS_RTOL (1e-4 relative,
tests/test_torch_parallel.py's bound between the packages' losses).
"""
import ast
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_torch.cli import dryrun as tdry
from vit_project_torch.data.imagenet import normalize_imagenet
from vit_project_torch.models import vit as tvit
from vit_project_torch.train import vit_loop as tloop

N = 4
LAUNCH_TIMEOUT = 240
LOSS_RTOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALE = {"RANK": "5", "WORLD_SIZE": "7", "LOCAL_RANK": "2",
         "MASTER_ADDR": "127.0.0.9", "MASTER_PORT": "1"}
# each section's loss, and the loss it must stay within its bound of
BOUNDS = {"dp": None, "fsdp": ("dp", tdry.LOSS_ATOL), "clip": None,
          "forks": None, "clip_sp_ring": None, "tp": ("dp", tdry.LOSS_ATOL),
          "sp": None, "sp_ring": ("sp", tdry.LOSS_ATOL), "ep": None,
          "pp": ("pp_oracle", tdry.LOSS_ATOL), "pp_oracle": None,
          "oracle": ("dp", tdry.ORACLE_ATOL)}


@pytest.fixture(scope="module")
def dry():
    """The launch's result dict and everything it printed."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in STALE.items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out):
            result = tdry.dryrun_multichip(N, device="cpu",
                                           timeout=LAUNCH_TIMEOUT)
    return result, out.getvalue()


@pytest.mark.parametrize("section", list(BOUNDS))
def test_section_loss_is_finite_and_within_its_bound(dry, section):
    """Every section ran on the 4 ranks (the oracle in its own process) and
    gave finite losses; the fsdp, tp, ring, pp and oracle losses stay
    within JAX's bounds of the loss they repeat."""
    result, _ = dry
    loss = result["losses"][section]
    assert np.isfinite(np.asarray(loss, np.float64)).all(), loss
    if section == "forks":
        assert np.shape(loss) == (N, 2)
    bound = BOUNDS[section]
    if bound is not None:
        ref, atol = bound
        assert abs(loss - result["losses"][ref]) <= atol, (
            section, loss, ref, result["losses"][ref])


@pytest.mark.parametrize("check", [
    "fsdp_sharded", "tp_qkv_split", "clip_step_ok", "clip_sp_ring_ok",
    "forks_shape", "ckpt_dp_zero1_own_shards", "ckpt_dp_zero1_bit_equal",
    "ckpt_fsdp_own_shards", "ckpt_fsdp_bit_equal", "oracle"])
def test_check_holds(dry, check):
    result, _ = dry
    assert result["checks"][check]["ok"], result["checks"][check]


def test_every_section_prints_and_the_summary_is_jax_s(dry):
    """The JSON line, then the repr line, then JAX's summary line with the
    port's sections, the oracle and the round trip."""
    result, text = dry
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("dryrun_dp_loss_repr="))
    assert json.loads(lines[i - 1]) == json.loads(json.dumps(result))
    assert float(lines[i].split("=", 1)[1]) == result["losses"]["dp"]
    summary = lines[i + 1]
    assert summary.startswith(f"dryrun_multichip({N}): ViT dp loss ")
    assert summary.endswith(" - OK")
    for words in ("fsdp equal", "one-process oracle equal", "CLIP dp loss",
                  f"{N} forks x 2 lock-steps", "ViT tp+dp loss",
                  "CLIP sp ring loss", "(ring equal)", "ViT ep+dp loss",
                  "ViT pp+dp loss", "(oracle equal)",
                  "sharded ckpt round-trip OK"):
        assert words in summary, words
    assert result["device"] == "cpu" and result["n"] == N
    assert len(result["launches"]) == N and len(result["oracle_launches"]) == 1
    # the shards' files: one a rank, each named for its rank
    for tree in ("dp_zero1", "fsdp"):
        assert sorted(result["ckpt"][tree]["bytes"]) == [
            f"__{r}_0.distcp" for r in range(N)]


def test_launch_ignores_the_callers_stale_rendezvous(dry):
    """The fixture's launch ran with RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT set to another (dead) group's values: its
    ranks made a group of 4 on a port of their own."""
    result, _ = dry
    assert result["checks"]["oracle"]["ok"]
    assert len(result["launches"]) == N
    assert all(os.environ.get(k) != v for k, v in STALE.items())


def test_dp_section_matches_the_jax_step(dry):
    """The dp section (grad_accum 2, zero1, global batch 8) against JAX's
    ViTTrainer step on a 4-device mesh from the same initial parameters
    and RandomState(0) draws."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.train import vit_loop as jloop
    result, _ = dry
    model = tdry.vit_model(tdry.VIT_TINY, "cpu")
    tree, _ = tloop._jax_trees(model, tloop.sgd_init(
        dict(model.named_parameters())))
    c = tdry.VIT_TINY
    jcfg = jvit.ViTConfig(patch=c.patch, width=c.width, layers=c.layers,
                          heads=c.heads, image_size=c.image_size,
                          num_classes=c.num_classes)
    mesh = jmesh.make_mesh(n_data=N, devices=jax.devices()[:N])
    trainer = jloop.ViTTrainer(jcfg, JTrainConfig(
        batch_size=2 * N, compute_dtype="float32", grad_accum=2, zero1=True),
        mesh)
    params = jmesh.replicate(mesh, jax.tree_util.tree_map(jnp.array, tree))
    buf = jmesh.shard_opt_state(mesh, jloop.sgd_init(params))
    d = tdry._draws(N)
    si, sl = trainer.shard(d["images"], d["labels"])
    _, _, loss = trainer._make_train_step(None)(
        params, buf, si, sl, tdry.LR, jax.random.PRNGKey(1), 0.1)
    want = float(loss)
    assert abs(result["losses"]["dp"] - want) <= LOSS_RTOL * abs(want), (
        result["losses"]["dp"], want)


def test_draws_are_jax_s():
    """The images, labels and CLIP draws are RandomState(0)'s, in the
    order and shapes of JAX's _dryrun_impl."""
    rs = np.random.RandomState(0)
    d = tdry._draws(N)
    np.testing.assert_array_equal(
        d["images"], rs.randint(0, 255, (2 * N, 64, 64, 3), np.uint8))
    np.testing.assert_array_equal(d["labels"],
                                  rs.randint(0, 10, 2 * N).astype(np.int32))
    np.testing.assert_array_equal(d["prompts"],
                                  rs.randint(1, 500, (66, 16)))
    np.testing.assert_array_equal(
        d["clip_images"], rs.randint(0, 255, (2 * N, 32, 32, 3), np.uint8))
    np.testing.assert_array_equal(d["clip_targets"],
                                  rs.rand(2 * N, 66).astype(np.float32))


def test_a_failing_rank_fails_the_call():
    """A failure planted in section fsdp on the last of 2 ranks: the call
    raises RuntimeError (torchrun stops the other rank)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tdry.FAIL_ENV, "fsdp")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            with pytest.raises(RuntimeError, match="launch failed"):
                tdry.dryrun_multichip(2, device="cpu",
                                      timeout=LAUNCH_TIMEOUT)
    assert "planted failure in section fsdp" in out.getvalue()


def test_no_card_raises_instead_of_running_on_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdry.dryrun_multichip(2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdry.entry()
    res = subprocess.run(
        [sys.executable, "-m", "vit_project_torch.cli.dryrun", "2",
         "--device", "cuda"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "dryrun_multichip(" not in res.stdout


def test_odd_n_of_four_or_more_is_refused():
    with pytest.raises(ValueError, match="even n"):
        tdry.dryrun_multichip(5, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        tdry.dryrun_multichip(0, device="cpu")


def test_entry_gives_the_classifier_s_logits():
    """entry() at test-tiny width on the CPU: logits [8, classes], equal to
    vit_classify called directly on the normalized images."""
    cfg = tvit.VIT_CONFIGS["test-tiny"]
    fn, (model, images) = tdry.entry(device="cpu", cfg=cfg)
    assert images.dtype == torch.uint8 and tuple(images.shape) == (
        8, cfg.image_size, cfg.image_size, 3)
    np.testing.assert_array_equal(
        images.numpy(), np.random.RandomState(0).randint(
            0, 255, (8, cfg.image_size, cfg.image_size, 3), np.uint8))
    logits = fn(model, images)
    assert tuple(logits.shape) == (8, cfg.num_classes)
    assert torch.isfinite(logits).all()
    with torch.no_grad():
        want = tvit.vit_classify(model, normalize_imagenet(images),
                                 compute_dtype=torch.bfloat16)
    assert torch.equal(logits, want)


def test_the_no_jax_import_check_covers_the_module():
    from test_torch_clip import _port_modules
    path = os.path.join(REPO, "vit_project_torch", "cli", "dryrun.py")
    assert path in {str(p) for p in _port_modules()}
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "torch" in names
    assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib",
                                                     "vit_project_tpu"}
    assert re.search(r"torch\.distributed\.run", open(path).read())
