"""The port's batched forks (train/multi_fork.py): against the port's own
sequential forks, against the JAX package's batched sweep and lengths,
checkpoints that resume across packages and modes, the attention launches
of a lock-step, and the bookkeeping of both (mirroring the JAX package's
TestBatched* cases in tests/test_sweep_driver.py).

Both packages load one weights file (a tiny CLIP drawn by the JAX package)
and fork from one baseline tree written by the JAX package. Where the port
is held against JAX, JAX's perturbation draws and dropout keep-masks are fed
to the port by key path, as tests/test_torch_paradigm.py does. f32
throughout, dropout on."""
import csv
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.cli import lengths as jlengths
from vit_project_tpu.cli import sweep as jsweep
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.train import clip_loop as jloop
from vit_project_torch.ckpt import serialization as tser
from vit_project_torch.cli import lengths as tlengths
from vit_project_torch.cli import sweep as tsweep
from vit_project_torch.core.preempt import PreemptionGuard
from vit_project_torch.core.prng import Key
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.ops import attention as tattn
from vit_project_torch.ops import dora as tdora
from vit_project_torch.perturb import injectors as tinj
from vit_project_torch.train import clip_loop as tloop
from vit_project_torch.train import multi_fork as tmf

KW = dict(width=32, layers=2, heads=2, patch=32, image_size=64, embed_dim=16,
          vocab=49408, context=16)
SEED = 7   # --perturb_seed of every fork below
SETUP = tmf._Setup   # the real one (tests below stub it)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic THINGS (60 train images, 48 inference, RDM .mat) and one
    OpenAI-format weights file drawn by the JAX package (the data of
    tests/test_torch_paradigm.py)."""
    from PIL import Image
    import pandas as pd
    import scipy.io
    root = tmp_path_factory.mktemp("forks")
    img_dir = root / "images"
    os.makedirs(img_dir)
    rs = np.random.RandomState(0)
    names = [f"thing_{i:03d}.png" for i in range(60)]
    for n in names:
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)) \
            .save(img_dir / n)
    for path, rows in ((root / "train.csv", names), (root / "val.csv",
                                                     names[:48])):
        df = pd.DataFrame({"image_name": rows})
        for j in range(66):
            df[f"d{j}"] = (rs.rand(len(rows)) * 2).astype(np.float32)
        df.to_csv(path)
    rdm = rs.rand(48, 48)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    scipy.io.savemat(root / "rdm.mat", {"RDM48_triplet": rdm})
    params = jclip.init_clip_params(jax.random.PRNGKey(0),
                                    jclip.tiny_clip_config(**KW))
    sd = tconvert.clip_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params),
        tclip.tiny_clip_config(**KW))
    torch.save(sd, root / "tiny_clip.pt")
    return {"root": root, "csv_file": str(root / "train.csv"),
            "img_dir": str(img_dir),
            "inference_csv_file": str(root / "val.csv"),
            "RDM48_triplet_dir": str(root / "rdm.mat"),
            "weights": str(root / "tiny_clip.pt")}


@pytest.fixture(scope="module")
def baseline(data, tmp_path_factory):
    """The JAX package's 2-epoch baseline (dropout 0.1): forks at runs 1, 2
    and 3 start fresh, from its epoch 1 and from its epoch 2, so their
    AdamW step counts differ (0, 3 and 6)."""
    out = str(tmp_path_factory.mktemp("jax_baseline"))
    cfg = {k: data[k] for k in ("csv_file", "img_dir", "inference_csv_file",
                                "RDM48_triplet_dir")}
    cfg.update({
        "clip_weights": data["weights"], "allow_hash_tokenizer": True,
        "epochs": 2, "batch_size": 20, "train_portion": 0.8, "lr": 3e-4,
        "logger": None, "early_stopping_patience": 20,
        "checkpoint_path": os.path.join(out, "model.ckpt"),
        "training_res_path": os.path.join(out, "training_res.csv"),
        "dora_parameters_path": os.path.join(out, "dora_params"),
        "random_state_path": os.path.join(out, "random_states"),
        "random_seed": 1, "vision_layers": 2, "transformer_layers": 1,
        "rank": 4, "criterion": "mse", "cuda": 0,
        "perturb_type": "baseline", "perturb_length": 0,
        "perturb_distribution": "target", "perturb_seed": 42,
        "training_run": 0, "compute_dtype": "float32"})
    assert jloop.run_behavioral_training(cfg)["last_epoch0"] == 1
    return out


def _common(data, baseline, out):
    return ["--csv_file", data["csv_file"], "--img_dir", data["img_dir"],
            "--inference_csv_file", data["inference_csv_file"],
            "--RDM48_triplet_dir", data["RDM48_triplet_dir"],
            "--clip_weights", data["weights"], "--allow_hash_tokenizer",
            "--epochs", "3", "--batch_size", "20", "--random_seed", "1",
            "--vision_layers", "2", "--transformer_layers", "1",
            "--rank", "4", "--perturb_seed", str(SEED),
            "--baseline_dora_directory",
            os.path.join(baseline, "dora_params"),
            "--baseline_random_state_path",
            os.path.join(baseline, "random_states"),
            "--baseline_split_indices_path",
            os.path.join(baseline, "random_states",
                         "dataset_split_indices.pth"),
            "--output_base_directory", out, "--compute_dtype", "float32"]


def _sweep_argv(data, baseline, out, kind, order, *extra):
    return _common(data, baseline, out) + [
        "--perturb_type", kind, "--training_order", order, *extra]


def _lengths_argv(data, baseline, out, length, *extra):
    return _common(data, baseline, out) + [
        "--perturb_type", "random_target", "--perturb_length", str(length),
        *extra]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _run_rows(out, run):
    return _rows(os.path.join(out, f"training_run{run}",
                              f"training_res_run{run}.csv"))


def _cond_rows(out, name):
    return _rows(os.path.join(out, name, "training_res.csv"))


def _close(a, b, loss_rtol, rho_atol):
    """Same epoch and flags; losses within `loss_rtol` relative; rho within
    `rho_atol`."""
    assert a[0] == b[0] and a[5:] == b[5:], (a, b)
    for i in (1, 2):
        d = abs(float(a[i]) - float(b[i]))
        assert d <= loss_rtol * abs(float(b[i])), (i, a, b)
    assert abs(float(a[3]) - float(b[3])) <= rho_atol, (a, b)


def _close_rows(got, want, loss_rtol, rho_atol):
    assert got[0] == want[0] and len(got) == len(want), (got, want)
    for a, b in zip(got[1:], want[1:]):
        _close(a, b, loss_rtol, rho_atol)


def _leaves(tree, prefix=""):
    """{path: array} of a nested checkpoint tree (dicts, tuples, optax
    states)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if hasattr(tree, "_fields"):
        return _leaves(tuple(tree), prefix)
    if isinstance(tree, (np.ndarray, np.generic, int, float)):
        return {prefix: np.asarray(tree)}
    return {}


def _ckpt_leaves(run_dir, sub, name):
    path = os.path.join(run_dir, sub, name)
    if name.endswith("_dora_params.pth"):
        return {k: v.numpy() for k, v in tser.load_flat(path).items()}
    state = tser.load(path)
    return {**_leaves(state["optimizer_state"], "opt"),
            "data_seed": np.asarray(state["data_seed"])}


def _assert_trees_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
        assert float(np.abs(g - w).max(initial=0.0)) <= tol * scale, k


# -- batched against sequential, in the port ----------------------------------

NAN_KEY = (SEED + 2 * 1000, 1)   # run 2's perturbation draw for batch 1


def test_batched_sweep_equals_sequential(data, baseline, tmp_path,
                                         monkeypatch):
    """Runs 1, 2 and 3 (AdamW step counts 0, 3 and 6 at the fork) as one
    group of 3 against the sequential sweep, dropout on, random_target's
    draw for run 2's batch 1 made non-finite: the same CSV rows (losses
    within 1e-5 relative, rho within 1e-4), the same checkpoints within
    1e-6 (the skipped batch leaves run 2 one step behind in both), and the
    same keep-mask for every key path, bit for bit."""
    masks = {}
    draw, keep = tinj.draw_clip, tdora.dropout_keep_mask

    def nan_draw(kind, key, rows, images, targets):
        d = draw(kind, key, rows, images, targets)
        if key.path == NAN_KEY:
            d = d.clone()
            d[0, 0] = float("nan")
        return d

    def record(shape, p, key, device):
        m = keep(shape, p, key, device)
        masks.setdefault(mode, {})[key.path] = m
        return m
    monkeypatch.setattr(tinj, "draw_clip", nan_draw)
    monkeypatch.setattr(tdora, "dropout_keep_mask", record)
    outs = {}
    for mode, extra in (("seq", ()), ("bat", ("--batched_forks", "3"))):
        outs[mode] = str(tmp_path / mode)
        assert tsweep.main(_sweep_argv(
            data, baseline, outs[mode], "random_target", "1,2,3",
            "--device", "cpu", *extra)) == []
    assert masks["bat"].keys() == masks["seq"].keys()
    assert all(torch.equal(masks["bat"][k], m)
               for k, m in masks["seq"].items())
    for run in (1, 2, 3):
        want = _run_rows(outs["seq"], run)
        assert [r[0] for r in want[1:]] == [str(e) for e in range(run, 4)]
        _close_rows(_run_rows(outs["bat"], run), want, 1e-5, 1e-4)
        for sub, fmt in ((f"dora_params_run{run}", "epoch{}_dora_params.pth"),
                         (f"random_states_run{run}",
                          "epoch{}_random_states.pth")):
            for e in range(run, 4):
                _assert_trees_close(
                    _ckpt_leaves(os.path.join(outs["bat"],
                                              f"training_run{run}"),
                                 sub, fmt.format(e)),
                    _ckpt_leaves(os.path.join(outs["seq"],
                                              f"training_run{run}"),
                                 sub, fmt.format(e)), 1e-6)
    counts = {run: int(tser.load(os.path.join(
        outs["bat"], f"training_run{run}", f"random_states_run{run}",
        "epoch3_random_states.pth"))["optimizer_state"][0].count)
        for run in (1, 2, 3)}
    assert counts == {1: 9, 2: 8, 3: 9}   # run 2 skipped one batch


# -- against the JAX package's batched sweep and lengths ----------------------

@pytest.fixture()
def jax_draws(monkeypatch):
    """Feed JAX's perturbation draws and dropout keep-masks to the port, by
    the port's key paths (which fold JAX's integers in JAX's order)."""
    def draw_clip(kind, key, rows, images, targets):
        seed, batch = key.path
        k = jax.random.fold_in(jax.random.PRNGKey(seed), batch)
        if kind == "random_target":
            d = jax.random.normal(k, (rows, *targets.shape[1:]), jnp.float32)
        elif kind == "label_shuffle":
            d = jax.random.uniform(k, (rows,))
        elif kind == "image_noise":
            d = jax.random.normal(k, (rows, *images.shape[1:]), jnp.float32)
        else:
            return None
        return torch.from_numpy(np.array(d))

    def keep_mask(shape, p, key, device):
        seed, epoch, batch, tower, block = key.path
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  epoch), batch)
        k = jax.random.fold_in(jax.random.split(k)[tower], block)
        return torch.from_numpy(np.array(
            jax.random.bernoulli(k, 1.0 - p, tuple(shape))))
    monkeypatch.setattr(tinj, "draw_clip", draw_clip)
    monkeypatch.setattr(tdora, "dropout_keep_mask", keep_mask)


@pytest.fixture(scope="module")
def jax_trees(data, baseline, tmp_path_factory):
    """The JAX package's batched sweep and lengths on the CPU, as its own
    tests/test_sweep_driver.py runs them: a sweep of runs 2 and 3 of
    image_noise in one group, and the lengths grid at onsets 2 and 3,
    length 1 and then length 2 (which resumes across runs from length 1).
    Returns their output directories (the lengths tree is the one after
    length 1, copied aside before length 2)."""
    out = {"sweep": str(tmp_path_factory.mktemp("jax_sweep")),
           "lengths": str(tmp_path_factory.mktemp("jax_lengths"))}
    assert jsweep.main(_sweep_argv(data, baseline, out["sweep"],
                                   "image_noise", "2,3",
                                   "--batched_forks", "2")) == []
    assert jlengths.main(_lengths_argv(
        data, baseline, out["lengths"], 1, "--onsets", "2,3",
        "--batched_forks", "2")) == []
    out["lengths_l1"] = str(tmp_path_factory.mktemp("jax_lengths_l1"))
    shutil.copytree(out["lengths"], out["lengths_l1"], dirs_exist_ok=True)
    assert jlengths.main(_lengths_argv(
        data, baseline, out["lengths"], 2, "--onsets", "2,3",
        "--batched_forks", "2")) == []
    return out


CONDS = [f"random_target_e{e}_l{ln}" for ln in (1, 2) for e in (2, 3)]


def test_batched_sweep_matches_jax(data, baseline, jax_trees, jax_draws,
                                   tmp_path):
    """image_noise runs 2 and 3 as one group, JAX's draws and masks fed in:
    each fork's rows within 2e-4 relative on the losses and 2e-3 on rho of
    JAX's batched sweep (the tolerances of the solo forks against JAX)."""
    out = str(tmp_path / "port")
    assert tsweep.main(_sweep_argv(data, baseline, out, "image_noise", "2,3",
                                   "--batched_forks", "2", "--device",
                                   "cpu")) == []
    for run in (2, 3):
        want = _run_rows(jax_trees["sweep"], run)
        assert [r[0] for r in want[1:]] == [str(e) for e in range(run, 4)]
        assert want[1][8] == "True"     # used_image_noise in the window
        _close_rows(_run_rows(out, run), want, 2e-4, 2e-3)


def test_batched_lengths_match_jax_and_resume_across(data, baseline,
                                                     jax_trees, jax_draws,
                                                     tmp_path):
    """The port's batched lengths, length 1 then 2, against JAX's (2e-4 and
    2e-3); the second invocation resumes each condition across runs from
    its length-1 sibling, and a third adds no row. JAX's batched length-1
    tree resumes in the port's batched lengths, and the port's batched
    length-1 checkpoints resume in JAX's solo lengths CLI and in the
    port's: each gives JAX's length-2 rows."""
    port = str(tmp_path / "port")
    for length in (1, 2):
        assert tlengths.main(_lengths_argv(
            data, baseline, port, length, "--onsets", "2,3",
            "--batched_forks", "2", "--device", "cpu")) == []
    for name in CONDS:
        _close_rows(_cond_rows(port, name),
                    _cond_rows(jax_trees["lengths"], name), 2e-4, 2e-3)
    assert _cond_rows(port, "random_target_e2_l2")[1] == \
        _cond_rows(port, "random_target_e2_l1")[1]   # pre-populated
    assert os.listdir(os.path.join(port, "random_target_e2_l2",
                                   "dora_params_2")) == \
        ["epoch3_dora_params.pth"]
    before = {n: _cond_rows(port, n) for n in CONDS}
    assert tlengths.main(_lengths_argv(
        data, baseline, port, 2, "--onsets", "2,3", "--batched_forks", "2",
        "--device", "cpu")) == []
    assert {n: _cond_rows(port, n) for n in CONDS} == before

    # JAX's batched length-1 tree, resumed by the port's batched lengths
    from_jax = str(tmp_path / "from_jax")
    shutil.copytree(jax_trees["lengths_l1"], from_jax)
    assert tlengths.main(_lengths_argv(
        data, baseline, from_jax, 2, "--onsets", "2,3", "--batched_forks",
        "2", "--device", "cpu")) == []
    # the port's batched length-1 tree, resumed by both solo CLIs at onset 2
    want = _cond_rows(jax_trees["lengths"], "random_target_e2_l2")
    for cli, extra in ((jlengths, ()), (tlengths, ("--device", "cpu"))):
        solo = str(tmp_path / f"solo_{cli.__name__.split('.')[0]}")
        shutil.copytree(port, solo)
        shutil.rmtree(os.path.join(solo, "random_target_e2_l2"))
        cli.main(_lengths_argv(
            data, baseline, solo, 2, "--perturb_epoch", "2", "--output_dir",
            "random_target_e2_l2", *extra))
        _close_rows(_cond_rows(solo, "random_target_e2_l2"), want, 2e-4,
                    2e-3)
    for name in ("random_target_e2_l2", "random_target_e3_l2"):
        _close_rows(_cond_rows(from_jax, name),
                    _cond_rows(jax_trees["lengths"], name), 2e-4, 2e-3)


# -- the attention launches of a lock-step ------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_lock_step_launches_the_solo_step_kernels(cached):
    """At 3 blocks a tower (2 visual and 1 text adapted): one lock-step batch
    calls flash3_fwd 6 times on the full tower and 3 times from the cache,
    and flash3_bwd once, at R = 1 and at R = 3 alike: the forks reach the
    kernels' batch, not a loop over forks. The rows equal the solo steps'."""
    from vit_project_torch.adapters import dora as tadora
    cfg = tclip.tiny_clip_config(width=32, layers=3, heads=2, patch=16,
                                 image_size=32, embed_dim=16, vocab=49408,
                                 context=8)
    model = tclip.init_clip_weights_(tclip.empty_clip(cfg, "cpu"),
                                     torch.Generator().manual_seed(0))
    spec = tadora.dora_spec(3, 3, 2, 1)
    init, static, acfg = tadora.apply_dora(
        model, spec, r=4, alpha=16, dropout=0.1,
        generator=torch.Generator().manual_seed(1))
    prompts = np.random.RandomState(0).randint(1, 400, (66, 8))
    tr = tloop.ClipHBATrainer(cfg, model, acfg, static, prompts, lr=1e-3,
                              compute_dtype=torch.float32)
    rs = np.random.RandomState(2)
    imgs, tgts = tr.upload_dataset(
        rs.randint(0, 255, (12, 32, 32, 3)).astype(np.uint8),
        rs.rand(12, 66).astype(np.float32))
    src = tr.build_prefix_cache(imgs) if cached else imgs
    tr.text_prefix_cache  # noqa: B018  (built before the step, once)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn.flash3_fwd, tattn.flash3_bwd

    def cfwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def cbwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    idxs = [np.arange(4) + 4 * f for f in range(3)]
    solo = []
    for f in range(3):
        t = tadora.make_trainable(init)
        solo.append(tr.train_step(t, tr.init_optimizer(t), src, tgts,
                                  idxs[f], Key((5, 0, 0)), cached=cached)[0])
    for R in (1, 3):
        trs = [tadora.make_trainable(init) for _ in range(R)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tattn, "flash3_fwd", cfwd)
            mp.setattr(tattn, "flash3_bwd", cbwd)
            calls.update(fwd=0, bwd=0)
            losses, oks = tr.train_step_forks(
                trs, [tr.init_optimizer(t) for t in trs], src, tgts,
                idxs[:R], [Key((5, 0, 0))] * R, cached=cached)
        assert calls == {"fwd": 3 if cached else 6, "bwd": 1}, (R, calls)
        assert oks == [True] * R and losses == solo[:R]


# -- the bookkeeping (JAX's TestBatched* cases) -----------------------------

def _stub_setup(tmp_path, fail_label=None, calls=None):
    class StubSetup:
        def __init__(self, base_config, logger, group_size=1, device=None):
            self.cfg = types.SimpleNamespace(
                perturb_length=1, perturb_type="random_target",
                baseline_dora_directory=str(tmp_path / "base_dora"),
                baseline_random_state_path=str(tmp_path / "base_rs"),
                epochs=30)
            self.log = lambda msg: None

        def load_state(self, label, dora_file, rs_dir, rfe, *,
                       require=False):
            if calls is not None:
                calls.append({"label": label, "dora_file": dora_file,
                              "rfe": rfe, "require": require})
            if fail_label and label.startswith(fail_label):
                raise RuntimeError("checkpoint unreadable")
            return (None, None, 0)
    return StubSetup


def _finish(seen):
    def run_group(su, forks, inits, guard=None):
        seen.append([f.label for f in forks])
        for f in forks:
            f.finished = True
        return {"lock_steps": 1, "live": len(forks), "rider": 0}
    return run_group


def test_duplicate_runs_collapse_into_ascending_groups(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(tmf, "_Setup", _stub_setup(tmp_path))
    monkeypatch.setattr(tmf, "_run_group", _finish(seen))
    assert tmf.run_batched_sweep({"output_base_directory": str(tmp_path)},
                                 [5, 2, 5, 9, 2], group_size=2) == []
    assert seen == [["2", "5"], ["9"]]


@pytest.mark.parametrize("which", ["sweep", "lengths"])
def test_init_failure_is_isolated_to_its_fork(tmp_path, monkeypatch,
                                              which):
    seen = []
    monkeypatch.setattr(tmf, "_run_group", _finish(seen))
    base = {"output_base_directory": str(tmp_path)}
    if which == "sweep":
        monkeypatch.setattr(tmf, "_Setup", _stub_setup(tmp_path, "run 5"))
        assert tmf.run_batched_sweep(base, [5, 2], group_size=8) == [5]
        assert seen == [["2"]]
    else:
        monkeypatch.setattr(tmf, "_Setup",
                            _stub_setup(tmp_path, "random_target_e8"))
        assert tmf.run_batched_lengths(base, [3, 8], 1, group_size=8) == \
            ["random_target_e8_l1"]
        assert seen == [["random_target_e3_l1"]]


@pytest.mark.parametrize("which", ["sweep", "lengths"])
def test_a_group_failure_reports_only_unfinished_forks(tmp_path, monkeypatch,
                                                       which):
    def crash(su, forks, inits, guard=None):
        forks[-1].finished = True      # the last fork wrote its whole tree
        raise RuntimeError("boom")
    monkeypatch.setattr(tmf, "_Setup", _stub_setup(tmp_path))
    monkeypatch.setattr(tmf, "_run_group", crash)
    base = {"output_base_directory": str(tmp_path)}
    if which == "sweep":
        done = []
        assert tmf.run_batched_sweep(base, [5, 2], group_size=8,
                                     done_report=done.extend) == [2]
        assert done == [5]
    else:
        assert tmf.run_batched_lengths(base, [3, 8], 1, group_size=8) == \
            ["random_target_e3_l1"]


class _TripAfter:
    """A guard whose collective poll trips at its n-th call."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def should_stop_collective(self):
        self.calls += 1
        return self.calls >= self.n


def test_preemption_between_groups_and_mid_group(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(tmf, "_Setup", _stub_setup(tmp_path))
    monkeypatch.setattr(tmf, "_run_group", _finish(seen))
    base = {"output_base_directory": str(tmp_path)}
    g = _TripAfter(1)
    assert tmf.run_batched_sweep(base, [1, 2, 3, 4], group_size=2,
                                 preempt_guard=g) == []
    assert seen == [["1", "2"]] and g.undispatched == [3, 4]
    g = _TripAfter(10)
    seen.clear()
    assert tmf.run_batched_lengths(base, [1, 2, 3], 1, group_size=2,
                                   preempt_guard=g) == []
    assert len(seen) == 2 and not getattr(g, "undispatched", None)

    def interrupted(su, forks, inits, guard=None):
        forks[0].finished = True
        return {"lock_steps": 1, "live": 2, "rider": 0, "interrupted": True}
    monkeypatch.setattr(tmf, "_run_group", interrupted)
    done, g = [], _TripAfter(10)
    assert tmf.run_batched_sweep(base, [1, 2, 3, 4], group_size=2,
                                 preempt_guard=g,
                                 done_report=done.extend) == []
    assert g.undispatched == [2, 3, 4] and done == [1]


def test_lengths_ladder_resumes_in_place_across_or_fresh(tmp_path,
                                                         monkeypatch):
    """In place from the condition's own anchored checkpoint; a torn tree
    (rows without checkpoints) falls through to the anchored shorter
    sibling; a missing checkpoint of a resumed trajectory is refused."""
    calls = []
    monkeypatch.setattr(tmf, "_Setup", _stub_setup(tmp_path, calls=calls))
    monkeypatch.setattr(tmf, "_run_group", _finish([]))
    cond = tmp_path / "random_target_e3_l2"
    os.makedirs(cond / "dora_params_3")
    (cond / "training_res.csv").write_text("epoch,train_loss\n3,0.5\n")
    prev = tmp_path / "random_target_e3_l1"
    for sub, f in (("dora_params_3", "epoch3_dora_params.pth"),
                   ("random_states_3", "epoch3_random_states.pth")):
        os.makedirs(prev / sub)
        (prev / sub / f).touch()
    base = {"output_base_directory": str(tmp_path)}
    assert tmf.run_batched_lengths(base, [3], 2) == []
    assert calls[-1] == {
        "label": "random_target_e3_l2", "rfe": 3, "require": True,
        "dora_file": str(prev / "dora_params_3" / "epoch3_dora_params.pth")}
    for sub, f in (("dora_params_3", "epoch3_dora_params.pth"),
                   ("random_states_3", "epoch3_random_states.pth")):
        os.makedirs(cond / sub, exist_ok=True)
        (cond / sub / f).touch()
    assert tmf.run_batched_lengths(base, [3], 2) == []
    assert calls[-1]["dora_file"] == str(
        cond / "dora_params_3" / "epoch3_dora_params.pth")
    fake = types.SimpleNamespace(cfg=None, log=lambda m: None,
                                 assets=types.SimpleNamespace(trainable=None))
    with pytest.raises(FileNotFoundError, match="torn artifact tree"):
        SETUP.load_state(fake, "run 5", str(tmp_path / "nope.pth"),
                              None, 4, require=True)


@pytest.mark.parametrize("whole_set", [True, False])
def test_eval_batching_matches_jax(whole_set):
    """eval_idx_mats: the whole set as one batch under 132,000 tokens, the
    cap divided by the forks a call runs (vmap_factor), as JAX's."""
    cfg = types.SimpleNamespace(visual=types.SimpleNamespace(seq_len=257))
    port = types.SimpleNamespace(cfg=cfg)
    jstub = types.SimpleNamespace(cfg=cfg, mesh=None)
    jstub._prep_idx_mat = types.MethodType(
        jloop.ClipHBATrainer._prep_idx_mat, jstub)
    for n, bs, factor in ((362, 64, 1), (362, 64, 2), (362, 64, 16),
                          (8, 4, 16), (100, 30, 3)):
        got = tloop.ClipHBATrainer.eval_idx_mats(
            types.SimpleNamespace(
                cfg=cfg, eval_batch_size=types.MethodType(
                    tloop.ClipHBATrainer.eval_batch_size, port)),
            n, bs, whole_set, factor)
        want = jloop.ClipHBATrainer.eval_idx_mats(jstub, n, bs, whole_set,
                                                  factor)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert tmf.per_chip_forks(8) == 8 and tmf.per_chip_forks(0) == 1


def test_collective_poll_is_local_in_one_process(monkeypatch):
    import torch.distributed as tdist
    g = PreemptionGuard()
    assert g.should_stop_collective() is False
    g.request()
    assert g.should_stop_collective() is True
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 1)
    assert g.should_stop_collective() is True
    # over several ranks: the flags are all-gathered, any one stops all
    from vit_project_torch.parallel import dist as pdist
    monkeypatch.setattr(tdist, "get_world_size", lambda: 4)
    monkeypatch.setattr(pdist, "collective_device",
                        lambda: torch.device("cpu"))
    others = [0.0, 0.0, 0.0]
    monkeypatch.setattr(pdist, "all_gather_rows", lambda t: torch.stack(
        [t, *(torch.tensor([f]) for f in others)]))
    assert g.should_stop_collective() is True
    assert g.should_stop() is False          # mid-epoch: one process only
    g2 = PreemptionGuard()
    assert g2.should_stop_collective() is False
    others[2] = 1.0
    assert g2.should_stop_collective() is True


# -- end to end: preemption, the image kind on the cache, the refusals --------

def test_mid_group_preemption_resumes_to_the_uninterrupted_rows(
        data, baseline, tmp_path, monkeypatch):
    """The guard trips at the first lock-step boundary: run 3 (one epoch
    left) has finished, run 2 holds its epoch-2 row and is left to
    re-dispatch; re-invoked, run 2 trains again from the baseline and its
    rows equal the uninterrupted group's."""
    def go(out, order, guard=None):
        cfg = tsweep.build_parser().parse_args(_sweep_argv(
            data, baseline, out, "random_target", order))
        base = {k: getattr(cfg, k) for k in (
            "csv_file", "img_dir", "inference_csv_file", "RDM48_triplet_dir",
            "clip_weights", "allow_hash_tokenizer", "epochs", "batch_size",
            "random_seed", "vision_layers", "transformer_layers", "rank",
            "perturb_type", "perturb_seed", "perturb_length",
            "baseline_dora_directory", "baseline_random_state_path",
            "baseline_split_indices_path", "output_base_directory",
            "compute_dtype")}
        return tmf.run_batched_sweep(base, [int(r) for r in order.split(",")],
                                     group_size=2, preempt_guard=guard,
                                     device="cpu")
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    assert go(whole, "2,3") == []
    g = _TripAfter(1)
    assert go(cut, "2,3", g) == []
    assert g.undispatched == [2]
    assert [r[0] for r in _run_rows(cut, 2)[1:]] == ["2"]
    assert _run_rows(cut, 3) == _run_rows(whole, 3)
    assert go(cut, "2") == []
    assert _run_rows(cut, 2) == _run_rows(whole, 2)


def test_preempted_lengths_group_resumes_in_place(data, baseline, tmp_path):
    """Onsets 1 and 2 at length 1 stopped at the first lock-step boundary:
    both conditions hold one row and their checkpoints, and the re-invoked
    group resumes each in place to the uninterrupted group's rows, bit for
    bit."""
    def go(out, guard=None):
        cfg = tlengths.build_parser().parse_args(_lengths_argv(
            data, baseline, out, 1, "--onsets", "1,2"))
        return tmf.run_batched_lengths(
            {**tlengths._base_config(cfg), "perturb_length": 1}, [1, 2], 1,
            group_size=2, preempt_guard=guard, device="cpu")
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    names = ["random_target_e1_l1", "random_target_e2_l1"]
    assert go(whole) == []
    g = _TripAfter(1)
    assert go(cut, g) == []
    assert g.undispatched == names
    assert [[r[0] for r in _cond_rows(cut, n)[1:]] for n in names] == \
        [["1"], ["2"]]
    assert go(cut) == []
    for n in names:
        assert _cond_rows(cut, n) == _cond_rows(whole, n)


def test_image_kind_runs_the_full_tower_under_the_cache(data, baseline,
                                                        tmp_path, capsys):
    """--frozen_cache with uniform_images: the group runs the full tower
    and says why; its rows equal the full-tower group's."""
    rows = {}
    for extra in ((), ("--frozen_cache",)):
        out = str(tmp_path / ("cache" if extra else "full"))
        assert tsweep.main(_sweep_argv(
            data, baseline, out, "uniform_images", "2,3", "--batched_forks",
            "2", "--device", "cpu", *extra)) == []
        rows[extra] = [_run_rows(out, r) for r in (2, 3)]
    assert "batched groups run the full tower" in capsys.readouterr().out
    assert rows[()] == rows[("--frozen_cache",)]
    assert rows[()][0][1][7] == "True"   # used_uniform_images at epoch 2


def test_batched_cli_needs_a_gpu_unless_told_otherwise(data, baseline,
                                                       tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.main(_sweep_argv(data, baseline, str(out), "random_target",
                                "2,3", "--batched_forks", "2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlengths.main(_lengths_argv(data, baseline, str(out), 1,
                                    "--onsets", "2,3"))
    assert not out.exists()
