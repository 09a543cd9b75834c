"""The port's CLIP-HBA training path against the JAX package: one training
step (loss, every adapter gradient, the post-AdamW values and state), the
NaN guard, a 3-epoch ``run_behavioral_training`` on a synthetic THINGS
fixture (file tree, CSV schema, trajectory), run-to-run determinism,
checkpoints resumed across packages in both directions, and the
``cli.baseline`` entry point on the CPU.

Both packages start from the same numbers: one weights file (a tiny CLIP at
the kernels' head width, 2 heads of 64, drawn by the JAX package and
written in OpenAI's layout) and the JAX package's initial DoRA adapters,
handed to the port. Dropout is 0 where the two packages are compared (their
dropout bits differ by design) and on where the port is compared with
itself. f32 throughout; JAX runs with jax_default_matmul_precision
"highest" (tests/conftest.py)."""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.data import things as jthings
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import convert as jconvert
from vit_project_tpu.train import clip_loop as jloop
from vit_project_torch.adapters import dora as tadora
from vit_project_torch.cli import baseline as tcli
from vit_project_torch.ckpt import clip_ckpt as tckpt
from vit_project_torch.models import convert as tconvert
from vit_project_torch.ops import attention as tattn
from vit_project_torch.ops import dora as tdora
from vit_project_torch.train import clip_loop as tloop

# 2 blocks per tower, width 128 = 2 heads of 64, 64 px images in 32 px
# patches (S = 5), 16-token prompts
JCFG = jclip.tiny_clip_config(width=128, layers=2, heads=2, patch=32,
                              image_size=64, embed_dim=32, vocab=49408,
                              context=16)
SEED = 1


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def things(tmp_path_factory):
    """Synthetic THINGS: 60 train images + 48 inference images + RDM .mat
    (the JAX package's fixture, tests/test_clip_training.py)."""
    from PIL import Image
    import pandas as pd
    import scipy.io
    root = tmp_path_factory.mktemp("things")
    img_dir = root / "images"
    os.makedirs(img_dir)
    rs = np.random.RandomState(0)
    names = []
    for i in range(60):
        name = f"thing_{i:03d}.png"
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)) \
            .save(img_dir / name)
        names.append(name)
    df = pd.DataFrame({"image_name": names})
    for j in range(66):
        df[f"d{j}"] = (rs.rand(60) * 2).astype(np.float32)
    df.to_csv(root / "spose_train.csv")
    inf = pd.DataFrame({"image_name": names[:48]})
    for j in range(66):
        inf[f"d{j}"] = (rs.rand(48) * 2).astype(np.float32)
    inf.to_csv(root / "spose_val.csv")
    rdm = rs.rand(48, 48)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    scipy.io.savemat(root / "RDM48_triplet.mat", {"RDM48_triplet": rdm})
    return {"csv_file": str(root / "spose_train.csv"),
            "img_dir": str(img_dir),
            "inference_csv_file": str(root / "spose_val.csv"),
            "RDM48_triplet_dir": str(root / "RDM48_triplet.mat")}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One OpenAI-format weights file both packages load."""
    params = jclip.init_clip_params(jax.random.PRNGKey(0), JCFG)
    cfg = tconvert.clip_config_from_state_dict(
        tconvert.clip_state_dict_from_jax_params(_np_tree(params),
                                                 _port_cfg()))
    sd = tconvert.clip_state_dict_from_jax_params(_np_tree(params), cfg)
    path = tmp_path_factory.mktemp("weights") / "tiny_clip.pt"
    torch.save(sd, path)
    return str(path)


def _port_cfg():
    from vit_project_torch.models import clip as tclip
    return tclip.tiny_clip_config(width=128, layers=2, heads=2, patch=32,
                                  image_size=64, embed_dim=32, vocab=49408,
                                  context=16)


def _jax_params(weights):
    sd = jconvert.load_torch_state_dict(weights)
    params, cfg = jconvert.clip_params_from_state_dict(sd)
    return jax.tree_util.tree_map(jnp.asarray, params), cfg


def _jax_adapters(params, cfg, n_vis=2, n_txt=2, r=4, seed=SEED + 123,
                  dropout=0.0):
    spec = jadora.dora_spec(cfg.visual.layers, cfg.text.layers, n_vis, n_txt)
    return jadora.apply_dora(params, spec, r=r, alpha=16, dropout=dropout,
                             key=jax.random.PRNGKey(seed))


# -- one step -----------------------------------------------------------------

class TestOneStep:
    B = 5

    @pytest.fixture(scope="class")
    def setup(self, weights):
        jparams, jcfg = _jax_params(weights)
        jtr, jst, acfg = _jax_adapters(jparams, jcfg)
        # move the adapters away from init so every gradient is generic
        jtr = jax.tree_util.tree_map(
            lambda x: x + 0.05 * jnp.sin(jnp.arange(x.size).reshape(x.shape)),
            jtr)
        rs = np.random.RandomState(3)
        prompts = rs.randint(1, 500, (6, jcfg.text.context_length))
        images = rs.randint(0, 256, (self.B, 64, 64, 3)).astype(np.uint8)
        targets = (rs.rand(self.B, 6) * 2).astype(np.float32)
        model = tconvert.clip_from_state_dict(
            tconvert.load_torch_state_dict(weights), "cpu")
        trainer = tloop.ClipHBATrainer(
            model.cfg, model, acfg,
            tconvert.adapters_from_jax(_np_tree(jst)), prompts, lr=1e-3,
            compute_dtype=torch.float32)
        return dict(jparams=jparams, jcfg=jcfg, jtr=jtr, jst=jst, acfg=acfg,
                    prompts=prompts, images=images, targets=targets,
                    trainer=trainer)

    def _jax_step(self, s, targets):
        jtrainer = jloop.ClipHBATrainer(s["jcfg"], s["jparams"], s["acfg"],
                                        s["jst"], s["prompts"], lr=1e-3,
                                        compute_dtype=jnp.float32)
        core = jtrainer._step_core("none")
        images = jthings.normalize_uint8(jnp.asarray(s["images"]))
        return core(s["jtr"], jtrainer.init_opt_state(s["jtr"]),
                    s["jparams"], s["jst"], images, jnp.asarray(targets),
                    jnp.ones(self.B), jax.random.PRNGKey(0),
                    jax.random.PRNGKey(1))

    def test_loss_grads_and_adamw_match_jax(self, setup, monkeypatch):
        """Loss at 1e-5 relative; each adapter gradient at 1e-4 of its
        largest |value| against jax.grad through the Pallas kernels
        (interpret mode); the post-AdamW adapters at 1e-6 and the moments
        at 1e-4 relative against JAX's _step_core. Every step runs the
        attention backward once per tower: image block 1 and the causal
        text block 1 take qkv that depends on block 0's adapter."""
        s = setup
        images = jthings.normalize_uint8(jnp.asarray(s["images"]))

        def jloss(tr):
            preds = jclip.clip_hba_forward(
                s["jparams"], images, jnp.asarray(s["prompts"]), s["jcfg"],
                adapters=jadora.assemble(tr, s["jst"]),
                adapter_cfg=s["acfg"], deterministic=True,
                compute_dtype=jnp.float32, use_pallas=True)
            return jnp.mean(jnp.mean((preds - s["targets"]) ** 2, axis=-1))
        jl, jgrads = jax.value_and_grad(jloss)(s["jtr"])
        new_tr, new_opt, loss, ok = self._jax_step(s, s["targets"])
        assert bool(ok)

        calls = []
        plain_bwd = tattn.flash3_bwd

        def counting_bwd(qkv, do, lse, num_heads, causal=False):
            calls.append(causal)
            return plain_bwd(qkv, do, lse, num_heads, causal)
        monkeypatch.setattr(tattn, "flash3_bwd", counting_bwd)

        trainer = s["trainer"]
        ttr = tadora.make_trainable(
            tconvert.adapters_from_jax(_np_tree(s["jtr"])))
        imgs_dev, tgts_dev = trainer.upload_dataset(s["images"], s["targets"])
        from vit_project_torch.data import things as tthings
        preds = trainer.forward(ttr, tthings.normalize_uint8(imgs_dev))
        tl = torch.mean(torch.mean((preds - tgts_dev) ** 2, dim=-1))
        tl.backward()
        assert sorted(calls) == [False, True]
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for tower, idx, name, leaf in tadora.trainable_leaves(ttr):
            want = np.asarray(jgrads[tower][idx][name])
            scale = np.abs(want).max()
            assert scale > 0
            np.testing.assert_allclose(leaf.grad.numpy(), want,
                                       atol=1e-4 * scale, rtol=0,
                                       err_msg=f"{tower}.{idx}.{name}")

        optimizer = trainer.init_optimizer(ttr)
        tloss, tok = trainer.train_step(ttr, optimizer, imgs_dev, tgts_dev,
                                        np.arange(self.B),
                                        tdora.DropoutKey.root(0))
        assert tok and abs(tloss - float(loss)) <= 1e-5 * float(loss)
        state = tckpt.optax_state_from_adamw(optimizer, ttr)
        assert int(state[0].count) == int(new_opt[0].count) == 1
        stepped = tconvert.adapters_to_jax(ttr)
        for tower, idx, name, _ in tadora.trainable_leaves(ttr):
            np.testing.assert_allclose(
                stepped[tower][idx][name], np.asarray(new_tr[tower][idx][name]),
                atol=1e-6, rtol=0)
            for got, want in ((state[0].mu, new_opt[0].mu),
                              (state[0].nu, new_opt[0].nu)):
                w = np.asarray(want[tower][idx][name])
                np.testing.assert_allclose(got[tower][idx][name], w,
                                           atol=1e-4 * np.abs(w).max(),
                                           rtol=0)

    def test_nan_guard_skips_the_update(self, setup):
        """A NaN target: no update, AdamW's step count unchanged (JAX's
        core reports the same batch as not ok); a finite batch then steps."""
        s = setup
        bad = s["targets"].copy()
        bad[2, 3] = np.nan
        assert not bool(self._jax_step(s, bad)[3])
        trainer = s["trainer"]
        ttr = tadora.make_trainable(
            tconvert.adapters_from_jax(_np_tree(s["jtr"])))
        before = {k: v.detach().clone() for k, v in
                  tadora.to_reference_names(ttr).items()}
        optimizer = trainer.init_optimizer(ttr)
        imgs_dev, tgts_dev = trainer.upload_dataset(s["images"], bad)
        loss, ok = trainer.train_step(ttr, optimizer, imgs_dev, tgts_dev,
                                      np.arange(self.B),
                                      tdora.DropoutKey.root(0))
        assert not ok and np.isnan(loss)
        for k, v in tadora.to_reference_names(ttr).items():
            assert torch.equal(v.detach(), before[k]), k
        assert int(tckpt.optax_state_from_adamw(optimizer, ttr)[0].count) == 0
        assert all(leaf.grad is None
                   for *_, leaf in tadora.trainable_leaves(ttr))
        _, ok = trainer.train_step(ttr, optimizer, imgs_dev, tgts_dev,
                                   np.arange(2), tdora.DropoutKey.root(0))
        assert ok
        assert int(tckpt.optax_state_from_adamw(optimizer, ttr)[0].count) == 1


# -- whole runs ---------------------------------------------------------------

def _config(things, weights, out, **over):
    cfg = {
        **things,
        "clip_weights": weights, "allow_hash_tokenizer": True,
        "epochs": 3, "batch_size": 16, "train_portion": 0.8, "lr": 3e-4,
        "logger": None, "early_stopping_patience": 20,
        "checkpoint_path": os.path.join(out, "model.ckpt"),
        "training_res_path": os.path.join(out, "training_res.csv"),
        "dora_parameters_path": os.path.join(out, "dora_params"),
        "random_state_path": os.path.join(out, "random_states"),
        "random_seed": SEED, "vision_layers": 2, "transformer_layers": 2,
        "rank": 4, "dora_dropout": 0.0, "criterion": "mse", "cuda": 0,
        "perturb_type": "baseline", "perturb_length": 0,
        "perturb_distribution": "target", "perturb_seed": 42,
        "training_run": 0, "compute_dtype": "float32",
    }
    cfg.update(over)
    return cfg


def _resume(cfg, src, epoch):
    """Resume `cfg` from the epoch-`epoch` files of the run in `src`."""
    return dict(cfg, resume_from_epoch=epoch,
                resume_dora_parameters_path=os.path.join(src, "dora_params"),
                resume_random_state_path=os.path.join(src, "random_states"),
                baseline_split_indices_path=os.path.join(
                    src, "random_states", "dataset_split_indices.pth"),
                previous_training_res_path=os.path.join(
                    src, "training_res.csv"))


def _run_port(cfg, weights, preempt_guard=None):
    """The port's run_behavioral_training on the CPU, starting from the
    JAX package's initial adapters for the same weights and seed."""
    jparams, jcfg = _jax_params(weights)
    jtr, jst, acfg = _jax_adapters(
        jparams, jcfg, cfg["vision_layers"], cfg["transformer_layers"],
        cfg["rank"], cfg["random_seed"] + 123, cfg["dora_dropout"])

    def apply_dora(model, spec, *, r, alpha=16, dropout=0.1, generator):
        assert r == acfg["r"] and dropout == acfg["dropout"]
        return (tconvert.adapters_from_jax(_np_tree(jtr)),
                tconvert.adapters_from_jax(_np_tree(jst)), dict(acfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadora, "apply_dora", apply_dora)
        return tloop.run_behavioral_training(cfg, device="cpu",
                                             preempt_guard=preempt_guard)


def _rows(cfg):
    with open(cfg["training_res_path"]) as f:
        return list(csv.reader(f))


def _tree(out):
    files = set()
    for d, _, names in os.walk(out):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), out)
            files.add("training_log.txt" if rel.startswith("training_log_")
                      else rel)
    return files


def _close(a, b, loss_rtol=2e-4, rho_atol=2e-3):
    """Loss columns within `loss_rtol` relative, rho and p within
    `rho_atol` (rank-based: a near-tie between two RDM entries can swap)."""
    assert a[0] == b[0] and a[5:] == b[5:]
    for i in (1, 2):
        assert abs(float(a[i]) - float(b[i])) <= loss_rtol * abs(float(b[i]))
    for i in (3, 4):
        assert abs(float(a[i]) - float(b[i])) <= rho_atol


@pytest.fixture(scope="module")
def jax_run(things, weights, tmp_path_factory):
    cfg = _config(things, weights, str(tmp_path_factory.mktemp("jax_run")))
    assert jloop.run_behavioral_training(cfg)["last_epoch0"] == 2
    return cfg


@pytest.fixture(scope="module")
def port_run(things, weights, tmp_path_factory):
    cfg = _config(things, weights, str(tmp_path_factory.mktemp("port_run")))
    res = _run_port(cfg, weights)
    assert res["last_epoch0"] == 2 and res["preempted"] is False
    return cfg


class TestBaselineRun:
    def test_same_files_schema_and_trajectory_as_jax(self, jax_run,
                                                     port_run):
        """The same file tree and CSV schema; each epoch's losses within
        2e-4 relative and rho, p within 2e-3 of the JAX run (f32, same
        weights, adapters, split, data order; two different attention
        implementations and optimizers for 3 epochs x 3 steps)."""
        out_j = os.path.dirname(jax_run["training_res_path"])
        out_t = os.path.dirname(port_run["training_res_path"])
        assert _tree(out_t) == _tree(out_j)
        assert "random_states/dataset_split_indices.pth" in _tree(out_t)
        rj, rt = _rows(jax_run), _rows(port_run)
        assert rt[0] == rj[0] and len(rt) == len(rj) == 4
        for a, b in zip(rt[1:], rj[1:]):
            _close(a, b)
            assert -1 <= float(a[3]) <= 1

    def test_two_runs_give_identical_csvs(self, things, weights, tmp_path):
        """Dropout on (p = 0.1): the port's dropout streams, data order and
        kernels replay bit for bit."""
        rows = []
        for name in ("a", "b"):
            cfg = _config(things, weights, str(tmp_path / name), epochs=2,
                          dora_dropout=0.1)
            _run_port(cfg, weights)
            rows.append(_rows(cfg))
        assert rows[0] == rows[1]

    def test_in_place_resume_is_bit_exact(self, things, weights, tmp_path):
        """Dropout on: a preemption after epoch 1, then an in-place resume,
        writes the uninterrupted run's CSV exactly."""
        ref = _config(things, weights, str(tmp_path / "ref"),
                      dora_dropout=0.1)
        _run_port(ref, weights)

        class Trip:
            def should_stop(self):
                return True
        out = str(tmp_path / "pre")
        cfg = _config(things, weights, out, dora_dropout=0.1)
        guard = Trip()
        res = _run_port(cfg, weights, guard)
        assert res["preempted"] is True and guard.stopped_at_epoch == 1
        assert [r[0] for r in _rows(cfg)[1:]] == ["1"]
        resumed = _resume(cfg, out, 1)
        resumed["previous_training_res_path"] = cfg["training_res_path"]
        _run_port(resumed, weights)
        assert _rows(resumed) == _rows(ref)


class TestCrossResume:
    def test_jax_to_port(self, things, weights, jax_run, tmp_path):
        """The port resumes from the JAX run's epoch-2 files (adapters,
        optax state, split, data seed): rows 1-2 are copied, row 3 agrees
        with JAX's within the run tolerances."""
        src = os.path.dirname(jax_run["training_res_path"])
        cfg = _resume(_config(things, weights, str(tmp_path / "t")), src, 2)
        _run_port(cfg, weights)
        rt, rj = _rows(cfg), _rows(jax_run)
        assert rt[:3] == rj[:3]
        _close(rt[3], rj[3])

    def test_port_to_jax(self, things, weights, port_run, tmp_path):
        """The JAX package resumes from the port's epoch-2 files: its
        optax-layout state pickle and torch-archive adapters load, and row 3
        agrees with the port's."""
        src = os.path.dirname(port_run["training_res_path"])
        cfg = _resume(_config(things, weights, str(tmp_path / "j")), src, 2)
        jloop.run_behavioral_training(cfg)
        rj, rt = _rows(cfg), _rows(port_run)
        assert rj[:3] == rt[:3]
        _close(rj[3], rt[3])


# -- entry point and refusals -------------------------------------------------

def test_cli_baseline_on_the_cpu(things, weights, tmp_path):
    out = tmp_path / "cli"
    tcli.main(["--csv_file", things["csv_file"], "--img_dir",
               things["img_dir"], "--inference_csv_file",
               things["inference_csv_file"], "--RDM48_triplet_dir",
               things["RDM48_triplet_dir"], "--clip_weights", weights,
               "--allow_hash_tokenizer", "--epochs", "1", "--batch_size",
               "16", "--vision_layers", "2", "--transformer_layers", "2",
               "--rank", "4", "--compute_dtype", "float32", "--device", "cpu",
               "--output_dir", str(out)])
    names = sorted(os.listdir(out))
    csvs = [n for n in names if n.startswith("training_res_")]
    assert len(csvs) == 1
    with open(out / csvs[0]) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2 and rows[1][0] == "1"
    dora = [n for n in names if n.startswith("dora_params_")][0]
    assert os.listdir(out / dora) == ["epoch1_dora_params.pth"]
    states = [n for n in names if n.startswith("random_states_")][0]
    assert sorted(os.listdir(out / states)) == [
        "dataset_split_indices.pth", "epoch1_random_states.pth"]


def test_cli_runs_on_the_gpu_unless_told_otherwise(things, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--csv_file", things["csv_file"], "--img_dir", "x",
                   "--inference_csv_file", "x", "--RDM48_triplet_dir", "x"])


@pytest.mark.parametrize("over,feature", [
    ({"sp_devices": 2}, "launch with torchrun"),
])
def test_unported_options_name_their_slice(things, weights, tmp_path, over,
                                           feature):
    """Sequence parallelism (ported, tests/test_torch_sp.py) shards the
    visual tower over the ranks of a process group: one process refuses it
    before writing anything."""
    cfg = _config(things, weights, str(tmp_path), **over)
    with pytest.raises(ValueError, match=feature):
        tloop.run_behavioral_training(cfg, device="cpu")
    assert not os.path.exists(cfg["training_res_path"])
