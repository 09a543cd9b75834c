"""The port's paradigm drivers against the JAX package's: sweep forks of the
four perturbation kinds from one baseline tree, the frozen-prefix cache,
remat, repeated forks, the per-epoch embedding dumps and the category-RDM
archive, and the lengths CLI's resume ladder.

Both packages load one weights file (a tiny CLIP drawn by the JAX package,
written in OpenAI's layout) and fork from one baseline tree written by the
JAX package. JAX's random draws are fed to the port: the perturbation draws
(``perturb.injectors.draw_clip``) and the ΔD dropout keep-masks
(``ops.dora.dropout_keep_mask``) are computed by JAX from the port's key
paths, which fold the same integers in the same order as JAX's keys. f32
throughout; JAX at "highest" matmul precision (tests/conftest.py)."""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.analysis import category_rdms as jrdms
from vit_project_tpu.cli import sweep as jsweep
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.train import clip_loop as jloop
from vit_project_torch.adapters import dora as tadora
from vit_project_torch.analysis import category_rdms as trdms
from vit_project_torch.cli import lengths as tlengths
from vit_project_torch.cli import sweep as tsweep
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.ops import dora as tdora
from vit_project_torch.perturb import injectors as tinj
from vit_project_torch.train import clip_loop as tloop

KW = dict(width=32, layers=2, heads=2, patch=32, image_size=64, embed_dim=16,
          vocab=49408, context=16)
KINDS = ["random_target", "label_shuffle", "uniform_images", "image_noise"]
NOD = [f"{c}_{i}.png" for c in ("apple", "pear", "plum") for i in range(3)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic THINGS (60 train images, 48 inference, RDM .mat), a NOD
    set of 3 categories, and one OpenAI-format weights file."""
    from PIL import Image
    import pandas as pd
    import scipy.io
    root = tmp_path_factory.mktemp("paradigm")
    img_dir = root / "images"
    os.makedirs(img_dir)
    rs = np.random.RandomState(0)
    names = [f"thing_{i:03d}.png" for i in range(60)]
    for n in names + NOD:
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)) \
            .save(img_dir / n)
    for path, rows in ((root / "train.csv", names), (root / "val.csv",
                                                     names[:48])):
        df = pd.DataFrame({"image_name": rows})
        for j in range(66):
            df[f"d{j}"] = (rs.rand(len(rows)) * 2).astype(np.float32)
        df.to_csv(path)
    pd.DataFrame({"image_name": NOD}).to_csv(root / "nod.csv", index=False)
    rdm = rs.rand(48, 48)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    scipy.io.savemat(root / "rdm.mat", {"RDM48_triplet": rdm})
    params = jclip.init_clip_params(jax.random.PRNGKey(0),
                                    jclip.tiny_clip_config(**KW))
    sd = tconvert.clip_state_dict_from_jax_params(
        _np_tree(params), tclip.tiny_clip_config(**KW))
    torch.save(sd, root / "tiny_clip.pt")
    return {"root": root, "csv_file": str(root / "train.csv"),
            "img_dir": str(img_dir),
            "inference_csv_file": str(root / "val.csv"),
            "RDM48_triplet_dir": str(root / "rdm.mat"),
            "nod_csv_file": str(root / "nod.csv"),
            "weights": str(root / "tiny_clip.pt")}


@pytest.fixture()
def jax_draws(monkeypatch):
    """Feed JAX's perturbation draws and dropout keep-masks to the port."""
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


def _run_config(data, out, **over):
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
        "training_run": 0, "compute_dtype": "float32",
        "dump_inference_embeddings": True,
        "inference_dump_dir": os.path.join(out, "things_48_inference_results"),
        "nod_csv_file": data["nod_csv_file"],
        "nod_dump_dir": os.path.join(out, "nod_inference_results")})
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def baseline(data, tmp_path_factory):
    """The JAX package's 2-epoch baseline (dropout 0.1, embedding dumps and
    the NOD set on): the tree every fork below starts from."""
    out = str(tmp_path_factory.mktemp("jax_baseline"))
    cfg = _run_config(data, out)
    assert jloop.run_behavioral_training(cfg)["last_epoch0"] == 1
    return cfg


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _sweep_argv(data, baseline, out, kind, *extra):
    base = os.path.dirname(baseline["training_res_path"])
    return ["--csv_file", data["csv_file"], "--img_dir", data["img_dir"],
            "--inference_csv_file", data["inference_csv_file"],
            "--RDM48_triplet_dir", data["RDM48_triplet_dir"],
            "--clip_weights", data["weights"], "--allow_hash_tokenizer",
            "--epochs", "3", "--batch_size", "20", "--random_seed", "1",
            "--vision_layers", "2", "--transformer_layers", "1",
            "--rank", "4", "--perturb_type", kind, "--perturb_seed", "7",
            "--baseline_dora_directory", os.path.join(base, "dora_params"),
            "--baseline_random_state_path",
            os.path.join(base, "random_states"),
            "--baseline_split_indices_path",
            os.path.join(base, "random_states", "dataset_split_indices.pth"),
            "--output_base_directory", out, "--training_order", "2",
            "--compute_dtype", "float32", *extra]


def _fork_rows(out):
    return _rows(os.path.join(out, "training_run2", "training_res_run2.csv"))


@pytest.fixture(scope="module")
def forks(data, baseline, tmp_path_factory):
    """Memoized sweep forks (run 2, epochs 2-3) -> CSV rows: ('jax', kind)
    and ('port', kind, flag...). A port fork with `fed=True` runs under the
    `jax_draws` fixture, else on the port's own draws and masks."""
    done = {}

    def get(package, kind, *extra, fed=False):
        key = (package, kind, extra, fed)
        if key not in done:
            assert fed == (tinj.draw_clip.__module__ != tinj.__name__)
            out = str(tmp_path_factory.mktemp("fork"))
            if package == "jax":
                assert jsweep.main(_sweep_argv(data, baseline, out,
                                               kind)) == []
            else:
                assert tsweep.main(_sweep_argv(data, baseline, out, kind,
                                               "--device", "cpu",
                                               *extra)) == []
            done[key] = _fork_rows(out)
        return done[key]
    return get


# the largest slope of the Spearman p-value in rho over the 1,128 RDM pairs
# (at rho = 0: 2 * pdf_t(0) * sqrt(n - 2) = 0.798 * 33.56)
P_SLOPE = 26.8


def _close(a, b, loss_rtol, rho_atol):
    """Same epoch and flags; losses within `loss_rtol` relative, rho within
    `rho_atol`, and p within what rho's difference moves it (P_SLOPE) plus
    `rho_atol` (the JAX package takes betainc in float32)."""
    assert a[0] == b[0] and a[5:] == b[5:], (a, b)
    for i in (1, 2):
        assert abs(float(a[i]) - float(b[i])) <= loss_rtol * abs(float(b[i])), \
            (i, a, b)
    d_rho = abs(float(a[3]) - float(b[3]))
    assert d_rho <= rho_atol, (a, b)
    assert abs(float(a[4]) - float(b[4])) <= P_SLOPE * d_rho + rho_atol, (a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_fork_matches_jax_sweep(forks, jax_draws, kind):
    """A sweep fork at run 2 (perturbed epoch 2, clean epoch 3) from the JAX
    baseline's epoch-1 files, JAX's draws and masks fed in: the full-tower
    and the frozen-cache fork each agree with JAX's sweep within 2e-4
    relative on the losses and 2e-3 on rho (as the baseline run in
    tests/test_torch_training.py: two attention implementations and
    optimizers over 3 steps an epoch), and the cached fork with the
    full-tower one within 1e-5 (image kinds run the full tower in epoch
    2)."""
    want = forks("jax", kind, fed=True)
    full = forks("port", kind, fed=True)
    cached = forks("port", kind, "--frozen_cache", fed=True)
    assert [r[0] for r in want[1:]] == ["2", "3"]
    flag = 5 + KINDS.index(kind)
    assert [r[flag] for r in want[1:]] == ["True", "False"]
    assert full[0] == cached[0] == want[0]
    for a, b, c in zip(full[1:], cached[1:], want[1:]):
        _close(a, c, 2e-4, 2e-3)
        _close(b, a, 1e-5, 1e-5)


@pytest.mark.parametrize("extra", [(), ("--frozen_cache",)])
def test_remat_fork_gives_equal_bits(forks, extra):
    """--remat (dropout on): the same CSV, bit for bit."""
    assert forks("port", "label_shuffle", "--remat", *extra) == \
        forks("port", "label_shuffle", *extra)


@pytest.mark.parametrize("kind", ["random_target", "image_noise"])
def test_repeated_fork_gives_an_identical_csv(data, baseline, forks,
                                              tmp_path, kind):
    """The port's own draws and masks (nothing fed in): a fork run twice
    writes the same CSV."""
    out = str(tmp_path / "again")
    assert tsweep.main(_sweep_argv(data, baseline, out, kind, "--device",
                                   "cpu", "--frozen_cache")) == []
    assert _fork_rows(out) == forks("port", kind, "--frozen_cache")


def _files(out):
    return sorted(
        os.path.relpath(os.path.join(d, n), out) for d, _, names in
        os.walk(out) for n in names if not n.startswith("training_log_"))


def test_dumps_and_archive_match_jax(data, baseline, jax_draws, tmp_path):
    """A port baseline from the JAX baseline's initial adapters, JAX's masks
    fed in: the same file tree (dumps, archive, checkpoints); dump files
    with JAX's columns, names and values within 2e-4 of the largest
    embedding; the archive's keys and categories equal, its RDMs within
    2e-3."""
    from vit_project_tpu.adapters import dora as jadora
    from vit_project_tpu.models import convert as jconvert
    out = str(tmp_path / "port")
    cfg = _run_config(data, out)
    sd = jconvert.load_torch_state_dict(data["weights"])
    jparams, jcfg = jconvert.clip_params_from_state_dict(sd)
    spec = jadora.dora_spec(jcfg.visual.layers, jcfg.text.layers, 2, 1)
    jtr, jst, acfg = jadora.apply_dora(
        jax.tree_util.tree_map(jnp.asarray, jparams), spec, r=4, alpha=16,
        dropout=0.1, key=jax.random.PRNGKey(1 + 123))

    def apply_dora(model, spec, *, r, alpha=16, dropout=0.1, generator):
        return (tconvert.adapters_from_jax(_np_tree(jtr)),
                tconvert.adapters_from_jax(_np_tree(jst)), dict(acfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tadora, "apply_dora", apply_dora)
        tloop.run_behavioral_training(cfg, device="cpu")
    jout = os.path.dirname(baseline["training_res_path"])
    assert _files(out) == _files(jout)
    assert "hba_nod_category_rdms_dict.npz" in _files(out)
    for rel in _files(out):
        if not rel.endswith(".csv") or "embeddings" not in rel:
            continue
        got, want = _rows(os.path.join(out, rel)), _rows(
            os.path.join(jout, rel))
        assert got[0] == want[0] and [r[0] for r in got] == \
            [r[0] for r in want]
        g = np.array([r[1:] for r in got[1:]], np.float64)
        w = np.array([r[1:] for r in want[1:]], np.float64)
        np.testing.assert_allclose(g, w, atol=2e-4 * np.abs(w).max(), rtol=0)
    a = np.load(os.path.join(out, "hba_nod_category_rdms_dict.npz"))
    b = np.load(os.path.join(jout, "hba_nod_category_rdms_dict.npz"))
    assert sorted(a.files) == sorted(b.files) == \
        ["categories", "epoch1", "epoch2"]
    assert list(a["categories"]) == list(b["categories"]) == \
        ["apple", "pear", "plum"]
    for k in ("epoch1", "epoch2"):
        np.testing.assert_allclose(a[k], b[k], atol=2e-3, rtol=0)


def test_dump_writer_and_archive_reader_match_jax(tmp_path):
    """The same array and names: the port's dump file is byte for byte
    JAX's (pandas) file, and the port's build_category_rdms reads JAX's dumps
    into JAX's archive."""
    emb = np.random.RandomState(3).randn(9, 66).astype(np.float32)
    emb[0, :3] = [1e6, 1e-7, -0.0]
    tloop.dump_embeddings(str(tmp_path / "t"), 4, emb, NOD, prefix="nod")
    jloop._dump_embeddings(str(tmp_path / "j"), 4, emb, NOD, prefix="nod")
    name = "nod_embeddings_epoch4.csv"
    assert (tmp_path / "t" / name).read_bytes() == \
        (tmp_path / "j" / name).read_bytes()
    tloop.dump_embeddings(str(tmp_path / "j"), 5, emb * 2, NOD, prefix="nod")
    got = trdms.build_category_rdms(str(tmp_path / "j"))
    want = jrdms.build_category_rdms(str(tmp_path / "j"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- the lengths CLI ----------------------------------------------------------

def _lengths(data, baseline, base, length, epochs, kind="random_target"):
    src = os.path.dirname(baseline["training_res_path"])
    tlengths.main([
        "--perturb_type", kind, "--perturb_epoch", "2",
        "--perturb_length", str(length), "--perturb_seed", "7",
        "--output_dir", f"{kind}_e2_l{length}", "--epochs", str(epochs),
        "--batch_size", "20", "--random_seed", "1",
        "--baseline_dora_directory", os.path.join(src, "dora_params"),
        "--baseline_random_state_path", os.path.join(src, "random_states"),
        "--baseline_split_indices_path",
        os.path.join(src, "random_states", "dataset_split_indices.pth"),
        "--output_base_directory", base,
        "--csv_file", data["csv_file"], "--img_dir", data["img_dir"],
        "--inference_csv_file", data["inference_csv_file"],
        "--RDM48_triplet_dir", data["RDM48_triplet_dir"],
        "--clip_weights", data["weights"], "--allow_hash_tokenizer",
        "--vision_layers", "2", "--transformer_layers", "1", "--rank", "4",
        "--compute_dtype", "float32", "--device", "cpu", "--frozen_cache"])
    return _rows(os.path.join(base, f"{kind}_e2_l{length}",
                              "training_res.csv"))


def test_lengths_resume_ladder(data, baseline, tmp_path):
    """e2_l2 three ways write the same CSV: fresh from the baseline's epoch
    1; across runs, from the e2_l1 sibling (its epoch-2 row and checkpoints,
    then epoch 3 perturbed); and in place (2 epochs, then re-invoked for
    3)."""
    fresh = _lengths(data, baseline, str(tmp_path / "a"), 2, 3)
    assert [r[0] for r in fresh[1:]] == ["2", "3"]
    assert [r[5] for r in fresh[1:]] == ["True", "True"]

    l1 = _lengths(data, baseline, str(tmp_path / "b"), 1, 3)
    assert [r[5] for r in l1[1:]] == ["True", "False"]
    crossed = _lengths(data, baseline, str(tmp_path / "b"), 2, 3)
    assert crossed[1] == l1[1]  # pre-populated from the shorter sibling
    assert os.listdir(tmp_path / "b" / "random_target_e2_l2" /
                      "dora_params_2") == ["epoch3_dora_params.pth"]
    assert crossed == fresh

    first = _lengths(data, baseline, str(tmp_path / "c"), 2, 2)
    assert first == fresh[:2]
    assert _lengths(data, baseline, str(tmp_path / "c"), 2, 3) == fresh


def test_lengths_baseline_mode(data, baseline, tmp_path):
    rows = _lengths(data, baseline, str(tmp_path), 0, 2, kind="baseline")
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert all(r[5:] == ["False"] * 4 for r in rows[1:])


def test_worker_processes_aggregate_failures(data, baseline, tmp_path,
                                             monkeypatch):
    """--workers 2 dispatches run 2 and run 9 to two worker processes
    (`python -m vit_project_torch.cli.sweep`, no pinning on the CPU): run 9's
    directory is a file, so it fails inside its worker, and the dispatcher
    reports [9] while run 2 trains."""
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = tmp_path / "workers"
    os.makedirs(out)
    (out / "training_run9").write_text("not a directory")
    argv = _sweep_argv(data, baseline, str(out), "random_target", "--device",
                       "cpu", "--workers", "2", "--worker_device_env", "none")
    argv[argv.index("--training_order") + 1] = "2,9"
    assert tsweep.main(argv) == [9]
    assert [r[0] for r in _fork_rows(str(out))[1:]] == ["2", "3"]
    assert json.loads((out / "worker0_done.json").read_text()) == [2]
    assert json.loads((out / "worker1_failed.json").read_text()) == [9]
    assert os.path.exists(out / "worker1.log")


def test_analysis_tools_read_a_port_tree(data, baseline, tmp_path,
                                         monkeypatch):
    """A clip_results tree in the reference layout whose sweep, per-type and
    lengths CSVs the port wrote (forks at run 2, lengths e2_l1 and e2_l2;
    the JAX baseline's CSV as its baseline): the port's copies of figs,
    parity and manifest give the JAX package's results on it."""
    import shutil
    import pandas as pd
    from vit_project_tpu.analysis import figs as jfigs
    from vit_project_tpu.analysis import manifest as jmanifest
    from vit_project_tpu.analysis import parity as jparity
    from vit_project_torch.analysis import figs as tfigs
    from vit_project_torch.analysis import manifest as tmanifest
    from vit_project_torch.analysis import parity as tparity
    root = tmp_path / "clip_results"
    sweep_dir = root / jparity.SWEEP_DIRNAME
    lengths_dir = root / jparity.LENGTHS_DIRNAME
    os.makedirs(sweep_dir)
    shutil.copyfile(baseline["training_res_path"],
                    root / jparity.BASELINE_NAME)
    for kind, type_dir in (("random_target", "target_noise"),
                           ("label_shuffle", "label_shuffle")):
        out = tmp_path / kind
        assert tsweep.main(_sweep_argv(data, baseline, str(out), kind,
                                       "--device", "cpu",
                                       "--frozen_cache")) == []
        os.makedirs(root / type_dir)
        shutil.copyfile(out / "training_run2" / "training_res_run2.csv",
                        root / type_dir / "training_res_run2.csv")
        if kind == "random_target":
            shutil.copytree(out / "training_run2",
                            sweep_dir / "training_run2")
    for length in (1, 2):
        _lengths(data, baseline, str(lengths_dir), length, 3)
    for mod in (jparity, tparity):
        monkeypatch.setattr(mod, "FIG2_EPOCHS", [2])
    base = str(root / jparity.BASELINE_NAME)
    type_dirs = {t: str(root / t) for t in ("target_noise", "label_shuffle")}
    for name, args in (("clip_trajectory", (base,)),
                       ("sweep_deltas", (base, str(sweep_dir))),
                       ("perturbation_type_deltas", (base, type_dirs, [2])),
                       ("recovery_table", (base, str(lengths_dir)))):
        want = getattr(jfigs, name)(*args)
        assert len(want) > 0, name
        pd.testing.assert_frame_equal(getattr(tfigs, name)(*args), want)
    reports = {}
    for label, mod in (("jax", jparity), ("port", tparity)):
        out = tmp_path / f"report_{label}"
        rep = mod.build_report(str(root), None, str(out))
        rep["artifacts"] = [os.path.relpath(a, out) if os.path.isabs(a)
                            else a for a in rep["artifacts"]]
        reports[label] = rep
    assert reports["port"] == reports["jax"]
    assert reports["jax"]["stats"]["recovery"]["conditions_ours"] == 2
    trees = {"sweep": str(sweep_dir), "lengths": str(lengths_dir)}
    assert tmanifest.tree_manifest(trees) == jmanifest.tree_manifest(trees)
