"""The port's ViT measurement grid against the JAX package: the per-epoch RSA
evaluation (``cli.vit_rsa_eval``) and the single-epoch perturbation grid
(``cli.vit_measure``, all four perturbation types) on checkpoints that the
JAX package's ``run_vit_training`` wrote, the unperturbed replay of a
port-trained baseline, the CSV schema and summary table, and the skips and
refusals.

Inputs are made with numpy from fixed seeds (the JAX package's own fixtures,
tests/test_vit_training.py). float32 throughout; JAX runs with
jax_default_matmul_precision "highest" (tests/conftest.py), its Pallas
attention in interpret mode. The gaussian cell is fed JAX's draws; the
label tables are numpy in both packages and so exact."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from vit_project_tpu.core import csvio as jcsv
from vit_project_tpu.core import prng as jprng
from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
from vit_project_tpu.models import vit as jvit
from vit_project_torch.cli import vit_measure as tmeasure
from vit_project_torch.cli import vit_rsa_eval as trsa
from vit_project_torch.core import csvio as tcsv
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.models import vit as tvit
from vit_project_torch.perturb import injectors as tinj
from vit_project_torch.train import vit_loop as tloop

TYPES = ("gaussian", "uniform_gray", "label_shuffle", "target_noise")
BACKBONE = "test-tiny-3"
# the JAX package's test-tiny with 3 classes (its grid test's model)
JTINY = jvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)
TTINY = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)
# float32 in another summation order over one epoch of 6 SGD steps and the
# 24-image validation: the JAX package's own bound between its training
# paths (tests/test_vit_training.py, grad_accum against the unsplit step)
LOSS_RTOL = 1e-4
# rho over 1,128 RDM pairs: the tiny random model's RDM entries lie close
# together, so embeddings that differ in the last float32 bits reorder
# near-tied pairs (on one checkpoint the two packages' rho differ by 2.6e-5,
# after the perturbed epoch by up to 4.8e-5)
RHO_ATOL = 2e-4


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """Tiny ImageFolder: 3 classes x 16 train + 8 val PNGs at 48x48."""
    from PIL import Image
    root = tmp_path_factory.mktemp("imagenet")
    rs = np.random.RandomState(0)
    for split, n in (("train", 16), ("val", 8)):
        for cls in ("apple", "banana", "cherry"):
            d = root / split / cls
            os.makedirs(d)
            for i in range(n):
                Image.fromarray(rs.randint(0, 255, (48, 48, 3),
                                           dtype=np.uint8)).save(d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def things48(tmp_path_factory):
    """48 THINGS-style images, their CSV and a symmetric random RDM."""
    from PIL import Image
    import scipy.io
    root = tmp_path_factory.mktemp("things48")
    img_dir = root / "imgs"
    os.makedirs(img_dir)
    rs = np.random.RandomState(1)
    names = []
    for i in range(48):
        n = f"v{i:02d}.png"
        Image.fromarray(rs.randint(0, 255, (48, 48, 3),
                                   dtype=np.uint8)).save(img_dir / n)
        names.append(n)
    pd.DataFrame({"image_name": names}).to_csv(root / "things.csv",
                                               index=False)
    rdm = rs.rand(48, 48)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    scipy.io.savemat(root / "rdm.mat", {"RDM48_triplet": rdm})
    return ["--things_csv", str(root / "things.csv"),
            "--things_img_dir", str(img_dir),
            "--things_rdm_path", str(root / "rdm.mat")]


def _tiny(cfg_cls, data, out, epochs=2):
    return cfg_cls(data_path=data, output_dir=out, batch_size=8, epochs=epochs,
                   lr=0.01, warmup_epochs=1, num_workers=2, num_classes=3,
                   image_size=32, compute_dtype="float32", random_seed=0)


@pytest.fixture(scope="module")
def backbone():
    """The tiny backbone registered under one name in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_CONFIGS, BACKBONE, JTINY)
        mp.setitem(tvit.VIT_CONFIGS, BACKBONE, TTINY)
        yield BACKBONE


@pytest.fixture(scope="module")
def jax_run(imagenet, tmp_path_factory):
    """A 2-epoch baseline written by the JAX package."""
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    out = str(tmp_path_factory.mktemp("jax_run") / "run")
    jrun(_tiny(JTrainConfig, imagenet, out), vit_cfg=JTINY)
    return out


def _rsa_args(ckpt_dir, out_csv, things):
    return ["--checkpoint_dir", ckpt_dir, "--output_csv", out_csv,
            "--backbone", BACKBONE, "--compute_dtype", "float32", *things]


@pytest.fixture(scope="module")
def rsa_rows(jax_run, things48, backbone, tmp_path_factory):
    """Both packages' vit_rsa_eval on the JAX baseline's checkpoints."""
    from vit_project_tpu.cli import vit_rsa_eval as jrsa
    root = tmp_path_factory.mktemp("rsa")
    paths = {"jax": str(root / "jax" / "rsa_results.csv"),
             "port": str(root / "port" / "rsa_results.csv")}
    jrsa.main(_rsa_args(jax_run, paths["jax"], things48))
    trsa.main(_rsa_args(jax_run, paths["port"], things48) +
              ["--device", "cpu"])
    return {k: pd.read_csv(p) for k, p in paths.items()}, paths


def _jax_gaussian(key, images, epsilon=0.1, drawn=None):
    """The port's gaussian injector fed JAX's draw for the same (seed,
    epoch, batch) key path: the port's Key folds the batch index into
    perturb_seed + epoch * 1000, as JAX's batch_perturb_key does."""
    base, batch_idx = key.path
    jkey = jprng.batch_perturb_key(base, 0, batch_idx)
    drawn = jax.random.normal(jkey, tuple(images.shape), jnp.float32)
    return torch.from_numpy(np.array(drawn)) * epsilon


def _measure_args(jax_run, baseline_csv, imagenet, out_csv, things):
    return ["--baseline_checkpoint_dir", jax_run,
            "--baseline_metrics_csv", baseline_csv,
            "--data_path", imagenet, "--output_csv", out_csv, *things,
            "--perturbation_types", *TYPES, "--perturb_epochs", "1",
            "--batch_size", "8", "--num_workers", "2",
            "--backbone", BACKBONE, "--compute_dtype", "float32",
            "--total_epochs", "3", "--warmup_epochs", "1", "--lr", "0.01"]


@pytest.fixture(scope="module")
def grid(jax_run, rsa_rows, imagenet, things48, backbone, tmp_path_factory):
    """Both packages' vit_measure over the four types at perturb epoch 1,
    each against its own rsa_results.csv."""
    from vit_project_tpu.cli import vit_measure as jmeasure
    _, rsa_paths = rsa_rows
    root = tmp_path_factory.mktemp("grid")
    out = {"jax": str(root / "jax" / "perturbation_effects.csv"),
           "port": str(root / "port" / "perturbation_effects.csv")}
    jmeasure.main(_measure_args(jax_run, rsa_paths["jax"], imagenet,
                                out["jax"], things48))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinj, "vit_gaussian_noise", _jax_gaussian)
        results = tmeasure.main(_measure_args(
            jax_run, rsa_paths["port"], imagenet, out["port"], things48) +
            ["--device", "cpu"])
    return out, results


# -- the per-epoch RSA evaluation ---------------------------------------------

def test_rsa_eval_matches_jax(rsa_rows):
    """Columns, checkpoints, epochs and the checkpoints' own metrics equal;
    rho within RHO_ATOL."""
    rows, _ = rsa_rows
    got, want = rows["port"], rows["jax"]
    assert list(got.columns) == ["checkpoint", "epoch", "train_loss",
                                 "val_loss", "val_acc", "rsa_score"]
    assert list(got.columns) == list(want.columns)
    assert list(got["checkpoint"]) == ["checkpoint_epoch_000",
                                       "checkpoint_epoch_001"]
    for col in ("checkpoint", "epoch", "train_loss", "val_loss", "val_acc"):
        assert list(got[col]) == list(want[col]), col
    np.testing.assert_allclose(got["rsa_score"], want["rsa_score"], rtol=0,
                               atol=RHO_ATOL)


def test_rsa_eval_refuses_an_empty_dir_and_orbax(things48, backbone,
                                                  tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no checkpoint_epoch_"):
        trsa.main(_rsa_args(str(empty), str(tmp_path / "r.csv"), things48) +
                  ["--device", "cpu"])
    os.makedirs(tmp_path / "pod" / "checkpoint_epoch_000.orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        trsa.list_epoch_checkpoints(str(tmp_path / "pod"))


# -- the grid -----------------------------------------------------------------

def test_grid_schema_and_summary_match_jax(grid):
    out, results = grid
    got = pd.read_csv(out["port"], float_precision="round_trip")
    want = pd.read_csv(out["jax"])
    assert list(got.columns) == list(want.columns) == jcsv.MEASURE_HEADERS
    assert list(got["perturbation_type"]) == list(TYPES)
    assert list(got["perturb_epoch"]) == [1] * 4
    assert [r["perturbation_type"] for r in results] == list(TYPES)
    for r in results:
        assert r["delta_loss"] == r["perturbed_loss"] - r["baseline_loss"]
        assert r["delta_rsa"] == r["perturbed_rsa"] - r["baseline_rsa"]
    # the CSV holds the rows' floats (repr round-trips)
    np.testing.assert_array_equal(
        got.drop(columns="perturbation_type").to_numpy(),
        [[r[k] for k in jcsv.MEASURE_HEADERS if k != "perturbation_type"]
         for r in results])
    assert np.isfinite(got.drop(columns="perturbation_type").to_numpy()).all()
    names = ("perturbation_summary_table.csv",)
    sg, sw = (pd.read_csv(os.path.join(os.path.dirname(out[k]), names[0]))
              for k in ("port", "jax"))
    assert list(sg.columns) == list(sw.columns) == [
        "perturb_epoch", "perturbation_type", "delta_loss", "delta_rsa",
        "baseline_loss", "baseline_rsa"]
    assert list(sg["perturbation_type"]) == list(sw["perturbation_type"])
    # 4-decimal projections of values within the tolerances below
    np.testing.assert_allclose(sg[["baseline_loss", "delta_loss"]],
                               sw[["baseline_loss", "delta_loss"]],
                               rtol=0, atol=1e-4 + 5e-4)
    np.testing.assert_allclose(sg[["baseline_rsa", "delta_rsa"]],
                               sw[["baseline_rsa", "delta_rsa"]],
                               rtol=0, atol=1e-4 + 2 * RHO_ATOL)


@pytest.mark.parametrize("ptype", TYPES)
def test_grid_row_matches_jax(grid, ptype):
    """One cell of each type: the baseline columns come from each package's
    rsa_results.csv, the perturbed loss within LOSS_RTOL, rho within
    RHO_ATOL."""
    out, _ = grid
    got, want = (pd.read_csv(out[k]).set_index("perturbation_type")
                 .loc[ptype] for k in ("port", "jax"))
    assert got["baseline_loss"] == want["baseline_loss"]
    np.testing.assert_allclose(got["baseline_rsa"], want["baseline_rsa"],
                               rtol=0, atol=RHO_ATOL)
    np.testing.assert_allclose(got["perturbed_loss"], want["perturbed_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["perturbed_rsa"], want["perturbed_rsa"],
                               rtol=0, atol=RHO_ATOL)


def test_measure_csv_writer_matches_jax(tmp_path):
    rows = [{"perturb_epoch": 5, "perturbation_type": "gaussian",
             "baseline_loss": 2.302585092994, "baseline_rsa": 0.125,
             "perturbed_loss": 2.5, "perturbed_rsa": -1.5e-7,
             "delta_loss": 0.197414907006, "delta_rsa": -0.1250001}]
    jcsv.write_measure_csv(str(tmp_path / "j" / "m.csv"), rows)
    tcsv.write_measure_csv(str(tmp_path / "t" / "m.csv"), rows)
    assert tcsv.MEASURE_HEADERS == jcsv.MEASURE_HEADERS
    assert (tmp_path / "t" / "m.csv").read_bytes() == \
        (tmp_path / "j" / "m.csv").read_bytes()


def test_missing_checkpoint_or_baseline_row_is_skipped(jax_run, rsa_rows):
    rows, _ = rsa_rows
    for epoch in (99, 0):
        # 99: no baseline row; 0: a row whose epoch -1 checkpoint is missing
        assert tmeasure.measure_perturbation_effect(
            epoch, "gaussian", None, jax_run, rows["port"], None, None,
            None, None, {}, 0.1) is None


def test_measure_refuses_a_batch_the_ranks_do_not_divide(monkeypatch,
                                                         tmp_path):
    """Over several ranks --batch_size is the global batch, split evenly
    (the 2-rank grid itself: tests/test_torch_parallel.py)."""
    import contextlib
    from vit_project_torch.parallel import dist as pdist
    monkeypatch.setattr(pdist, "process_group",
                        lambda device: contextlib.nullcontext((1, 3)))
    pd.DataFrame({"epoch": [1]}).to_csv(tmp_path / "b.csv", index=False)
    with pytest.raises(SystemExit, match="must divide by 3 processes"):
        tmeasure.main(["--baseline_checkpoint_dir", "x",
                       "--baseline_metrics_csv", str(tmp_path / "b.csv"),
                       "--data_path", "x", "--output_csv", "x",
                       "--things_csv", "x", "--things_img_dir", "x",
                       "--things_rdm_path", "x", "--batch_size", "8",
                       "--backbone", "test-tiny", "--device", "cpu"])


# -- the unperturbed replay of a port-trained baseline -------------------------

@pytest.fixture(scope="module")
def port_cell(imagenet, things48, backbone, tmp_path_factory):
    """A 2-epoch port-trained baseline, its rsa_results rows, and a function
    that measures one perturb-epoch-1 cell on it (optionally through a
    ckpt_cache)."""
    import scipy.io
    out = str(tmp_path_factory.mktemp("port_run") / "run")
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, out), vit_cfg=TTINY,
                           device="cpu")
    # the rows as vit_rsa_eval computed them (its CSV keeps 16 digits)
    baseline = trsa.main(_rsa_args(
        out, str(tmp_path_factory.mktemp("port_rsa") / "rsa_results.csv"),
        things48) + ["--device", "cpu"])
    cfg = TTrainConfig(batch_size=8, lr=0.01, warmup_epochs=1, epochs=3,
                       num_workers=2, num_classes=3, image_size=32,
                       compute_dtype="float32")
    trainer = tloop.ViTTrainer(TTINY, cfg, tvit.empty_vit(TTINY, "cpu"),
                               "cpu")
    from vit_project_torch.data.packed import make_loader
    train = make_loader(f"{imagenet}/train", 8, train=True, seed=0, size=32,
                        workers=2, drop_last=True)
    val = make_loader(f"{imagenet}/val", 8, train=False, size=32, workers=2)
    _, things = tmeasure.load_things_for_vit(things48[1], things48[3],
                                             size=32)
    rdm = np.asarray(scipy.io.loadmat(things48[5])["RDM48_triplet"],
                     np.float32)
    sched = dict(base_lr=0.01, warmup_epochs=1, max_epochs=2, eta_min=0.0)

    def cell(ptype, ckpt_cache=None):
        return tmeasure.measure_perturbation_effect(
            1, ptype, trainer, out, baseline, train, val, things, rdm, sched,
            0.1, ckpt_cache=ckpt_cache)
    return cell, baseline, train, out


def test_port_baseline_replays_bit_equal(port_cell):
    """Epoch 1 trained again from the epoch-0 checkpoint without a
    perturbation gives the baseline's epoch-1 val_loss and rsa_score bit
    for bit (float32 on the CPU: the same data order, lr, momentum and
    arithmetic). A gaussian cell measured twice gives equal rows."""
    cell, baseline, train, _ = port_cell
    replay = cell(None)
    row = baseline[baseline["epoch"] == 1].iloc[0]
    assert replay["perturbed_loss"] == row["val_loss"]
    assert replay["perturbed_rsa"] == row["rsa_score"]
    assert replay["delta_loss"] == 0.0 and replay["delta_rsa"] == 0.0
    assert cell("gaussian") == cell("gaussian")
    assert train.label_table is None


def test_checkpoint_cache_restores_bit_equal(port_cell):
    """The per-epoch ckpt_cache: the first cell reads and converts the
    checkpoint and keeps the parameters, momentum and scheduler state; the
    epoch's later cells restore them by copies and give the rows of cells
    that read the file themselves."""
    from vit_project_torch.ckpt import vit_ckpt
    cell, _, _, out = port_cell
    cache: dict = {}
    first = cell("label_shuffle", cache)
    params, momentum, scheduler_state = cache["state"]
    assert all(isinstance(t, torch.Tensor) for t in params.values())
    assert set(momentum) <= set(params)
    assert scheduler_state == vit_ckpt.load_checkpoint(
        vit_ckpt.epoch_checkpoint(out, 0))["scheduler_state"]
    cached = [cell(ptype, cache) for ptype in ("uniform_gray", None)]
    assert cache["state"][0] is params       # not read again
    assert [first, *cached] == [cell(ptype) for ptype in
                                ("label_shuffle", "uniform_gray", None)]


def test_analysis_tools_read_the_port_grid(grid, rsa_rows, tmp_path):
    """The port's grid CSVs as a vit_results tree: the port's copies of figs
    and parity give the JAX package's results on it."""
    import shutil
    from vit_project_tpu.analysis import figs as jfigs
    from vit_project_tpu.analysis import parity as jparity
    from vit_project_torch.analysis import figs as tfigs
    from vit_project_torch.analysis import parity as tparity
    out, _ = grid
    _, rsa_paths = rsa_rows
    tree = tmp_path / "vit_results"
    os.makedirs(tree)
    shutil.copyfile(out["port"], tree / "perturbation_effects.csv")
    shutil.copyfile(rsa_paths["port"], tree / "rsa_results.csv")
    for name, csv_name in (("vit_type_deltas", "perturbation_effects.csv"),
                           ("vit_trajectory", "rsa_results.csv")):
        pd.testing.assert_frame_equal(
            getattr(tfigs, name)(str(tree / csv_name)),
            getattr(jfigs, name)(str(tree / csv_name)))
    checks = tparity.vit_inventory(str(tree))
    assert checks == jparity.vit_inventory(str(tree))
    # the columns pass; 4 cells are not the reference's 44
    assert [c["ok"] for c in checks] == [True, True, False]
    reports = {}
    for label, mod in (("jax", jparity), ("port", tparity)):
        rep = mod.build_report(None, None, str(tmp_path / label),
                               ours_vit=str(tree))
        reports[label] = {k: v for k, v in rep.items() if k != "artifacts"}
    assert reports["port"] == reports["jax"]
