"""The port's data parallelism over ``torch.distributed`` (parallel/dist.py,
parallel/mesh.py, the three modes of train/vit_loop.py, the collective
preemption poll, primary-only writes, the gathered RSA and the grid across
ranks) against the JAX package and against itself.

Two ranks run under gloo on the CPU: one ``torchrun --standalone`` launch
(its own free port) runs this file as a script, and each rank works
through every scenario in turn and writes what it saw to a JSON file; the
tests read those files and the runs' trees. The 2-rank dp trajectory is
held against the JAX package's in-process run on its 8-device virtual
mesh (tests/conftest.py), zero1 and fsdp against the port's dp at JAX's
own tolerances (tests/test_vit_training.py, rtol 1e-4 / atol 1e-5), and
the one-process port against the 2-rank runs where the numbers must agree.

The model is the JAX fixture's test-tiny ViT (width 32, 2 blocks, 2 heads,
3 classes) on its ImageFolder (3 x 16 train, 3 x 8 val PNGs at 48^2),
global batch 8 (4 a rank), float32.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from vit_project_torch.ckpt import vit_ckpt as tckpt
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.core.preempt import PreemptionGuard
from vit_project_torch.models import vit as tvit
from vit_project_torch.parallel import dist as tdist_mod
from vit_project_torch.parallel import mesh as tmesh
from vit_project_torch.train import vit_loop as tloop

WORLD = 2
BACKBONE = "test-tiny-3"
TTINY = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)
# float32 in another summation order over an epoch (the port's tolerance
# against JAX, tests/test_torch_vit_training.py _assert_rows_close)
LOSS_RTOL = 1e-4
# JAX's bound between its own data-parallel modes (tests/test_vit_training.py)
MODE_RTOL, MODE_ATOL = 1e-4, 1e-5
# the launch of every scenario: ~40 s alone, several times that beside
# three other files' launches under xdist
LAUNCH_TIMEOUT = 600
# how long rank 0 holds back cli.vit_rsa_eval's CSV in the worker: far
# longer than rank 1 takes to reach cli.vit_measure's read of it
RSA_WRITE_DELAY = 2.0


def _tiny(cfg_cls, data, out, epochs=2, **kw):
    return cfg_cls(data_path=data, output_dir=out, batch_size=8,
                   epochs=epochs, lr=0.01, warmup_epochs=1, num_workers=2,
                   num_classes=3, image_size=32, compute_dtype="float32",
                   random_seed=0, **kw)


def _things(root, n=11, seed=1):
    """`n` THINGS-style PNGs, their CSV and a symmetric random RDM."""
    from PIL import Image
    import scipy.io
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    rs = np.random.RandomState(seed)
    names = []
    for i in range(n):
        name = f"v{i:02d}.png"
        Image.fromarray(rs.randint(0, 255, (48, 48, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, name))
        names.append(name)
    pd.DataFrame({"image_name": names}).to_csv(
        os.path.join(root, "things.csv"), index=False)
    rdm = rs.rand(n, n).astype(np.float32)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    scipy.io.savemat(os.path.join(root, "rdm.mat"), {"RDM48_triplet": rdm})
    return ["--things_csv", os.path.join(root, "things.csv"),
            "--things_img_dir", img_dir,
            "--things_rdm_path", os.path.join(root, "rdm.mat")]


def _resume_dir(src, dst, epoch=0):
    """A run tree holding epochs 0..`epoch` of `src` (that checkpoint as
    latest, their metrics rows)."""
    os.makedirs(dst)
    shutil.copyfile(os.path.join(src, f"checkpoint_epoch_{epoch:03d}.pth"),
                    os.path.join(dst, "checkpoint_latest.pth"))
    with open(os.path.join(src, "training_metrics.csv")) as f:
        rows = f.read().splitlines()
    with open(os.path.join(dst, "training_metrics.csv"), "w") as f:
        f.write("\n".join(rows[:epoch + 2]) + "\n")


def _metrics(out):
    return pd.read_csv(os.path.join(out, "training_metrics.csv"))


def _trees(out):
    ck = tckpt.load_checkpoint(os.path.join(out, "checkpoint_latest.pth"))
    return ck["params"], ck["opt_state"]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# -- the two ranks ------------------------------------------------------------

def _grid_args(spec, run, rsa_csv, out_csv):
    return ["--baseline_checkpoint_dir", run, "--baseline_metrics_csv",
            rsa_csv, "--data_path", spec["data"], "--output_csv", out_csv,
            *spec["things"], "--perturbation_types", "label_shuffle",
            "--perturb_epochs", "1", "--batch_size", "8", "--num_workers",
            "2", "--backbone", BACKBONE, "--compute_dtype", "float32",
            "--total_epochs", "3", "--warmup_epochs", "1", "--lr", "0.01",
            "--device", "cpu"]


def _rsa_args(spec, run, out_csv):
    return ["--checkpoint_dir", run, "--output_csv", out_csv, "--backbone",
            BACKBONE, "--compute_dtype", "float32", *spec["things"],
            "--device", "cpu"]


class _StopOnRankOne(PreemptionGuard):
    """The notice reaches rank 1 only, after its second batch."""

    def __init__(self):
        super().__init__()
        self.polls = self.answered_true = 0

    def should_stop(self):
        self.polls += 1
        if tdist_mod.rank() == 1 and self.polls == 2:
            self.request()
        stop = super().should_stop()
        self.answered_true += stop
        return stop


def _worker(spec_path):
    """One rank: every scenario in order; what it saw goes to
    report_rank{r}.json beside the spec."""
    import torch.distributed as tdist
    from vit_project_torch.cli import vit_measure as tmeasure
    from vit_project_torch.cli import vit_rsa_eval as trsa
    from vit_project_torch.core import csvio

    with open(spec_path) as f:
        spec = json.load(f)
    root, data = spec["root"], spec["data"]
    rank, world = tdist_mod.setup_distributed("cpu")
    tvit.VIT_CONFIGS[BACKBONE] = TTINY
    report = {"rank": rank, "world": world, "backend": tdist.get_backend(),
              "checked_steps": {}}

    # the ranks' parameters are compared after every dp and zero1 step
    step = tloop.ViTTrainer.step
    mode_of_run = {}

    def checked_step(self, *a, **k):
        loss = step(self, *a, **k)
        if self.mode in ("dp", "zero1"):
            flat = torch.cat([p.detach().reshape(-1)
                              for p in self.model.parameters()])
            both = tdist_mod.all_gather_rows(flat)
            if not torch.equal(both[0], both[1]):
                raise AssertionError(f"ranks differ after a {self.mode} step")
            key = mode_of_run["run"]
            report["checked_steps"][key] = \
                report["checked_steps"].get(key, 0) + 1
        return loss
    tloop.ViTTrainer.step = checked_step

    def run(name, cfg, **kw):
        mode_of_run["run"] = name
        return tloop.run_vit_training(cfg, vit_cfg=TTINY, device="cpu",
                                      logger=None, **kw)

    def out(name):
        return os.path.join(root, name)

    run("dp_from_jax", _tiny(TTrainConfig, data, out("dp_from_jax")))
    run("dp", _tiny(TTrainConfig, data, out("dp")))
    res = run("zero1", _tiny(TTrainConfig, data, out("zero1"), zero1=True))
    named = dict(res["model"].named_parameters())
    report["zero1"] = {
        "momentum_bytes": sum(m.numel() * m.element_size()
                              for m in res["momentum_buf"].values()),
        "full_bytes": sum(p.numel() * p.element_size()
                          for p in named.values()),
        "split_local": sum(res["momentum_buf"][n].numel()
                           for n, p in named.items()
                           if tmesh.zero1_sharding(world, p)),
        "split_full": sum(p.numel() for p in named.values()
                          if tmesh.zero1_sharding(world, p))}
    res = run("fsdp", _tiny(TTrainConfig, data, out("fsdp"), fsdp=True,
                            grad_accum=2))
    res["model"].reshard()   # validation left the root's gathered
    named = dict(res["model"].named_parameters())
    report["fsdp"] = {
        "types": sorted({type(p).__name__ for p in named.values()}),
        "param_local": sum(p.to_local().numel() for p in named.values()),
        "momentum_local": sum(m.to_local().numel()
                              for m in res["momentum_buf"].values()),
        "full": sum(p.numel() for p in named.values()),
        "matrix_local": sum(p.to_local().numel() for p in named.values()
                            if tmesh.fsdp_sharding(world, p)),
        "matrix_full": sum(p.numel() for p in named.values()
                           if tmesh.fsdp_sharding(world, p))}
    del res, named

    # cross-resumes: dp's epoch 0 under zero1, zero1's under fsdp
    for name, src, kw in (("zero1_from_dp", "dp", dict(zero1=True)),
                          ("fsdp_from_zero1", "zero1", dict(fsdp=True))):
        if rank == 0:
            _resume_dir(out(src), out(name))
        tdist.barrier()
        run(name, _tiny(TTrainConfig, data, out(name), **kw))

    # one rank's notice stops both at the end of epoch 0; the rerun
    # finishes the run
    guard = _StopOnRankOne()
    res = run("preempt", _tiny(TTrainConfig, data, out("preempt")),
              preempt_guard=guard)
    report["preempt"] = {"preempted": bool(res.get("preempted")),
                         "requested": guard.requested,
                         "local_stops": guard.answered_true,
                         "rows": len(_metrics(out("preempt")))}
    res = run("preempt", _tiny(TTrainConfig, data, out("preempt")))
    report["preempt"]["rerun_preempted"] = bool(res.get("preempted"))
    del res

    # the gathered RSA on dp's final weights
    import scipy.io
    from vit_project_torch.cli.vit_measure import load_things_for_vit
    _, imgs = load_things_for_vit(spec["things"][1], spec["things"][3],
                                  size=32)
    rdm = scipy.io.loadmat(spec["things"][5])["RDM48_triplet"]
    trainer = tloop.ViTTrainer(TTINY, _tiny(TTrainConfig, data, "x"),
                               tvit.empty_vit(TTINY, "cpu"), "cpu")
    tloop.load_trees(trainer.model, _trees(out("dp"))[0])
    report["rsa_rho"] = trainer.compute_rsa_score(imgs, rdm,
                                                  batch_size=4)[0]
    # the gathered embeddings: row i is dataset item i
    n = len(imgs)
    idx = np.arange(rank, world * -(-n // world), world) % n
    emb = trainer._feature_step(torch.from_numpy(np.ascontiguousarray(
        imgs[idx])))
    report["rsa_emb"] = tdist_mod.ordered_allgather_strided(emb, n).tolist()
    del trainer

    # the per-epoch RSA and one grid cell, CSVs from rank 0 only. Rank 0's
    # RSA write is held back RSA_WRITE_DELAY s, and cli.vit_measure (which
    # reads that CSV first) follows at once on every rank: a rank that left
    # cli.vit_rsa_eval before the file was whole reads none or part of it
    writes = {"measure": 0, "rsa": 0}
    write_measure = csvio.write_measure_csv
    to_csv, read_csv = pd.DataFrame.to_csv, pd.read_csv
    rsa_csv = out("rsa2/rsa_results.csv")
    report["rsa_rows_read"] = []

    def counting_measure(*a, **k):
        writes["measure"] += 1
        return write_measure(*a, **k)

    def counting_to_csv(self, *a, **k):
        writes["rsa"] += 1
        if "rsa_summary_also" not in writes:
            time.sleep(RSA_WRITE_DELAY)
        return to_csv(self, *a, **k)

    def recording_read_csv(path, *a, **k):
        df = read_csv(path, *a, **k)
        if path == rsa_csv:
            report["rsa_rows_read"].append(len(df))
        return df
    csvio.write_measure_csv = counting_measure
    pd.DataFrame.to_csv = counting_to_csv
    pd.read_csv = recording_read_csv
    mode_of_run["run"] = "grid"
    try:
        trsa.main(_rsa_args(spec, out("dp"), rsa_csv))
        writes["rsa_summary_also"] = writes["rsa"]
        writes["rsa"] = 0
        tmeasure.main(_grid_args(spec, out("dp"), rsa_csv,
                                 out("grid2/effects.csv")))
        writes["summary"] = writes["rsa"]
    finally:
        csvio.write_measure_csv = write_measure
        pd.DataFrame.to_csv = to_csv
        pd.read_csv = read_csv
    report["writes"] = {"rsa": writes["rsa_summary_also"],
                        "measure": writes["measure"],
                        "summary": writes["summary"]}
    with open(os.path.join(root, f"report_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """The JAX package's fixture (tests/test_vit_training.py): 3 classes x
    16 train + 8 val PNGs at 48x48."""
    from PIL import Image
    root = tmp_path_factory.mktemp("imagenet")
    rs = np.random.RandomState(0)
    for split, n in (("train", 16), ("val", 8)):
        for cls in ("apple", "banana", "cherry"):
            d = root / split / cls
            os.makedirs(d)
            for i in range(n):
                Image.fromarray(rs.randint(
                    0, 255, (48, 48, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def backbone():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tvit.VIT_CONFIGS, BACKBONE, TTINY)
        yield BACKBONE


@pytest.fixture(scope="module")
def ranks(imagenet, tmp_path_factory):
    """The JAX run (in this process, on its 8-device virtual mesh), then
    one 2-rank launch of every scenario (``_worker``); returns the root of
    the trees and the ranks' reports."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    root = str(tmp_path_factory.mktemp("parallel"))
    jtiny = jvit.ViTConfig(patch=8, width=32, layers=2, heads=2,
                           image_size=32, num_classes=3)
    jrun(_tiny(JTrainConfig, imagenet, os.path.join(root, "jax")),
         vit_cfg=jtiny)
    assert jax.device_count() == 8
    _resume_dir(os.path.join(root, "jax"), os.path.join(root, "dp_from_jax"))
    spec = {"root": root, "data": imagenet,
            "things": _things(os.path.join(root, "things"))}
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), __file__, spec_path],
        env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    reports = []
    for r in range(WORLD):
        with open(os.path.join(root, f"report_rank{r}.json")) as f:
            reports.append(json.load(f))
    return root, spec, reports



# -- parallel/dist.py ---------------------------------------------------------

def _no_rendezvous(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


def _forbid_init(monkeypatch):
    import torch.distributed as tdist

    def forbidden(*a, **k):
        raise AssertionError("init_process_group called")
    monkeypatch.setattr(tdist, "init_process_group", forbidden)


def test_setup_distributed_without_a_launcher_initializes_nothing(
        monkeypatch):
    _no_rendezvous(monkeypatch)
    _forbid_init(monkeypatch)
    assert tdist_mod.setup_distributed("cpu") == (0, 1)
    assert tdist_mod.setup_distributed("cuda") == (0, 1)
    assert not tdist_mod.is_initialized()
    assert tdist_mod.world_size() == 1 and tdist_mod.rank() == 0
    with tdist_mod.process_group("cpu") as ranks:
        assert ranks == (0, 1)


def test_setup_distributed_reraises_a_rendezvous_failure(monkeypatch):
    """A swallowed failure would turn the ranks into independent rank-0
    runs writing the same files; no fallback to gloo or to the CPU."""
    import torch.distributed as tdist
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    seen = []

    def boom(backend=None, **kw):
        seen.append(backend)
        raise RuntimeError("connection to the store at localhost:1 failed")
    monkeypatch.setattr(tdist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="store"):
        tdist_mod.setup_distributed("cpu")
    with pytest.raises(RuntimeError, match="address already in use"):
        monkeypatch.setattr(tdist, "init_process_group", lambda **kw: (
            _ for _ in ()).throw(RuntimeError("bind: address already in use")))
        tdist_mod.setup_distributed("cpu")
    assert seen == ["gloo"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist_mod.setup_distributed("cuda")
    with pytest.raises(ValueError, match="backend"):
        tdist_mod.setup_distributed("meta")


def test_setup_distributed_leaves_an_existing_group_alone(monkeypatch):
    import torch.distributed as tdist
    _forbid_init(monkeypatch)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_rank", lambda: 1)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 4)
    assert tdist_mod.setup_distributed("cpu") == (1, 4)
    destroyed = []
    monkeypatch.setattr(tdist, "destroy_process_group",
                        lambda: destroyed.append(1))
    with tdist_mod.process_group("cpu") as ranks:
        assert ranks == (1, 4)
    assert destroyed == []          # not the context's group to destroy
    assert tdist_mod.is_primary() is False


def test_is_primary_answers_from_rank_without_initializing(monkeypatch):
    _no_rendezvous(monkeypatch)
    _forbid_init(monkeypatch)
    assert tdist_mod.is_primary() is True
    for rank, want in (("0", True), ("", True), ("3", False)):
        monkeypatch.setenv("RANK", rank)
        assert tdist_mod.is_primary() is want
    assert not tdist_mod.is_initialized()


def test_local_device_is_the_ranks_card(monkeypatch):
    _no_rendezvous(monkeypatch)
    assert tdist_mod.local_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdist_mod.local_device("cuda") == torch.device("cuda", 3)
    assert tdist_mod.local_device("cuda:1") == torch.device("cuda", 1)
    assert tdist_mod.local_device("cpu") == torch.device("cpu")


def test_ordered_allgather_interleaves_the_strided_shards(ranks):
    """One process trims; two ranks' shards (rank r: items r, r+2, ...,
    wrap-padded to 6 of 11) come back with row i = item i: each row equals
    the one-process embedding of its image, and no other."""
    root, spec, reports = ranks
    x = np.arange(10).reshape(5, 2)
    np.testing.assert_array_equal(tdist_mod.ordered_allgather_strided(x, 3),
                                  x[:3])
    import scipy.io  # noqa: F401 (the loader below needs it)
    from vit_project_torch.cli.vit_measure import load_things_for_vit
    _, imgs = load_things_for_vit(spec["things"][1], spec["things"][3],
                                  size=32)
    trainer = tloop.ViTTrainer(TTINY, _tiny(TTrainConfig, "x", "x"),
                               tvit.empty_vit(TTINY, "cpu"), "cpu")
    tloop.load_trees(trainer.model, _trees(os.path.join(root, "dp"))[0])
    want = trainer._feature_step(torch.from_numpy(imgs)).numpy()
    for rep in reports:
        got = np.asarray(rep["rsa_emb"], np.float32)
        assert got.shape == want.shape == (11, 32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        dists = ((got[:, None] - want[None]) ** 2).sum(-1)
        assert (dists.argmin(1) == np.arange(11)).all()


# -- parallel/mesh.py ---------------------------------------------------------

def test_make_mesh_refuses_the_later_axes():
    with pytest.raises(NotImplementedError, match="not ported"):
        tmesh.make_mesh(n_stage=2)
    # the model and expert axes are ported (tests/test_torch_tp.py,
    # tests/test_torch_ep.py); each must divide the ranks, and only one may
    # be > 1, in JAX's words
    for axis in ("model", "expert"):
        with pytest.raises(ValueError, match=rf"{axis} axis \(2\) must divide "
                                             r"the device count \(1\)"):
            tmesh.make_mesh(**{f"n_{axis}": 2})
    with pytest.raises(ValueError, match="at most one"):
        tmesh.make_mesh(n_model=2, n_expert=2)


@pytest.mark.parametrize("shape", [(8,), (12,), (16, 3), (24, 5, 2), (6, 4),
                                   (3, 8), ()])
def test_sharding_rules_are_jaxs(shape):
    """zero1_sharding / fsdp_sharding say "split" exactly where JAX's
    place the leaf on P('data') over its 8-device mesh."""
    from vit_project_tpu.parallel import mesh as jmesh
    from jax.sharding import PartitionSpec as P
    jm = jmesh.make_mesh()
    x = np.zeros(shape, np.float32)
    assert tmesh.zero1_sharding(8, x) == (
        jmesh.zero1_sharding(jm, x).spec == P("data"))
    assert tmesh.fsdp_sharding(8, x) == (
        jmesh.fsdp_sharding(jm, x).spec == P("data"))
    t = torch.zeros(shape)
    assert tmesh.zero1_sharding(8, t) == tmesh.zero1_sharding(8, x)


def test_pad_to_multiple_and_shard_rows_match_jax():
    from vit_project_tpu.parallel import mesh as jmesh
    rs = np.random.RandomState(0)
    tree = {"images": rs.rand(5, 3).astype(np.float32),
            "labels": np.arange(5)}
    for mult in (1, 2, 4, 8):
        got, n = tmesh.pad_to_multiple(tree, mult)
        want, jn = jmesh.pad_to_multiple(tree, mult)
        assert n == jn == 5
        for k in tree:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    x = torch.arange(24.0).reshape(6, 4)
    np.testing.assert_array_equal(tmesh.shard_rows(x, 2, 1).numpy(),
                                  x[3:].numpy())


# -- the modes ----------------------------------------------------------------

def test_dp_matches_the_jax_run_on_its_virtual_mesh(ranks):
    """Two ranks, resumed from the JAX run's epoch 0, train epoch 1 as JAX's
    8-device mesh does: the rows to rtol 1e-4 (accuracy within one of the
    24 val images), the checkpoint's trees to 1e-5."""
    root, _, _ = ranks
    got = _metrics(os.path.join(root, "dp_from_jax"))
    want = _metrics(os.path.join(root, "jax"))
    assert list(got["epoch"]) == list(want["epoch"]) == [0, 1]
    np.testing.assert_allclose(got[["train_loss", "val_loss"]].values,
                               want[["train_loss", "val_loss"]].values,
                               rtol=LOSS_RTOL)
    assert (abs(got["val_acc"] - want["val_acc"]) <= 100 / 24 + 1e-6).all()
    for a, b in zip(_trees(os.path.join(root, "dp_from_jax")),
                    _trees(os.path.join(root, "jax"))):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=MODE_RTOL, atol=MODE_ATOL)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_modes_match_dp(ranks, mode):
    """zero1 moves the momentum, fsdp (here with grad_accum = 2) the
    parameters and the momentum, never the numbers: rows and the final
    trees within JAX's bound between its modes. ZeRO-1 is dp bit for bit
    (the same elementwise update on the same gradients)."""
    root, _, _ = ranks
    got, want = (_metrics(os.path.join(root, d)) for d in (mode, "dp"))
    np.testing.assert_allclose(got[["train_loss", "val_loss"]].values,
                               want[["train_loss", "val_loss"]].values,
                               rtol=MODE_RTOL)
    for a, b in zip(_trees(os.path.join(root, mode)),
                    _trees(os.path.join(root, "dp"))):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=MODE_RTOL, atol=MODE_ATOL)
            if mode == "zero1":
                np.testing.assert_array_equal(x, y)


def test_zero1_keeps_half_of_the_split_momentum_per_rank(ranks):
    for rep in ranks[2]:
        z = rep["zero1"]
        assert z["split_full"] > 0.9 * z["full_bytes"] / 4
        assert 2 * z["split_local"] == z["split_full"]
        assert z["momentum_bytes"] <= 0.52 * z["full_bytes"]


def test_fsdp_shards_parameters_and_momentum(ranks):
    """FSDP2 holds about 1/2 of every leaf a rank (dim 0, the last shard
    padded), matrices exactly half, and the momentum as the parameters."""
    for rep in ranks[2]:
        f = rep["fsdp"]
        assert f["types"] == ["DTensor"]
        assert f["matrix_full"] > 0.9 * f["full"]
        assert 2 * f["matrix_local"] == f["matrix_full"]
        assert f["momentum_local"] == f["param_local"]
        assert abs(f["param_local"] - f["full"] / 2) <= 0.02 * f["full"]
    assert sum(r["fsdp"]["param_local"] for r in ranks[2]) == \
        ranks[2][0]["fsdp"]["full"]


def test_ranks_hold_equal_parameters_after_every_step(ranks):
    """The worker compared the two ranks' parameters after every dp and
    zero1 step (and raised at the first difference): 6 steps an epoch."""
    for rep in ranks[2]:
        assert rep["world"] == 2 and rep["backend"] == "gloo"
        c = rep["checked_steps"]
        assert (c["dp"], c["zero1"], c["dp_from_jax"], c["zero1_from_dp"],
                c["preempt"], c["grid"]) == (12, 12, 6, 6, 12, 6)


def test_checkpoints_cross_resume_between_modes_and_one_process(
        ranks, imagenet, tmp_path):
    """dp's epoch 0 resumed under zero1, zero1's under fsdp, and fsdp's in
    one process: each epoch-1 row equals the uninterrupted dp run's."""
    root, _, _ = ranks
    one = str(tmp_path / "one_from_fsdp")
    _resume_dir(os.path.join(root, "fsdp"), one)
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, one),
                           vit_cfg=TTINY, device="cpu")
    want = _metrics(os.path.join(root, "dp"))
    for d in (os.path.join(root, "zero1_from_dp"),
              os.path.join(root, "fsdp_from_zero1"), one):
        got = _metrics(d)
        assert list(got["epoch"]) == [0, 1]
        np.testing.assert_allclose(got[["train_loss", "val_loss"]].values,
                                   want[["train_loss", "val_loss"]].values,
                                   rtol=MODE_RTOL)
    # one process from fsdp's epoch 0 against two ranks from dp's: the same
    # data, another batch composition a step
    for a, b in zip(_trees(one), _trees(os.path.join(root, "dp"))):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=MODE_RTOL, atol=MODE_ATOL)


def test_modes_refuse_what_jax_refuses(imagenet, tmp_path, monkeypatch):
    cfg = _tiny(TTrainConfig, imagenet, str(tmp_path / "x"))
    for kw in (dict(zero1=True), dict(fsdp=True)):
        with pytest.raises(ValueError, match="pp_stages"):
            tloop.train_mode(dataclasses.replace(cfg, pp_stages=2, **kw),
                             True)
        with pytest.raises(ValueError, match="torchrun"):
            tloop.run_vit_training(dataclasses.replace(cfg, **kw),
                                   vit_cfg=TTINY, device="cpu")
    monkeypatch.setattr(tdist_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="fused_dw"):
        tloop.train_mode(dataclasses.replace(cfg, fused_dw=True), True)
    assert tloop.train_mode(cfg, True) == "dp"
    assert tloop.train_mode(dataclasses.replace(cfg, zero1=True, fsdp=True),
                            True) == "fsdp"
    assert tloop.train_mode(cfg, False) == "single"


# -- the RSA, preemption, the grid --------------------------------------------

def test_rsa_over_two_ranks_equals_one_process(ranks):
    import scipy.io
    from vit_project_torch.cli.vit_measure import load_things_for_vit
    root, spec, reports = ranks
    _, imgs = load_things_for_vit(spec["things"][1], spec["things"][3],
                                  size=32)
    rdm = scipy.io.loadmat(spec["things"][5])["RDM48_triplet"]
    trainer = tloop.ViTTrainer(TTINY, _tiny(TTrainConfig, "x", "x"),
                               tvit.empty_vit(TTINY, "cpu"), "cpu")
    tloop.load_trees(trainer.model, _trees(os.path.join(root, "dp"))[0])
    rho = trainer.compute_rsa_score(imgs, rdm, batch_size=4)[0]
    assert reports[0]["rsa_rho"] == reports[1]["rsa_rho"]
    assert abs(reports[0]["rsa_rho"] - rho) <= 1e-6


def test_one_ranks_notice_stops_both_at_the_epoch_boundary(ranks):
    """The notice reached rank 1 alone, mid-epoch: neither rank stopped
    inside the epoch, both stopped after epoch 0's checkpoint, and the
    rerun's rows and trees equal the uninterrupted dp run's bit for bit."""
    root, _, reports = ranks
    assert [r["preempt"]["requested"] for r in reports] == [False, True]
    for r in reports:
        p = r["preempt"]
        assert p["preempted"] and p["local_stops"] == 0 and p["rows"] == 1
        assert not p["rerun_preempted"]
    assert not os.path.exists(os.path.join(root, "preempt",
                                           "checkpoint_preempt.pth"))
    pd.testing.assert_frame_equal(_metrics(os.path.join(root, "preempt")),
                                  _metrics(os.path.join(root, "dp")))
    for a, b in zip(_trees(os.path.join(root, "preempt")),
                    _trees(os.path.join(root, "dp"))):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_mid_epoch_stop_is_one_process_only(monkeypatch):
    g = PreemptionGuard()
    g.request()
    assert g.should_stop() is True
    monkeypatch.setattr(tdist_mod, "world_size", lambda: 2)
    assert g.should_stop() is False


def test_chained_grid_clis_read_the_primarys_whole_csv(ranks):
    """cli.vit_measure straight after cli.vit_rsa_eval in one group, with
    rank 0's RSA write held back RSA_WRITE_DELAY s: both ranks read the
    whole CSV (its two epoch rows). A rank that returned from
    cli.vit_rsa_eval before the primary's write ended would fail the
    launch on a missing or empty file."""
    for rep in ranks[2]:
        assert rep["rsa_rows_read"] == [2]


def test_grid_over_two_ranks_writes_one_csv_equal_to_one_process(
        ranks, backbone, tmp_path):
    """vit_rsa_eval and one vit_measure cell (label_shuffle at epoch 1) over
    two ranks: rank 0 wrote each CSV once, rank 1 none, and the rows equal
    the one-process CLIs' on the same baseline (losses rtol 1e-4, rho
    2e-4: the tiny model's near-tied RDM pairs,
    tests/test_torch_vit_grid.py)."""
    from vit_project_torch.cli import vit_measure as tmeasure
    from vit_project_torch.cli import vit_rsa_eval as trsa
    root, spec, reports = ranks
    assert [r["writes"] for r in reports] == [
        {"rsa": 1, "measure": 1, "summary": 1},
        {"rsa": 0, "measure": 0, "summary": 0}]
    assert sorted(os.listdir(os.path.join(root, "grid2"))) == [
        "effects.csv", "perturbation_summary_table.csv"]
    rsa1 = str(tmp_path / "rsa1.csv")
    trsa.main(_rsa_args(spec, os.path.join(root, "dp"), rsa1))
    r2, r1 = pd.read_csv(os.path.join(root, "rsa2", "rsa_results.csv")), \
        pd.read_csv(rsa1)
    assert list(r2.columns) == list(r1.columns) and len(r2) == len(r1) == 2
    np.testing.assert_allclose(r2["rsa_score"], r1["rsa_score"], atol=1e-6)
    out1 = str(tmp_path / "grid1" / "effects.csv")
    tmeasure.main(_grid_args(spec, os.path.join(root, "dp"), rsa1, out1))
    g2 = pd.read_csv(os.path.join(root, "grid2", "effects.csv"))
    g1 = pd.read_csv(out1)
    assert list(g2.columns) == list(g1.columns) and len(g2) == len(g1) == 1
    assert g2["perturbation_type"].tolist() == ["label_shuffle"]
    np.testing.assert_allclose(g2[["perturbed_loss", "delta_loss"]].values,
                               g1[["perturbed_loss", "delta_loss"]].values,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(g2["perturbed_rsa"], g1["perturbed_rsa"],
                               atol=2e-4)


# -- primary-only files ------------------------------------------------------

def test_only_the_primary_writes_the_log_and_checkpoints(tmp_path,
                                                          monkeypatch):
    from vit_project_torch.core import logs
    from vit_project_torch.ckpt import vit_ckpt
    _no_rendezvous(monkeypatch)
    monkeypatch.setenv("RANK", "1")
    lg = logs.setup_logger(str(tmp_path / "r1" / "train.log"))
    lg.info("rank 1")
    vit_ckpt.save_checkpoint(0, {"w": np.zeros(2)}, {"w": np.zeros(2)}, {},
                             1.0, 1.0, 50.0, str(tmp_path / "r1"))
    assert vit_ckpt.prune_checkpoints(str(tmp_path / "r1"), 1, 5) == []
    assert not (tmp_path / "r1").exists()
    monkeypatch.setenv("RANK", "0")
    lg = logs.setup_logger(str(tmp_path / "r0" / "train.log"))
    lg.info("rank 0")
    vit_ckpt.save_checkpoint(0, {"w": np.zeros(2)}, {"w": np.zeros(2)}, {},
                             1.0, 1.0, 50.0, str(tmp_path / "r0"))
    for h in lg.handlers:
        h.flush()
    assert sorted(os.listdir(tmp_path / "r0")) == [
        "checkpoint_epoch_000.pth", "checkpoint_latest.pth", "train.log",
        "training_metrics.csv"]
    assert "rank 0" in (tmp_path / "r0" / "train.log").read_text()


if __name__ == "__main__":
    _worker(sys.argv[1])
