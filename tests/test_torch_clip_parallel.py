"""CLIP-HBA training, sweeps and batched forks across ranks over
``torch.distributed`` (train/clip_loop.py's data-parallel trainer,
train/multi_fork.py and the three CLIP CLIs under torchrun) against the
JAX package and against the port's one-process runs.

Three processes run at once, each with one thread (the CPU's GEMMs may
split their sums by thread count, so bits are compared at one thread):
``torchrun --standalone --nproc_per_node 2`` (two gloo ranks), ``torchrun
--nproc_per_node 1`` (the data-parallel path at world size 1) and the same
script alone (no process group). Each works through its scenarios and
writes what it saw to a JSON file; the tests read those files and the
runs' trees. The JAX runs happen in the pytest process first, on its
8-device virtual mesh (tests/conftest.py): the baseline that the ranks
are held against, and the tree the sweeps and lengths fork from.

The model is tests/test_torch_training.py's tiny CLIP (2 blocks a tower of
width 128, 2 heads of 64, 64 px images in 32 px patches) on its synthetic
THINGS (60 images, 48 for training), rank-4 DoRA on both blocks of each
tower, float32, the JAX package's initial adapters with dropout 0.
"""
import csv
import hashlib
import json
import os
import pickle
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_project_torch.cli import lengths as tlengths
from vit_project_torch.cli import sweep as tsweep
from vit_project_torch.train import clip_loop as tloop
from vit_project_torch.train import multi_fork as tmf

SEED = 1
EPOCHS = 3
BATCH = 16
KINDS = ("random_target", "label_shuffle", "uniform_images", "image_noise")
# test_torch_training.py _close: f32 in another summation order for 3
# epochs x 3 steps (JAX's attention and optimizer against the port's)
LOSS_RTOL, RHO_ATOL = 2e-4, 2e-3
LAUNCH_TIMEOUT = 300


def _close(a, b, loss_rtol=LOSS_RTOL, rho_atol=RHO_ATOL):
    """One CSV row against another: epoch and flags equal, losses within
    `loss_rtol` relative, rho and p within `rho_atol`."""
    assert a[0] == b[0] and a[5:] == b[5:], (a, b)
    for i in (1, 2):
        assert abs(float(a[i]) - float(b[i])) <= loss_rtol * abs(float(b[i]))
    for i in (3, 4):
        assert abs(float(a[i]) - float(b[i])) <= rho_atol


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _stamped(out, prefix):
    """The one entry of `out` named prefix + a timestamp."""
    hits = [n for n in os.listdir(out) if n.startswith(prefix)]
    assert len(hits) == 1, (out, prefix, hits)
    return os.path.join(out, hits[0])


def _tree(out):
    """Every file under `out`, timestamps replaced by T."""
    files = []
    for d, _, names in os.walk(out):
        for n in names:
            files.append(re.sub(r"_\d{8}_\d{6}", "_T",
                                os.path.relpath(os.path.join(d, n), out)))
    return sorted(files)


def _file_bytes(out, skip=("log",)):
    """{relative path: bytes} of the files under `out`, logs left out."""
    got = {}
    for d, _, names in os.walk(out):
        for n in names:
            if any(s in n for s in skip):
                continue
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                got[os.path.relpath(path, out)] = f.read()
    return got


# -- the ranks ------------------------------------------------------------------

def _cli_args(data, out, batch=BATCH, epochs=EPOCHS):
    return ["--csv_file", data["csv_file"], "--img_dir", data["img_dir"],
            "--inference_csv_file", data["inference_csv_file"],
            "--RDM48_triplet_dir", data["RDM48_triplet_dir"],
            "--clip_weights", data["weights"], "--allow_hash_tokenizer",
            "--epochs", str(epochs), "--batch_size", str(batch),
            "--vision_layers", "2", "--transformer_layers", "2", "--rank",
            "4", "--compute_dtype", "float32", "--device", "cpu",
            "--output_dir", out]


def _fork_args(spec, out):
    data, base = spec["things"], spec["jax_tree"]
    args = _cli_args(data, out)[:-2]
    return args + [
        "--baseline_dora_directory", os.path.join(base, "dora_params"),
        "--baseline_random_state_path", os.path.join(base, "random_states"),
        "--baseline_split_indices_path",
        os.path.join(base, "random_states", "dataset_split_indices.pth"),
        "--output_base_directory", out]


def _config(data, out, **over):
    """The run config of ``cli.baseline`` with `_cli_args`' flags, as a
    dict with fixed paths (test_torch_training.py's `_config`)."""
    cfg = {
        **{k: data[k] for k in ("csv_file", "img_dir", "inference_csv_file",
                                "RDM48_triplet_dir")},
        "clip_weights": data["weights"], "allow_hash_tokenizer": True,
        "epochs": EPOCHS, "batch_size": BATCH, "train_portion": 0.8,
        "lr": 3e-4, "logger": None, "early_stopping_patience": 20,
        "checkpoint_path": os.path.join(out, "model.ckpt"),
        "training_res_path": os.path.join(out, "training_res.csv"),
        "dora_parameters_path": os.path.join(out, "dora_params"),
        "random_state_path": os.path.join(out, "random_states"),
        "random_seed": SEED, "vision_layers": 2, "transformer_layers": 2,
        "rank": 4, "dora_dropout": 0.0, "criterion": "mse", "cuda": 0,
        "perturb_type": "baseline", "perturb_length": 0,
        "perturb_distribution": "target", "perturb_seed": 42,
        "training_run": 0, "compute_dtype": "float32"}
    cfg.update(over)
    return cfg


def _resume(cfg, epoch):
    """`cfg` resumed in place from its own epoch-`epoch` files."""
    out = os.path.dirname(cfg["training_res_path"])
    return dict(cfg, resume_from_epoch=epoch,
                resume_dora_parameters_path=os.path.join(out, "dora_params"),
                resume_random_state_path=os.path.join(out, "random_states"),
                baseline_split_indices_path=os.path.join(
                    out, "random_states", "dataset_split_indices.pth"),
                previous_training_res_path=cfg["training_res_path"])


def _digest(trainable, optimizer):
    """sha256 of the adapters and their AdamW state, in leaf order."""
    from vit_project_torch.adapters import dora as tadora
    h = hashlib.sha256()
    for *_, leaf in tadora.trainable_leaves(trainable):
        h.update(leaf.detach().numpy().tobytes())
        for k, v in sorted(optimizer.state.get(leaf, {}).items()):
            h.update(k.encode() + v.detach().numpy().tobytes())
    return h.hexdigest()


class _Recorder:
    """What the trainer did in the current scenario: each step's (loss,
    ok, digest of the adapters and moments), each rank's local ok before
    the all-reduce, the padding-only blocks, the smallest attention batch,
    and each batched lock-step's losses."""

    def __init__(self):
        self.scenario = None
        self.seen = {}

    def at(self, name):
        self.scenario = name
        return self.seen.setdefault(name, {
            "steps": [], "local_ok": [], "empty_blocks": 0,
            "min_attention_batch": None, "fork_losses": []})

    def install(self):
        from vit_project_torch.ops import attention as tattn
        rec = self
        step = tloop.ClipHBATrainer.train_step
        reduce_step = tloop.ClipHBATrainer._all_reduce_step
        inputs = tloop.ClipHBATrainer.batch_inputs
        forks = tloop.ClipHBATrainer.train_step_forks
        attn = tattn.flash_mha_packed_qkv

        def train_step(self, trainable, optimizer, *a, **k):
            loss, ok = step(self, trainable, optimizer, *a, **k)
            rec.seen[rec.scenario]["steps"].append(
                [loss if ok else None, ok, _digest(trainable, optimizer)])
            return loss, ok

        def all_reduce_step(self, trainable, loss, ok):
            rec.seen[rec.scenario]["local_ok"].append(bool(ok))
            return reduce_step(self, trainable, loss, ok)

        def batch_inputs(self, *a, **k):
            out = inputs(self, *a, **k)
            rec.seen[rec.scenario]["empty_blocks"] += out[2] == 0
            return out

        def train_step_forks(self, *a, **k):
            losses, oks = forks(self, *a, **k)
            rec.seen[rec.scenario]["fork_losses"].append(losses)
            return losses, oks

        def flash_mha_packed_qkv(qkv, *a, **k):
            seen = rec.seen[rec.scenario]
            b = int(qkv.shape[0])
            seen["min_attention_batch"] = min(
                b, seen["min_attention_batch"] or b)
            return attn(qkv, *a, **k)
        tloop.ClipHBATrainer.train_step = train_step
        tloop.ClipHBATrainer._all_reduce_step = all_reduce_step
        tloop.ClipHBATrainer.batch_inputs = batch_inputs
        tloop.ClipHBATrainer.train_step_forks = train_step_forks
        tattn.flash_mha_packed_qkv = flash_mha_packed_qkv


def _perturbed_inputs(spec, report):
    """Each CLIP kind over an epoch of batches 20, 20, 8 (the last block
    padding only on rank 1): this rank's block against the one-process
    batch's rows; whether label_shuffle moved a target across the ranks'
    blocks; the frozen-prefix cache against the one-process cache."""
    from vit_project_torch.core.prng import perturb_base_key
    from vit_project_torch.data import things as tthings
    from vit_project_torch.models import convert as tconvert
    from vit_project_torch.parallel import mesh as tmesh
    from vit_project_torch.perturb import injectors as tinj
    with open(spec["adapters"], "rb") as f:
        ad = pickle.load(f)
    model = tconvert.clip_from_state_dict(
        tconvert.load_torch_state_dict(spec["things"]["weights"]), "cpu")
    rs = np.random.RandomState(5)
    images = rs.randint(0, 256, (48, 64, 64, 3)).astype(np.uint8)
    targets = (rs.rand(48, 66) * 2).astype(np.float32)
    prompts = rs.randint(1, 500, (66, 16))
    mean, std = tinj.perturb_distribution_stats(targets, "target")
    one, dp = (tloop.ClipHBATrainer(
        model.cfg, model, ad["acfg"], ad["static"], prompts, lr=3e-4,
        compute_dtype=torch.float32, dist_mean=mean, dist_std=std,
        mesh=mesh) for mesh in (None, tmesh.make_mesh()))
    imgs, tgts = one.upload_dataset(images, targets)
    batches = list(tthings.EpochShuffler(48, 20, 3).batches(0))
    out = {}
    for kind in KINDS:
        equal, crossed = True, False
        for bi, idx in enumerate(batches):
            key = perturb_base_key(42, 2).fold_in(bi)
            whole = one.batch_inputs(imgs, tgts, idx, perturb_type=kind,
                                     perturb_key=key, batch_size=20)
            block = dp.batch_inputs(imgs, tgts, idx, perturb_type=kind,
                                    perturb_key=key, batch_size=20)
            w = 10
            lo, m = dp.rank * w, min(w, max(0, len(idx) - dp.rank * w))
            if m:
                equal &= (torch.equal(block[0], whole[0][lo:lo + m])
                          and torch.equal(block[1], whole[1][lo:lo + m])
                          and block[2] == whole[2] == len(idx))
            else:
                equal &= block[2] == 0 and not torch.any(block[1]).item()
            if kind == "label_shuffle" and bi == 0:
                clean = tgts[torch.as_tensor(idx)]
                crossed = any(torch.equal(whole[1][i], clean[j])
                              for i in range(w) for j in range(w, len(idx)))
        out[kind] = {"equal": bool(equal), "crossed": bool(crossed)}
    report["perturbed"] = out
    report["cache_equal"] = torch.equal(dp.build_prefix_cache(imgs),
                                        one.build_prefix_cache(imgs))


def _worker(spec_path, launch):
    """One process of `launch` ("dp2", "dp1" or "alone"): its scenarios in
    order; what it saw goes to report_{launch}_rank{r}.json."""
    from vit_project_torch.adapters import dora as tadora
    from vit_project_torch.cli import baseline as tbaseline
    from vit_project_torch.parallel import dist as tdist_mod
    from chip_smoke import _WriteCounter

    with open(spec_path) as f:
        spec = json.load(f)
    root = spec["root"]
    grouped = launch != "alone"
    rank, world = (tdist_mod.setup_distributed("cpu") if grouped
                   else (0, 1))
    with open(spec["adapters"], "rb") as f:
        ad = pickle.load(f)

    def apply_dora(model, spec_, *, r, alpha=16, dropout=0.1, generator):
        # the JAX package's initial adapters, dropout 0 (its dropout bits
        # differ from the port's by design)
        assert r == ad["acfg"]["r"]
        return ad["trainable"], ad["static"], dict(ad["acfg"])
    tadora.apply_dora = apply_dora
    rec = _Recorder()
    rec.install()
    report = {"rank": rank, "world": world}

    def out(name):
        return os.path.join(root, launch, name)

    def baseline(name, data, **kw):
        rec.at(name)
        argv = _cli_args(data, out(name), **kw)
        tbaseline.main(argv)

    counter = _WriteCounter(root) if rank == 1 else None
    if counter is not None:
        counter.__enter__()
    try:
        baseline("baseline", spec["things"])
        if launch in ("dp2", "alone"):
            baseline("nan", spec["things_nan"], epochs=2)
            baseline("partial", spec["things"], batch=20, epochs=2)
            rec.at("frozen")
            tbaseline.main(_cli_args(spec["things"], out("frozen"),
                                     epochs=2) + ["--frozen_cache"])
            # a sequential sweep run: data-parallel over the ranks
            rec.at("sequential")
            report["sequential_failed"] = tsweep.main(
                _fork_args(spec, out("sequential")) + [
                    "--perturb_type", "label_shuffle", "--training_order",
                    "2"])
        if launch == "dp2":
            # a notice on rank 1 during epoch 1 stops both after it; the
            # run then resumes in place
            rec.at("preempt")
            cfg = _config(spec["things"], out("preempt"))
            evaluate = tloop.ClipHBATrainer.evaluate_resident
            calls = []

            def evaluate_then_signal(self, *a, **k):
                calls.append(1)
                if rank == 1 and len(calls) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return evaluate(self, *a, **k)
            tloop.ClipHBATrainer.evaluate_resident = evaluate_then_signal
            res = tloop.run_behavioral_training(cfg, device="cpu")
            tloop.ClipHBATrainer.evaluate_resident = evaluate
            report["preempt"] = {"preempted": res["preempted"],
                                 "last_epoch0": res["last_epoch0"]}
            res = tloop.run_behavioral_training(_resume(cfg, 1),
                                                device="cpu")
            report["preempt"]["resumed_preempted"] = res["preempted"]
        if grouped:
            rec.at("sweep")
            clamp = ["--fork_devices", "2"] if launch == "dp2" else []
            report["sweep_failed"] = tsweep.main(
                _fork_args(spec, out("sweep")) + [
                    "--perturb_type", "label_shuffle", "--training_order",
                    "1,2", "--batched_forks", "2", *clamp])
            rec.at("lengths")
            report["lengths_failed"] = tlengths.main(
                _fork_args(spec, out("lengths")) + [
                    "--perturb_type", "random_target", "--perturb_length",
                    "1", "--onsets", "1,2", "--batched_forks", "2"])
    finally:
        if counter is not None:
            counter.__exit__()
            report["rank1_writes"] = counter.paths
    if grouped:
        checks = {}
        for name, value in (("equal", 1.0), ("differ", float(rank))):
            try:
                tdist_mod.check_replicas_equal([torch.full((3,), value)], "x")
                checks[name] = "passed"
            except RuntimeError:
                checks[name] = "raised"
        report["replica_check"] = checks
    if launch == "dp2":
        _perturbed_inputs(spec, report)
    report["seen"] = rec.seen
    with open(os.path.join(root, f"report_{launch}_rank{rank}.json"),
              "w") as f:
        json.dump(report, f)
    if grouped:
        torch.distributed.destroy_process_group()


# -- fixtures -------------------------------------------------------------------

def _write_things(root, nan_at=None):
    """test_torch_training.py's synthetic THINGS (60 train PNGs, 48
    inference, an RDM); `nan_at` puts a NaN into that row's targets."""
    from PIL import Image
    import pandas as pd
    import scipy.io
    img_dir = os.path.join(root, "images")
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(0)
    names = []
    for i in range(60):
        name = f"thing_{i:03d}.png"
        img = rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)
        if nan_at is None:
            os.makedirs(img_dir, exist_ok=True)
            Image.fromarray(img).save(os.path.join(img_dir, name))
        names.append(name)
    df = pd.DataFrame({"image_name": names})
    for j in range(66):
        df[f"d{j}"] = (rs.rand(60) * 2).astype(np.float32)
    if nan_at is not None:
        df.loc[nan_at, "d3"] = np.nan
    df.to_csv(os.path.join(root, "spose_train.csv"))
    inf = pd.DataFrame({"image_name": names[:48]})
    for j in range(66):
        inf[f"d{j}"] = (rs.rand(48) * 2).astype(np.float32)
    inf.to_csv(os.path.join(root, "spose_val.csv"))
    rdm = rs.rand(48, 48)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    scipy.io.savemat(os.path.join(root, "RDM48_triplet.mat"),
                     {"RDM48_triplet": rdm})
    return {"csv_file": os.path.join(root, "spose_train.csv"),
            "img_dir": img_dir,
            "inference_csv_file": os.path.join(root, "spose_val.csv"),
            "RDM48_triplet_dir": os.path.join(root, "RDM48_triplet.mat")}


def _rank_one_row():
    """A training row that epoch 1's first batch (16 rows, 8 a rank) puts
    in rank 1's block, as a row of the THINGS CSV."""
    from vit_project_torch.data import things as tthings
    train_idx, _ = tthings.random_split_indices(60, 0.8, SEED)
    first = next(iter(tthings.EpochShuffler(48, BATCH, SEED).batches(0)))
    return int(train_idx[first[12]])


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The JAX runs, then the three launches at once; returns the root,
    the spec and {launch: [reports by rank]}."""
    import jax
    from vit_project_tpu.adapters import dora as jadora
    from vit_project_tpu.models import clip as jclip
    from vit_project_tpu.models import convert as jconvert
    from vit_project_tpu.train import clip_loop as jloop
    from vit_project_torch.models import clip as tclip
    from vit_project_torch.models import convert as tconvert
    root = str(tmp_path_factory.mktemp("clip_parallel"))
    things = _write_things(os.path.join(root, "things"))
    nan_row = _rank_one_row()
    things_nan = dict(things, **{
        k: v for k, v in _write_things(os.path.join(root, "things_nan"),
                                       nan_at=nan_row).items()
        if k != "img_dir"})

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)
    jcfg = jclip.tiny_clip_config(width=128, layers=2, heads=2, patch=32,
                                  image_size=64, embed_dim=32, vocab=49408,
                                  context=16)
    tcfg = tclip.tiny_clip_config(width=128, layers=2, heads=2, patch=32,
                                  image_size=64, embed_dim=32, vocab=49408,
                                  context=16)
    params = np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    weights = os.path.join(root, "tiny_clip.pt")
    tcfg = tconvert.clip_config_from_state_dict(
        tconvert.clip_state_dict_from_jax_params(params, tcfg))
    torch.save(tconvert.clip_state_dict_from_jax_params(params, tcfg),
               weights)
    things["weights"] = things_nan["weights"] = weights
    jparams, jc = jconvert.clip_params_from_state_dict(
        jconvert.load_torch_state_dict(weights))
    spec_ = jadora.dora_spec(jc.visual.layers, jc.text.layers, 2, 2)
    jtr, jst, acfg = jadora.apply_dora(
        jax.tree_util.tree_map(jax.numpy.asarray, jparams), spec_, r=4,
        alpha=16, dropout=0.0, key=jax.random.PRNGKey(SEED + 123))
    adapters = os.path.join(root, "adapters.pkl")
    with open(adapters, "wb") as f:
        pickle.dump({"trainable": tconvert.adapters_from_jax(np_tree(jtr)),
                     "static": tconvert.adapters_from_jax(np_tree(jst)),
                     "acfg": dict(acfg)}, f)
    jax_cfg = _config(things, os.path.join(root, "jax"))
    assert jloop.run_behavioral_training(jax_cfg)["last_epoch0"] == 2
    assert jax.device_count() == 8
    spec = {"root": root, "things": things, "things_nan": things_nan,
            "adapters": adapters, "jax_tree": os.path.join(root, "jax"),
            "nan_row": nan_row}
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node"]
    cmds = {"dp2": run + ["2", __file__, spec_path, "dp2"],
            "dp1": run + ["1", __file__, spec_path, "dp1"],
            "alone": [sys.executable, __file__, spec_path, "alone"]}
    procs = {name: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=LAUNCH_TIMEOUT)[0]
    finally:
        for p in procs.values():     # a hang fails the fixture, not the run
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name}:\n{outs[name][-8000:]}"
    reports = {name: [] for name in cmds}
    for name, nproc in (("dp2", 2), ("dp1", 1), ("alone", 1)):
        for r in range(nproc):
            with open(os.path.join(root, f"report_{name}_rank{r}.json")) as f:
                reports[name].append(json.load(f))
    return root, spec, jax_cfg, reports


def _baseline_csv(root, launch, name="baseline"):
    return _rows(_stamped(os.path.join(root, launch, name), "training_res_"))


# -- the data-parallel baseline ---------------------------------------------------

def test_two_ranks_match_jax_and_one_process(launches):
    """cli.baseline over 2 gloo ranks: each epoch within 2e-4 (losses) and
    2e-3 (rho, p) of JAX's data-parallel run and of the port's run alone;
    the same file tree as alone, with one log."""
    root, _, jax_cfg, _ = launches
    dp2, alone = _baseline_csv(root, "dp2"), _baseline_csv(root, "alone")
    jax_rows = _rows(jax_cfg["training_res_path"])
    assert dp2[0] == alone[0] == jax_rows[0] and len(dp2) == EPOCHS + 1
    for a, b, c in zip(dp2[1:], alone[1:], jax_rows[1:]):
        _close(a, b)
        _close(a, c)
    tree = _tree(os.path.join(root, "dp2", "baseline"))
    assert tree == _tree(os.path.join(root, "alone", "baseline"))
    assert [f for f in tree if f.startswith("training_log_")] == [
        "training_log_T.txt"]


def test_rank_one_writes_no_file(launches):
    _, _, _, reports = launches
    assert reports["dp2"][1]["rank1_writes"] == []
    assert reports["dp2"][0]["world"] == 2


def test_ranks_hold_equal_adapters_and_moments_after_every_step(launches):
    """Each step's loss, skip flag and digest of the adapters and AdamW
    moments, rank against rank, in every scenario."""
    _, _, _, reports = launches
    r0, r1 = (r["seen"] for r in reports["dp2"])
    assert set(r0) == set(r1)
    for name in r0:
        assert r0[name]["steps"] == r1[name]["steps"], name
    assert len(r0["baseline"]["steps"]) == EPOCHS * 3


def test_world_size_one_is_the_run_alone_bit_for_bit(launches):
    """torchrun with one rank runs the data-parallel step (one all-reduce
    of one rank): rows, DoRA and random-state files as the run alone's."""
    root, _, _, reports = launches
    assert reports["dp1"][0]["seen"]["baseline"]["local_ok"]
    assert not reports["alone"][0]["seen"]["baseline"]["local_ok"]
    one, alone = (_file_bytes(os.path.join(root, k, "baseline"))
                  for k in ("dp1", "alone"))

    def unstamped(files):
        return {re.sub(r"_\d{8}_\d{6}", "_T", k): v for k, v in files.items()}
    assert unstamped(one) == unstamped(alone)
    assert len(one) == 1 + 2 * EPOCHS + 1    # CSV, 2 files an epoch, split


def test_a_non_finite_row_on_rank_one_skips_the_step_on_both(launches):
    """A NaN target in rank 1's block of epoch 1's first batch: rank 1's
    share is not finite, rank 0's is, and both skip the step; the steps
    skipped and the rows agree with a run alone on the same data."""
    root, _, _, reports = launches
    r0, r1 = (r["seen"]["nan"] for r in reports["dp2"])
    assert r1["local_ok"][0] is False and r0["local_ok"][0] is True
    oks = [s[1] for s in r0["steps"]]
    assert oks[0] is False and oks == [s[1] for s in r1["steps"]]
    assert oks == [s[1] for s in reports["alone"][0]["seen"]["nan"]["steps"]]
    dp2, alone = (_baseline_csv(root, k, "nan") for k in ("dp2", "alone"))
    assert len(dp2) == len(alone) == 3
    for a, b in zip(dp2[1:], alone[1:]):
        _close(a, b)


def test_partial_last_batch_of_padding_only_trains_on_both(launches):
    """Batches 20, 20, 8 over 2 ranks: the last batch's second block holds
    padding only, and rank 1 still runs (padded rows, no empty attention
    call) and joins the all-reduce; rows within the bounds of alone's."""
    root, _, _, reports = launches
    r0, r1 = (r["seen"]["partial"] for r in reports["dp2"])
    assert r0["empty_blocks"] == 0 and r1["empty_blocks"] == 2
    assert len(r0["steps"]) == len(r1["steps"]) == 2 * 3
    assert min(r0["min_attention_batch"], r1["min_attention_batch"]) > 0
    dp2, alone = (_baseline_csv(root, k, "partial") for k in ("dp2", "alone"))
    for a, b in zip(dp2[1:], alone[1:]):
        _close(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_perturbed_epoch_gives_one_process_inputs_row_for_row(launches,
                                                             kind):
    """Each rank's perturbed block equals the one-process batch's rows;
    label_shuffle permutes across the ranks' blocks."""
    _, _, _, reports = launches
    for rep in reports["dp2"]:
        assert rep["perturbed"][kind]["equal"], (rep["rank"], kind)
        if kind == "label_shuffle":
            assert rep["perturbed"][kind]["crossed"]


def test_a_notice_on_one_rank_stops_both_and_the_resume_completes(launches):
    root, _, _, reports = launches
    for rep in reports["dp2"]:
        assert rep["preempt"] == {"preempted": True, "last_epoch0": 0,
                                  "resumed_preempted": False}
    rows = _rows(os.path.join(root, "dp2", "preempt", "training_res.csv"))
    assert rows == _baseline_csv(root, "dp2")


def test_sequential_sweep_run_trains_over_two_ranks(launches):
    """cli.sweep without batching under torchrun: the run (a label_shuffle
    fork of the JAX baseline at epoch 2) trains data-parallel, within the
    bounds of the same run alone; rank 0 reports no failed run."""
    root, _, _, reports = launches
    rows = [_rows(os.path.join(root, k, "sequential", "training_run2",
                               "training_res_run2.csv"))
            for k in ("dp2", "alone")]
    assert [r[0] for r in rows[0][1:]] == ["2", "3"]
    for a, b in zip(rows[0][1:], rows[1][1:]):
        _close(a, b)
    assert rows[0][1][6] == "True"         # the label_shuffle window
    assert all(len(r["seen"]["sequential"]["steps"]) == 2 * 3
               for r in reports["dp2"])
    assert reports["dp2"][0]["sequential_failed"] == []


def test_replica_check_names_the_rank_that_differs(launches):
    _, _, _, reports = launches
    assert [r["replica_check"] for r in reports["dp2"]] == [
        {"equal": "passed", "differ": "passed"},
        {"equal": "passed", "differ": "raised"}]


def test_frozen_cache_run_over_two_ranks(launches):
    """--frozen_cache over 2 ranks within the bounds of alone's; the cache
    itself equals the one-process cache bit for bit."""
    root, _, _, reports = launches
    dp2, alone = (_baseline_csv(root, k, "frozen") for k in ("dp2", "alone"))
    assert len(dp2) == 3
    for a, b in zip(dp2[1:], alone[1:]):
        _close(a, b)
    assert all(rep["cache_equal"] for rep in reports["dp2"])


# -- batched forks under torchrun ----------------------------------------------------

@pytest.mark.parametrize("cli", ["sweep", "lengths"])
def test_batched_forks_over_two_ranks_equal_one_process(launches, cli):
    """cli.sweep --batched_forks 2 (runs 1, 2; with --fork_devices 2,
    clamped to one device here) and cli.lengths --onsets 1,2 over 2 ranks:
    CSVs and checkpoints bit-equal to one rank's; every rank trains the
    same groups."""
    root, _, _, reports = launches
    two, one = (_file_bytes(os.path.join(root, k, cli))
                for k in ("dp2", "dp1"))
    n_csv = sum(k.endswith(".csv") for k in two)
    assert n_csv == 2 and len(two) > 2 and two == one
    r0, r1 = (r["seen"][cli]["fork_losses"] for r in reports["dp2"])
    assert r0 and r0 == r1
    assert reports["dp2"][0][f"{cli}_failed"] == []
    if cli == "sweep":
        log = _stamped(os.path.join(root, "dp2", "sweep"),
                       "main_training_log_")
        with open(log) as f:
            assert "Fork axis on 1 device (requested 2)" in f.read()


# -- refusals and helpers ------------------------------------------------------

def test_workers_under_torchrun_raise_before_dispatch(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="under torchrun"):
        tsweep.main(["--csv_file", "c", "--img_dir", "i",
                     "--inference_csv_file", "v", "--RDM48_triplet_dir", "r",
                     "--baseline_dora_directory", "d",
                     "--baseline_random_state_path", "s",
                     "--baseline_split_indices_path", "x",
                     "--output_base_directory", str(out), "--workers", "2",
                     "--device", "cpu"])
    assert not out.exists()


def test_sequence_parallel_still_raises():
    """Sequence parallelism is ported (tests/test_torch_sp.py); without its
    ("data", "model") mesh the trainer raises JAX's refusal."""
    with pytest.raises(ValueError, match=r"sp=True needs a \('data','model'\) "
                                         r"mesh"):
        tloop.ClipHBATrainer(None, torch.nn.Linear(1, 1), {}, {}, [[0]],
                             lr=1.0, sp=True)


def test_local_rows_refuses_a_ragged_batch():
    tr = tloop.ClipHBATrainer.__new__(tloop.ClipHBATrainer)
    tr.world, tr.rank = 2, 1
    assert tr._local_rows(np.arange(6)).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="must divide by 2 processes"):
        tr._local_rows(np.arange(5))
    idx, valid = tr._prep_idx(np.arange(7), 8)
    assert idx.tolist() == [4, 5, 6, 0] and valid.tolist() == [1, 1, 1, 0]


def test_fork_devices_clamp_like_jax(monkeypatch, capsys):
    """min(requested, this host's cards, the group's forks): one device
    runs as today and says so; more than one raises: not ported."""
    assert tmf.make_fork_mesh(1, 8) is None
    assert tmf.make_fork_mesh(4, 8) is None          # no card here
    assert "Fork axis on 1 device (requested 4)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tmf.make_fork_mesh(4, 1) is None          # one fork in the group
    with pytest.raises(NotImplementedError,
                       match="fork axis over several cards is not ported"):
        tmf.make_fork_mesh(4, 3)

    class Mesh:
        def size(self):
            return 2
    assert tmf.per_chip_forks(5, None) == 5
    assert tmf.per_chip_forks(5, Mesh()) == 3


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
