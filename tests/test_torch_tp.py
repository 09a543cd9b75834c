"""The port's tensor parallelism (``--tp_devices``: parallel/mesh.py's
("data", "model") mesh and Megatron placement, models/vit.py's
``classifier_block_tp``, train/vit_loop.py's mode "tp") against the JAX
package's tp run and against the port's own data parallelism.

Two ``torchrun --standalone`` launches run this file as a script at once,
gloo on the CPU, one thread a rank: "tp2" (2 ranks: data 1 x model 2) and
"tp4" (4 ranks: data 2 x model 2). Each rank works through its scenarios
and writes what it saw to a JSON file; the tests read those files and the
runs' trees. The JAX run is ``run_vit_training(tp_devices=2)`` on its
8-device virtual mesh (tests/conftest.py), in the pytest process; the
port's runs resume its epoch 0 and are held to its epoch 1 (rows to
LOSS_RTOL, trees within JAX's own tp-against-dp bound,
tests/test_vit_training.py).

The model is the JAX fixture's test-tiny ViT (width 32, 2 blocks, 2 heads,
3 classes, so T = 2 keeps one head a rank) on its ImageFolder (3 x 16
train, 3 x 8 val PNGs at 48^2), global batch 8, float32.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from vit_project_torch.ckpt import vit_ckpt as tckpt
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.parallel import dist as tdist_mod
from vit_project_torch.parallel import mesh as tmesh
from vit_project_torch.train import vit_loop as tloop

LAUNCHES = {"tp2": 2, "tp4": 4}
TP = 2
TTINY = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)
# float32 in another summation order over an epoch (the port's tolerance
# against JAX, tests/test_torch_vit_training.py _assert_rows_close)
LOSS_RTOL = 1e-4
# JAX's bound between its own modes, tp against dp included
# (tests/test_vit_training.py)
MODE_RTOL, MODE_ATOL = 1e-4, 1e-5
# both launches at once, 6 ranks on the host: ~30 s alone, several times
# that beside other files' launches under xdist
LAUNCH_TIMEOUT = 600
STEPS = 6          # an epoch: 48 train images at global batch 8


def _tiny(cfg_cls, data, out, epochs=2, **kw):
    return cfg_cls(data_path=data, output_dir=out, batch_size=8,
                   epochs=epochs, lr=0.01, warmup_epochs=1, num_workers=2,
                   num_classes=3, image_size=32, compute_dtype="float32",
                   random_seed=0, **kw)


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


def _assert_runs_close(got_dir, want_dir, rtol=MODE_RTOL, atol=MODE_ATOL):
    got, want = _metrics(got_dir), _metrics(want_dir)
    assert list(got["epoch"]) == list(want["epoch"])
    np.testing.assert_allclose(got[["train_loss", "val_loss"]].values,
                               want[["train_loss", "val_loss"]].values,
                               rtol=rtol)
    # accuracy within one of the 24 val images
    assert (abs(got["val_acc"] - want["val_acc"]) <= 100 / 24 + 1e-6).all()
    for a, b in zip(_trees(got_dir), _trees(want_dir)):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


# -- the ranks ----------------------------------------------------------------

def _worker(spec_path, launch):
    """One rank of `launch`: its scenarios in order; what it saw goes to
    report_{launch}_rank{r}.json beside the spec."""
    import torch.distributed as tdist
    from vit_project_torch.data.packed import make_loader

    with open(spec_path) as f:
        spec = json.load(f)
    root, data = os.path.join(spec["root"], launch), spec["data"]
    rank, world = tdist_mod.setup_distributed("cpu")
    report = {"rank": rank, "world": world, "backend": tdist.get_backend(),
              "checked_steps": {}, "same_images_steps": {}}
    run_name = {}

    # after every tp step: the data group's ranks hold equal shards and
    # momentum, the model group's equal whole leaves, and the model group's
    # ranks trained on the same images
    step = tloop.ViTTrainer.step

    def checked_step(self, momentum, images_u8, labels, *a, **k):
        loss = step(self, momentum, images_u8, labels, *a, **k)
        if self.mode == "tp":
            self.check_replicas(momentum)
            key = run_name["run"]
            report["checked_steps"][key] = \
                report["checked_steps"].get(key, 0) + 1
            seen = tdist_mod.all_gather_rows(images_u8.float(),
                                             self.tp_group)
            lbls = tdist_mod.all_gather_rows(labels, self.tp_group)
            if all(torch.equal(seen[0], s) for s in seen) and \
                    all(torch.equal(lbls[0], s) for s in lbls):
                report["same_images_steps"][key] = \
                    report["same_images_steps"].get(key, 0) + 1
        return loss
    tloop.ViTTrainer.step = checked_step

    def run(name, **kw):
        run_name["run"] = name
        out = os.path.join(root, name)
        return tloop.run_vit_training(_tiny(TTrainConfig, data, out, **kw),
                                      vit_cfg=TTINY, device="cpu")

    run("tp_from_jax", tp_devices=TP)
    run("tp", tp_devices=TP)
    if launch == "tp2":
        run("tp_remat", tp_devices=TP, remat=True)
        run("dp")
        # cross-resumes: dp's epoch 0 under tp, tp's under dp
        for name, src, kw in (("tp_from_dp", "dp", dict(tp_devices=TP)),
                              ("dp_from_tp", "tp", {})):
            if rank == 0:
                _resume_dir(os.path.join(root, src), os.path.join(root, name))
            tdist.barrier()
            run(name, **kw)

    # within a model group the whole leaves' gradients are equal before the
    # data all-reduce (the copy / reduce pair), and the shards' are not
    cfg = _tiny(TTrainConfig, data, "x", tp_devices=TP)
    gen = torch.Generator().manual_seed(0)
    model = tvit.init_vit_params(tvit.empty_vit(TTINY, "cpu"), gen)
    trainer = tloop.ViTTrainer(TTINY, cfg, model, "cpu")
    loader = make_loader(f"{data}/train", cfg.batch_size // trainer.n_data,
                         train=True, seed=0, size=32, workers=1,
                         drop_last=True, num_shards=trainer.n_data,
                         shard_id=trainer.data_rank)
    images, labels = trainer.place(*next(iter(loader.epoch(0))))
    named = list(model.named_parameters())
    _, grads = trainer.batch_grads([p for _, p in named], images, labels)
    tp_names = set(trainer.shard_names())
    for kind in ("whole", "shard"):
        flat = torch.cat([g.reshape(-1) for (n, _), g in zip(named, grads)
                          if (n in tp_names) == (kind == "shard")])
        both = tdist_mod.all_gather_rows(flat, trainer.tp_group)
        report[f"{kind}_grads_equal"] = all(torch.equal(both[0], b)
                                            for b in both)
    report["data_rank"], report["model_rank"] = (trainer.data_rank,
                                                 trainer.model_rank)
    report["local_batch"] = loader.batch_size
    with open(os.path.join(spec["root"], f"report_{launch}_rank{rank}.json"),
              "w") as f:
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


def _jtiny():
    from vit_project_tpu.models import vit as jvit
    return jvit.ViTConfig(patch=8, width=32, layers=2, heads=2,
                          image_size=32, num_classes=3)


@pytest.fixture(scope="module")
def ranks(imagenet, tmp_path_factory):
    """JAX's tp run (in this process, on its 8-device virtual mesh), then
    the two launches at once; returns the root of the trees and the ranks'
    reports by launch."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    root = str(tmp_path_factory.mktemp("tp"))
    jrun(_tiny(JTrainConfig, imagenet, os.path.join(root, "jax_tp"),
               tp_devices=TP), vit_cfg=_jtiny())
    assert jax.device_count() == 8
    for launch in LAUNCHES:
        _resume_dir(os.path.join(root, "jax_tp"),
                    os.path.join(root, launch, "tp_from_jax"))
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"root": root, "data": imagenet}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = {launch: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), __file__, spec_path, launch],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for launch, n in LAUNCHES.items()}
    outs = {}
    try:
        for launch, p in procs.items():
            outs[launch] = p.communicate(timeout=LAUNCH_TIMEOUT)[0]
    finally:
        for p in procs.values():     # a hang fails the fixture, not the run
            if p.poll() is None:
                p.kill()
                p.communicate()
    for launch, p in procs.items():
        assert p.returncode == 0, f"{launch}:\n{outs[launch][-8000:]}"
    reports = {}
    for launch, n in LAUNCHES.items():
        reports[launch] = []
        for r in range(n):
            with open(os.path.join(root, f"report_{launch}_rank{r}.json")) as f:
                reports[launch].append(json.load(f))
    return root, reports


# -- parallel/mesh.py: JAX's placement on the port's flat state ----------------

def test_shards_are_the_slices_jax_places_on_each_model_device():
    """Every block leaf of model rank t is the slice JAX's
    shard_vit_params_tp puts on the device at model index t of its
    ('data', 'model') mesh; the other leaves stay whole; unshard is the
    inverse bit for bit."""
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import mesh as jmesh
    jtree = jvit.init_vit_params(jax.random.PRNGKey(3), _jtiny())
    jm = jmesh.make_mesh(n_model=TP)
    placed = jmesh.shard_vit_params_tp(jm, jtree, heads=2)
    state = tconvert.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtree), TTINY.patch)
    D, Dl = 32, 32 // TP

    def on(x, t):
        dev = jm.devices[0, t]
        return np.asarray(next(s.data for s in x.addressable_shards
                               if s.device == dev))

    shards = [tmesh.shard_vit_params_tp(state, TP, t, heads=2)
              for t in range(TP)]
    for t, local in enumerate(shards):
        for i, jb in enumerate(placed["blocks"]):
            p = f"blocks.{i}."
            qkv = local[p + "attn.qkv.weight"].numpy()
            assert qkv.shape == (3 * Dl, D)
            np.testing.assert_array_equal(
                qkv.reshape(3, Dl, D).transpose(2, 0, 1), on(jb["qkv_w"], t))
            np.testing.assert_array_equal(
                local[p + "attn.qkv.bias"].numpy().reshape(3, Dl),
                on(jb["qkv_b"], t))
            for name, jname in (("attn.proj.weight", "out_w"),
                                ("mlp.fc1.weight", "fc1_w"),
                                ("mlp.fc2.weight", "fc2_w")):
                np.testing.assert_array_equal(local[p + name].numpy().T,
                                              on(jb[jname], t))
            np.testing.assert_array_equal(local[p + "mlp.fc1.bias"].numpy(),
                                          on(jb["fc1_b"], t))
            for name, jname in (("attn.proj.bias", "out_b"),
                                ("mlp.fc2.bias", "fc2_b")):
                assert jb[jname].sharding.is_fully_replicated
                assert local[p + name] is state[p + name]
        for name in ("cls_token", "pos_embed", "head.weight", "norm.weight"):
            assert local[name] is state[name]
    assert sorted(n for n in state if tmesh.tp_layout(n)) == sorted(
        f"blocks.{i}.{leaf}" for i in range(2) for leaf in tmesh.TP_LEAVES)
    back = tmesh.unshard_vit_params_tp(shards)
    assert back.keys() == state.keys()
    for name, x in state.items():
        assert torch.equal(back[name], x), name
    with pytest.raises(ValueError, match="must divide heads"):
        tmesh.shard_vit_params_tp(state, 4, 0, heads=2)
    with pytest.raises(ValueError, match="must divide heads"):
        jmesh.shard_vit_params_tp(jmesh.make_mesh(n_model=4), jtree, heads=2)


def test_tp_block_on_each_ranks_heads_is_the_whole_block(monkeypatch):
    """classifier_block_tp on each model rank's shards, with the group's
    all-reduce replaced by the sum over the ranks' parts computed here,
    gives the whole block's output; its packed qkv is [q_t | k_t | v_t] of
    the whole block's (the colscale on the rank's q columns only)."""
    torch.manual_seed(0)
    model = tvit.init_vit_params(tvit.empty_vit(TTINY, "cpu"),
                                 torch.Generator().manual_seed(0))
    blk = model.blocks[0]
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn_like(p))   # non-zero biases
    x = torch.randn(3, TTINY.seq_len, 32)
    act = tvit._activation(TTINY)
    qkvs, rank_of = {}, {threading.get_ident(): "whole"}
    attn = tvit.vattn.flash_mha_packed_qkv

    def recording(qkv, **kw):
        qkvs[rank_of[threading.get_ident()]] = qkv
        return attn(qkv, **kw)
    monkeypatch.setattr(tvit.vattn, "flash_mha_packed_qkv", recording)
    want = tvit.classifier_block(blk, x, 2, act=act)
    state = {f"blocks.0.{n}": p.detach() for n, p in blk.named_parameters()}
    parts = []
    for t in range(TP):
        b = tvit.Block(32, 4)
        for name, v in tmesh.shard_vit_params_tp(state, TP, t).items():
            owner, leaf = name[len("blocks.0."):].rsplit(".", 1)
            setattr(b.get_submodule(owner), leaf, torch.nn.Parameter(v))
        parts.append(b)
    # the all-reduce as the sum of the ranks' parts: run the ranks in lock
    # step, one thread each, and sum what they hand in
    barrier = threading.Barrier(TP)
    pending, lock = {}, threading.Lock()

    def fake_all_reduce(t, group=None, **kw):
        me = threading.get_ident()
        with lock:
            pending[me] = t.clone()
        barrier.wait()
        total = sum(pending[k] for k in sorted(pending))
        barrier.wait()
        t.copy_(total)
    monkeypatch.setattr(tvit.tdist, "all_reduce", fake_all_reduce)
    monkeypatch.setattr(tvit.tdist, "get_world_size", lambda group=None: TP)
    outs = [None] * TP

    def rank(t):
        rank_of[threading.get_ident()] = t
        outs[t] = tvit.classifier_block_tp(parts[t], x, 2, act=act,
                                           group="model")
    threads = [threading.Thread(target=rank, args=(t,)) for t in range(TP)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    for out in outs:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    whole = qkvs["whole"]
    D, Dl = 32, 32 // TP
    for t in range(TP):
        local = qkvs[t]
        assert local.shape == (3, TTINY.seq_len, 3 * Dl)
        cols = [c for j in range(3) for c in range(j * D + t * Dl,
                                                   j * D + (t + 1) * Dl)]
        torch.testing.assert_close(local, whole[..., cols], rtol=1e-5,
                                   atol=1e-6)


# -- the runs -----------------------------------------------------------------

@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_tp_matches_the_jax_tp_run_on_its_virtual_mesh(ranks, launch):
    """Resumed from JAX's tp run's epoch 0 (its flat checkpoint), the
    port's tp run trains epoch 1 as JAX's does: rows to LOSS_RTOL,
    accuracy within one image, the flat trees within JAX's tp bound."""
    root, _ = ranks
    got = os.path.join(root, launch, "tp_from_jax")
    assert list(_metrics(got)["epoch"]) == [0, 1]
    _assert_runs_close(got, os.path.join(root, "jax_tp"), rtol=LOSS_RTOL)


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_tp_checkpoint_is_flat_and_equals_the_ports_dp_run(ranks, launch):
    """From the port's seed, tp (data 1 or 2 x model 2) trains as the
    2-rank dp run does, and its checkpoint holds the flat layout: qkv_w
    [D, 3D], fc1_w [D, 4D], the momentum alike."""
    root, _ = ranks
    got = os.path.join(root, launch, "tp")
    _assert_runs_close(got, os.path.join(root, "tp2", "dp"))
    params, momentum = _trees(got)
    for tree in (params, momentum):
        for bp in tree["blocks"]:
            assert np.asarray(bp["qkv_w"]).shape == (32, 96)
            assert np.asarray(bp["qkv_b"]).shape == (96,)
            assert np.asarray(bp["fc1_w"]).shape == (32, 128)
            assert np.asarray(bp["out_w"]).shape == (32, 32)


def test_remat_under_tp_is_bit_equal(ranks):
    """remat replays each block's forward, all-reduces included, in the
    backward on every rank alike: the same rows and trees, bit for bit."""
    root, _ = ranks
    pd.testing.assert_frame_equal(_metrics(os.path.join(root, "tp2",
                                                        "tp_remat")),
                                  _metrics(os.path.join(root, "tp2", "tp")))
    for a, b in zip(_trees(os.path.join(root, "tp2", "tp_remat")),
                    _trees(os.path.join(root, "tp2", "tp"))):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_checkpoints_cross_resume_between_tp_dp_and_one_process(
        ranks, imagenet, tmp_path):
    """dp's epoch 0 resumed under tp, tp's under dp and in one process:
    each epoch-1 row and final tree within JAX's bound of the uninterrupted
    run's. (JAX's tp checkpoint under the port's tp is
    test_tp_matches_the_jax_tp_run_on_its_virtual_mesh.)"""
    root, _ = ranks
    tp2 = os.path.join(root, "tp2")
    one = str(tmp_path / "one_from_tp")
    _resume_dir(os.path.join(tp2, "tp"), one)
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, one),
                           vit_cfg=TTINY, device="cpu")
    for got, want in (("tp_from_dp", "dp"), ("dp_from_tp", "tp")):
        _assert_runs_close(os.path.join(tp2, got), os.path.join(tp2, want))
    _assert_runs_close(one, os.path.join(tp2, "tp"))


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_replicas_hold_and_model_groups_read_one_shard(ranks, launch):
    """After every tp step (the worker raised at the first difference)
    the data group's ranks held equal shards and momentum and the model
    group's equal whole leaves; the two ranks of a model group trained on
    the same images every step, the data axis split the batch (rank r is
    data rank r // 2, model rank r % 2)."""
    _, reports = ranks
    runs = ["tp_from_jax", "tp"] + (["tp_remat", "tp_from_dp"]
                                    if launch == "tp2" else [])
    want = {"tp_from_jax": STEPS, "tp": 2 * STEPS, "tp_remat": 2 * STEPS,
            "tp_from_dp": STEPS}
    n = LAUNCHES[launch]
    for r, rep in enumerate(reports[launch]):
        assert rep["world"] == n and rep["backend"] == "gloo"
        assert (rep["data_rank"], rep["model_rank"]) == (r // TP, r % TP)
        assert rep["local_batch"] == 8 // (n // TP)
        assert rep["checked_steps"] == {k: want[k] for k in runs}
        assert rep["same_images_steps"] == rep["checked_steps"]


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_whole_leaf_gradients_agree_within_a_model_group(ranks, launch):
    """Before the data all-reduce the whole leaves' gradients are already
    equal on a model group's ranks (so tp all-reduces them over the data
    group only); the shards' gradients differ."""
    for rep in ranks[1][launch]:
        assert rep["whole_grads_equal"] is True
        assert rep["shard_grads_equal"] is False


# -- refusals -----------------------------------------------------------------

# (config change, model change, words both packages raise)
REFUSALS = {
    "sp": (dict(sp_devices=2), {}, "enable at most one"),
    "pp": (dict(pp_stages=2), {}, "enable at most one"),
    "ep": (dict(ep_devices=2), dict(moe_experts=4), "enable at most one"),
    "moe": ({}, dict(moe_experts=4), "does not compose with MoE blocks"),
    "heads": (dict(tp_devices=4), {}, "must divide the model heads"),
    "zero1": (dict(zero1=True), {}, "do not compose with tp_devices"),
    "fsdp": (dict(fsdp=True), {}, "do not compose with tp_devices"),
    "fused_dw": (dict(fused_dw=True), {}, "fused_dw is a single-chip path"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tp_refuses_what_jax_refuses_in_its_words(case, monkeypatch):
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.train.vit_loop import ViTTrainer as JTrainer
    kw, model_kw, words = REFUSALS[case]
    kw = {"tp_devices": TP, **kw}
    jcfg = dataclasses.replace(_tiny(JTrainConfig, "x", "x"), **kw)
    with pytest.raises(ValueError, match=re.escape(words)):
        JTrainer(dataclasses.replace(_jtiny(), **model_kw), jcfg)
    cfg = dataclasses.replace(_tiny(TTrainConfig, "x", "x"), **kw,
                              **({"moe_experts": 4} if model_kw else {}))
    monkeypatch.setattr(tdist_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=re.escape(words)):
        tloop.train_mode(cfg, True, TTINY.heads)


def test_tp_without_torchrun_is_refused(imagenet, tmp_path):
    """JAX drives the model axis from one process; the port's axis is the
    ranks of a process group, so one process cannot hold it."""
    cfg = _tiny(TTrainConfig, imagenet, str(tmp_path / "x"), tp_devices=TP)
    with pytest.raises(ValueError, match="torchrun"):
        tloop.run_vit_training(cfg, vit_cfg=TTINY, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        tloop.train_mode(cfg, False, TTINY.heads)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
