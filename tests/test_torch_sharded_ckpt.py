"""The port's per-rank sharded checkpoints: ``ckpt/serialization.py``
``save_sharded`` / ``load_sharded`` (torch.distributed.checkpoint) and
``ckpt/vit_ckpt.py``'s ``sharded=`` / ``template=`` and `.dcp` resolution,
the counterparts of the JAX package's orbax pair.

In one process: round trips of every kind of leaf, the `.dcp` beside the
`.pth` (latest, epoch, listing, pruning), a `.dcp` read back as the JAX-layout
trees a `.pth` holds, a JAX-written `.orbax` beside them resolved and read as
JAX reads it, the refusal of torn directories.

Across ranks: one ``torchrun --standalone --nproc_per_node 2`` launch of this
file (its ``__main__`` is the rank's worker), gloo on the CPU, one thread a
rank. Each rank takes one ZeRO-1 and one FSDP2 step of a tiny ViT, writes
each state with ``save_checkpoint(sharded=True)`` and restores it into a
fresh trainer's placement (other weights, zero momentum), into the other
mode's placement, and whole; rank 0 also saves the gathered state
(``full_state``). The tests read the ranks' reports, and check the shard
files' bytes against the gathered state here.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vit_project_torch.ckpt import serialization as tser
from vit_project_torch.ckpt import vit_ckpt as tckpt
from vit_project_torch.cli import dryrun as tdry
from vit_project_torch.cli import vit_rsa_eval as trsa
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.parallel import mesh as tmesh
from vit_project_torch.train import vit_loop as tloop

TINY = tvit.VIT_CONFIGS["test-tiny"]
WORLD = 2
BATCH = 8
LAUNCH_TIMEOUT = 300
MODES = ("zero1", "fsdp")


def _tree():
    gen = torch.Generator().manual_seed(3)
    return {"epoch": 4,
            "params": {"blocks.0.attn.qkv.weight": torch.randn(6, 4,
                                                                generator=gen),
                       "head.bias": torch.randn(3, generator=gen,
                                                dtype=torch.float64),
                       "step": torch.tensor(7)},
            "opt_state": {"ids": torch.arange(5, dtype=torch.int32),
                          "half": torch.randn(2, 2, generator=gen).bfloat16()},
            "scheduler_state": {"last_epoch": 5, "base_lr": 0.1,
                                "name": "cosine", "milestones": [1, 2]},
            "train_loss": np.float32(1.25), "val_acc": 50.0,
            "note": None}


def _assert_same(got, want):
    assert type(got) is dict and got.keys() == want.keys(), (got, want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same(g, w)
        elif isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        elif isinstance(w, np.generic):
            assert g == w.item() and type(g) is type(w.item()), k
        else:
            assert g == w and type(g) is type(w), k


# -- one process ------------------------------------------------------------------

def test_round_trip_in_one_process_every_leaf(tmp_path):
    """No process group: every leaf back bit for bit, whole (template None)
    and in place into a template (which need not name the leaves that are
    not tensors); numpy scalars come back as Python numbers."""
    path = str(tmp_path / "s.dcp")
    tree = _tree()
    tser.save_sharded(path, tree)
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    _assert_same(tser.load_sharded(path), tree)
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in tree["params"].items()},
                "opt_state": {k: torch.zeros_like(v)
                              for k, v in tree["opt_state"].items()}}
    leaves = [template["params"]["blocks.0.attn.qkv.weight"]]
    back = tser.load_sharded(path, template)
    assert back is template
    assert back["params"]["blocks.0.attn.qkv.weight"] is leaves[0]
    _assert_same(back, tree)


def test_saving_again_replaces_the_directory(tmp_path):
    path = str(tmp_path / "s.dcp")
    tser.save_sharded(path, _tree())
    open(os.path.join(path, "__9_0.distcp"), "w").close()
    tser.save_sharded(path, {"x": torch.ones(2)})
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    assert torch.equal(tser.load_sharded(path)["x"], torch.ones(2))


def test_a_torn_directory_raises(tmp_path):
    """No metadata (a write that did not finish), or a shard file cut
    short: the load raises, and vit_ckpt does not resolve the first."""
    tree = _tree()
    for cut in ("metadata", "shard"):
        out = tmp_path / cut
        path = tckpt.save_checkpoint(0, tree["params"], tree["opt_state"],
                                     {"last_epoch": 1}, 1.0, 2.0, 3.0,
                                     str(out), sharded=True)
        if cut == "metadata":
            os.unlink(os.path.join(path, ".metadata"))
            assert tckpt.epoch_checkpoint(str(out), 0) is None
            assert tckpt.latest_checkpoint(str(out)) is None
        else:
            shard = os.path.join(path, "__0_0.distcp")
            with open(shard, "r+b") as f:
                f.truncate(os.path.getsize(shard) // 2)
        err = (FileNotFoundError, "no .metadata") if cut == "metadata" \
            else (RuntimeError, "sharded checkpoint failed")
        for load in (tser.load_sharded, tckpt.load_checkpoint):
            with pytest.raises(err[0], match=err[1]):
                load(path)
        with pytest.raises(err[0], match=err[1]):
            tser.load_sharded(path, {"params": {
                k: torch.zeros_like(v) for k, v in tree["params"].items()}})


def _vit_state(seed=0):
    model = tvit.init_vit_params(tvit.empty_vit(TINY, "cpu"),
                                 torch.Generator().manual_seed(seed))
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(seed + 1)
    momentum = {n: torch.randn(p.shape, generator=gen)
                for n, p in params.items()}
    return params, momentum


def test_dcp_reads_as_the_pth_of_the_same_state(tmp_path):
    """load_checkpoint of a .dcp without a template: the dict a .pth of the
    same state holds (JAX-layout numpy trees, the scalars), so every
    reader (resume, measure, RSA, serve, export) takes either file."""
    params, momentum = _vit_state()
    sched = {"last_epoch": 2, "base_lr": 0.1}
    pth = tckpt.save_checkpoint(1, tconvert.vit_jax_from_state_dict(params),
                                tconvert.vit_jax_from_state_dict(momentum),
                                sched, 1.5, 2.5, 40.0, str(tmp_path / "a"))
    dcp = tckpt.save_checkpoint(1, params, momentum, sched, 1.5, 2.5, 40.0,
                                str(tmp_path / "b"), sharded=True)
    assert dcp.endswith("checkpoint_epoch_001.dcp")
    a, b = tckpt.load_checkpoint(pth), tckpt.load_checkpoint(dcp)
    assert a.keys() == b.keys()
    for k in ("epoch", "scheduler_state", "train_loss", "val_loss",
              "val_acc"):
        assert a[k] == b[k], k
    import jax
    for key in ("params", "opt_state"):
        la, lb = (jax.tree_util.tree_leaves(t[key]) for t in (a, b))
        assert len(la) == len(lb) == len(params)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    model = tvit.empty_vit(TINY, "cpu")
    tloop.load_trees(model, b["params"])
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    # both wrote the same metrics row
    rows = [open(os.path.join(tmp_path, d, "training_metrics.csv")).read()
            for d in ("a", "b")]
    assert rows[0] == rows[1]


def test_latest_and_epoch_resolve_dcp_beside_pth(tmp_path):
    """The newer of the .pth and the .dcp (dated by the pointer for
    'latest'), as JAX resolves .orbax beside .pth; a newer JAX-written
    .orbax is resolved and read; the listing and the pruning take .dcp
    epochs."""
    out = str(tmp_path)
    params, momentum = _vit_state()
    jp, jm = (tconvert.vit_jax_from_state_dict(t) for t in (params, momentum))
    assert tckpt.latest_checkpoint(out) is None
    tckpt.save_checkpoint(0, jp, jm, {}, 1.0, 1.0, 1.0, out)
    assert tckpt.latest_checkpoint(out).endswith("checkpoint_latest.pth")
    time.sleep(0.02)
    d1 = tckpt.save_checkpoint(1, params, momentum, {}, 1.0, 1.0, 1.0, out,
                               sharded=True)
    with open(os.path.join(out, tckpt.LATEST_PTR)) as f:
        assert f.read() == "checkpoint_epoch_001.dcp"
    assert tckpt.latest_checkpoint(out) == d1
    assert tckpt.epoch_checkpoint(out, 1) == d1
    assert tckpt.epoch_checkpoint(out, 0).endswith("checkpoint_epoch_000.pth")
    assert tckpt.epoch_checkpoint(out, 2) is None
    time.sleep(0.02)
    tckpt.save_checkpoint(1, jp, jm, {}, 1.0, 1.0, 1.0, out)
    assert tckpt.latest_checkpoint(out).endswith("checkpoint_latest.pth")
    assert tckpt.epoch_checkpoint(out, 1).endswith(".pth")
    assert [e for e, _ in trsa.list_epoch_checkpoints(out)] == [0, 1]
    time.sleep(0.02)
    d2 = tckpt.save_checkpoint(2, params, momentum, {}, 1.0, 1.0, 1.0, out,
                               sharded=True)
    assert tckpt.latest_checkpoint(out) == d2
    assert trsa.list_epoch_checkpoints(out) == [
        (0, tckpt.epoch_checkpoint(out, 0)), (1, tckpt.epoch_checkpoint(
            out, 1)), (2, d2)]
    removed = tckpt.prune_checkpoints(out, keep_last=1, current_epoch=2)
    assert sorted(removed) == ["checkpoint_epoch_000.pth",
                               "checkpoint_epoch_001.dcp",
                               "checkpoint_epoch_001.pth"]
    assert not os.path.exists(d1) and os.path.isdir(d2)
    # a newer pod-written .orbax (the JAX package's collective writer) is
    # JAX's choice, and the port's: resolved, listed and read as JAX reads it
    from vit_project_tpu.ckpt import vit_ckpt as jckpt
    time.sleep(0.02)
    d3 = jckpt.save_checkpoint(2, jp, jm, {"last_epoch": 3}, 1.0, 1.0, 1.0,
                               out, sharded=True)
    assert d3 == os.path.join(out, "checkpoint_epoch_002.orbax")
    assert tckpt.latest_checkpoint(out) == jckpt.latest_checkpoint(out) == d3
    assert tckpt.epoch_checkpoint(out, 2) == d3
    assert trsa.list_epoch_checkpoints(out)[-1] == (2, d3)
    got, want = tckpt.load_checkpoint(d3), jckpt.load_checkpoint(d3)
    assert got["epoch"] == 2 and got["scheduler_state"] == {"last_epoch": 3}
    import jax
    for key in ("params", "opt_state"):
        la, lb = (jax.tree_util.tree_leaves(t[key]) for t in (got, want))
        assert len(la) == len(lb) == len(params)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, np.asarray(y))


def test_resume_reads_a_dcp_latest(tmp_path):
    """run_vit_training's resume path (latest_checkpoint, load_checkpoint,
    load_trees) restores a sharded checkpoint's parameters and momentum."""
    out = str(tmp_path)
    params, momentum = _vit_state(seed=5)
    tckpt.save_checkpoint(3, params, momentum, {"last_epoch": 4}, 1.0, 1.0,
                          1.0, out, sharded=True)
    ckpt = tckpt.load_checkpoint(tckpt.latest_checkpoint(out))
    assert ckpt["epoch"] == 3 and ckpt["scheduler_state"] == {
        "last_epoch": 4}
    model = tvit.empty_vit(TINY, "cpu")
    mom = tloop.sgd_init(dict(model.named_parameters()))
    tloop.load_trees(model, ckpt["params"], mom, ckpt["opt_state"])
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
        assert torch.equal(mom[n], momentum[n]), n


def test_sharded_state_of_a_mode_without_sharded_layout_is_refused():
    model = tdry.vit_model(tdry.VIT_TINY, "cpu")
    trainer = tloop.ViTTrainer(tdry.VIT_TINY, tloop.ViTTrainConfig(
        batch_size=4, compute_dtype="float32"), model, "cpu")
    params, mom = trainer.sharded_state(trainer.init_momentum())
    assert set(params) == set(mom) == {n for n, _ in
                                       model.named_parameters()}
    trainer.mode = "tp"
    with pytest.raises(NotImplementedError, match="mode 'tp'"):
        trainer.sharded_state({})


# -- two ranks ----------------------------------------------------------------------

def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _worker(root):
    """One of 2 gloo ranks: each mode's step, its sharded save, and the
    restores; report_rank{r}.json beside, rank 0's gathered states in
    full_{mode}.pt."""
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor, Shard
    torch.set_num_threads(1)
    tdist.init_process_group("gloo")
    rank = tdist.get_rank()
    rs = np.random.RandomState(4)
    images = rs.randint(0, 255, (BATCH, 32, 32, 3), np.uint8)
    labels = rs.randint(0, 10, BATCH).astype(np.int32)
    report = {"rank": rank}
    saved = {}
    for mode in MODES:
        _, trainer, momentum = tdry.vit_step("cpu", images, labels, cfg=TINY,
                                             **{mode: True})
        params, mom = trainer.sharded_state(momentum)
        full_p, full_m = trainer.full_state(momentum)
        if rank == 0:
            torch.save({"params": full_p, "opt_state": full_m},
                       os.path.join(root, f"full_{mode}.pt"))
        out = os.path.join(root, mode)
        path = tckpt.save_checkpoint(0, params, mom, {"last_epoch": 1},
                                     2.0, 3.0, 4.0, out, sharded=True)
        saved[mode] = (path, params, mom, full_p, full_m)
        report[mode] = {
            "path": path,
            "split_momentum": sorted(n for n, m in mom.items()
                                     if isinstance(m, DTensor)),
            "placements": sorted({str(tuple(m.placements))
                                  for m in mom.values()
                                  if isinstance(m, DTensor)}),
            "momentum_views": all(
                _local(mom[n]).data_ptr() == momentum[n].data_ptr()
                for n in mom if mode == "zero1"),
        }
    for mode in MODES:
        path, params, mom, full_p, full_m = saved[mode]
        for into in MODES:
            # a fresh trainer of the `into` mode: other weights, zero
            # momentum
            fresh = tdry.vit_step("cpu", images[:WORLD], labels[:WORLD],
                                  cfg=TINY, **{into: True})[1]
            with torch.no_grad():
                for p in fresh.model.parameters():
                    _local(p).normal_()
            fmom = fresh.init_momentum()
            tp, tm = fresh.sharded_state(fmom)
            back = tckpt.load_checkpoint(path, template={"params": tp,
                                                         "opt_state": tm})
            got_p, got_m = fresh.full_state(fmom)
            same = (all(torch.equal(got_p[n], full_p[n]) for n in full_p)
                    and all(torch.equal(got_m[n], full_m[n])
                            for n in full_m))
            if into == mode:
                # the restored local shards are the saved local shards
                same = same and all(
                    torch.equal(_local(back[t][n]), _local(src[n]))
                    for t, src in (("params", params), ("opt_state", mom))
                    for n in src)
            report[mode][f"into_{into}"] = same
            report[mode][f"into_{into}_extras"] = [
                back["epoch"], back["scheduler_state"], back["train_loss"]]
        whole = tser.load_sharded(path)
        report[mode]["whole"] = (
            all(torch.equal(whole["params"][n], full_p[n]) for n in full_p)
            and all(torch.equal(whole["opt_state"][n], full_m[n])
                    for n in full_m))
        report[mode]["shard_files"] = {
            f: sorted(set(fqn for fqn, _ in items))
            for f, items in tser.shard_files(path).items()}
        tdist.barrier()
    with open(os.path.join(root, f"report_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    tdist.barrier()
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), __file__, root],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=LAUNCH_TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-8000:]
    reports = []
    for r in range(WORLD):
        with open(os.path.join(root, f"report_rank{r}.json")) as f:
            reports.append(json.load(f))
    yield root, reports
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("into", MODES)
@pytest.mark.parametrize("mode", MODES)
def test_state_restores_bit_equal_into_a_fresh_placement(ranks, mode, into):
    """A mode's sharded checkpoint loaded into a fresh trainer (other
    weights, zero momentum) of the same mode, or of the other one (DCP
    re-shards: ZeRO-1 rows into FSDP2 shards and back): the gathered state
    equals the saved one bit for bit on both ranks, and in the same
    placement every local shard equals the saved shard."""
    _, reports = ranks
    for rep in reports:
        assert rep[mode][f"into_{into}"] is True, (rep["rank"], mode, into)
        assert rep[mode][f"into_{into}_extras"] == [0, {"last_epoch": 1},
                                                    2.0]


@pytest.mark.parametrize("mode", MODES)
def test_whole_load_equals_the_gathered_state(ranks, mode):
    """load_sharded without a template on each rank: every leaf whole on
    the host, equal to full_state's gather."""
    _, reports = ranks
    assert all(rep[mode]["whole"] is True for rep in reports)


def test_zero1_momentum_is_viewed_as_dim0_shards(ranks):
    """sharded_state under zero1: the momentum leaves zero1_sharding splits
    are DTensors sharded on dim 0 over the data axis, views of the
    trainer's rows; the others stay whole. Under fsdp every leaf is
    FSDP2's DTensor."""
    root, reports = ranks
    full = torch.load(os.path.join(root, "full_zero1.pt"))["opt_state"]
    split = sorted(n for n, m in full.items()
                   if tmesh.zero1_sharding(WORLD, m))
    assert split and len(split) < len(full)
    for rep in reports:
        assert rep["zero1"]["split_momentum"] == split
        assert rep["zero1"]["placements"] == ["(Shard(dim=0),)"]
        assert rep["zero1"]["momentum_views"] is True
        assert rep["fsdp"]["split_momentum"] == sorted(full)


@pytest.mark.parametrize("mode", MODES)
def test_each_rank_file_holds_only_its_shards(ranks, mode):
    """By the metadata, each sharded leaf has a chunk in each rank's file;
    by the bytes, rank r's file holds the bytes of chunk r of every
    sharded leaf and none of the other rank's chunks (all-zero chunks are
    left out: zero bytes are no evidence)."""
    root, reports = ranks
    path = reports[0][mode]["path"]
    full = torch.load(os.path.join(root, f"full_{mode}.pt"))
    sharded = reports[0][mode]["split_momentum"]
    leaves = [("opt_state", n) for n in sharded]
    if mode == "fsdp":
        leaves += [("params", n) for n in full["params"]]
    files = reports[0][mode]["shard_files"]
    datas = []
    for r in range(WORLD):
        name = f"__{r}_0.distcp"
        with open(os.path.join(path, name), "rb") as f:
            datas.append(f.read())
        held = set(files[name])
        for tree, n in leaves:
            chunks = full[tree][n].chunk(WORLD)
            if r < len(chunks) and chunks[r].numel():
                assert f"{tree}.{n}" in held, (name, tree, n)
    checked = 0
    for tree, n in leaves:
        chunks = full[tree][n].chunk(WORLD)
        for r, data in enumerate(datas):
            for c, chunk in enumerate(chunks):
                raw = chunk.contiguous().numpy().tobytes()
                if not chunk.numel() or not chunk.any():
                    continue
                assert (raw in data) == (c == r), (mode, tree, n, r, c)
                checked += 1
    assert checked >= 2 * len(leaves)
    # the whole leaves (the zero1 parameters) are written once, by one rank
    if mode == "zero1":
        owners = [sum(f"params.{n}" in set(files[f"__{r}_0.distcp"])
                      for r in range(WORLD)) for n in full["params"]]
        assert owners == [1] * len(full["params"])


def test_ranks_agree_on_the_metadata(ranks):
    _, reports = ranks
    for mode in MODES:
        assert reports[0][mode]["shard_files"] == \
            reports[1][mode]["shard_files"]
        assert reports[0][mode]["path"] == reports[1][mode]["path"]


if __name__ == "__main__":
    _worker(sys.argv[1])
