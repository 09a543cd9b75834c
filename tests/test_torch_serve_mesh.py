"""The port's mesh serving (serve/engine.py ``mesh=`` / ``shard_params=``)
against the engine alone and against the JAX package's meshed engines
(tests/test_serve.py's TestMeshServing), and the step profiler's
``--memory`` rows on real ranks against its planner.

One ``torchrun --standalone`` launch of 2 ranks runs this file as a script
(gloo on the CPU, one thread a rank). Every rank builds the same engines
from the same weights and calls them with the same images (the engines'
SPMD contract), and writes what it saw to a JSON file; the tests read
those files. The JAX engines run in the pytest process on the 8-device
virtual mesh (tests/conftest.py): dp over all 8, tp over data 4 x model 2.

The model is the test-tiny ViT (width 32, 2 blocks, 2 heads, 10 classes;
T = 2 keeps one head a rank), float32, JAX's weights converted.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_project_torch.cli import profile as tprof
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.serve import vit_classifier_engine

RANKS = 2
VIT_TINY = tvit.VIT_CONFIGS["test-tiny"]
N_IMAGES = 11             # pads to 16 (dp buckets 8, 16) and chunks 8 + 3->4
DP_BUCKETS = (8, 16)
TP_BUCKETS = (4, 8)
# JAX's tolerance for its meshed engines (tests/test_serve.py)
RTOL = ATOL = 1e-5
LAUNCH_TIMEOUT = 600
MEMORY_MODES = ("dp", "zero1", "fsdp")


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 32, 32, 3).astype(np.float32)


# -- the worker (a rank of the launch) -------------------------------------------

def _worker(spec_path):
    import io
    import contextlib
    from vit_project_torch.models import clip as tclip
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import mesh as tmesh
    from vit_project_torch.serve import (clip_hba_engine,
                                         vit_features_engine)
    from vit_project_torch.serve import export as texport
    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = dist.setup_distributed("cpu")
    imgs = np.load(spec["images"])
    state = torch.load(spec["state"], weights_only=True)

    def vit():
        model = tvit.empty_vit(VIT_TINY, "cpu")
        model.load_state_dict(state)
        return model

    def tp_shards(m, s):
        return tmesh.shard_vit_params_tp_mesh(m, s, heads=VIT_TINY.heads)

    kw = dict(compute_dtype=torch.float32, device="cpu")
    dp_mesh = tmesh.make_mesh()
    tp_mesh = tmesh.make_mesh(n_model=RANKS)
    rep = {"rank": rank, "world": world}
    solo = vit_classifier_engine(vit(), buckets=DP_BUCKETS, **kw)
    dp = vit_classifier_engine(vit(), buckets=DP_BUCKETS, mesh=dp_mesh, **kw)
    tp = vit_classifier_engine(vit(), buckets=TP_BUCKETS, mesh=tp_mesh,
                               shard_params=tp_shards, **kw)
    rep["solo"] = solo(imgs).tolist()
    rep["dp"] = dp(imgs).tolist()
    rep["tp"] = tp(imgs).tolist()
    rep["tp_qkv_shape"] = list(tp.model.blocks[0].attn.qkv.weight.shape)
    rep["tp_fc2_shape"] = list(tp.model.blocks[0].mlp.fc2.weight.shape)
    rep["dp_qkv_shape"] = list(dp.model.blocks[0].attn.qkv.weight.shape)
    batches = [imgs[:3], imgs, imgs[:9]]
    rep["dp_stream"] = [o.tolist() for o in dp.map_stream(batches, depth=2)]
    rep["dp_calls"] = [dp(b).tolist() for b in batches]
    for pool in ("token", "avg"):
        fsolo = vit_features_engine(vit(), pool=pool, buckets=DP_BUCKETS,
                                    **kw)
        fdp = vit_features_engine(vit(), pool=pool, buckets=DP_BUCKETS,
                                  mesh=dp_mesh, **kw)
        ftp = vit_features_engine(vit(), pool=pool, buckets=TP_BUCKETS,
                                  mesh=tp_mesh, shard_params=tp_shards, **kw)
        rep[f"features_{pool}"] = {"solo": fsolo(imgs).tolist(),
                                   "dp": fdp(imgs).tolist(),
                                   "tp": ftp(imgs).tolist()}
    rep["int8"] = {
        "solo": vit_classifier_engine(vit(), buckets=DP_BUCKETS,
                                      quantize="int8", **kw)(imgs).tolist(),
        "dp": vit_classifier_engine(vit(), buckets=DP_BUCKETS,
                                    quantize="int8", mesh=dp_mesh,
                                    **kw)(imgs).tolist()}
    cfg = tclip.tiny_clip_config()
    tokens = np.random.RandomState(3).randint(
        0, cfg.text.vocab_size, (5, cfg.text.context_length))

    def clip():
        return tclip.init_clip_weights_(tclip.empty_clip(cfg, "cpu"),
                                        torch.Generator().manual_seed(0))
    rep["clip"] = {
        "solo": clip_hba_engine(clip(), tokens, buckets=DP_BUCKETS,
                                **kw)(imgs).tolist(),
        "dp": clip_hba_engine(clip(), tokens, buckets=DP_BUCKETS,
                              mesh=dp_mesh, **kw)(imgs).tolist()}

    def refusal(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None
    rep["refused"] = {
        "buckets": refusal(lambda: vit_classifier_engine(
            vit(), buckets=(3, 8), mesh=dp_mesh, **kw)),
        "export": refusal(lambda: texport.export_serving(
            dp, (32, 32, 3), os.path.join(spec["root"], f"art{rank}"))),
        "clip_shard_params": refusal(lambda: clip_hba_engine(
            clip(), tokens, buckets=DP_BUCKETS, mesh=tp_mesh,
            shard_params=tp_shards, **kw)),
        "int8_tp": refusal(lambda: vit_classifier_engine(
            vit(), buckets=TP_BUCKETS, quantize="int8", mesh=tp_mesh,
            shard_params=tp_shards, **kw)),
    }
    rep["export_dir_made"] = os.path.exists(
        os.path.join(spec["root"], f"art{rank}"))
    # the profiler's --memory on these ranks: what each holds, and the
    # table rank 0 prints
    rep["memory"] = {}
    for mode in MEMORY_MODES:
        stats, n, _ = tprof.analyze_memory(
            "test-tiny", 4, compute_dtype="float32", device="cpu",
            fsdp=mode == "fsdp", zero1=mode == "zero1")
        rep["memory"][mode] = {"n": n, **stats}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tprof.main(["--memory", "--device", "cpu", "--model", "test-tiny",
                    "--batch", "4", "--compute_dtype", "float32", "--fsdp"])
    rep["memory_printed"] = out.getvalue()
    with open(os.path.join(spec["root"], f"report_rank{rank}.json"),
              "w") as f:
        json.dump(rep, f)
    import torch.distributed as tdist
    tdist.destroy_process_group()


# -- the fixture: JAX's meshed engines, then the launch --------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.serve import vit_classifier_engine as jengine
    root = str(tmp_path_factory.mktemp("serve_mesh"))
    jtiny = jvit.VIT_CONFIGS["test-tiny"]
    params = jvit.init_vit_params(jax.random.PRNGKey(0), jtiny)
    imgs = _images(N_IMAGES)
    kw = dict(compute_dtype=jnp.float32, use_pallas=False)
    want = {
        "solo": jengine(params, jtiny, buckets=DP_BUCKETS, **kw)(imgs),
        "dp": jengine(params, jtiny, buckets=DP_BUCKETS,
                      mesh=jmesh.make_mesh(), **kw)(imgs),
        "tp": jengine(params, jtiny, buckets=TP_BUCKETS,
                      mesh=jmesh.make_mesh(n_data=4, n_model=2),
                      shard_params=lambda m, p: jmesh.shard_vit_params_tp(
                          m, p, heads=jtiny.heads), **kw)(imgs)}
    assert jax.device_count() == 8
    model = tconvert.vit_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  VIT_TINY, "cpu")
    spec = {"root": root, "images": os.path.join(root, "images.npy"),
            "state": os.path.join(root, "state.pth")}
    np.save(spec["images"], imgs)
    torch.save(model.state_dict(), spec["state"])
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), __file__, spec_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = p.communicate(timeout=LAUNCH_TIMEOUT)[0]
    finally:
        if p.poll() is None:        # a hang fails the fixture, not the run
            p.kill()
            p.communicate()
    assert p.returncode == 0, out[-8000:]
    reports = []
    for r in range(RANKS):
        with open(os.path.join(root, f"report_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports, want


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- the ViT engines against the engine alone and JAX's ---------------------------

@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_meshed_classifier_equals_solo_and_jax(ranks, kind):
    """Every rank returns the whole batch, equal to the engine alone and to
    JAX's engine over its mesh (data 8 for dp, data 4 x model 2 for tp)
    within JAX's 1e-5."""
    reports, want = ranks
    for rep in reports:
        assert np.asarray(rep[kind]).shape == (N_IMAGES, 10)
        _close(rep[kind], rep["solo"])
        _close(rep[kind], want[kind])
        _close(rep["solo"], want["solo"])


def test_dp_ranks_agree_bit_for_bit(ranks):
    """The all-gather moves bits: the ranks hold the same outputs."""
    reports, _ = ranks
    for kind in ("dp", "tp"):
        assert reports[0][kind] == reports[1][kind]


@pytest.mark.parametrize("pool", ["token", "avg"])
@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_meshed_features_equal_solo(ranks, pool, kind):
    reports, _ = ranks
    for rep in reports:
        feats = rep[f"features_{pool}"]
        assert np.asarray(feats[kind]).shape == (N_IMAGES, VIT_TINY.width)
        _close(feats[kind], feats["solo"])


def test_tp_ranks_hold_their_heads(ranks):
    """Under shard_params each rank holds its model index's shards (q, k, v
    of one head: 3 x 16 rows of width 32; fc2's 64 of 128 input columns);
    the dp engine keeps the model whole."""
    reports, _ = ranks
    for rep in reports:
        assert rep["tp_qkv_shape"] == [3 * 32 // RANKS, 32]
        assert rep["tp_fc2_shape"] == [32, 128 // RANKS]
        assert rep["dp_qkv_shape"] == [3 * 32, 32]


def test_dp_map_stream_matches_calls(ranks):
    reports, _ = ranks
    for rep in reports:
        assert len(rep["dp_stream"]) == 3
        for got, call in zip(rep["dp_stream"], rep["dp_calls"]):
            np.testing.assert_array_equal(got, call)


def test_int8_over_a_dp_mesh_equals_int8_alone(ranks):
    """JAX serves int8 weights over a dp mesh; so does the port."""
    reports, _ = ranks
    for rep in reports:
        _close(rep["int8"]["dp"], rep["int8"]["solo"])


def test_clip_engine_over_a_dp_mesh_equals_alone(ranks):
    reports, _ = ranks
    for rep in reports:
        assert np.asarray(rep["clip"]["dp"]).shape == (N_IMAGES, 5)
        _close(rep["clip"]["dp"], rep["clip"]["solo"])


# -- refusals ---------------------------------------------------------------------

def test_bucket_not_multiple_of_the_data_axis_refused(ranks):
    reports, _ = ranks
    for rep in reports:
        assert rep["refused"]["buckets"] == (
            "buckets [3] are not multiples of the mesh data-axis size 2; "
            "padded batches could not be sharded evenly")


def test_meshed_export_refused(ranks):
    """serve/export.py refuses a meshed engine in JAX's words, before it
    writes anything."""
    reports, _ = ranks
    for rep in reports:
        assert rep["refused"]["export"] == (
            "AOT export supports single-device engines only (a meshed "
            "export pins the exporting host's device assignment into the "
            "artifact)")
        assert not rep["export_dir_made"]


def test_clip_shard_params_refused(ranks):
    reports, _ = ranks
    for rep in reports:
        assert "no tensor-parallel CLIP forward" in \
            rep["refused"]["clip_shard_params"]


def test_int8_with_shard_params_refused(ranks):
    """JAX's tp placement fails on int8 leaves (AttributeError); the port
    refuses the combination by name."""
    reports, _ = ranks
    for rep in reports:
        assert "takes no shard_params" in rep["refused"]["int8_tp"]


def test_shard_params_without_mesh_rejected():
    model = tvit.init_vit_params(tvit.empty_vit(VIT_TINY, "cpu"),
                                 torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="^shard_params requires a mesh$"):
        vit_classifier_engine(model, buckets=(4,), device="cpu",
                              shard_params=lambda m, s: s)


# -- the profiler's --memory on real ranks ---------------------------------------

@pytest.mark.parametrize("mode", MEMORY_MODES)
def test_memory_rows_on_ranks_equal_the_plan(ranks, mode):
    """What each of the 2 ranks holds (FSDP2's local shards, ZeRO-1's
    momentum rows) equals the planner's figure for that rank from shapes
    on the meta device, so --virtual_devices plans what a launch holds."""
    reports, _ = ranks
    for rep in reports:
        got = rep["memory"][mode]
        plan, n, _ = tprof.plan_memory("test-tiny", 4, RANKS,
                                       fsdp=mode == "fsdp",
                                       zero1=mode == "zero1",
                                       rank=rep["rank"])
        assert n == got["n"] == RANKS
        for k in ("params", "momentum", "batch", "arguments"):
            assert got[k] == plan[k], (mode, k)
        assert got["peak_allocated"] is None       # no step on the CPU


def test_memory_table_printed_by_rank_0_only(ranks):
    reports, _ = ranks
    out = reports[0]["memory_printed"]
    assert "global batch 8, float32, fsdp" in out
    assert "over 2 rank(s)" in out and "peak needs the card" in out
    assert reports[1]["memory_printed"] == ""


if __name__ == "__main__":
    _worker(sys.argv[1])
