"""The port's pipeline parallelism (``--pp_stages`` / ``--pp_micro``:
parallel/pipeline.py's GPipe schedule, parallel/mesh.py's ("data",
"stage") mesh, parallel/dist.py's stage hop, train/vit_loop.py's mode
"pp") against the JAX package's pipeline and against the port's own flat
forward, step and data parallelism.

Two ``torchrun --standalone`` launches run this file as a script at once,
gloo on the CPU, one thread a rank: "pp2" (2 ranks: data 1 x stage 2) and
"pp4" (4 ranks: data 2 x stage 2). Each rank works through its scenarios
and writes what it saw to report_{launch}_rank{r}.json (the trainer
steps' flat states to a .pth beside it); the tests read those files and
the runs' trees. The JAX side runs in the pytest process on its 8-device
virtual mesh (tests/conftest.py): its ``run_vit_training(pp_stages=2,
pp_micro=2)`` before the launches (the port's runs resume its epoch 0),
its ``pipeline_features`` / ``pipeline_classify`` on ('stage',) and
('data', 'stage') meshes and its pipelined train step while they run.

The model is JAX's pipeline-test ViT (width 32, 4 blocks, 2 heads: two
blocks a stage) with the 3 classes of the ImageFolder fixture (3 x 16
train, 3 x 8 val PNGs at 48^2), global batch 8, float32; the step and
forward images are seeded with numpy.
"""
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from vit_project_torch.ckpt import vit_ckpt as tckpt
from vit_project_torch.core.configs import IMAGENET_MEAN, IMAGENET_STD
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.parallel import dist as tdist_mod
from vit_project_torch.parallel import mesh as tmesh
from vit_project_torch.parallel import pipeline as tpp
from vit_project_torch.train import vit_loop as tloop

LAUNCHES = {"pp2": 2, "pp4": 4}
S, M = 2, 2
TTINY = tvit.ViTConfig(patch=8, width=32, layers=4, heads=2, image_size=32,
                       num_classes=3)
NORM = (IMAGENET_MEAN, IMAGENET_STD)
# JAX's own bounds for its pipeline against the plain trunk and the flat
# SGD oracle (tests/test_pipeline.py:55-77, :151-193)
FWD_ATOL = 1e-5
STEP_LOSS_RTOL = 1e-5
STEP_ATOL = (2e-5, 5e-5)          # after the first and the second step
# float32 in another summation order over an epoch (the port's tolerance
# against JAX, tests/test_torch_vit_training.py _assert_rows_close)
LOSS_RTOL = 1e-4
# JAX's bound between its own modes (tests/test_vit_training.py), the tp
# test's
MODE_RTOL, MODE_ATOL = 1e-4, 1e-5
# both launches at once, 6 ranks on the host: ~20 s alone, several times
# that beside other files' launches under xdist
LAUNCH_TIMEOUT = 600
STEPS = 6          # an epoch: 48 train images at global batch 8
EDGE_MICRO = (1, 3)
EDGE_BATCH = 6
RAGGED_BATCH = 5   # validation and RSA chunks that M = 2 does not divide
THINGS_N = 11


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


@contextlib.contextmanager
def _one_thread():
    """The port's runs in the pytest process on one thread, as the ranks
    run: the default thread count oversubscribes the host's cores and made
    a 12-step run 7x slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _inputs(root):
    z = np.load(os.path.join(root, "inputs.npz"))
    return z["images"], z["labels"], z["things"], z["rdm"]


# -- the ranks ----------------------------------------------------------------

def _worker(spec_path, launch):
    """One rank of `launch`: its scenarios in order; what it saw goes to
    report_{launch}_rank{r}.json beside the spec."""
    import torch.distributed as tdist
    from vit_project_torch.data.packed import make_loader

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    root, data = spec["root"], spec["data"]
    out_root = os.path.join(root, launch)
    rank, world = tdist_mod.setup_distributed("cpu")
    report = {"rank": rank, "world": world, "backend": tdist.get_backend(),
              "checked_steps": {}, "same_images_steps": {}}
    images, labels, things, rdm = _inputs(root)
    images_t, labels_t = torch.from_numpy(images), torch.from_numpy(labels)
    jax_state = torch.load(os.path.join(root, "jax_params.pth"))

    def model_from(state):
        model = tvit.empty_vit(TTINY, "cpu")
        model.load_state_dict(state)
        return model

    mesh = tmesh.make_mesh(n_stage=S)
    st = tpp.stages_of(mesh)
    d = mesh.get_local_rank("data")
    report["data_rank"], report["stage"] = d, st.index
    nd = st.n_data
    # the data shard of JAX's P('data'): contiguous rows
    lo, hi = d * len(images) // nd, (d + 1) * len(images) // nd

    # -- the pipelined forward against JAX's and the port's plain one
    whole = model_from(jax_state)
    staged = tpp.stage_model(model_from(jax_state), mesh)
    report["params_held"] = sum(p.numel() for p in staged.parameters())
    report["params_whole"] = sum(p.numel() for p in whole.parameters())
    fwd = {}
    for pool in ("token", "avg"):
        got = tpp.pipeline_features(staged, images_t[lo:hi], mesh,
                                    n_micro=M, pool=pool, input_norm=NORM)
        want = tvit.forward_features(whole, images_t[lo:hi], pool=pool,
                                     input_norm=NORM)
        fwd[pool] = got.tolist()
        fwd[f"{pool}_plain_err"] = (got - want).abs().max().item()
    got = tpp.pipeline_classify(staged, images_t[lo:hi], mesh, n_micro=M,
                                input_norm=NORM)
    fwd["logits"] = got.tolist()
    fwd["logits_plain_err"] = (got - tvit.vit_classify(
        whole, images_t[lo:hi], input_norm=NORM)).abs().max().item()
    report["forward"], report["rows"] = fwd, [lo, hi]

    # -- the schedule's edges against the whole model's plain autograd,
    # forward and gradients: M = 1 and M = 3 over 2 stages; 4 stages of one
    # block (two middle stages, which receive and send both ways)
    def edges(mesh_, micro_counts):
        x, y = images_t[:EDGE_BATCH], labels_t[:EDGE_BATCH]
        plain = model_from(jax_state)
        logp = torch.log_softmax(tvit.vit_classify(plain, x, input_norm=NORM),
                                 -1)
        ref_loss = -logp.gather(1, y[:, None].long())[:, 0].mean()
        ref_loss.backward()
        ref = {n: p.grad for n, p in plain.named_parameters()}
        model = tpp.stage_model(model_from(jax_state), mesh_)
        st_ = tpp.stages_of(mesh_)
        out = {"stage": st_.index}
        for m in micro_counts:
            feats = tpp.pipeline_features(model, x, mesh_, n_micro=m,
                                          input_norm=NORM)
            loss = tpp.pipeline_backward(model, x, y, mesh_, n_micro=m,
                                         input_norm=NORM)
            loss = tdist_mod.all_reduce_sum(loss, st_.group)
            errs = [((p.grad if p.grad is not None else torch.zeros_like(p))
                     - ref[n]).abs().max().item()
                    for n, p in model.named_parameters()
                    if tpp.is_block_leaf(n) or p.grad is not None]
            used = [n for n, p in model.named_parameters()
                    if p.grad is not None]
            model.zero_grad(set_to_none=True)
            out[str(m)] = {
                "feat_err": (feats - tvit.forward_features(
                    plain, x, input_norm=NORM)).abs().max().item(),
                "loss": loss.item(), "ref_loss": ref_loss.item(),
                "grad_err": max(errs), "used": used}
        return out
    if launch == "pp2":
        report["edges"] = edges(mesh, EDGE_MICRO)
    else:
        mesh4 = tmesh.make_mesh(n_stage=4)
        report["edges"] = edges(mesh4, (M,))

    # -- the refusals, in JAX's words
    refusals = {}
    with pytest.raises(ValueError) as e:
        tpp.pipeline_features(staged, images_t[:5], mesh, n_micro=M)
    refusals["batch"] = str(e.value)
    with pytest.raises(ValueError) as e:
        tpp.shard_params_pp(tmesh.make_mesh(), dict(whole.named_parameters()))
    refusals["no_stage_axis"] = str(e.value)
    if launch == "pp4":
        # blocks staged for 4 stages handed to the 2-stage mesh
        wrong = tpp.stage_model(model_from(jax_state), mesh4)
    else:
        wrong = model_from(jax_state)          # not staged: 1 stage
    with pytest.raises(ValueError) as e:
        tpp.pipeline_features(wrong, images_t[lo:hi], mesh, n_micro=M)
    refusals["stages"] = str(e.value)
    for name, kw in (("grad_accum", dict(grad_accum=3)),
                     ("grad_accum_unit", dict(grad_accum=2, pp_micro=8))):
        with pytest.raises(ValueError) as e:
            tloop.run_vit_training(
                _tiny(TTrainConfig, data, os.path.join(out_root, "x"),
                      **{"pp_stages": S, "pp_micro": M, **kw}),
                vit_cfg=TTINY, device="cpu")
        refusals[name] = str(e.value)
    report["refusals"] = refusals
    del whole, staged, wrong

    # -- two ViTTrainer pp steps from JAX's weights, remat off and on
    states = {}
    for remat in (False, True):
        cfg = dataclasses.replace(
            _tiny(TTrainConfig, data, "x"), momentum=0.9, weight_decay=1e-4,
            pp_stages=S, pp_micro=M, remat=remat)
        tr = tloop.ViTTrainer(TTINY, cfg, model_from(jax_state), "cpu")
        mom = tr.init_momentum()
        losses, flat = [], []
        for _ in range(2):
            loss = tr.step(mom, images_t[lo:hi], labels_t[lo:hi], 0.1)
            losses.append(tr.global_mean(loss).item())
            p, m_ = tr.full_state(mom)
            flat.append({k: v.clone() for k, v in p.items()})
        report[f"step_losses_remat{int(remat)}"] = losses
        states[f"remat{int(remat)}"] = flat
    if rank == 0:
        torch.save(states, os.path.join(root, f"steps_{launch}.pth"))

    # -- validation and the RSA with ragged tails against one process
    gen = torch.Generator().manual_seed(5)
    seeded = tvit.init_vit_params(tvit.empty_vit(TTINY, "cpu"), gen)
    state = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
    cfg = dataclasses.replace(_tiny(TTrainConfig, data, "x"), pp_stages=S,
                              pp_micro=M)
    tr = tloop.ViTTrainer(TTINY, cfg, model_from(state), "cpu")
    one = tloop.ViTTrainer(TTINY, _tiny(TTrainConfig, data, "x"),
                           model_from(state), "cpu", distributed=False)
    val = {}
    for name, t, shards, sid in (("pp", tr, tr.n_data, tr.data_rank),
                                 ("one", one, 1, 0)):
        loader = make_loader(f"{data}/val", RAGGED_BATCH, train=False,
                             size=32, workers=1, num_shards=shards,
                             shard_id=sid)
        val[name] = list(t.validate(loader))
        val[f"{name}_rsa"] = t.compute_rsa_score(things, rdm,
                                                 batch_size=RAGGED_BATCH)[0]
        val[f"{name}_emb"] = t._feature_step(
            torch.from_numpy(things[:RAGGED_BATCH + 1])).tolist()
    report["val"] = val
    del tr, one

    # -- the runs; after every pp step the data group's ranks hold equal
    # blocks and momentum, the stage group's equal whole leaves, and the
    # stage group's ranks trained on the same images
    run_name = {}
    step = tloop.ViTTrainer.step

    def checked_step(self, momentum, images_u8, labels, *a, **k):
        loss = step(self, momentum, images_u8, labels, *a, **k)
        if self.mode == "pp":
            self.check_replicas(momentum)
            key = run_name["run"]
            report["checked_steps"][key] = \
                report["checked_steps"].get(key, 0) + 1
            seen = tdist_mod.all_gather_rows(images_u8.float(),
                                             self.stages.group)
            lbls = tdist_mod.all_gather_rows(labels, self.stages.group)
            if all(torch.equal(seen[0], s) for s in seen) and \
                    all(torch.equal(lbls[0], s) for s in lbls):
                report["same_images_steps"][key] = \
                    report["same_images_steps"].get(key, 0) + 1
        return loss
    tloop.ViTTrainer.step = checked_step

    def run(name, **kw):
        run_name["run"] = name
        return tloop.run_vit_training(
            _tiny(TTrainConfig, data, os.path.join(out_root, name), **kw),
            vit_cfg=TTINY, device="cpu")

    pp = dict(pp_stages=S, pp_micro=M)
    run("pp_from_jax", **pp)
    run("pp", **pp)
    if launch == "pp2":
        run("dp")
        if rank == 0:
            _resume_dir(os.path.join(root, "one"),
                        os.path.join(out_root, "pp_from_one"))
        tdist.barrier()
        run("pp_from_one", **pp)
    with open(os.path.join(root, f"report_{launch}_rank{rank}.json"),
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
    return jvit.ViTConfig(patch=8, width=32, layers=4, heads=2,
                          image_size=32, num_classes=3)


def _jmesh(shape, names):
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _jax_references(params, images, labels):
    """JAX's pipelined forwards on ('stage',) and ('data', 'stage') meshes
    (jitted: JAX's shard_map compiles once a program), its pipelined train
    step on the (2, 2) mesh (tests/test_pipeline.py's use) and the flat SGD
    oracle, two steps each."""
    import jax.numpy as jnp
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import pipeline as jpp
    from vit_project_tpu.train.vit_loop import ViTTrainer as JTrainer
    cfg = _jtiny()
    images, labels = jnp.asarray(images), jnp.asarray(labels)
    out = {}
    for launch, shape, names in (("pp2", (S,), ("stage",)),
                                 ("pp4", (2, S), ("data", "stage"))):
        mesh = _jmesh(shape, names)
        rest, blocks_st = jpp.shard_params_pp(mesh, params)
        for pool in ("token", "avg"):
            out[(launch, pool)] = np.asarray(jax.jit(
                lambda r, b, x, pool=pool: jpp.pipeline_features(
                    r, b, x, cfg, mesh, n_micro=M, pool=pool,
                    input_norm=NORM))(rest, blocks_st, images))
        out[(launch, "logits")] = np.asarray(jax.jit(
            lambda r, b, x: jpp.pipeline_classify(
                r, b, x, cfg, mesh, n_micro=M, input_norm=NORM))(
            rest, blocks_st, images))

    def loss_fn(p):
        logits = jvit.vit_classify(p, images, cfg, input_norm=NORM,
                                   use_pallas=False)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None],
                                             axis=1)[:, 0])

    @jax.jit
    def oracle(p, buf):
        loss, g = jax.value_and_grad(loss_fn)(p)
        buf = jax.tree_util.tree_map(lambda p_, g_, b: 0.9 * b
                                     + (g_ + 1e-4 * p_), p, g, buf)
        return jax.tree_util.tree_map(lambda p_, b: p_ - 0.1 * b, p,
                                      buf), buf, loss
    p, buf = params, jax.tree_util.tree_map(jnp.zeros_like, params)
    out["oracle"] = []
    for _ in range(2):
        p, buf, loss = oracle(p, buf)
        out["oracle"].append((float(loss), jax.tree_util.tree_map(
            np.asarray, p)))
    mesh = _jmesh((2, S), ("data", "stage"))
    state = jpp.shard_params_pp(mesh, params)
    mom = jax.tree_util.tree_map(jnp.zeros_like, state)
    trainer = JTrainer(cfg, JTrainConfig(
        momentum=0.9, weight_decay=1e-4, compute_dtype="float32",
        pp_stages=S, pp_micro=M), mesh)
    step = trainer._make_train_step(None)
    out["jax_pp"] = []
    for _ in range(2):
        state, mom, loss = step(state, mom, images, labels, 0.1,
                                jax.random.PRNGKey(0))
        out["jax_pp"].append((float(loss), jax.tree_util.tree_map(
            np.asarray, jpp.unstage_blocks(*state))))
    return out


@pytest.fixture(scope="module")
def ranks(imagenet, tmp_path_factory):
    """JAX's pp run and the port's one-process run, then the two launches
    at once while JAX's pipelined forwards and steps run here; returns the
    root of the trees, the ranks' reports by launch and JAX's results."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    root = str(tmp_path_factory.mktemp("pp"))
    jrun(_tiny(JTrainConfig, imagenet, os.path.join(root, "jax_pp"),
               pp_stages=S, pp_micro=M), vit_cfg=_jtiny())
    assert jax.device_count() == 8
    with _one_thread():
        tloop.run_vit_training(_tiny(TTrainConfig, imagenet,
                                     os.path.join(root, "one")),
                               vit_cfg=TTINY, device="cpu")
    params = jvit.init_vit_params(jax.random.PRNGKey(0), _jtiny())
    torch.save(tconvert.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), TTINY.patch),
        os.path.join(root, "jax_params.pth"))
    rs = np.random.RandomState(1)
    images = rs.randint(0, 255, (8, 32, 32, 3)).astype(np.uint8)
    labels = rs.randint(0, 3, 8).astype(np.int64)
    things = rs.randint(0, 255, (THINGS_N, 32, 32, 3)).astype(np.uint8)
    rdm = rs.rand(THINGS_N, THINGS_N)
    rdm = rdm + rdm.T
    np.fill_diagonal(rdm, 0.0)
    np.savez(os.path.join(root, "inputs.npz"), images=images, labels=labels,
             things=things, rdm=rdm)
    for launch in LAUNCHES:
        _resume_dir(os.path.join(root, "jax_pp"),
                    os.path.join(root, launch, "pp_from_jax"))
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
        ref = _jax_references(params, images, labels.astype(np.int32))
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
            path = os.path.join(root, f"report_{launch}_rank{r}.json")
            with open(path) as f:
                reports[launch].append(json.load(f))
    return root, reports, ref


# -- parallel/pipeline.py: JAX's stacked layout on the port's flat state ------

def test_stage_blocks_have_jax_shapes_and_round_trip():
    """stage_blocks stacks each block leaf into [S, L/S, ...] as JAX's does
    (the same leading axes, the same blocks in each slot, each leaf in the
    port's layout); unstage_blocks is the inverse bit for bit; L % S != 0 is
    refused in JAX's words by both."""
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import pipeline as jpp
    jtree = jvit.init_vit_params(jax.random.PRNGKey(3), _jtiny())
    state = tconvert.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jtree), TTINY.patch)
    jrest, jst = jpp.stage_blocks(jtree, S)
    rest, blocks_st = tpp.stage_blocks(state, S)
    assert {x.shape[:2] for x in jax.tree_util.tree_leaves(jst)} == \
        {tuple(x.shape[:2]) for x in blocks_st.values()} == {(S, 2)}
    assert sorted(rest) == sorted(n for n in state if not tpp.is_block_leaf(n))
    for s in range(S):
        for j in range(2):
            one = jax.tree_util.tree_map(lambda x: np.asarray(x[s, j]), jst)
            want = tconvert.vit_state_dict_from_jax(
                {**jax.tree_util.tree_map(np.asarray, jrest),
                 "blocks": [one]}, TTINY.patch)
            for name, x in want.items():
                if name.startswith("blocks.0."):
                    leaf = name[len("blocks.0."):]
                    assert torch.equal(blocks_st[leaf][s, j], x), name
    back = tpp.unstage_blocks(rest, blocks_st)
    assert back.keys() == state.keys()
    for name, x in state.items():
        assert torch.equal(back[name], x), name
    words = "layers (4) must divide by n_stages (3)"
    with pytest.raises(ValueError, match=re.escape(words)):
        jpp.stage_blocks(jtree, 3)
    with pytest.raises(ValueError, match=re.escape(words)):
        tpp.stage_blocks(state, 3)


# -- the ranks' forward, steps and refusals ------------------------------------

@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_pipelined_forward_matches_jax_and_the_plain_trunk(ranks, launch):
    """pipeline_features (token and avg pooling) and pipeline_classify on
    each rank (its data shard's rows, the whole result on every stage)
    against JAX's on its ('stage',) (pp2) or ('data', 'stage') (pp4) mesh
    and against the port's plain forward_features / vit_classify, within
    JAX's own bound."""
    _, reports, ref = ranks
    for rep in reports[launch]:
        lo, hi = rep["rows"]
        for key in ("token", "avg", "logits"):
            np.testing.assert_allclose(np.asarray(rep["forward"][key]),
                                       ref[(launch, key)][lo:hi],
                                       atol=FWD_ATOL)
            assert rep["forward"][f"{key}_plain_err"] <= FWD_ATOL


@pytest.mark.parametrize("launch,stages,micro", [
    ("pp2", S, 1), ("pp2", S, 3), ("pp4", 4, M)])
def test_schedule_edges(ranks, launch, stages, micro):
    """The schedule's edges: at S = 2, M = 1 (no overlap at all) and M = 3
    (an odd count); at S = 4 (one block a stage), two middle stages that
    receive and send in both directions. The forward and every gradient
    against the whole model's plain autograd; each stage touches its
    blocks and the stem (the first stage), the final norm and the head
    (the last) or nothing else (a middle stage)."""
    _, reports, _ = ranks
    tail = {"norm.weight", "norm.bias", "head.weight", "head.bias"}
    for rep in reports[launch]:
        e = rep["edges"][str(micro)]
        assert e["feat_err"] <= FWD_ATOL and e["grad_err"] <= MODE_ATOL
        np.testing.assert_allclose(e["loss"], e["ref_loss"],
                                   rtol=STEP_LOSS_RTOL)
        rest = {n for n in e["used"] if not tpp.is_block_leaf(n)}
        stage = rep["edges"]["stage"]
        assert stage == rep["rank"] % stages
        if stage == 0:
            assert rest and not rest & tail
        else:
            assert rest == (tail if stage == stages - 1 else set())


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_trainer_steps_match_jax_and_the_flat_oracle(ranks, launch):
    """Two ViTTrainer pp steps from JAX's weights: the loss (the data mean
    of the local mean CE) and the gathered flat parameters against JAX's
    pipelined step on its (2, 2) mesh and the flat SGD oracle, within JAX's
    bounds (tests/test_pipeline.py:151-193)."""
    root, reports, ref = ranks
    steps = torch.load(os.path.join(root, f"steps_{launch}.pth"))["remat0"]
    for rep in reports[launch]:
        for i in range(2):
            for want, _ in (ref["oracle"][i], ref["jax_pp"][i]):
                np.testing.assert_allclose(rep["step_losses_remat0"][i], want,
                                           rtol=STEP_LOSS_RTOL)
    for i, atol in enumerate(STEP_ATOL):
        got = _leaves(tconvert.vit_jax_from_state_dict(steps[i]))
        for _, want in (ref["oracle"][i], ref["jax_pp"][i]):
            assert len(got) == len(_leaves(want))
            for a, b in zip(got, _leaves(want)):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_remat_is_bit_equal(ranks, launch):
    """remat recomputes each block's forward in the backward: the same
    losses and parameters, bit for bit."""
    root, reports, _ = ranks
    steps = torch.load(os.path.join(root, f"steps_{launch}.pth"))
    for rep in reports[launch]:
        assert rep["step_losses_remat1"] == rep["step_losses_remat0"]
    for a, b in zip(steps["remat0"], steps["remat1"]):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_pipeline_refuses_in_jax_words(ranks):
    """A batch the microbatches do not divide, a model staged for another
    stage count (or not at all), a mesh with no 'stage' axis and a
    grad_accum split the pipeline cannot take: refused on every rank in
    the words JAX raises."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import pipeline as jpp
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    _, reports, _ = ranks
    params = jvit.init_vit_params(jax.random.PRNGKey(0), _jtiny())
    imgs = np.zeros((5, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="batch 5 must divide by "
                                         r"n_data\*n_micro = 1\*2"):
        jpp.pipeline_features(*jpp.shard_params_pp(
            _jmesh((S,), ("stage",)), params), imgs, _jtiny(),
            _jmesh((S,), ("stage",)), n_micro=M)
    with pytest.raises(ValueError, match="has no 'stage' axis"):
        jpp.shard_params_pp(_jmesh((2,), ("data",)), params, 2)
    _, st4 = jpp.stage_blocks(params, 4)
    with pytest.raises(ValueError, match="blocks_st has 4 stages but the "
                                         "mesh 'stage' axis is 2"):
        jpp.pipeline_features(jpp.stage_blocks(params, 2)[0], st4,
                              imgs[:4], _jtiny(), _jmesh((S,), ("stage",)),
                              n_micro=M)
    accum = {}
    for name, kw in (("grad_accum", dict(grad_accum=3)),
                     ("grad_accum_unit", dict(grad_accum=2, pp_micro=8))):
        with pytest.raises(ValueError) as e:
            jrun(_tiny(JTrainConfig, "x", "x",
                       **{"pp_stages": S, "pp_micro": M, **kw}),
                 vit_cfg=_jtiny())
        accum[name] = str(e.value)
    for launch, reps in reports.items():
        n_data = LAUNCHES[launch] // S
        for rep in reps:
            r = rep["refusals"]
            assert r["batch"] == (f"batch {5 * n_data} must divide by "
                                  f"n_data*n_micro = {n_data}*{M}")
            assert "has no 'stage' axis" in r["no_stage_axis"]
            k = 4 if launch == "pp4" else 1
            assert r["stages"].startswith(
                f"blocks_st has {k} stages but the mesh 'stage' axis is 2")
            assert r["grad_accum"] == accum["grad_accum"]
            # JAX's data axis is 4 here (8 devices), the port's 1 or 2
            assert r["grad_accum_unit"] == (
                f"per-grad-accum batch 8//2 = 4 must divide by "
                f"data_shards*pp_micro = {n_data * 8}")
            assert accum["grad_accum_unit"] == (
                "per-grad-accum batch 8//2 = 4 must divide by "
                "data_shards*pp_micro = 32")


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_a_rank_holds_its_stage_only(ranks, launch):
    """Each rank holds its stage's 2 of the 4 blocks and the whole rest:
    the other stage's block tensors are gone from the model."""
    _, reports, _ = ranks
    for rep in reports[launch]:
        whole, held = rep["params_whole"], rep["params_held"]
        block = sum(p.numel() for p in tvit.Block(32, 4).parameters())
        assert held == whole - 2 * block


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_validation_and_rsa_with_ragged_tails_equal_one_process(ranks,
                                                                launch):
    """Batches of 5 (padded to 6 for M = 2, the pad counting for nothing)
    and the RSA's chunks of 5 (rounded up to 6, the ragged tail padded):
    the loss and accuracy, the embeddings and rho of one process."""
    _, reports, _ = ranks
    for rep in reports[launch]:
        v = rep["val"]
        np.testing.assert_allclose(v["pp"][0], v["one"][0], rtol=MODE_RTOL)
        assert v["pp"][1] == v["one"][1]
        np.testing.assert_allclose(v["pp_rsa"], v["one_rsa"], atol=MODE_ATOL)
        np.testing.assert_allclose(np.asarray(v["pp_emb"]),
                                   np.asarray(v["one_emb"]), atol=FWD_ATOL)


# -- the runs -----------------------------------------------------------------

@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_pp_run_matches_the_jax_pp_run(ranks, launch):
    """Resumed from JAX's pp run's epoch 0 (its flat checkpoint), the
    port's pp run trains epoch 1 as JAX's does: rows to LOSS_RTOL,
    accuracy within one image, the flat trees within JAX's mode bound."""
    root, _, _ = ranks
    got = os.path.join(root, launch, "pp_from_jax")
    assert list(_metrics(got)["epoch"]) == [0, 1]
    _assert_runs_close(got, os.path.join(root, "jax_pp"), rtol=LOSS_RTOL)


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_pp_checkpoint_is_flat_and_equals_the_ports_dp_run(ranks, launch):
    """From the port's seed, pp (data 1 or 2 x stage 2) trains as the
    2-rank dp run does, and its checkpoint holds the flat layout: every
    block, qkv_w [D, 3D] and fc1_w [D, 4D], the momentum alike."""
    root, _, _ = ranks
    got = os.path.join(root, launch, "pp")
    _assert_runs_close(got, os.path.join(root, "pp2", "dp"))
    params, momentum = _trees(got)
    for tree in (params, momentum):
        assert len(tree["blocks"]) == 4
        for bp in tree["blocks"]:
            assert np.asarray(bp["qkv_w"]).shape == (32, 96)
            assert np.asarray(bp["fc1_w"]).shape == (32, 128)


def test_checkpoints_cross_resume_between_pp_and_one_process(
        ranks, imagenet, tmp_path):
    """One process's epoch 0 resumed under pp, and pp's resumed in one
    process: each epoch-1 row and final tree within JAX's mode bound of
    the uninterrupted run's."""
    root, _, _ = ranks
    pp2 = os.path.join(root, "pp2")
    one = str(tmp_path / "one_from_pp")
    _resume_dir(os.path.join(pp2, "pp"), one)
    with _one_thread():
        tloop.run_vit_training(_tiny(TTrainConfig, imagenet, one),
                               vit_cfg=TTINY, device="cpu")
    _assert_runs_close(os.path.join(pp2, "pp_from_one"),
                       os.path.join(root, "one"))
    _assert_runs_close(one, os.path.join(pp2, "pp"))


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_replicas_hold_and_stage_groups_read_one_shard(ranks, launch):
    """After every pp step (the worker raised at the first difference) the
    data group's ranks held equal blocks and momentum and the stage group's
    equal whole leaves; the two stages of a group trained on the same
    images every step, the data axis split the batch (rank r is data rank
    r // 2, stage r % 2)."""
    _, reports, _ = ranks
    runs = ["pp_from_jax", "pp"] + (["pp_from_one"] if launch == "pp2"
                                    else [])
    want = {"pp_from_jax": STEPS, "pp": 2 * STEPS, "pp_from_one": STEPS}
    n = LAUNCHES[launch]
    for r, rep in enumerate(reports[launch]):
        assert rep["world"] == n and rep["backend"] == "gloo"
        assert (rep["data_rank"], rep["stage"]) == (r // S, r % S)
        assert rep["checked_steps"] == {k: want[k] for k in runs}
        assert rep["same_images_steps"] == rep["checked_steps"]


# -- refusals -----------------------------------------------------------------

# (config change, model change, words both packages raise)
REFUSALS = {
    "sp": (dict(sp_devices=2), {}, "enable at most one"),
    "tp": (dict(tp_devices=2), {}, "enable at most one"),
    "ep": (dict(ep_devices=2), dict(moe_experts=4), "enable at most one"),
    "moe": ({}, dict(moe_experts=4),
            "MoE blocks are not supported on the pipeline path"),
    "zero1": (dict(zero1=True), {}, "do not compose with pp_stages"),
    "fsdp": (dict(fsdp=True), {}, "do not compose with pp_stages"),
    "fused_dw": (dict(fused_dw=True), {}, "fused_dw is a single-chip path"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pp_refuses_what_jax_refuses_in_its_words(case, monkeypatch):
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.train.vit_loop import ViTTrainer as JTrainer
    kw, model_kw, words = REFUSALS[case]
    kw = {"pp_stages": S, **kw}
    jcfg = dataclasses.replace(_tiny(JTrainConfig, "x", "x"), **kw)
    with pytest.raises(ValueError, match=re.escape(words)):
        JTrainer(dataclasses.replace(_jtiny(), **model_kw), jcfg,
                 _jmesh((4, 2), ("data", "stage")))
    cfg = dataclasses.replace(_tiny(TTrainConfig, "x", "x"), **kw,
                              **({"moe_experts": 4} if model_kw else {}))
    monkeypatch.setattr(tdist_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=re.escape(words)):
        tloop.train_mode(cfg, True, TTINY.heads)


def test_pp_without_torchrun_is_refused(imagenet, tmp_path):
    """JAX drives the stage axis from one process; the port's axis is the
    ranks of a process group, so one process cannot hold it."""
    cfg = _tiny(TTrainConfig, imagenet, str(tmp_path / "x"), pp_stages=S,
                pp_micro=M)
    with pytest.raises(ValueError, match="torchrun"):
        tloop.run_vit_training(cfg, vit_cfg=TTINY, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        tloop.train_mode(cfg, False, TTINY.heads)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
