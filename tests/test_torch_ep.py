"""The port's MoE ViT across ranks: data parallelism with MoE blocks (the
global capacity, queues and aux of ``ops/moe.py`` over the data axis) and
expert parallelism (``--ep_devices``: parallel/mesh.py's ("data",
"expert") mesh and expert placement, train/vit_loop.py's mode "ep")
against one process and against the JAX package's step.

Two ``torchrun --standalone`` launches run this file as a script at once,
gloo on the CPU, one thread a rank: "ep2" (2 ranks: dp over 2, ep as data 1
x expert 2) and "ep4" (4 ranks: dp over 4, ep as data 2 x expert 2). Each
rank takes one SGD step from JAX-drawn weights on a global batch of 8 in
each mode and case, and trains a 2-epoch ep run through
``run_vit_training``; rank 0 writes the full trees, every rank a JSON
report. The tests hold the steps to the port's step in one process and to
JAX's ``ViTTrainer`` step on the same batch, in the pytest process.

The model is the JAX tests' MoE tiny (test-tiny with 4 experts, block 1 a
MoE block) at capacity factor 0.5, where queues overflow; float32, zero
momentum and no weight decay, so the momentum after the step is the
gradient. Tolerances: the step's 1e-4 relative and 1e-6 absolute (the
port's dense-step bound against JAX), rows of an epoch 1e-4 relative and
trees JAX's own bound between its modes (1e-4, 1e-5).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
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

LAUNCHES = {"ep2": 2, "ep4": 4}
EP = 2
TMOE = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                      num_classes=10, moe_experts=4, moe_capacity=0.5)
# (topk, train-config fields) of each one-step case
CASES = {"top1": (1, {}), "top2": (2, {}),
         "top2_accum2": (2, {"grad_accum": 2})}
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-4
MODE_RTOL, MODE_ATOL = 1e-4, 1e-5
LAUNCH_TIMEOUT = 600
RUN_STEPS = 12     # 2 epochs of 48 train images at global batch 8


def _step_cfg(topk, kw, **mode):
    return TTrainConfig(batch_size=8, compute_dtype="float32", image_size=32,
                        num_classes=10, weight_decay=0.0, moe_experts=4,
                        moe_topk=topk, moe_capacity=0.5, **kw, **mode)


def _run_cfg(cls, data, out, **kw):
    return cls(data_path=data, output_dir=out, batch_size=8, epochs=2,
               lr=0.01, warmup_epochs=1, num_workers=2, num_classes=3,
               image_size=32, compute_dtype="float32", random_seed=0,
               moe_experts=4, moe_capacity=0.5, **kw)


RUN_CFG = dataclasses.replace(TMOE, num_classes=3)


def _model(state, cfg=TMOE):
    model = tvit.empty_vit(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


# -- the ranks ----------------------------------------------------------------

def _worker(spec_path, launch):
    """One rank of `launch`: the one-step cases in each mode, then the ep
    run; what it saw goes to report_{launch}_rank{r}.json beside the
    spec, the full trees of rank 0 to {launch}_{mode}_{case}.npz."""
    import torch.distributed as tdist

    with open(spec_path) as f:
        spec = json.load(f)
    root = spec["root"]
    inputs = np.load(os.path.join(root, "inputs.npz"))
    state = {k[2:]: inputs[k] for k in inputs.files if k.startswith("p.")}
    imgs, lbls = inputs["images"], inputs["labels"]
    rank, world = tdist_mod.setup_distributed("cpu")
    report = {"rank": rank, "world": world, "backend": tdist.get_backend(),
              "local_shapes": {}, "whole_grads_equal": {},
              "expert_grads_equal": {}, "checked_steps": 0}
    for mode in ("dp", "ep"):
        for case, (topk, kw) in CASES.items():
            cfg = dataclasses.replace(TMOE, moe_topk=topk)
            model = _model(state, cfg)
            trainer = tloop.ViTTrainer(cfg, _step_cfg(
                topk, kw, ep_devices=EP if mode == "ep" else 1), model, "cpu")
            assert trainer.mode == mode
            momentum = trainer.init_momentum()
            # the data axis's ranks take the interleaved rows of the global
            # batch, as the loaders' strided shards do
            local = (imgs[trainer.data_rank::trainer.n_data],
                     lbls[trainer.data_rank::trainer.n_data])
            images, labels = trainer.place(*local)
            if mode == "ep" and case == "top1":
                named = list(model.named_parameters())
                report["local_shapes"] = {n: list(p.shape) for n, p in named}
                report["data_rank"] = trainer.data_rank
                report["expert_rank"] = trainer.expert_rank
                _, grads = trainer.batch_grads([p for _, p in named], images,
                                               labels)
                split = set(trainer.shard_names())
                for kind, group in (("whole", trainer.ep_group),
                                    ("expert", trainer.ep_group)):
                    flat = torch.cat([g.reshape(-1) for (n, _), g in
                                      zip(named, grads)
                                      if (n in split) == (kind == "expert")])
                    every = tdist_mod.all_gather_rows(flat, group)
                    report[f"{kind}_grads_equal"] = all(
                        torch.equal(every[0], e) for e in every)
            loss = trainer.global_mean(trainer.step(momentum, images, labels,
                                                    0.1))
            trainer.check_replicas(momentum)
            report["checked_steps"] += mode == "ep"
            params, grads = trainer.full_state(momentum)
            if rank == 0:
                np.savez(os.path.join(root, f"{launch}_{mode}_{case}.npz"),
                         loss=np.float32(float(loss)),
                         **{"p." + n: t.detach().numpy()
                            for n, t in params.items()},
                         **{"g." + n: t.numpy() for n, t in grads.items()})
    tloop.run_vit_training(
        _run_cfg(TTrainConfig, spec["data"],
                 os.path.join(root, launch, "ep_run"), ep_devices=EP),
        vit_cfg=RUN_CFG, device="cpu")
    with open(os.path.join(root, f"report_{launch}_rank{rank}.json"),
              "w") as f:
        json.dump(report, f)
    tdist.destroy_process_group()


# -- the fixtures ---------------------------------------------------------------

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


def _jmoe():
    from vit_project_tpu.models import vit as jvit
    return jvit.ViTConfig(patch=8, width=32, layers=2, heads=2,
                          image_size=32, num_classes=10, moe_experts=4,
                          moe_capacity=0.5)


@pytest.fixture(scope="module")
def inputs():
    """JAX-drawn weights (flat, the port's names) and a global batch of 8."""
    from vit_project_tpu.models import vit as jvit
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        jvit.init_vit_params, static_argnums=1)(jax.random.PRNGKey(7),
                                                _jmoe()))
    state = {k: v.numpy() for k, v in
             tconvert.vit_state_dict_from_jax(tree, 8).items()}
    rs = np.random.RandomState(6)
    return (tree, state, rs.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8),
            rs.randint(0, 10, 8).astype(np.int32))


@pytest.fixture(scope="module")
def ranks(imagenet, inputs, tmp_path_factory):
    """Both launches at once; returns the root of their outputs and the
    ranks' reports by launch."""
    root = str(tmp_path_factory.mktemp("ep"))
    _, state, imgs, lbls = inputs
    np.savez(os.path.join(root, "inputs.npz"), images=imgs, labels=lbls,
             **{"p." + k: v for k, v in state.items()})
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


def _one_process_step(state, imgs, lbls, case):
    topk, kw = CASES[case]
    cfg = dataclasses.replace(TMOE, moe_topk=topk)
    model = _model(state, cfg)
    trainer = tloop.ViTTrainer(cfg, _step_cfg(topk, kw), model, "cpu")
    momentum = trainer.init_momentum()
    loss = trainer.step(momentum, *trainer.place(imgs, lbls), 0.1)
    return (float(loss), {n: p.detach().numpy()
                          for n, p in model.named_parameters()},
            {n: m.numpy() for n, m in momentum.items()})


def _jax_step(tree, imgs, lbls, case):
    """JAX's ViTTrainer step on a one-device mesh (its MoE sees the global
    batch) from the same tree: (loss, params, momentum) as flat numpy by
    the port's names."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.train import vit_loop as jloop
    topk, kw = CASES[case]
    jtr = jloop.ViTTrainer(dataclasses.replace(_jmoe(), moe_topk=topk),
                           JTrainConfig(batch_size=8, compute_dtype="float32",
                                        image_size=32, num_classes=10,
                                        weight_decay=0.0, moe_experts=4,
                                        **kw),
                           jmesh.make_mesh(n_data=1,
                                           devices=jax.devices()[:1]))
    # copies: the step donates its inputs, and jnp.asarray may share the
    # numpy buffers of the fixture
    params = jax.tree_util.tree_map(jnp.array, tree)
    mom = jax.tree_util.tree_map(jnp.zeros_like, params)
    jp, jm, jl = jtr._make_train_step(None)(
        params, mom, jnp.asarray(imgs), jnp.asarray(lbls), 0.1,
        jax.random.PRNGKey(1), 0.1)

    def flat(t):
        return {k: v.numpy() for k, v in tconvert.vit_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, t), 8).items()}
    return float(jl), flat(jp), flat(jm)


def _assert_step_close(got, want):
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for n in w:
            np.testing.assert_allclose(g[n], w[n], rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=n)


def _launch_step(root, launch, mode, case):
    z = np.load(os.path.join(root, f"{launch}_{mode}_{case}.npz"))
    return (float(z["loss"]),
            {k[2:]: z[k] for k in z.files if k.startswith("p.")},
            {k[2:]: z[k] for k in z.files if k.startswith("g.")})


# -- one step in each mode --------------------------------------------------------

@pytest.fixture(scope="module")
def references(inputs):
    """Each case's step in one process and JAX's, computed once."""
    tree, state, imgs, lbls = inputs
    return {case: (_one_process_step(state, imgs, lbls, case),
                   _jax_step(tree, imgs, lbls, case)) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["dp", "ep"])
@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_step_matches_one_process_and_jax(ranks, references, launch, mode,
                                          case):
    """One step over the launch's ranks (dp over 2 or 4 data ranks; ep as
    data 1 or 2 x expert 2), the queues overflowing: the loss, every
    gradient (the router's among them) and every new parameter, gathered
    flat, as one process's step and JAX's step on the same global batch
    (with grad_accum 2 too: a microbatch is JAX's contiguous half of the
    global batch)."""
    root, _ = ranks
    got = _launch_step(root, launch, mode, case)
    assert np.abs(got[2]["blocks.1.moe.router_w"]).max() > 0
    for want in references[case]:
        _assert_step_close(got, want)


def test_queues_overflow_on_the_step_batch(inputs):
    """The step cases are ones where capacity drops tokens (in block 1 of
    the forward at the JAX-drawn weights)."""
    from vit_project_torch.ops import moe as tmoe
    _, state, imgs, _ = inputs
    seen = []
    route = tmoe.route

    def recording(*a, **k):
        r = route(*a, **k)
        seen.append(int((r.slots < 0).sum()))
        return r
    tmoe.route = recording
    try:
        for topk in (1, 2):
            model = _model(state, dataclasses.replace(TMOE, moe_topk=topk))
            with torch.no_grad():
                tvit.vit_classify(model, torch.from_numpy(imgs).float(),
                                  input_norm=tloop.IMAGENET_NORM)
    finally:
        tmoe.route = route
    assert len(seen) == 2 and all(n > 0 for n in seen), seen


# -- placement and replicas ---------------------------------------------------------

@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_experts_live_sliced_and_whole_gradients_agree(ranks, launch):
    """Each rank holds its expert rank's 2 of the 4 experts of block 1 and
    every other leaf whole (rank r is data rank r // 2, expert rank r % 2);
    before the data all-reduce the whole leaves' gradients (the router's
    among them) are equal across an expert group and the experts' are not;
    after every ep step the replicas held (the worker raised otherwise)."""
    _, reports = ranks
    for r, rep in enumerate(reports[launch]):
        assert rep["world"] == LAUNCHES[launch] and rep["backend"] == "gloo"
        assert (rep["data_rank"], rep["expert_rank"]) == (r // EP, r % EP)
        shapes = rep["local_shapes"]
        assert shapes["blocks.1.moe.fc1_w"] == [2, 32, 128]
        assert shapes["blocks.1.moe.fc2_b"] == [2, 32]
        assert shapes["blocks.1.moe.router_w"] == [32, 4]
        assert shapes["blocks.0.mlp.fc1.weight"] == [128, 32]
        assert rep["whole_grads_equal"] is True
        assert rep["expert_grads_equal"] is False
        assert rep["checked_steps"] == len(CASES)


def test_shards_are_the_experts_jax_places_on_each_expert_device(inputs):
    """Expert rank j's expert leaves are the slice JAX's
    shard_vit_params_ep puts on the device at expert index j of its
    ('data', 'expert') mesh; the router and the dense leaves stay whole;
    unshard is the inverse bit for bit."""
    from vit_project_tpu.parallel import mesh as jmesh
    tree, state, _, _ = inputs
    jm = jmesh.make_mesh(n_data=4, n_expert=EP)
    placed = jmesh.shard_vit_params_ep(jm, tree)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    shards = [tmesh.shard_vit_params_ep(tstate, EP, j) for j in range(EP)]
    for j, local in enumerate(shards):
        dev = jm.devices[0, j]
        for leaf in ("fc1_w", "fc1_b", "fc2_w", "fc2_b"):
            x = placed["blocks"][1]["moe"][leaf]
            on = np.asarray(next(s.data for s in x.addressable_shards
                                 if s.device == dev))
            np.testing.assert_array_equal(
                local[f"blocks.1.moe.{leaf}"].numpy(), on)
        assert placed["blocks"][1]["moe"]["router_w"].sharding \
            .is_fully_replicated
        for name in ("blocks.1.moe.router_w", "blocks.0.mlp.fc1.weight",
                     "head.weight"):
            assert local[name] is tstate[name]
    assert sorted(n for n in tstate if tmesh.ep_layout(n)) == sorted(
        f"blocks.1.moe.{k}" for k in ("fc1_w", "fc1_b", "fc2_w", "fc2_b"))
    back = tmesh.unshard_vit_params_ep(shards)
    for name, x in tstate.items():
        assert torch.equal(back[name], x), name
    with pytest.raises(ValueError, match=re.escape(
            "expert axis (3) must divide the expert count (4)")):
        tmesh.shard_vit_params_ep(tstate, 3, 0)
    with pytest.raises(ValueError, match=re.escape(
            "expert axis (3) must divide the expert count (4)")):
        jmesh.shard_vit_params_ep(jmesh.make_mesh(n_data=2, n_expert=3), tree)


# -- the run ---------------------------------------------------------------------

@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_ep_run_matches_one_process_and_writes_flat_trees(ranks, imagenet,
                                                          tmp_path, launch):
    """``run_vit_training`` with ep_devices 2 (data 1 or 2) trains 2 epochs
    as one process does from the same seed: rows to LOSS_RTOL, accuracy
    within one of the 24 val images, and a checkpoint holding every expert
    (the flat layout, momentum alike) within JAX's bound between modes."""
    root, _ = ranks
    one = str(tmp_path / "one")
    tloop.run_vit_training(_run_cfg(TTrainConfig, imagenet, one),
                           vit_cfg=RUN_CFG, device="cpu")
    got, want = (pd.read_csv(os.path.join(d, "training_metrics.csv"))
                 for d in (os.path.join(root, launch, "ep_run"), one))
    assert list(got["epoch"]) == list(want["epoch"]) == [0, 1]
    np.testing.assert_allclose(got[["train_loss", "val_loss"]].values,
                               want[["train_loss", "val_loss"]].values,
                               rtol=LOSS_RTOL)
    assert (abs(got["val_acc"] - want["val_acc"]) <= 100 / 24 + 1e-6).all()
    a, b = (tckpt.load_checkpoint(os.path.join(d, "checkpoint_latest.pth"))
            for d in (os.path.join(root, launch, "ep_run"), one))
    for key in ("params", "opt_state"):
        assert np.asarray(a[key]["blocks"][1]["moe"]["fc1_w"]).shape == \
            (4, 32, 128)
        for x, y in zip(jax.tree_util.tree_leaves(a[key]),
                        jax.tree_util.tree_leaves(b[key])):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=MODE_RTOL, atol=MODE_ATOL)


# -- refusals ---------------------------------------------------------------------

# (config change, model has MoE, words both packages raise)
REFUSALS = {
    "no_moe": (dict(ep_devices=2), False, "ep_devices > 1 needs a MoE model"),
    "tp": (dict(ep_devices=2, tp_devices=2), True, "enable at most one"),
    "sp": (dict(ep_devices=2, sp_devices=2), True, "enable at most one"),
    "pp": (dict(ep_devices=2, pp_stages=2), True, "enable at most one"),
    "zero1": (dict(ep_devices=2, zero1=True), True,
              "zero1/fsdp do not compose with ep_devices"),
    "fsdp": (dict(ep_devices=2, fsdp=True), True,
             "zero1/fsdp do not compose with ep_devices"),
    "pp_moe": (dict(pp_stages=2), True,
               "MoE blocks are not supported on the pipeline path"),
    "ring_moe": (dict(sp_devices=2, sp_ring=True), True,
                 "sp_ring does not compose with MoE blocks"),
    "fused_dw": (dict(ep_devices=2, fused_dw=True), True,
                 "fused_dw is a single-chip path"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_ep_and_moe_refuse_what_jax_refuses_in_its_words(case, monkeypatch):
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.train.vit_loop import ViTTrainer as JTrainer
    kw, moe, words = REFUSALS[case]
    experts = 4 if moe else 0
    jcfg = JTrainConfig(batch_size=8, compute_dtype="float32",
                        moe_experts=experts, **kw)
    with pytest.raises(ValueError, match=re.escape(words)):
        JTrainer(dataclasses.replace(_jmoe(), moe_experts=experts), jcfg)
    cfg = _step_cfg(1, {}, **kw)
    cfg.moe_experts = experts
    monkeypatch.setattr(tdist_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=re.escape(words)):
        tloop.train_mode(cfg, True, TMOE.heads, moe)


def test_ep_without_torchrun_is_refused(imagenet, tmp_path):
    """JAX drives the expert axis from one process; the port's axis is the
    ranks of a process group, so one process cannot hold it."""
    cfg = _run_cfg(TTrainConfig, imagenet, str(tmp_path / "x"),
                   ep_devices=EP)
    with pytest.raises(ValueError, match="launch with torchrun"):
        tloop.run_vit_training(cfg, vit_cfg=RUN_CFG, device="cpu")
    assert not os.path.exists(tmp_path / "x" / "training_metrics.csv")


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
