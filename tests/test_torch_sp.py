"""The port's sequence parallelism (``--sp_devices``, ``--sp_ring``:
parallel/mesh.py's ``seq_sharding``, parallel/dist.py's token collectives,
parallel/ring.py, the sp branches of models/vit.py, train/vit_loop.py's
mode "sp" and the CLIP trainer's ``sp``) against the JAX package and
against the port's own data parallelism.

Two ``torchrun --standalone`` launches run this file as a script at once,
gloo on the CPU, one thread a rank: "sp2" (2 ranks: data 1 x model 2) and
"sp4" (4 ranks: data 2 x model 2). Each rank works through its scenarios
and writes what it saw to a JSON file (rank 0 of a launch also writes
arrays); the tests read those and the runs' trees. The JAX references are
computed first, in the pytest process, on its 8-device virtual mesh
(tests/conftest.py): ring attention on a (4, 2) mesh, the
``run_vit_training(sp_devices=2[, sp_ring=True])`` runs whose epoch 0 the
port's runs resume, one MoE step under sp, and
``run_behavioral_training(sp_devices=2)``.

The ViT is the JAX fixture's test-tiny (width 32, 2 blocks, 2 heads, S=17:
9 + 8 tokens over 2 ranks, the ring padding 17 to 18) on its ImageFolder,
global batch 8, float32; the CLIP model is tests/test_torch_clip_parallel.py's
tiny CLIP (visual S=5: 3 + 2 tokens) with JAX's initial adapters.
Tolerances: ring attention 1e-5 forward and 1e-4 gradients against JAX's;
rows of an epoch LOSS_RTOL and trees JAX's own bound between its modes.
"""
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_clip_parallel import _close, _config, _rows, _write_things
from test_torch_tp import (_assert_runs_close, _leaves, _metrics, _resume_dir,
                           _tiny, _trees, imagenet)  # noqa: F401 (fixture)
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.parallel import dist as tdist_mod
from vit_project_torch.parallel import mesh as tmesh
from vit_project_torch.parallel import ring as tring
from vit_project_torch.train import clip_loop as tclip_loop
from vit_project_torch.train import multi_fork as tmf
from vit_project_torch.train import vit_loop as tloop

LAUNCHES = {"sp2": 2, "sp4": 4}
SP = 2
TTINY = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)
TMOE = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                      num_classes=10, moe_experts=4, moe_capacity=0.5)
# the port against JAX over an epoch (tests/test_torch_tp.py) and between
# its modes (JAX's own bound, tests/test_vit_training.py)
LOSS_RTOL = 1e-4
MODE_RTOL, MODE_ATOL = 1e-4, 1e-5
# one step against JAX's and one process's (tests/test_torch_ep.py)
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
RING_FWD_ATOL, RING_GRAD_ATOL = 1e-5, 1e-4
# (S, causal) of the ring cases; S=17 pads to 18 over 2 ranks
RING_CASES = {"plain": (24, False), "padded": (17, False),
              "causal": (17, True)}
CLIP_EPOCHS = 2
LAUNCH_TIMEOUT = 600
STEPS = 6          # an epoch: 48 train images at global batch 8


# -- the ranks ----------------------------------------------------------------

def _ring_case(spec, seq, name):
    """The port's ring on this rank's block of JAX's padded inputs, both
    backward forms: the whole output and gradients, gathered over the model
    group, as numpy."""
    z = np.load(os.path.join(spec["root"], "ring_inputs.npz"))
    S, causal = RING_CASES[name]
    per = seq.shard_len(S)
    lo, hi = seq.bounds(S)
    out = {}
    for me in (True, False):
        q, k, v = (torch.from_numpy(z[f"{name}.{t}"])[
            :, seq.index * per:(seq.index + 1) * per].clone()
            .requires_grad_(True) for t in "qkv")
        o = tring.ring_attention_bshd(q, k, v, seq, s_valid=S, causal=causal,
                                      memory_efficient=me)
        (o[:, :hi - lo] ** 2).sum().backward()
        for key, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
            full = tdist_mod.all_gather_rows(t.detach().contiguous(),
                                             seq.group)
            out[f"{name}.{key}.{int(me)}"] = full.movedim(0, 1).reshape(
                t.shape[0], -1, *t.shape[2:]).numpy()
    return out


def _moe_step(spec, root, launch, report):
    """One sp step of the MoE tiny (capacity 0.5, the queues overflowing)
    from JAX-drawn weights on the global batch, each data rank on its
    interleaved rows; rank 0 writes the flat trees."""
    z = np.load(os.path.join(root, "moe_inputs.npz"))
    model = tvit.empty_vit(TMOE, "cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(z[k]) for k in z.files
                           if k.startswith("p.")})
    trainer = tloop.ViTTrainer(TMOE, _step_cfg(sp_devices=SP), model, "cpu")
    momentum = trainer.init_momentum()
    imgs, lbls = z["images"], z["labels"]
    images, labels = trainer.place(imgs[trainer.data_rank::trainer.n_data],
                                   lbls[trainer.data_rank::trainer.n_data])
    loss = trainer.global_mean(trainer.step(momentum, images, labels, 0.1))
    params, mom = trainer.full_state(momentum)
    report["moe_mode"] = trainer.mode
    if tdist_mod.rank() == 0:
        np.savez(os.path.join(root, f"{launch}_moe.npz"),
                 loss=np.float32(float(loss)),
                 **{"p." + n: t.detach().numpy() for n, t in params.items()},
                 **{"g." + n: t.numpy() for n, t in mom.items()})


def _grads_counted_once(spec, report):
    """The sp step's gradients after its all-reduce against one process's
    on the same global batch, leaf by leaf, and model rank 1's head
    gradient before it (zero: only model rank 0 counts the loss)."""
    from vit_project_torch.data.packed import make_loader
    cfg = _tiny(TTrainConfig, spec["data"], "x", sp_devices=SP)
    gen = torch.Generator().manual_seed(0)
    model = tvit.init_vit_params(tvit.empty_vit(TTINY, "cpu"), gen)
    trainer = tloop.ViTTrainer(TTINY, cfg, model, "cpu")
    one = tloop.ViTTrainer(TTINY, _tiny(TTrainConfig, spec["data"], "x"),
                           model, "cpu", distributed=False)
    loader = make_loader(f"{spec['data']}/train", cfg.batch_size, train=True,
                         seed=0, size=32, workers=1, drop_last=True)
    imgs, lbls = next(iter(loader.epoch(0)))
    named = list(model.named_parameters())
    params = [p for _, p in named]
    local = trainer.place(imgs[trainer.data_rank::trainer.n_data],
                          lbls[trainer.data_rank::trainer.n_data])
    _, mine = trainer.batch_grads(params, *local)
    report["head_grad_before_sum"] = float(
        mine[[n for n, _ in named].index("head.weight")].abs().max())
    got = trainer._all_reduce_mean(list(mine))
    _, want = one.batch_grads(params, *one.place(imgs, lbls))
    report["grad_rel_err"] = {
        n: float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        for (n, _), g, w in zip(named, got, want)}
    report["data_rank"], report["model_rank"] = (trainer.data_rank,
                                                 trainer.model_rank)
    report["bounds"] = [list(trainer.seq_shard.bounds(TTINY.seq_len)),
                        list(trainer.seq_shard.bounds(197))]


def _clip_runs(spec, root, launch):
    """``run_behavioral_training(sp_devices=2)`` (and the ring on sp2) from
    JAX's initial adapters, dropout 0."""
    from vit_project_torch.adapters import dora as tadora
    with open(spec["adapters"], "rb") as f:
        ad = pickle.load(f)

    def apply_dora(model, spec_, *, r, alpha=16, dropout=0.1, generator):
        assert r == ad["acfg"]["r"]
        return ad["trainable"], ad["static"], dict(ad["acfg"])
    real = tadora.apply_dora
    tadora.apply_dora = apply_dora
    try:
        for name, kw in (("clip_sp", {}), ("clip_ring", {"sp_ring": True})):
            if name == "clip_ring" and launch != "sp2":
                continue
            tclip_loop.run_behavioral_training(_config(
                spec["things"], os.path.join(root, launch, name),
                epochs=CLIP_EPOCHS, sp_devices=SP, **kw), device="cpu")
    finally:
        tadora.apply_dora = real


def _worker(spec_path, launch):
    """One rank of `launch`: its scenarios in order; what it saw goes to
    report_{launch}_rank{r}.json beside the spec."""
    import torch.distributed as tdist

    with open(spec_path) as f:
        spec = json.load(f)
    root, data = spec["root"], spec["data"]
    out_root = os.path.join(root, launch)
    rank, world = tdist_mod.setup_distributed("cpu")
    report = {"rank": rank, "world": world, "backend": tdist.get_backend(),
              "checked_steps": {}, "same_images_steps": {}}
    run_name = {}

    # after every sp step: every rank holds the same parameters, the model
    # group the same momentum, and the model group's ranks trained on the
    # same images
    step = tloop.ViTTrainer.step

    def checked_step(self, momentum, images_u8, labels, *a, **k):
        loss = step(self, momentum, images_u8, labels, *a, **k)
        if self.mode == "sp":
            self.check_replicas(momentum)
            key = run_name["run"]
            report["checked_steps"][key] = \
                report["checked_steps"].get(key, 0) + 1
            group = self.seq_shard.group
            seen = tdist_mod.all_gather_rows(images_u8.float(), group)
            lbls = tdist_mod.all_gather_rows(labels, group)
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

    mesh = tmesh.make_mesh(n_model=SP)
    seq = tmesh.seq_sharding(mesh)
    arrays = {}
    for name in RING_CASES:
        arrays.update(_ring_case(spec, seq, name))
    if rank == 0:
        np.savez(os.path.join(root, f"{launch}_ring.npz"), **arrays)

    run("sp_from_jax", sp_devices=SP)
    run("ring_from_jax", sp_devices=SP, sp_ring=True)
    run("sp", sp_devices=SP)
    run("sp_zero1", sp_devices=SP, zero1=True, epochs=1)
    if launch == "sp2":
        run("dp")
        run("sp_accum", sp_devices=SP, grad_accum=2, epochs=1)
        run("ring", sp_devices=SP, sp_ring=True, epochs=1)
        run("ring_remat", sp_devices=SP, sp_ring=True, remat=True, epochs=1)
        if rank == 0:
            _resume_dir(os.path.join(out_root, "dp"),
                        os.path.join(out_root, "sp_from_dp"))
        tdist.barrier()
        run("sp_from_dp", sp_devices=SP)
    tloop.ViTTrainer.step = step
    _grads_counted_once(spec, report)
    _moe_step(spec, root, launch, report)
    _clip_runs(spec, root, launch)
    with open(os.path.join(root, f"report_{launch}_rank{rank}.json"),
              "w") as f:
        json.dump(report, f)
    tdist.destroy_process_group()


# -- the fixtures ---------------------------------------------------------------

def _step_cfg(**mode):
    return TTrainConfig(batch_size=8, compute_dtype="float32", image_size=32,
                        num_classes=10, weight_decay=0.0, moe_experts=4,
                        moe_capacity=0.5, **mode)


def _jtiny(**kw):
    from vit_project_tpu.models import vit as jvit
    return jvit.ViTConfig(patch=8, width=32, layers=2, heads=2,
                          image_size=32, **{"num_classes": 3, **kw})


def _jax_ring(root):
    """JAX's ring on a (data 4, model 2) mesh for each case: the padded
    inputs, the output and the gradients of the valid rows' sum of
    squares."""
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.parallel import ring as jring
    mesh = jmesh.make_mesh(n_data=4, n_model=SP)
    rs = np.random.RandomState(0)
    inputs, refs = {}, {}
    for name, (S, causal) in RING_CASES.items():
        qkv = [jnp.asarray(rs.randn(4, S, 2, 8), jnp.float32)
               for _ in range(3)]
        padded = [jring.pad_seq(t, SP)[0] for t in qkv]

        def loss(q, k, v, S=S, causal=causal):
            o = jring.ring_attention_bshd(q, k, v, mesh, "model", s_valid=S,
                                          causal=causal)
            return jnp.sum(o[:, :S] ** 2), o
        (_, o), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*padded)
        for t, x in zip("qkv", padded):
            inputs[f"{name}.{t}"] = np.asarray(x)
        refs[name] = {"o": np.asarray(o), "S": S,
                      **{f"d{t}": np.asarray(g) for t, g in zip("qkv", grads)}}
    np.savez(os.path.join(root, "ring_inputs.npz"), **inputs)
    return refs


def _jax_moe_step(root):
    """JAX-drawn MoE weights and a batch (saved for the ranks), and JAX's
    sp step on its (data 4, model 2) mesh: (loss, params, momentum) flat
    by the port's names."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.train import vit_loop as jloop
    jcfg = _jtiny(num_classes=10, moe_experts=4, moe_capacity=0.5)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        jvit.init_vit_params, static_argnums=1)(jax.random.PRNGKey(7), jcfg))
    rs = np.random.RandomState(6)
    imgs = rs.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    lbls = rs.randint(0, 10, 8).astype(np.int32)

    def flat(t):
        return {k: v.numpy() for k, v in tconvert.vit_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, t), 8).items()}
    np.savez(os.path.join(root, "moe_inputs.npz"), images=imgs, labels=lbls,
             **{"p." + k: v for k, v in flat(tree).items()})
    mesh = jmesh.make_mesh(n_data=4, n_model=SP)
    jtr = jloop.ViTTrainer(jcfg, JTrainConfig(
        batch_size=8, compute_dtype="float32", image_size=32,
        num_classes=10, weight_decay=0.0, moe_experts=4, moe_capacity=0.5,
        sp_devices=SP), mesh)
    params = jmesh.replicate(mesh, jax.tree_util.tree_map(jnp.array, tree))
    mom = jmesh.replicate(mesh, jax.tree_util.tree_map(jnp.zeros_like,
                                                       params))
    si, sl = jtr.shard(imgs, lbls)
    jp, jm, jl = jtr._make_train_step(None)(params, mom, si, sl, 0.1,
                                            jax.random.PRNGKey(1), 0.1)
    return float(jl), flat(jp), flat(jm)


def _jax_clip(root):
    """The tiny CLIP's weights file and JAX's initial adapters (dropout 0),
    and JAX's ``run_behavioral_training(sp_devices=2)`` on the synthetic
    THINGS; returns (things, adapters path, the JAX run's config)."""
    from vit_project_tpu.adapters import dora as jadora
    from vit_project_tpu.models import clip as jclip
    from vit_project_tpu.models import convert as jconvert
    from vit_project_tpu.train import clip_loop as jloop
    from vit_project_torch.models import clip as tclip
    things = _write_things(os.path.join(root, "things"))
    kw = dict(width=128, layers=2, heads=2, patch=32, image_size=64,
              embed_dim=32, vocab=49408, context=16)
    params = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), jclip.tiny_clip_config(**kw)))
    tcfg = tconvert.clip_config_from_state_dict(
        tconvert.clip_state_dict_from_jax_params(
            params, tclip.tiny_clip_config(**kw)))
    weights = os.path.join(root, "tiny_clip.pt")
    torch.save(tconvert.clip_state_dict_from_jax_params(params, tcfg),
               weights)
    things["weights"] = weights
    jparams, jc = jconvert.clip_params_from_state_dict(
        jconvert.load_torch_state_dict(weights))
    jtr, jst, acfg = jadora.apply_dora(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        jadora.dora_spec(jc.visual.layers, jc.text.layers, 2, 2), r=4,
        alpha=16, dropout=0.0, key=jax.random.PRNGKey(1 + 123))
    adapters = os.path.join(root, "adapters.pkl")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    with open(adapters, "wb") as f:
        pickle.dump({"trainable": tconvert.adapters_from_jax(np_tree(jtr)),
                     "static": tconvert.adapters_from_jax(np_tree(jst)),
                     "acfg": dict(acfg)}, f)
    jax_cfg = _config(things, os.path.join(root, "jax_clip_sp"),
                      epochs=CLIP_EPOCHS, sp_devices=SP)
    assert jloop.run_behavioral_training(jax_cfg)["last_epoch0"] == \
        CLIP_EPOCHS - 1
    return things, adapters, jax_cfg


@pytest.fixture(scope="module")
def ranks(imagenet, tmp_path_factory):
    """The JAX references (in this process, on its 8-device virtual mesh),
    then the two launches at once; returns the root, the references and
    the ranks' reports by launch."""
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    root = str(tmp_path_factory.mktemp("sp"))
    assert jax.device_count() == 8
    for name, kw in (("jax_sp", {}), ("jax_ring", {"sp_ring": True})):
        jrun(_tiny(JTrainConfig, imagenet, os.path.join(root, name),
                   sp_devices=SP, **kw), vit_cfg=_jtiny())
        for launch in LAUNCHES:
            _resume_dir(os.path.join(root, name), os.path.join(
                root, launch, name[len("jax_"):] + "_from_jax"))
    refs = {"ring": _jax_ring(root), "moe": _jax_moe_step(root)}
    things, adapters, refs["clip_cfg"] = _jax_clip(root)
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"root": root, "data": imagenet, "things": things,
                   "adapters": adapters}, f)
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
    return root, refs, reports


# -- parallel/mesh.py: the layout ----------------------------------------------

def test_seq_shards_are_gspmds_ragged_split():
    """ceil(S / n) tokens a rank, the last shard short: ViT-B/16's 197 as
    99 + 98, CLIP ViT-L/14's 257 as 129 + 128, the tiny ViT's 17 over 4
    ranks as 5 + 5 + 5 + 2; the ring pads each shard to ceil(S / n)."""
    def split(S, n):
        return [tmesh.SeqShard(None, n, t).bounds(S) for t in range(n)]
    assert split(197, 2) == [(0, 99), (99, 197)]
    assert split(257, 2) == [(0, 129), (129, 257)]
    assert [hi - lo for lo, hi in split(17, 4)] == [5, 5, 5, 2]
    assert split(17, 2) == [(0, 9), (9, 17)]
    assert tmesh.SeqShard(None, 4, 3).shard_len(17) == 5


def test_seq_sharding_refuses_a_mesh_without_a_model_axis_in_jaxs_words():
    from vit_project_tpu.parallel import mesh as jmesh
    with pytest.raises(ValueError) as jerr:
        jmesh.seq_sharding(jmesh.make_mesh(n_data=8))
    with pytest.raises(ValueError) as terr:
        tmesh.seq_sharding(types.SimpleNamespace(mesh_dim_names=("data",)))
    assert str(terr.value) == str(jerr.value)


# -- parallel/ring.py -----------------------------------------------------------

@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_ring_attention_matches_jaxs(ranks, launch, case):
    """The port's ring over the model group (each rank its block of JAX's
    padded inputs) gives JAX's output within 1e-5 and the gradients of the
    valid rows' sum of squares within 1e-4, on the valid rows, plain,
    padded (17 -> 18) and causal."""
    root, refs, _ = ranks
    z = np.load(os.path.join(root, f"{launch}_ring.npz"))
    ref = refs["ring"][case]
    S = ref["S"]
    np.testing.assert_allclose(z[f"{case}.o.1"][:, :S], ref["o"][:, :S],
                               rtol=0, atol=RING_FWD_ATOL)
    for t in ("dq", "dk", "dv"):
        np.testing.assert_allclose(z[f"{case}.{t}.1"][:, :S],
                                   ref[t][:, :S], rtol=0,
                                   atol=RING_GRAD_ATOL, err_msg=t)


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_memory_efficient_backward_matches_the_oracle(ranks, launch):
    """The ring's own backward (k/v rotated again, dk/dv travelling home)
    against autograd through the forward's loop (each hop a RingHop):
    the same output, and gradients up to f32 reassociation."""
    root, _, _ = ranks
    z = np.load(os.path.join(root, f"{launch}_ring.npz"))
    for case, (S, _) in RING_CASES.items():
        np.testing.assert_array_equal(z[f"{case}.o.1"], z[f"{case}.o.0"])
        for t in ("dq", "dk", "dv"):
            np.testing.assert_allclose(z[f"{case}.{t}.1"][:, :S],
                                       z[f"{case}.{t}.0"][:, :S], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{case} {t}")


def test_pad_seq_and_the_nondividing_refusal_match_jax():
    """pad_seq pads as JAX's, and the ring shards vit_encode enters with are
    pad_seq's blocks. JAX's refusal of an S_pad the axis does not divide
    has no counterpart: each rank passes its own block, so S_pad is n times
    its length; the port refuses blocks of unequal shapes instead."""
    from vit_project_tpu.parallel import ring as jring
    x = np.random.RandomState(0).randn(2, 17, 2, 8).astype(np.float32)
    got, s = tring.pad_seq(torch.from_numpy(x), 4)
    want, js = jring.pad_seq(jnp.asarray(x), 4)
    assert s == js == 17 and got.shape == (2, 20, 2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for index in range(4):
        shard, sp = tvit._seq_parallel_enter(torch.from_numpy(x),
                                             tmesh.SeqShard(None, 4, index),
                                             True)
        assert sp.S == 17 and sp.ring
        np.testing.assert_array_equal(
            shard.numpy(), got.numpy()[:, 5 * index:5 * index + 5])
    t = torch.from_numpy(x[:, :5])
    with pytest.raises(ValueError, match="one rank's blocks of one shape"):
        tring.ring_attention_bshd(t, t[:, :4], t, tmesh.SeqShard(None, 4, 0))


# -- the ViT runs ---------------------------------------------------------------

@pytest.mark.parametrize("form", ["sp", "ring"])
@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_sp_and_ring_match_the_jax_runs_on_its_virtual_mesh(ranks, launch,
                                                             form):
    """Resumed from JAX's run_vit_training(sp_devices=2[, sp_ring=True])
    epoch 0 (its flat checkpoint), the port's run trains epoch 1 as JAX's
    does: rows to LOSS_RTOL, accuracy within one image, the flat trees
    within JAX's bound between its modes."""
    root, _, _ = ranks
    got = os.path.join(root, launch, f"{form}_from_jax")
    assert list(_metrics(got)["epoch"]) == [0, 1]
    _assert_runs_close(got, os.path.join(root, f"jax_{form}"),
                       rtol=LOSS_RTOL)


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_sp_trains_as_dp_and_writes_flat_checkpoints(ranks, launch):
    """From the port's seed, sp (data 1 or 2 x model 2) trains 2 epochs as
    the 2-rank dp run does; its checkpoint holds the flat layout."""
    root, _, _ = ranks
    got = os.path.join(root, launch, "sp")
    _assert_runs_close(got, os.path.join(root, "sp2", "dp"))
    for tree in _trees(got):
        for bp in tree["blocks"]:
            assert np.asarray(bp["qkv_w"]).shape == (32, 96)
            assert np.asarray(bp["fc1_w"]).shape == (32, 128)


def _epoch0(out):
    from vit_project_torch.ckpt import vit_ckpt as tckpt
    ck = tckpt.load_checkpoint(os.path.join(out, "checkpoint_epoch_000.pth"))
    return ck["params"], ck["opt_state"]


@pytest.mark.parametrize("run,exact", [
    ("sp4/sp_zero1", True), ("sp2/sp_zero1", True),
    ("sp2/sp_accum", False), ("sp2/ring", False)])
def test_sp_composes_with_zero1_and_grad_accum_and_ring(ranks, run, exact):
    """Epoch 0 of sp with zero1 (the momentum split over the data axis)
    equals sp's bit for bit; with grad_accum 2 (the microbatches' sums in
    another order) and in the ring form it is within JAX's bound."""
    root, _, _ = ranks
    launch = run.split("/")[0]
    got, want = os.path.join(root, run), os.path.join(root, launch, "sp")
    rows = _metrics(got)
    assert list(rows["epoch"]) == [0]
    np.testing.assert_allclose(
        rows[["train_loss", "val_loss"]].values,
        _metrics(want)[["train_loss", "val_loss"]].values[:1],
        rtol=0 if exact else MODE_RTOL)
    for a, b in zip(_epoch0(got), _epoch0(want)):
        for x, y in zip(_leaves(a), _leaves(b)):
            if exact:
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=MODE_RTOL,
                                           atol=MODE_ATOL)


def test_remat_under_the_ring_is_bit_equal(ranks):
    """remat replays each block's forward, the ring's hops included, on
    every rank alike: the same row and trees, bit for bit."""
    root, _, _ = ranks
    got, want = (os.path.join(root, "sp2", n) for n in ("ring_remat", "ring"))
    assert _metrics(got).equals(_metrics(want))
    for a, b in zip(_epoch0(got), _epoch0(want)):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_checkpoints_cross_resume_between_sp_dp_and_one_process(
        ranks, imagenet, tmp_path):
    """dp's epoch 0 resumed under sp, and sp's in one process: each epoch-1
    row and final tree within JAX's bound of the uninterrupted run's."""
    root, _, _ = ranks
    sp2 = os.path.join(root, "sp2")
    one = str(tmp_path / "one_from_sp")
    _resume_dir(os.path.join(sp2, "sp"), one)
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, one),
                           vit_cfg=TTINY, device="cpu")
    _assert_runs_close(os.path.join(sp2, "sp_from_dp"),
                       os.path.join(sp2, "dp"))
    _assert_runs_close(one, os.path.join(sp2, "sp"))


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_every_leaf_gradient_is_counted_once(ranks, launch):
    """The sp step's gradients after its one all-reduce equal one process's
    on the global batch, every leaf (the head, the CLS token and the
    positions among them) within 1e-5 of its largest value; model rank 1
    holds no head gradient before the sum (only model rank 0 counts the
    loss)."""
    _, _, reports = ranks
    for r, rep in enumerate(reports[launch]):
        errs = rep["grad_rel_err"]
        assert {"head.weight", "head.bias", "cls_token",
                "pos_embed"} <= set(errs)
        assert max(errs.values()) <= 1e-5, errs
        if rep["model_rank"] == 1:
            assert rep["head_grad_before_sum"] == 0.0
        else:
            assert rep["head_grad_before_sum"] > 0.0


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_model_groups_read_one_shard_and_replicas_hold(ranks, launch):
    """After every sp step the ranks held the same parameters and the model
    group the same momentum (the worker raised otherwise), the two ranks of
    a model group trained on the same images every step, and the layout is
    the ragged split (rank r is data rank r // 2, model rank r % 2)."""
    _, _, reports = ranks
    runs = {"sp_from_jax": STEPS, "ring_from_jax": STEPS, "sp": 2 * STEPS,
            "sp_zero1": STEPS}
    if launch == "sp2":
        runs.update(sp_accum=STEPS, ring=STEPS, ring_remat=STEPS,
                    sp_from_dp=STEPS)
    for r, rep in enumerate(reports[launch]):
        assert rep["world"] == LAUNCHES[launch] and rep["backend"] == "gloo"
        assert (rep["data_rank"], rep["model_rank"]) == (r // SP, r % SP)
        assert rep["bounds"] == [[[0, 9], [9, 17]][r % SP],
                                 [[0, 99], [99, 197]][r % SP]]
        assert rep["checked_steps"] == runs
        assert rep["same_images_steps"] == rep["checked_steps"]


# -- MoE under the gather form --------------------------------------------------

def _one_process_moe_step(root):
    z = np.load(os.path.join(root, "moe_inputs.npz"))
    model = tvit.empty_vit(TMOE, "cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(z[k]) for k in z.files
                           if k.startswith("p.")})
    trainer = tloop.ViTTrainer(TMOE, _step_cfg(), model, "cpu")
    momentum = trainer.init_momentum()
    loss = trainer.step(momentum, *trainer.place(z["images"], z["labels"]),
                        0.1)
    return (float(loss), {n: p.detach().numpy()
                          for n, p in model.named_parameters()},
            {n: m.numpy() for n, m in momentum.items()})


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_moe_step_under_the_gather_form_matches_jax(ranks, launch):
    """One sp step of the MoE tiny, the queues overflowing (capacity 0.5):
    each rank routes its model group's whole sequence, so the loss, every
    new parameter and every gradient (the router's among them) are JAX's
    sp step's and one process's on the same global batch."""
    root, refs, reports = ranks
    assert all(rep["moe_mode"] == "sp" for rep in reports[launch])
    z = np.load(os.path.join(root, f"{launch}_moe.npz"))
    got = (float(z["loss"]),
           {k[2:]: z[k] for k in z.files if k.startswith("p.")},
           {k[2:]: z[k] for k in z.files if k.startswith("g.")})
    assert np.abs(got[2]["blocks.1.moe.router_w"]).max() > 0
    for want in (refs["moe"], _one_process_moe_step(root)):
        assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
        for g, w in zip(got[1:], want[1:]):
            assert g.keys() == w.keys()
            for n in w:
                np.testing.assert_allclose(g[n], w[n], rtol=STEP_RTOL,
                                           atol=STEP_ATOL, err_msg=n)


# -- CLIP-HBA: the visual tower sequence-parallel --------------------------------

@pytest.mark.parametrize("run", ["sp2/clip_sp", "sp4/clip_sp",
                                 "sp2/clip_ring"])
def test_clip_sp_matches_jaxs_run(ranks, run):
    """run_behavioral_training(sp_devices=2) over the ranks (the ring on
    sp2 too): each epoch's losses within 2e-4 and rho, p within 2e-3 of
    JAX's sp run (tests/test_torch_clip_parallel.py's bounds)."""
    root, refs, _ = ranks
    got = _rows(os.path.join(root, run, "training_res.csv"))
    want = _rows(refs["clip_cfg"]["training_res_path"])
    assert got[0] == want[0] and len(got) == CLIP_EPOCHS + 1
    for a, b in zip(got[1:], want[1:]):
        _close(a, b)


# -- refusals -------------------------------------------------------------------

# (config change, model has MoE, words both packages raise)
REFUSALS = {
    "tp": (dict(sp_devices=2, tp_devices=2), False, "enable at most one"),
    "ring_without_sp": (dict(sp_ring=True), False,
                        "sp_ring needs sp_devices > 1"),
    "ring_moe": (dict(sp_devices=2, sp_ring=True), True,
                 "sp_ring does not compose with MoE blocks"),
    "fsdp": (dict(sp_devices=2, fsdp=True), False,
             "fsdp does not compose with sp_devices"),
    "fused_dw": (dict(sp_devices=2, fused_dw=True), False,
                 "fused_dw is a single-chip path"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_sp_refuses_what_jax_refuses_in_its_words(case, monkeypatch):
    from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
    from vit_project_tpu.train.vit_loop import ViTTrainer as JTrainer
    kw, moe, words = REFUSALS[case]
    experts = 4 if moe else 0
    jcfg = dataclasses.replace(_tiny(JTrainConfig, "x", "x"), **kw,
                               moe_experts=experts)
    with pytest.raises(ValueError, match=re.escape(words)):
        JTrainer(_jtiny(moe_experts=experts), jcfg)
    cfg = dataclasses.replace(_tiny(TTrainConfig, "x", "x"), **kw,
                              moe_experts=experts)
    monkeypatch.setattr(tdist_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=re.escape(words)):
        tloop.train_mode(cfg, True, TTINY.heads)


def test_sp_without_torchrun_is_refused(imagenet, tmp_path):
    """JAX drives the model axis from one process; the port's axis is the
    ranks of a process group, so one process cannot hold it."""
    cfg = _tiny(TTrainConfig, imagenet, str(tmp_path / "x"), sp_devices=SP)
    with pytest.raises(ValueError, match="launch with torchrun"):
        tloop.run_vit_training(cfg, vit_cfg=TTINY, device="cpu")
    assert not os.path.exists(tmp_path / "x" / "training_metrics.csv")
    ccfg = _config({k: "x" for k in ("csv_file", "img_dir",
                                     "inference_csv_file",
                                     "RDM48_triplet_dir", "weights")},
                   str(tmp_path / "c"), sp_devices=SP)
    with pytest.raises(ValueError, match="launch with torchrun"):
        tclip_loop.run_behavioral_training(ccfg, device="cpu")
    assert not os.path.exists(ccfg["training_res_path"])


def test_clip_and_forks_refuse_what_jax_refuses_in_its_words():
    """The CLIP trainer's sp refusals (sp_ring without sp, sp without a
    mesh, the frozen-prefix cache under sp), batched forks under sp, and
    ring_attn without seq_shard, each in JAX's words."""
    tr = tclip_loop.ClipHBATrainer
    with pytest.raises(ValueError, match=re.escape("sp_ring needs sp=True")):
        tr(None, torch.nn.Linear(1, 1), {}, {}, [[0]], lr=1.0, sp_ring=True)
    with pytest.raises(ValueError, match=re.escape(
            "sp=True needs a ('data','model') mesh")):
        tr(None, torch.nn.Linear(1, 1), {}, {}, [[0]], lr=1.0, sp=True)
    sharded = tr.__new__(tr)
    sharded.seq_shard = tmesh.SeqShard(None, 2, 0)
    with pytest.raises(ValueError, match="frozen_cache is incompatible with "
                                         "sequence parallelism"):
        sharded.build_prefix_cache(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="batched multi-fork execution does "
                                         "not compose with sequence "
                                         "parallelism"):
        tmf._Setup({"sp_devices": 2}, None)
    with pytest.raises(ValueError, match=re.escape(
            "ring_attn=True needs seq_shard")):
        tvit.vit_classify(tvit.empty_vit(TTINY, "cpu"),
                          torch.zeros(1, 32, 32, 3), ring_attn=True)


def test_int8_weights_are_refused_under_sp():
    """int8 is the serving path and sp the training one: a quantized model
    under seq_shard is refused before any collective (its q lanes are
    prescaled for the kernels, which the ring would scale again)."""
    from vit_project_torch.ops import quant as tquant
    model = tquant.quantize_vit_blocks(
        tvit.init_vit_params(tvit.empty_vit(TTINY, "cpu"),
                             torch.Generator().manual_seed(0)))
    for ring in (False, True):
        with pytest.raises(ValueError, match="takes float weights"):
            tvit.vit_classify(model, torch.zeros(1, 32, 32, 3),
                              seq_shard=tmesh.SeqShard(None, 2, 0),
                              ring_attn=ring)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
