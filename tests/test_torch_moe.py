"""The port's MoE ViT in one process (``ops/moe.py``, the MoE blocks of
``models/vit.py``, the aux term of ``train/vit_loop.py``, the converter's
``"moe"`` sub-tree, int8 leaving MoE blocks float) against the JAX package.

Inputs are made with numpy from fixed seeds; weights drawn by the JAX
package reach the port through ``models/convert.py``. float32 throughout,
JAX at jax_default_matmul_precision "highest" (tests/conftest.py). The
model is the JAX tests' MoE tiny (test-tiny with 4 experts: block 1 is a
MoE block). Tolerances: one MoE layer 1e-5 relative (the same products in
another order), a model and one step 1e-4 relative and 1e-6 absolute (the
port's bound for the dense step, tests/test_torch_vit_training.py), rows of
an epoch 1e-4 relative.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
from vit_project_tpu.models import vit as jvit
from vit_project_tpu.ops import moe as jmoe
from vit_project_torch.ckpt import vit_ckpt as tckpt
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.ops import moe as tmoe
from vit_project_torch.ops import quant as tquant
from vit_project_torch.train import vit_loop as tloop

JMOE = jvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                      num_classes=10, moe_experts=4)
TMOE = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                      num_classes=10, moe_experts=4)
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
LAYER_RTOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
MOE_LEAVES = ("router_w", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


# JAX's initialisers and forward, compiled once a shape (eager JAX compiles
# each op on its own, which dominates these tests' time)
_jinit = jax.jit(jvit.init_vit_params, static_argnums=1)
_jinit_moe = jax.jit(jmoe.init_moe_mlp, static_argnums=(1, 2, 3))
_jclassify = jax.jit(jvit.vit_classify, static_argnums=2,
                     static_argnames=("input_norm", "with_aux"))
_jmoe = jax.jit(jmoe.moe_mlp,
                static_argnames=("act", "capacity_factor", "topk"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer(key, width=16, hidden=32, experts=4):
    """JAX's init_moe_mlp as numpy, and the port's MoEMlp holding it."""
    p = _np_tree(_jinit_moe(jax.random.PRNGKey(key), width, hidden, experts))
    m = tmoe.MoEMlp(width, hidden, experts)
    with torch.no_grad():
        for k in MOE_LEAVES:
            getattr(m, k).copy_(torch.from_numpy(np.array(p[k])))
    return p, m


def _relu_j(v):
    return jnp.maximum(v, 0)


def _close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale + atol, \
        (np.abs(got - want).max(), scale)


def _port_moe(x, m, **kw):
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    y, aux = tmoe.moe_mlp(xt, m, act=torch.relu, **kw)
    return xt, y, aux


# -- one MoE layer ------------------------------------------------------------

@pytest.mark.parametrize("n,cf,E", [(20, 1.25, 4), (50432, 1.25, 8),
                                    (12608, 2.5, 8), (16, 0.8, 2),
                                    (7, 0.5, 3)])
def test_expert_capacity_is_jaxs(n, cf, E):
    assert tmoe.expert_capacity(n, E, cf) == jmoe.expert_capacity(n, E, cf)


@pytest.mark.parametrize("topk,cf", [(1, 1.25), (1, 0.5), (2, 0.9),
                                     (2, 0.4)])
def test_moe_mlp_matches_jax_values_and_gradients(topk, cf):
    """y, aux and the gradients of x and of every leaf (router included) of
    a weighted sum of y plus 0.3 aux, against JAX's moe_mlp; the cases with
    capacity factor 0.5 and 0.4 drop tokens (checked), and so does one of
    the others."""
    p, m = _layer(4)
    x = np.random.RandomState(2).randn(4, 17, 16).astype(np.float32)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(x, p):
        y, aux = jmoe.moe_mlp(x, p, act=_relu_j, capacity_factor=cf,
                              topk=topk)
        return (y * w).sum() + 0.3 * aux, (y, aux)
    (_, (jy, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), p)
    xt, y, aux = _port_moe(x, m, capacity_factor=cf, topk=topk)
    ((y * torch.from_numpy(w)).sum() + 0.3 * aux).backward()
    _close(y.detach(), jy, LAYER_RTOL)
    assert abs(aux.item() - float(jaux)) <= LAYER_RTOL * abs(float(jaux))
    _close(xt.grad, jgx, LAYER_RTOL)
    for k in MOE_LEAVES:
        _close(getattr(m, k).grad, jgp[k], LAYER_RTOL)
    r = tmoe.route(torch.from_numpy(x).reshape(-1, 16), m.router_w,
                   n_images=4, capacity_factor=cf, topk=topk)
    assert bool((r.slots < 0).any()) or cf > 0.6


def test_capacity_drops_late_tokens():
    """JAX's case: every token routed to expert 0, capacity 8 of 20 tokens:
    the first 8 get expert output, the rest exactly 0, in both packages."""
    p, m = _layer(0, width=8, hidden=16, experts=2)
    p["router_w"] = np.zeros((8, 2), np.float32)
    p["router_w"][:, 0] = 10.0
    p["fc2_b"] = p["fc2_b"] + 1.0
    with torch.no_grad():
        m.router_w.copy_(torch.from_numpy(p["router_w"]))
        m.fc2_b.add_(1.0)
    x = (np.abs(np.random.RandomState(0).randn(1, 20, 8)) + 0.1).astype(
        np.float32)
    jy, _ = _jmoe(jnp.asarray(x), p, act=_relu_j, capacity_factor=0.5)
    _, y, _ = _port_moe(x, m, capacity_factor=0.5)
    C = tmoe.expert_capacity(20, 2, 0.5)
    assert C == 8
    norms = np.linalg.norm(y.detach().numpy()[0], axis=-1)
    assert (norms[:C] > 0).all() and (norms[C:] == 0).all()
    _close(y.detach(), jy, LAYER_RTOL)


def test_top2_saturated_router_no_double_dispatch():
    """JAX's case: token 0's router saturates (the other probability is 0
    in f32); its second choice must still be the other expert, so token 7's
    real second choice keeps the last slot."""
    p, m = _layer(0, width=2, hidden=8, experts=2)
    p["router_w"] = np.array([[100.0, 0.0], [0.0, 1.0]], np.float32)
    p["fc2_b"] = p["fc2_b"] + 1.0
    with torch.no_grad():
        m.router_w.copy_(torch.from_numpy(p["router_w"]))
        m.fc2_b.add_(1.0)
    x = np.zeros((1, 16, 2), np.float32)
    x[0, 0] = [4.0, 0.0]
    x[0, 1:] = [0.0, 1.0]
    jy, _ = _jmoe(jnp.asarray(x), p, act=_relu_j, capacity_factor=0.4,
                  topk=2)
    _, y, _ = _port_moe(x, m, capacity_factor=0.4, topk=2)
    _close(y.detach(), jy, LAYER_RTOL, atol=1e-6)
    r = tmoe.route(torch.from_numpy(x).reshape(-1, 2), m.router_w,
                   n_images=1, capacity_factor=0.4, topk=2)
    # expert 0's queue: token 0's first choice, then the second choices of
    # tokens 1-7 up to capacity 8; token 8 is the first one dropped
    assert r.slots[:, 1].tolist()[6:9] == [6, 7, -1]


def test_uniform_routing_aux_is_one():
    _, m = _layer(0, width=8, hidden=16, experts=4)
    with torch.no_grad():
        m.router_w.zero_()
    x = np.random.RandomState(0).randn(2, 8, 8).astype(np.float32)
    _, _, aux = _port_moe(x, m, capacity_factor=2.0)
    assert abs(float(aux) - 1.0) <= 1e-6


@pytest.mark.parametrize("topk,experts,words", [(3, 4, "topk must be 1 or 2"),
                                                (2, 1, "2 experts")])
def test_topk_guards_in_jaxs_words(topk, experts, words):
    p, m = _layer(0, width=8, hidden=16, experts=experts)
    x = np.zeros((1, 4, 8), np.float32)
    with pytest.raises(ValueError, match=words):
        jmoe.moe_mlp(jnp.asarray(x), p, act=lambda v: v, topk=topk)
    with pytest.raises(ValueError, match=words):
        _port_moe(x, m, topk=topk)


def _one_hot_oracle(x, m, act, capacity_factor, topk):
    """JAX's einsum form in torch (the plain version of the index dispatch,
    used only here): [T, E, C] one-hots for dispatch and combine."""
    B, S, D = x.shape
    T, E = B * S, m.router_w.shape[1]
    C = tmoe.expert_capacity(T, E, capacity_factor * topk)
    xt = x.reshape(T, D)
    logits = xt.float() @ m.router_w
    probs = torch.softmax(logits, -1)
    e1 = probs.argmax(-1)
    gate = probs.max(-1).values
    oh = torch.nn.functional.one_hot(e1, E).float()
    pos = torch.cumsum(oh, 0) * oh - 1
    keep = oh * (pos < C)
    pos_oh = torch.nn.functional.one_hot(
        pos.max(-1).values.long().clamp(0, C - 1), C).float()
    dispatch = keep[:, :, None] * pos_oh[:, None, :]
    combine = dispatch * gate[:, None, None]
    if topk == 2:
        e2 = (logits - oh * 2e30).argmax(-1)
        g2 = probs.gather(1, e2[:, None])[:, 0]
        oh2 = torch.nn.functional.one_hot(e2, E).float()
        pos2 = (torch.cumsum(oh2, 0) + oh.sum(0, keepdim=True)) * oh2 - 1
        keep2 = oh2 * (pos2 < C)
        pos2_oh = torch.nn.functional.one_hot(
            pos2.max(-1).values.long().clamp(0, C - 1), C).float()
        dispatch2 = keep2[:, :, None] * pos2_oh[:, None, :]
        denom = torch.clamp(gate + g2, min=1e-9)
        combine = (dispatch * (gate / denom)[:, None, None]
                   + dispatch2 * (g2 / denom)[:, None, None])
        dispatch = dispatch + dispatch2
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    h = act(torch.einsum("ecd,edh->ech", xe, m.fc1_w.to(x.dtype))
            + m.fc1_b[:, None, :].to(x.dtype))
    ye = (torch.einsum("ech,ehd->ecd", h, m.fc2_w.to(x.dtype))
          + m.fc2_b[:, None, :].to(x.dtype))
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)
    aux = E * (oh.mean(0) * probs.mean(0)).sum()
    return y.reshape(B, S, D), aux


@pytest.mark.parametrize("topk", [1, 2])
def test_index_dispatch_is_the_one_hot_einsum_and_repeats_bit_equal(topk):
    """The index dispatch against the one-hot einsum oracle on the same
    inputs (values and gradients, with drops), and a second run of the same
    forward and backward equal bit for bit."""
    _, m = _layer(6, experts=4)
    x = torch.from_numpy(np.random.RandomState(3).randn(3, 17, 16).astype(
        np.float32))

    def run(fn):
        xg = x.clone().requires_grad_()
        m.zero_grad()
        y, aux = fn(xg, m, torch.relu, 0.5, topk)
        (y.square().sum() + aux).backward()
        return [y.detach(), aux.detach(), xg.grad] + [
            getattr(m, k).grad.clone() for k in MOE_LEAVES]

    def port(xg, m, act, cf, k):
        return tmoe.moe_mlp(xg, m, act=act, capacity_factor=cf, topk=k)
    got, again = run(port), run(port)
    want = run(_one_hot_oracle)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, c, LAYER_RTOL)


# -- the model ------------------------------------------------------------------

def test_moe_model_has_dense_and_sparse_blocks():
    cfg = dataclasses.replace(TMOE, moe_experts=2, layers=4)
    model = tvit.init_vit_params(tvit.empty_vit(cfg, "cpu"),
                                 torch.Generator().manual_seed(0))
    kinds = ["moe" if hasattr(b, "moe") else "dense" for b in model.blocks]
    assert kinds == ["dense", "moe", "dense", "moe"]
    assert tuple(model.blocks[1].moe.fc1_w.shape) == (2, 32, 128)
    assert [cfg.is_moe_block(i) for i in range(4)] == [
        dataclasses.replace(JMOE, moe_experts=2, layers=4).is_moe_block(i)
        for i in range(4)]
    moe = model.blocks[1].moe
    assert float(moe.fc1_b.abs().max()) == 0.0
    for w in (moe.router_w, moe.fc1_w, moe.fc2_w):     # trunc-normal 0.02
        assert float(w.abs().max()) <= 0.04 and 0.01 < float(w.std()) < 0.03


def test_bridge_carries_the_moe_tree_bit_exactly_both_ways():
    tree = _np_tree(_jinit(jax.random.PRNGKey(5), JMOE))
    sd = tconvert.vit_state_dict_from_jax(tree, 8)
    assert sorted(k for k in sd if ".moe." in k) == sorted(
        f"blocks.1.moe.{k}" for k in MOE_LEAVES)
    back = tconvert.vit_jax_from_state_dict(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("topk,remat", [(1, False), (2, True)])
def test_moe_vit_logits_and_aux_match_jax(topk, remat):
    jcfg = dataclasses.replace(JMOE, moe_topk=topk, moe_capacity=0.5)
    tcfg = dataclasses.replace(TMOE, moe_topk=topk, moe_capacity=0.5)
    tree = _jinit(jax.random.PRNGKey(1), jcfg)
    imgs = np.random.RandomState(4).randint(0, 256, (6, 32, 32, 3)).astype(
        np.float32)
    jl, jaux = _jclassify(tree, jnp.asarray(imgs), jcfg, input_norm=NORM,
                          with_aux=True)
    model = tconvert.vit_from_jax(_np_tree(tree), tcfg, "cpu")
    with torch.no_grad():
        tl, taux = tvit.vit_classify(model, torch.from_numpy(imgs),
                                     input_norm=NORM, with_aux=True,
                                     remat=remat)
        plain = tvit.vit_classify(model, torch.from_numpy(imgs),
                                  input_norm=NORM)
    _close(tl, jl, STEP_RTOL, STEP_ATOL)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    assert torch.equal(plain, tl)


def _jax_step(jcfg, tcfg_kw, params, imgs, lbls):
    """JAX's ViTTrainer step on a one-device mesh, zero momentum and no
    weight decay: the new momentum is the gradient."""
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.train import vit_loop as jloop
    jtr = jloop.ViTTrainer(jcfg, JTrainConfig(
        batch_size=len(imgs), compute_dtype="float32", image_size=32,
        num_classes=10, weight_decay=0.0, moe_experts=jcfg.moe_experts,
        **tcfg_kw), jmesh.make_mesh(n_data=1, devices=jax.devices()[:1]))
    mom = jax.tree_util.tree_map(jnp.zeros_like, params)
    jp, jm, jl = jtr._make_train_step(None)(
        params, mom, jnp.asarray(imgs), jnp.asarray(lbls), 0.1,
        jax.random.PRNGKey(1), 0.1)
    return _np_tree(jp), _np_tree(jm), float(jl)


STEP_CASES = {"top1": (1, {}), "top2": (2, {}),
              "grad_accum2": (1, {"grad_accum": 2}),
              "remat": (2, {"remat": True})}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_moe_step_matches_jax_loss_and_every_gradient(case):
    """One SGD step of the MoE ViT (capacity factor 0.5: queues overflow)
    from JAX-drawn weights: the loss (CE plus 0.01 aux), every gradient
    (the momentum after a step from zero without weight decay), the
    router's among them, and the new parameters."""
    topk, kw = STEP_CASES[case]
    jcfg = dataclasses.replace(JMOE, moe_topk=topk, moe_capacity=0.5)
    tcfg = dataclasses.replace(TMOE, moe_topk=topk, moe_capacity=0.5)
    rs = np.random.RandomState(6)
    imgs = rs.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    lbls = rs.randint(0, 10, 8).astype(np.int32)
    params = _np_tree(_jinit(jax.random.PRNGKey(7), jcfg))
    # copies: the step donates its inputs, and jnp.asarray may share the
    # numpy buffers
    jp, jg, jl = _jax_step(jcfg, kw, jax.tree_util.tree_map(jnp.array,
                                                            params),
                           imgs, lbls)

    model = tconvert.vit_from_jax(params, tcfg, "cpu")
    tr = tloop.ViTTrainer(tcfg, TTrainConfig(
        batch_size=8, compute_dtype="float32", image_size=32, num_classes=10,
        weight_decay=0.0, moe_experts=4, **kw), model, "cpu")
    momentum = tr.init_momentum()
    loss = tr.step(momentum, *tr.place(imgs, lbls), 0.1)
    assert abs(float(loss) - jl) <= 1e-5 * abs(jl)
    tp, tg = tloop._jax_trees(model, momentum)
    assert "moe" in tg["blocks"][1] and np.abs(
        tg["blocks"][1]["moe"]["router_w"]).max() > 0
    for got, want in ((tg, jg), (tp, jp)):
        la, lb = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)


def test_int8_leaves_moe_blocks_float_as_jax():
    """quantize_vit_blocks quantizes the dense block's four weights and
    leaves the MoE block float in both packages; the port carries JAX's
    quantized MoE tree and serves its logits."""
    from vit_project_tpu.ops import quant as jquant
    tree = _jinit(jax.random.PRNGKey(3), JMOE)
    qtree = jquant.quantize_vit_blocks(tree)
    assert isinstance(qtree["blocks"][0]["fc1_w"], dict)
    assert qtree["blocks"][1] is tree["blocks"][1]
    model = tconvert.vit_from_jax(_np_tree(tree), TMOE, "cpu")
    tquant.quantize_vit_blocks(model)
    assert tquant.is_quantized(model.blocks[0].mlp.fc1.weight)
    assert not any(tquant.is_quantized(w) for w in (
        model.blocks[1].attn.qkv.weight, model.blocks[1].attn.proj.weight))
    carried = tconvert.vit_from_jax(qtree, TMOE, "cpu")
    imgs = np.random.RandomState(8).rand(3, 32, 32, 3).astype(np.float32) * 255
    want = _jclassify(qtree, jnp.asarray(imgs), JMOE, input_norm=NORM)
    with torch.no_grad():
        for m in (model, carried):
            got = tvit.vit_classify(m, torch.from_numpy(imgs),
                                    input_norm=NORM)
            _close(got, want, STEP_RTOL, STEP_ATOL)


# -- whole runs and checkpoints across packages ----------------------------------

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


def _run_cfg(cls, data, out, epochs=2):
    return cls(data_path=data, output_dir=out, batch_size=8, epochs=epochs,
               lr=0.01, warmup_epochs=1, num_workers=2, num_classes=3,
               image_size=32, compute_dtype="float32", random_seed=0,
               moe_experts=4, moe_topk=2, moe_capacity=0.5)


# the runs' model: the MoE tiny with 3 classes, top-2, capacity factor 0.5
RUN_MOE = dict(num_classes=3, moe_topk=2, moe_capacity=0.5)
JRUN = dataclasses.replace(JMOE, **RUN_MOE)
TRUN = dataclasses.replace(TMOE, **RUN_MOE)


def _metrics(out):
    with open(os.path.join(out, "training_metrics.csv")) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def runs(imagenet, tmp_path_factory):
    """2-epoch MoE runs (top-2, capacity factor 0.5) of both packages."""
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    root = tmp_path_factory.mktemp("moe_runs")
    out = {"jax": str(root / "jax"), "port": str(root / "port")}
    jrun(_run_cfg(JTrainConfig, imagenet, out["jax"]), vit_cfg=JRUN)
    tloop.run_vit_training(_run_cfg(TTrainConfig, imagenet, out["port"]),
                           vit_cfg=TRUN, device="cpu")
    return out


def _resume_dir(src, dst):
    os.makedirs(dst)
    shutil.copyfile(os.path.join(src, "checkpoint_epoch_000.pth"),
                    os.path.join(dst, "checkpoint_latest.pth"))
    with open(os.path.join(dst, "training_metrics.csv"), "w") as f:
        f.write("\n".join(_metrics(src)[:2]) + "\n")


def _assert_rows_close(got, want):
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    np.testing.assert_allclose(
        [[float(v) for v in r.split(",")[1:3]] for r in got],
        [[float(v) for v in r.split(",")[1:3]] for r in want], rtol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_checkpoints_cross_resume_between_packages(runs, imagenet,
                                                       tmp_path, writer):
    """Epoch 0 of one package's run (parameters, the momentum with its
    "moe" sub-trees, the scheduler) resumed by the other: its epoch-1 row
    and final trees as the writer's uninterrupted run's."""
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    out = str(tmp_path / "resumed")
    _resume_dir(runs[writer], out)
    if writer == "jax":
        tloop.run_vit_training(_run_cfg(TTrainConfig, imagenet, out),
                               vit_cfg=TRUN, device="cpu")
    else:
        jrun(_run_cfg(JTrainConfig, imagenet, out), vit_cfg=JRUN)
    got, want = _metrics(out), _metrics(runs[writer])
    assert got[:2] == want[:2] and len(got) == 3
    _assert_rows_close(got[1:], want[1:])
    for key in ("params", "opt_state"):
        a = tckpt.load_checkpoint(os.path.join(out, "checkpoint_latest.pth"))
        b = tckpt.load_checkpoint(os.path.join(runs[writer],
                                               "checkpoint_latest.pth"))
        assert "moe" in a[key]["blocks"][1]
        for x, y in zip(jax.tree_util.tree_leaves(a[key]),
                        jax.tree_util.tree_leaves(b[key])):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-4, atol=1e-5)


def test_moe_runs_write_jaxs_tree_and_refuse_two_expert_counts(
        runs, imagenet, tmp_path):
    """Both packages' MoE runs write the same checkpoint tree ("moe"
    sub-trees in the MoE blocks); a train config and a model config that
    name other expert counts are refused in JAX's words."""
    port, jx = _metrics(runs["port"]), _metrics(runs["jax"])
    assert [r.split(",")[0] for r in port] == [r.split(",")[0] for r in jx]
    a = tckpt.load_checkpoint(os.path.join(runs["port"],
                                           "checkpoint_latest.pth"))
    b = tckpt.load_checkpoint(os.path.join(runs["jax"],
                                           "checkpoint_latest.pth"))
    for key in ("params", "opt_state"):
        assert jax.tree_util.tree_structure(a[key]) == \
            jax.tree_util.tree_structure(_np_tree(b[key]))
    cfg = _run_cfg(TTrainConfig, imagenet, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="moe_experts disagrees"):
        tloop.run_vit_training(cfg, vit_cfg=dataclasses.replace(
            TRUN, moe_experts=2), device="cpu")
