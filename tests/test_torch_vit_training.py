"""The port's ViT-B/16 training path against the JAX package: the fused
dW+db function and its autograd wrapper, the classifier forward through the
weights bridge, one SGD step (fused and plain), the ImageFolder and packed
loaders, the schedule and the metrics CSV, checkpoints resumed across
packages in both directions, the port's own mid-epoch preemption, the
refusals of what is not ported yet, and the ``cli.vit_train`` entry point on
the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
weights drawn by the JAX package reach the port through
``models/convert.py``. float32 throughout; JAX runs with
jax_default_matmul_precision "highest" (tests/conftest.py). On the CPU the
port's kernel wrappers take their plain versions, and JAX's Pallas kernels
run in interpret mode."""
import dataclasses
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.core.configs import ViTTrainConfig as JTrainConfig
from vit_project_tpu.models import vit as jvit
from vit_project_tpu.ops import fused_dw as jfdw
from vit_project_tpu.ops import nn as jnn
from vit_project_torch.ckpt import serialization as tser
from vit_project_torch.ckpt import vit_ckpt as tckpt
from vit_project_torch.cli import vit_train as tcli
from vit_project_torch.core.configs import ViTTrainConfig as TTrainConfig
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.ops import fused_dw as tfdw
from vit_project_torch.ops import nn as tnn
from vit_project_torch.train import vit_loop as tloop

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# width 128 = 2 heads of 64 (the kernels' head width), 32 px images in 8 px
# patches (S = 17)
JCFG = jvit.ViTConfig(patch=8, width=128, layers=2, heads=2, image_size=32,
                      num_classes=10)
TCFG = tvit.ViTConfig(patch=8, width=128, layers=2, heads=2, image_size=32,
                      num_classes=10)
# the fixture's model: the JAX package's test-tiny with 3 classes
JTINY = jvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)
TTINY = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                       num_classes=3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(jparams, cfg=TCFG):
    model = tvit.empty_vit(cfg, "cpu")
    model.load_state_dict(tconvert.vit_state_dict_from_jax(_np_tree(jparams),
                                                           cfg.patch))
    return model


def _assert_trees_close(a, b, rtol, atol):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """Tiny ImageFolder (the JAX package's fixture, tests/test_vit_training.py):
    3 classes x 16 train + 8 val PNGs at 48x48."""
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


def _tiny(cfg_cls, data, out, epochs=2, **kw):
    return cfg_cls(data_path=data, output_dir=out, batch_size=8, epochs=epochs,
                   lr=0.01, warmup_epochs=1, num_workers=2, num_classes=3,
                   image_size=32, compute_dtype="float32", random_seed=0, **kw)


def _metrics(out):
    with open(os.path.join(out, "training_metrics.csv")) as f:
        return f.read().splitlines()


# -- the fused dW + db function -------------------------------------------------

@pytest.mark.parametrize("N,Din,Dout", [(50, 768, 2304), (197, 64, 1000),
                                        (300, 256, 768), (64, 2048, 2560)])
def test_dw_db_matches_jax_kernel_and_numpy(N, Din, Dout):
    """The plain version (what a CPU tensor takes) against JAX's Pallas
    kernel in interpret mode and against x^T g / the row sum in float64:
    float32 sums in another order (rtol 2e-5, atol 2e-4, the JAX package's
    own tolerance for its kernel)."""
    rs = np.random.RandomState(N)
    x = rs.randn(N, Din).astype(np.float32)
    g = rs.randn(N, Dout).astype(np.float32)
    dw, db = tfdw.dw_db(torch.from_numpy(x), torch.from_numpy(g))
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (Din, Dout) and db.shape == (Dout,)
    jdw, jdb = jfdw.dw_db_pallas(jnp.asarray(x), jnp.asarray(g),
                                 interpret=True)
    for got, want in ((dw, np.asarray(jdw)), (db, np.asarray(jdb)),
                      (dw, x.astype(np.float64).T @ g),
                      (db, g.astype(np.float64).sum(0))):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


VIT_DENSE_SHAPES = {"qkv": (50432, 768, 2304), "proj": (50432, 768, 768),
                    "fc1": (50432, 768, 3072), "fc2": (50432, 3072, 768),
                    "head": (256, 768, 1000)}


@pytest.mark.parametrize("route", ["tma", "mma", "fma"])
@pytest.mark.parametrize("N,Din,Dout", [*VIT_DENSE_SHAPES.values(),
                                        (33, 13, 7), (1000, 130, 250)])
def test_dw_db_schedule_covers_every_tile_row_step_once(route, N, Din, Dout):
    """The kernel's persistent schedule: every (tile, row step) lies in
    exactly one item, each item is one contiguous, non-empty range of row
    steps, a tile's items in fix-up order run from step 0 to the last in
    split order, and every item belongs to exactly one block of the grid."""
    sc = tfdw.schedule(N, Din, Dout, route)
    r = tfdw.ROUTES[route]
    assert sc.steps == -(-N // r.bk)
    assert sc.items == sc.tiles * sc.splits
    assert sc.blocks == min(r.blocks, sc.items)
    covered = {}
    for i in range(sc.items):
        tm, tn, split, s0, s1 = sc.item(i)
        assert 0 <= tm < sc.tiles_m and 0 <= tn < sc.tiles_n and s0 < s1
        for step in range(s0, s1):
            key = (tm * sc.tiles_n + tn, step)
            assert key not in covered
            covered[key] = i
    assert len(covered) == sc.tiles * sc.steps
    for tile in range(sc.tiles):
        order = sc.fixup_order(tile)
        ranges = [sc.item(i)[3:] for i in order]
        assert [sc.item(i)[2] for i in order] == list(range(sc.splits))
        assert ranges[0][0] == 0 and ranges[-1][1] == sc.steps
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    owners = sorted(i for b in range(sc.blocks) for i in sc.block_items(b))
    assert owners == list(range(sc.items))
    # db: the Din tiles' row groups cut each step's rows into contiguous
    # pieces, and the fix-up sums, for each Dout tile, one partial of every
    # (split, Din tile) item of that column, split-major
    groups = [sc.db_rows(tm) for tm in range(sc.tiles_m)]
    assert groups[0][0] == 0 and groups[-1][1] == r.bk
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(groups, groups[1:]))
    for tn in range(sc.tiles_n):
        order = sc.db_order(tn)
        assert [sc.item(i)[1] for i in order] == [tn] * (sc.items // sc.tiles_n)
        assert [sc.item(i)[2::-2] for i in order] == [
            (j, tm) for j in range(sc.splits) for tm in range(sc.tiles_m)]
    # the cuts are a function of the shape alone: the same on every call
    assert tfdw.schedule(N, Din, Dout, route) == sc


@pytest.mark.parametrize("label,tiles,splits", [
    ("qkv", 54, 7), ("proj", 18, 7), ("fc1", 72, 5), ("fc2", 72, 5),
    ("head", 24, 4)])
def test_dw_db_schedule_at_the_vit_shapes(label, tiles, splits):
    """128 x 256 tiles of the TMA route at every dense layer of the ViT-B/16
    step, and the splits the cost model picks: fc1's 72 tiles x 5 splits are
    360 items, 3 waves of 132 blocks; proj's 18 x 7 one wave of 126; the
    head's 4 row steps give 4 items a tile."""
    N, Din, Dout = VIT_DENSE_SHAPES[label]
    sc = tfdw.schedule(N, Din, Dout, "tma")
    assert (sc.tiles, sc.splits) == (tiles, splits)
    assert sc.tiles == -(-Din // 128) * -(-Dout // 256)
    assert sc.blocks == min(132, sc.items)


@pytest.mark.parametrize("dtype,Din,Dout,x_off,g_off,want", [
    (torch.bfloat16, 768, 2304, 0, 0, "tma"),     # qkv
    (torch.bfloat16, 768, 768, 0, 0, "tma"),      # proj
    (torch.bfloat16, 768, 3072, 0, 0, "tma"),     # fc1
    (torch.bfloat16, 3072, 768, 0, 0, "tma"),     # fc2
    (torch.bfloat16, 768, 1000, 0, 0, "tma"),     # the head
    (torch.bfloat16, 130, 256, 0, 0, "mma"),      # Din not a multiple of 8
    (torch.bfloat16, 768, 7, 0, 0, "mma"),        # Dout not a multiple of 8
    (torch.bfloat16, 768, 768, 1, 0, "mma"),      # x's base off 16 bytes
    (torch.bfloat16, 768, 768, 0, 1, "mma"),      # g's base off 16 bytes
    (torch.float32, 768, 3072, 0, 0, "fma"),
    (torch.float32, 130, 7, 1, 0, "fma"),
])
def test_dw_db_route_choice(dtype, Din, Dout, x_off, g_off, want):
    """The route follows dtype, shape and alignment: TMA needs 16-byte
    aligned bases and row strides, so every ViT-B/16 shape takes it and Din
    130, Dout 7 or an unaligned base take mma.sync; float32 takes the FMA
    route. The tensors' own addresses decide (an element offset into a
    buffer moves the base by 2 bytes in bf16)."""
    x = torch.zeros(4 * Din + 8, dtype=dtype)[x_off:x_off + 4 * Din].view(4, Din)
    g = torch.zeros(4 * Dout + 8, dtype=dtype)[g_off:g_off + 4 * Dout].view(4, Dout)
    assert x.is_contiguous() and g.is_contiguous()
    assert tfdw.route(x, g) == want


def test_dw_db_routes_match_the_kernel_source():
    """ROUTES mirrors the CUDA source's kTile table (tile rows, columns, rows
    a step, blocks of the grid) in route-code order."""
    src = (pathlib.Path(tfdw.__file__).resolve().parents[1] / "csrc" / "dw_db.cu").read_text()
    rows = ", ".join("{" + f"{r.bm}, {r.bn}, {r.bk}, {r.blocks}" + "}" for r in
                     sorted(tfdw.ROUTES.values(), key=lambda r: r.code))
    assert f"constexpr int kTile[3][4] = {{{rows}}};" in src
    assert [tfdw.ROUTES[n].code for n in ("fma", "mma", "tma")] == [0, 1, 2]
    assert "constexpr int kRouteFma = 0, kRouteMma = 1, kRouteTma = 2;" in src
    assert "atomicAdd" not in src and ".red." not in src   # no float atomics


def test_dense_dw_fused_grads_match_autograd_and_jax():
    """DenseDwFused's (dx, dW, db) against plain autograd of ``dense`` and
    against jax.grad through JAX's dense_dw_fused (interpret mode): float32
    sums in another order (rtol 2e-5, atol 2e-4)."""
    rs = np.random.RandomState(1)
    w = rs.randn(128, 256).astype(np.float32)
    b = rs.randn(256).astype(np.float32)
    x = rs.randn(4, 37, 128).astype(np.float32)

    def port(fused):
        tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, w, b))
        torch.sin(tnn.dense(tx, tw, tb, fused_dw=fused)).sum().backward()
        return [t.grad.numpy() for t in (tx, tw, tb)]

    def loss(x, w, b):
        return jnp.sum(jnp.sin(jfdw.dense_dw_fused(x, w, b)))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b))
    fused, plain = port(True), port(False)
    for f, p, j in zip(fused, plain, want):
        np.testing.assert_allclose(f, p, rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(f, np.asarray(j), rtol=2e-5, atol=2e-4)


def test_dense_takes_the_fused_path_only_with_a_bias():
    x = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(8, 4, requires_grad=True)
    y = tnn.dense(x, w, torch.zeros(4), fused_dw=True)
    assert type(y.grad_fn).__name__.startswith("DenseDwFused")
    y = tnn.dense(x, w, None, fused_dw=True)
    assert not type(y.grad_fn).__name__.startswith("DenseDwFused")


# -- the classifier forward ------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_classifier_forward_matches_jax(use_pallas):
    """vit_classify and forward_features (CLS and mean pooling) with the JAX
    package's weights through the bridge, on raw uint8 images with the
    normalization folded in. JAX on its einsum path, and on its Pallas
    attention in interpret mode; the port on the packed attention's plain
    version. float32: rtol 1e-4, atol 1e-5 (another order of summation in
    the attention and the patch einsum)."""
    params = jvit.init_vit_params(jax.random.PRNGKey(0), JCFG)
    model = _port_model(params)
    imgs = np.random.RandomState(2).randint(0, 256, (3, 32, 32, 3),
                                            dtype=np.uint8)
    want = jvit.vit_classify(params, jnp.asarray(imgs), JCFG,
                             use_pallas=use_pallas, input_norm=NORM)
    with torch.no_grad():
        got = tvit.vit_classify(model, torch.from_numpy(imgs), input_norm=NORM)
        assert got.dtype == torch.float32 and got.shape == (3, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        for pool in ("token", "avg"):
            want = jvit.forward_features(params, jnp.asarray(imgs), JCFG,
                                         pool=pool, use_pallas=use_pallas,
                                         input_norm=NORM)
            got = tvit.forward_features(model, torch.from_numpy(imgs),
                                        pool=pool, input_norm=NORM)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)


def test_patch_embed_affine_and_remat_match():
    """The folded normalization equals normalize-then-embed, and a remat
    forward + backward gives the same numbers as the plain one."""
    from vit_project_torch.data import imagenet as timg
    params = jvit.init_vit_params(jax.random.PRNGKey(3), JCFG)
    model = _port_model(params)
    imgs = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    with torch.no_grad():
        a = tvit.vit_embed(model, imgs, input_norm=NORM)
        b = tvit.vit_embed(model, timg.normalize_imagenet(imgs))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    grads = []
    for remat in (False, True):
        model.zero_grad()
        tvit.vit_classify(model, imgs, input_norm=NORM,
                          remat=remat).sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_init_distributions_match_jax():
    """init_vit_params draws what JAX's does: truncated normals of std 0.02
    cut at two deviations, unit LayerNorms, zero biases."""
    model = tvit.init_vit_params(tvit.empty_vit(TCFG, "cpu"),
                                 torch.Generator().manual_seed(0))
    jtree = _np_tree(jvit.init_vit_params(jax.random.PRNGKey(0), JCFG))
    ttree = tconvert.vit_jax_from_state_dict(model.state_dict())
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(ttree)
    for j, t in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(ttree)):
        assert j.shape == t.shape
        if np.all(j == j.flat[0]):          # LayerNorm scales, biases
            np.testing.assert_array_equal(t, j)
        else:
            assert np.abs(t).max() <= 0.04 + 1e-7
            assert abs(t.std() - j.std()) < 0.1 * j.std()


def test_bridge_is_bit_exact_both_ways():
    tree = _np_tree(jvit.init_vit_params(jax.random.PRNGKey(5), JCFG))
    back = tconvert.vit_jax_from_state_dict(
        tconvert.vit_state_dict_from_jax(tree, JCFG.patch))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


# -- one SGD step ---------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_one_train_step_matches_jax_fused_step(fused):
    """The port's step (with and without the fused dW+db) against JAX's
    ViTTrainer step with fused_dw=True on a one-device mesh, from the same
    params, a non-zero momentum and a batch: the loss, every parameter and
    every momentum buffer. float32: rtol 1e-4, atol 1e-6."""
    from vit_project_tpu.parallel import mesh as jmesh
    from vit_project_tpu.train import vit_loop as jloop
    rs = np.random.RandomState(6)
    imgs = rs.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    lbls = rs.randint(0, 10, 8).astype(np.int32)
    params = jvit.init_vit_params(jax.random.PRNGKey(7), JCFG)
    mom = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * 1e-3),
        params)
    np_params, np_mom = _np_tree(params), _np_tree(mom)
    jtr = jloop.ViTTrainer(JCFG, JTrainConfig(
        batch_size=8, compute_dtype="float32", image_size=32, num_classes=10,
        fused_dw=True), jmesh.make_mesh(n_data=1, devices=jax.devices()[:1]))
    try:
        step = jtr._make_train_step(None)
        jp, jm, jl = step(params, mom, jnp.asarray(imgs), jnp.asarray(lbls),
                          0.1, jax.random.PRNGKey(1), 0.1)
        jp, jm, jl = _np_tree(jp), _np_tree(jm), float(jl)
    finally:
        jnn.set_dense_dw_fused(False)

    model = _port_model(np_params)
    tcfg = TTrainConfig(batch_size=8, compute_dtype="float32", image_size=32,
                        num_classes=10, fused_dw=fused)
    tr = tloop.ViTTrainer(TCFG, tcfg, model, "cpu")
    momentum = tconvert.vit_state_dict_from_jax(np_mom, TCFG.patch)
    loss = tr.step(momentum, *tr.place(imgs, lbls), 0.1)
    assert abs(float(loss) - jl) < 1e-5 * max(1.0, abs(jl))
    tp, tm = tloop._jax_trees(model, momentum)
    _assert_trees_close(tp, jp, rtol=1e-4, atol=1e-6)
    _assert_trees_close(tm, jm, rtol=1e-4, atol=1e-6)
    assert jnn._DW_FUSED is False   # JAX's process-wide toggle restored


def test_grad_accum_matches_the_unsplit_step():
    """grad_accum=2 sums two microbatches' gradients: the same update as the
    unsplit step up to float32 summation order (rtol 1e-5, atol 1e-7)."""
    rs = np.random.RandomState(8)
    imgs = rs.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    lbls = rs.randint(0, 10, 8).astype(np.int32)
    tree = _np_tree(jvit.init_vit_params(jax.random.PRNGKey(9), JCFG))
    out = []
    for G in (1, 2):
        model = _port_model(tree)
        tr = tloop.ViTTrainer(TCFG, TTrainConfig(
            compute_dtype="float32", num_classes=10, grad_accum=G), model,
            "cpu")
        momentum = tloop.sgd_init(dict(model.named_parameters()))
        out.append((float(tr.step(momentum, *tr.place(imgs, lbls), 0.1)),
                    tloop._jax_trees(model, momentum)))
    assert abs(out[0][0] - out[1][0]) < 1e-6
    _assert_trees_close(out[0][1], out[1][1], rtol=1e-5, atol=1e-7)


# -- loaders, schedule, CSV -------------------------------------------------------

def test_image_folder_and_packed_loaders_match_jax(imagenet, tmp_path):
    """Train batches of two epochs (shuffle and crops from the seed, the
    epoch and the index) and the val batches, byte for byte, from the
    ImageFolder tree and from a pack the JAX package wrote."""
    from vit_project_tpu.data import imagenet as jimg
    from vit_project_tpu.data import packed as jpacked
    from vit_project_torch.data import imagenet as timg
    from vit_project_torch.data import packed as tpacked
    for split in ("train", "val"):
        jpacked.pack_image_folder(os.path.join(imagenet, split),
                                  str(tmp_path / split), shard_mb=1,
                                  logger=None)
    assert tpacked.is_packed(str(tmp_path / "train"))
    assert not tpacked.is_packed(os.path.join(imagenet, "train"))
    for split, train, epochs in (("train", True, (0, 1)),
                                 ("val", False, (0,))):
        kw = dict(train=train, seed=3, size=32, workers=2, drop_last=train)
        want = jimg.ImageFolderLoader(os.path.join(imagenet, split), 8, **kw)
        for got in (timg.ImageFolderLoader(os.path.join(imagenet, split), 8,
                                           **kw),
                    tpacked.make_loader(str(tmp_path / split), 8, **kw)):
            assert len(got) == len(want)
            assert got.classes == want.classes
            for e in epochs:
                pairs = list(zip(got.epoch(e), want.epoch(e)))
                assert len(pairs) == len(want)
                for (gi, gl), (wi, wl) in pairs:
                    np.testing.assert_array_equal(gi, wi)
                    np.testing.assert_array_equal(gl, wl)


def test_schedule_and_metrics_csv_match_jax(tmp_path):
    from vit_project_tpu.core import csvio as jcsv
    from vit_project_tpu.train.schedules import CosineAnnealingLRWithWarmup \
        as JSched
    from vit_project_torch.core import csvio as tcsv
    from vit_project_torch.train.schedules import \
        CosineAnnealingLRWithWarmup as TSched
    j, t = JSched(0.1, 5, 30), TSched(0.1, 5, 30)
    for _ in range(30):
        assert t.peek() == j.peek()
        assert t.step() == j.step()
        assert t.state_dict() == j.state_dict()
    t2 = TSched(1.0, 1, 2)
    t2.load_state_dict(j.state_dict())
    assert t2.state_dict() == j.state_dict()
    rows = [(0, 2.302585092994, 2.2, 12.5), (1, 1.5, 1.25e-7, 100.0)]
    for mod, name in ((jcsv, "j.csv"), (tcsv, "t.csv")):
        for r in rows:
            mod.append_vit_row(str(tmp_path / "m" / name), *r)
    assert (tmp_path / "m" / "t.csv").read_bytes() == \
        (tmp_path / "m" / "j.csv").read_bytes()


# -- whole runs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(imagenet, tmp_path_factory):
    """Uninterrupted 2-epoch runs of both packages on the fixture."""
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    root = tmp_path_factory.mktemp("runs")
    out = {"jax": str(root / "jax"), "port": str(root / "port")}
    jrun(_tiny(JTrainConfig, imagenet, out["jax"]), vit_cfg=JTINY)
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, out["port"]),
                           vit_cfg=TTINY, device="cpu")
    return out


def _resume_dir(src, dst):
    """A run tree holding only epoch 0 of `src` (its checkpoint as latest,
    its first metrics row)."""
    os.makedirs(dst)
    shutil.copyfile(os.path.join(src, "checkpoint_epoch_000.pth"),
                    os.path.join(dst, "checkpoint_latest.pth"))
    with open(os.path.join(dst, "training_metrics.csv"), "w") as f:
        f.write("\n".join(_metrics(src)[:2]) + "\n")


def _assert_rows_close(got, want):
    """Epoch, losses to rtol 1e-4 (float32 in another order over one epoch
    of training); accuracy within one of the 24 val images."""
    g, w = got.split(","), want.split(",")
    assert g[0] == w[0]
    np.testing.assert_allclose([float(v) for v in g[1:3]],
                               [float(v) for v in w[1:3]], rtol=1e-4)
    assert abs(float(g[3]) - float(w[3])) <= 100 / 24 + 1e-6


def test_port_run_writes_the_reference_tree(runs):
    rows = _metrics(runs["port"])
    assert rows[0] == "epoch,train_loss,val_loss,val_acc"
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]
    for e in (0, 1):
        assert tckpt.epoch_checkpoint(runs["port"], e) is not None
    ck = tckpt.load_checkpoint(tckpt.latest_checkpoint(runs["port"]))
    assert ck["epoch"] == 1 and set(ck) == {
        "epoch", "params", "opt_state", "scheduler_state", "train_loss",
        "val_loss", "val_acc"}
    jck = tser.load(os.path.join(runs["jax"], "checkpoint_latest.pth"))
    assert jax.tree_util.tree_structure(ck["params"]) == \
        jax.tree_util.tree_structure(_np_tree(jck["params"]))
    assert ck["scheduler_state"] == jck["scheduler_state"]


def test_port_resumes_a_jax_run(runs, imagenet, tmp_path):
    out = str(tmp_path / "port_from_jax")
    _resume_dir(runs["jax"], out)
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, out),
                           vit_cfg=TTINY, device="cpu")
    got, want = _metrics(out), _metrics(runs["jax"])
    assert got[:2] == want[:2] and len(got) == 3
    _assert_rows_close(got[2], want[2])


def test_jax_resumes_a_port_run(runs, imagenet, tmp_path):
    from vit_project_tpu.train.vit_loop import run_vit_training as jrun
    out = str(tmp_path / "jax_from_port")
    _resume_dir(runs["port"], out)
    jrun(_tiny(JTrainConfig, imagenet, out), vit_cfg=JTINY)
    got, want = _metrics(out), _metrics(runs["port"])
    assert got[:2] == want[:2] and len(got) == 3
    _assert_rows_close(got[2], want[2])


class _TripAfter:
    """A preemption guard that asks to stop after `n` batches."""

    def __init__(self, n):
        self.n, self.seen, self.mid_state = n, 0, None

    def should_stop(self):
        self.seen += 1
        return self.seen >= self.n


def test_port_mid_epoch_preemption_resumes_bit_exactly(runs, imagenet,
                                                       tmp_path):
    """Stopped after 3 batches of epoch 1 (of 6), then run again: the rows,
    parameters and momentum equal the uninterrupted run's bit for bit."""
    out = str(tmp_path / "preempted")
    _resume_dir(runs["port"], out)
    res = tloop.run_vit_training(_tiny(TTrainConfig, imagenet, out),
                                 vit_cfg=TTINY, device="cpu",
                                 preempt_guard=_TripAfter(3))
    assert res["preempted"]
    pc = tser.load(os.path.join(out, "checkpoint_preempt.pth"))
    assert (pc["epoch"], pc["batch_idx"], pc["num_batches"]) == (1, 3, 3)
    tloop.run_vit_training(_tiny(TTrainConfig, imagenet, out),
                           vit_cfg=TTINY, device="cpu")
    assert not os.path.exists(os.path.join(out, "checkpoint_preempt.pth"))
    assert _metrics(out) == _metrics(runs["port"])
    a = tckpt.load_checkpoint(os.path.join(out, "checkpoint_latest.pth"))
    b = tckpt.load_checkpoint(os.path.join(runs["port"],
                                           "checkpoint_latest.pth"))
    for k in ("params", "opt_state"):
        for x, y in zip(jax.tree_util.tree_leaves(a[k]),
                        jax.tree_util.tree_leaves(b[k])):
            np.testing.assert_array_equal(x, y)


def test_cli_trains_on_the_cpu_and_defaults_to_the_card(imagenet, tmp_path):
    out = str(tmp_path / "cli")
    args = ["--data_path", imagenet, "--output_dir", out, "--backbone",
            "test-tiny", "--epochs", "1", "--batch_size", "8",
            "--num_workers", "2", "--compute_dtype", "float32",
            "--keep_last", "1"]
    tcli.main(args + ["--device", "cpu"])
    assert [r.split(",")[0] for r in _metrics(out)[1:]] == ["0"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(args + ["--output_dir", str(tmp_path / "cuda")])


# -- the profiler trace -----------------------------------------------------------

def test_trace_is_nothing_without_a_logdir(tmp_path):
    from vit_project_torch.core.profiling import trace
    with trace(None):
        torch.ones(2).sum()
    with trace(""):
        pass
    assert not os.listdir(tmp_path)


def test_cli_profile_dir_writes_a_trace_of_the_first_epoch(imagenet,
                                                           tmp_path):
    """--profile_dir (JAX: a jax.profiler trace of the first epoch) writes
    one Chrome / TensorBoard trace on the CPU, naming the step's ops, and
    the run trains and checkpoints as without it."""
    import json
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    tcli.main(["--data_path", imagenet, "--output_dir", out, "--backbone",
               "test-tiny", "--epochs", "2", "--batch_size", "8",
               "--num_workers", "2", "--compute_dtype", "float32",
               "--device", "cpu", "--profile_dir", prof])
    assert [r.split(",")[0] for r in _metrics(out)[1:]] == ["0", "1"]
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1           # the first epoch only
    with open(os.path.join(prof, traces[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("vit_project_torch::flash3_fwd" in n for n in names)
    assert any(n.startswith("aten::") for n in names)


# -- refusals -------------------------------------------------------------------

# the modes ported since these cases were written, and what each now does
# in JAX's words: ep without a MoE model, a train config whose expert count
# disagrees with the explicit (dense) model config, sp in one process (its
# axis is the ranks of a process group) and sp_ring without sp
PORTED_MODES = {"ep_devices": "ep_devices > 1 needs a MoE model",
                "moe_experts": "moe_experts disagrees",
                "sp_devices": "launch with torchrun",
                "sp_ring": "sp_ring needs sp_devices > 1"}


@pytest.mark.parametrize("field,value", [
    ("pp_stages", 2), ("sp_devices", 2), ("sp_ring", True), ("ep_devices", 2),
    ("pp_stages", 4), ("moe_experts", 4)])
def test_unported_modes_are_refused_by_name(imagenet, tmp_path, field, value):
    """The unported modes raise by name; the ported ep, MoE and sp fields
    (tests/test_torch_moe.py, tests/test_torch_ep.py, tests/test_torch_sp.py)
    raise JAX's refusals of these configurations instead."""
    cfg = dataclasses.replace(_tiny(TTrainConfig, imagenet,
                                    str(tmp_path / "x")), **{field: value})
    if field in PORTED_MODES:
        with pytest.raises(ValueError, match=PORTED_MODES[field]):
            tloop.run_vit_training(cfg, vit_cfg=TTINY, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=field):
        tloop.run_vit_training(cfg, vit_cfg=TTINY, device="cpu")


@pytest.mark.parametrize("flag", [["--sp_devices", "2"],
                                  ["--moe_experts", "2"]])
def test_cli_refuses_unported_flags(imagenet, tmp_path, flag):
    """--sp_devices (ported) reaches the training loop, which asks for
    torchrun in one process; --moe_experts (ported) trains a tiny MoE
    epoch on the CPU, its block 1 a MoE of 2 experts."""
    argv = ["--data_path", imagenet, "--output_dir", str(tmp_path / "x"),
            "--backbone", "test-tiny", "--device", "cpu", *flag]
    if flag[0] != "--moe_experts":
        with pytest.raises(ValueError, match="launch with torchrun"):
            tcli.main(argv)
        return
    tcli.main(argv + ["--epochs", "1", "--batch_size", "8", "--num_workers",
                      "2", "--compute_dtype", "float32"])
    rows = _metrics(str(tmp_path / "x"))
    assert [r.split(",")[0] for r in rows[1:]] == ["0"]
    ck = tckpt.load_checkpoint(tckpt.latest_checkpoint(str(tmp_path / "x")))
    assert np.asarray(ck["params"]["blocks"][1]["moe"]["fc1_w"]).shape == \
        (2, 32, 128)
    assert "moe" not in ck["params"]["blocks"][0]


@pytest.mark.parametrize("flags,words", [
    (["--tp_devices", "2"], "launch with torchrun"),
    (["--tp_devices", "2", "--sp_devices", "2"], "enable at most one"),
    (["--tp_devices", "2", "--zero1"], "do not compose with tp_devices"),
    (["--tp_devices", "4"], "must divide the model heads")])
def test_cli_takes_tp_and_refuses_jaxs_conflicts(imagenet, tmp_path, flags,
                                                 words):
    """--tp_devices reaches the training loop (tensor parallelism is
    ported): alone it asks for torchrun, and JAX's conflicts are refused
    in JAX's words (test-tiny has 2 heads)."""
    with pytest.raises(ValueError, match=words):
        tcli.main(["--data_path", imagenet, "--output_dir",
                   str(tmp_path / "x"), "--backbone", "test-tiny",
                   "--device", "cpu", *flags])
    assert not os.path.exists(tmp_path / "x" / "training_metrics.csv")


def test_other_unported_paths_are_refused_by_name(imagenet, tmp_path):
    model = tvit.empty_vit(TTINY, "cpu")
    imgs = torch.zeros(1, 32, 32, 3)
    # seq_shard and ring_attn are ported (tests/test_torch_sp.py): the ring
    # without a sequence layout is refused in JAX's words
    with pytest.raises(ValueError, match="ring_attn=True needs seq_shard"):
        tvit.vit_classify(model, imgs, ring_attn=True)
    # with_aux (ported with the MoE blocks): (logits, aux), 0.0 for a dense
    # model, as JAX's vit_classify
    tvit.init_vit_params(model, torch.Generator().manual_seed(0))
    logits, aux = tvit.vit_classify(model, imgs, with_aux=True)
    assert logits.shape == (1, 3) and aux.dtype == torch.float32
    assert float(aux) == 0.0
    # JAX's head_shard is a GSPMD pin; the port's tensor parallelism takes
    # its model group as tp= instead, and has no such argument
    with pytest.raises(TypeError, match="head_shard"):
        tvit.vit_classify(model, imgs, head_shard=object())
    # a MoE ViT (ported): its MoE blocks hold the experts, and ring
    # attention with them is refused in JAX's words
    moe = tvit.empty_vit(dataclasses.replace(TTINY, moe_experts=2), "cpu")
    assert [hasattr(b, "moe") for b in moe.blocks] == [False, True]
    with pytest.raises(ValueError, match="ring_attn does not compose with "
                                         "MoE blocks"):
        tvit.vit_classify(moe, imgs, seq_shard=object(), ring_attn=True)
    os.makedirs(tmp_path / "pod" / "checkpoint_latest.orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.latest_checkpoint(str(tmp_path / "pod"))
