"""The port's int8 serving quantization (ops/quant.py) against the JAX
package's ops/quant.py: the same numpy-seeded weights and activations
through both, the JAX test_quant.py cases, the holder's dtype rule, and the
quantized engines (ViT classifier and features, CLIP-HBA after the bake)
against the JAX engines on the same parameters, in f32 on the CPU with the
JAX attention in Pallas interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu import serve as jserve
from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import vit as jvit
from vit_project_tpu.ops import quant as jquant
from vit_project_torch import serve as tserve
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.ops import nn as tnn
from vit_project_torch.ops import quant as tquant

JTINY = jvit.VIT_CONFIGS["test-tiny"]
TTINY = tvit.VIT_CONFIGS["test-tiny"]
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# engines on the same parameters: max |port - JAX| over max |JAX|. Both
# quantize the same f32 values to the same int8 (tested bit for bit below);
# the float parts (LayerNorm, GELU, the f32 products, the attention) sum in
# another order, ~1e-7 of the outputs' size (measured: 4e-7 at most)
ENGINE_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the arithmetic against JAX's ---------------------------------------------

@pytest.mark.parametrize("shape,seed", [((64, 48), 0), ((32, 96), 1),
                                        ((768, 2304), 2)])
def test_quantize_weight_equals_jax(shape, seed):
    """q equal; s within one float32 ulp (both are max|w| / 127 in f32)."""
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jw = jquant.quantize_weight(w)
    tw = tquant.quantize_weight(_t(w.T))          # the port's [out, in]
    assert tw.q.dtype == torch.int8 and tw.s.dtype == torch.float32
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw["q"]).T)
    np.testing.assert_array_max_ulp(tw.s.numpy(), np.asarray(jw["s"]),
                                    maxulp=1)
    np.testing.assert_array_equal(tquant.dequantize_weight(tw).numpy(),
                                  np.asarray(jquant.dequantize_weight(jw)).T)


@pytest.mark.parametrize("lead", [(8,), (3, 17)])
@pytest.mark.parametrize("bias", [False, True])
def test_int8_dense_bit_equal_to_jax_in_f32(lead, bias):
    """The same int8 operands, an exact int32 sum in both, then the same
    f32 rescale and bias: equal bits."""
    rs = np.random.RandomState(3)
    x = rs.randn(*lead, 64).astype(np.float32)
    w = rs.randn(64, 40).astype(np.float32)
    b = rs.randn(40).astype(np.float32) if bias else None
    want = np.asarray(jquant.int8_dense(
        jnp.asarray(x), jquant.quantize_weight(w),
        None if b is None else jnp.asarray(b)))
    got = tquant.int8_dense(_t(x), tquant.quantize_weight(_t(w.T)),
                            None if b is None else _t(b)).numpy()
    assert got.shape == lead + (40,)
    np.testing.assert_array_equal(got, want)


def test_int8_dense_bit_equal_to_jax_in_bf16():
    """bf16 activations (the serving default): the same row scales (abs-max
    is exact in bf16), the same f32 rescale, one rounding to bf16, then the
    bias in bf16."""
    rs = np.random.RandomState(5)
    x = rs.randn(3, 17, 64).astype(np.float32)
    w = rs.randn(64, 40).astype(np.float32)
    b = rs.randn(40).astype(np.float32)
    want = jquant.int8_dense(jnp.asarray(x, jnp.bfloat16),
                             jquant.quantize_weight(w),
                             jnp.asarray(b, jnp.bfloat16))
    got = tquant.int8_dense(_t(x).bfloat16(), tquant.quantize_weight(_t(w.T)),
                            _t(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_dense_keeps_the_compute_dtype():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(5, 32).astype(np.float32)).bfloat16()
    wq = tquant.quantize_weight(torch.randn(16, 32,
                                            generator=torch.Generator()
                                            .manual_seed(0)))
    y = tquant.int8_dense(x, wq, torch.zeros(16))
    assert y.dtype == torch.bfloat16 and y.shape == (5, 16)


# -- the JAX package's test_quant.py cases -------------------------------------

def test_exact_on_representable_inputs():
    """Integer x and w with amax = 127 quantize losslessly -> exact dot."""
    rs = np.random.RandomState(0)
    x = rs.randint(-127, 128, (4, 16)).astype(np.float32)
    x[:, 0] = 127  # pin every row scale to exactly 1
    w = rs.randint(-127, 128, (16, 8)).astype(np.float32)
    w[0, :] = 127  # pin every column scale to exactly 1
    got = tquant.int8_dense(_t(x), tquant.quantize_weight(_t(w.T)))
    np.testing.assert_array_equal(got.numpy(), x @ w)


def test_close_on_random_inputs():
    rs = np.random.RandomState(1)
    x = rs.randn(8, 64).astype(np.float32)
    w = rs.randn(64, 32).astype(np.float32)
    b = rs.randn(32).astype(np.float32)
    got = tquant.int8_dense(_t(x), tquant.quantize_weight(_t(w.T)),
                            _t(b)).numpy()
    want = x @ w + b
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.02


def test_per_channel_scales_isolate_outlier_column():
    """One huge output channel must not destroy the others' resolution."""
    rs = np.random.RandomState(2)
    w = rs.randn(32, 4).astype(np.float32)
    w[:, 0] *= 1000.0
    x = rs.randn(4, 32).astype(np.float32)
    got = tquant.int8_dense(_t(x), tquant.quantize_weight(_t(w.T))).numpy()
    want = x @ w
    rel_rest = (np.linalg.norm(got[:, 1:] - want[:, 1:])
                / np.linalg.norm(want[:, 1:]))
    assert rel_rest < 0.03, rel_rest


def test_dense_dispatches_a_quantized_weight():
    rs = np.random.RandomState(3)
    x = _t(rs.randn(2, 8).astype(np.float32))
    wq = tquant.quantize_weight(_t(rs.randn(4, 8).astype(np.float32)))
    np.testing.assert_array_equal(tnn.dense(x, wq).numpy(),
                                  tquant.int8_dense(x, wq).numpy())


def test_dequantize_roundtrip_error_bound():
    w = np.random.RandomState(4).randn(16, 16).astype(np.float32)
    wd = tquant.dequantize_weight(tquant.quantize_weight(_t(w))).numpy()
    rowmax = np.abs(w).max(axis=1, keepdims=True)   # per output channel
    assert np.all(np.abs(wd - w) <= rowmax / 254 + 1e-6)


def _tiny_vit(seed=0):
    return tvit.init_vit_params(tvit.empty_vit(TTINY, "cpu"),
                                torch.Generator().manual_seed(seed))


def test_non_block_weights_stay_float():
    model = tquant.quantize_vit_blocks(_tiny_vit())
    assert not tquant.is_quantized(model.patch_embed.proj.weight)
    assert not tquant.is_quantized(model.head.weight)
    for blk in model.blocks:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            assert tquant.is_quantized(lin.weight)
            assert lin.bias.dtype == torch.float32
    names = dict(model.named_buffers())
    assert names["blocks.0.attn.qkv.weight.q"].dtype == torch.int8
    assert "blocks.0.attn.qkv.weight" not in dict(model.named_parameters())


def test_clip_towers_quantize_both():
    model = tclip.init_clip_weights_(tclip.empty_clip(
        tclip.tiny_clip_config(), "cpu"), torch.Generator().manual_seed(0))
    tquant.quantize_clip_blocks(model)
    for tower in (model.visual.transformer, model.transformer):
        for blk in tower.resblocks:
            assert tquant.is_quantized(blk.attn.in_proj_weight)
            assert tquant.is_quantized(blk.mlp.c_proj.weight)
            assert blk.attn.in_proj_bias.dtype == torch.float32
    assert not tquant.is_quantized(model.visual.conv1.weight)


def test_holder_keeps_its_scales_float32():
    """Module.to(dtype) casts every floating buffer; the holder moves its
    tensors but keeps q int8 and s float32 (a bf16 scale would add a second
    rounding to the int8 one)."""
    model = tquant.quantize_vit_blocks(_tiny_vit())
    s = model.blocks[0].attn.qkv.weight.s.clone()
    for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.half(),
                 lambda m: m.to("cpu", torch.bfloat16)):
        cast(model)
        wq = model.blocks[0].attn.qkv.weight
        assert wq.q.dtype == torch.int8 and wq.s.dtype == torch.float32
        assert torch.equal(wq.s, s)
    assert model.blocks[0].attn.qkv.bias.dtype == torch.bfloat16  # the last


def test_holder_learns_the_device_without_converting_its_tensors():
    """The holder asks fn where a tensor goes with an empty one, so a cast
    converts nothing and a move copies each buffer once."""
    wq = tquant.quantize_weight(torch.randn(24, 16))
    q, s = wq.q, wq.s
    seen = []

    def fn(t):
        seen.append(t.numel())
        return t.to(torch.bfloat16) if t.is_floating_point() else t
    wq._apply(fn)
    assert seen == [0, 0]
    assert wq.q is q and wq.s is s          # same device: no copy at all


def test_unknown_quantize_mode_rejected():
    with pytest.raises(ValueError, match="int8"):
        tserve.vit_classifier_engine(_tiny_vit(), quantize="fp4",
                                     device="cpu")


def test_quantized_engine_with_bf16_params_keeps_f32_scales():
    """The float cast runs first, then the quantization, and the engine
    casts nothing: bf16 biases and LayerNorms, f32 scales, and the scales
    are those of the bf16-rounded weights (as in JAX)."""
    model = _tiny_vit()
    w = model.blocks[0].attn.qkv.weight.detach().clone()
    eng = tserve.vit_classifier_engine(
        model, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        quantize="int8", buckets=(4,), device="cpu")
    wq = eng.model.blocks[0].attn.qkv.weight
    assert wq.s.dtype == torch.float32
    assert eng.model.blocks[0].attn.qkv.bias.dtype == torch.bfloat16
    assert eng.model.blocks[0].norm1.weight.dtype == torch.bfloat16
    want = tquant.quantize_weight(w.bfloat16())
    assert torch.equal(wq.s, want.s) and torch.equal(wq.q, want.q)
    out = eng(np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32))
    assert out.shape == (3, 10) and np.all(np.isfinite(out))


# -- the quantized engines against the JAX engines ----------------------------

def _images(n, seed):
    return (np.random.RandomState(seed).rand(n, 32, 32, 3) * 255).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["logits", "token", "avg"])
def test_quantized_vit_engines_equal_jax(kind):
    params = jvit.init_vit_params(jax.random.PRNGKey(0), JTINY)
    kw = dict(compute_dtype=jnp.float32, input_norm=NORM, buckets=(8,),
              quantize="int8")
    tkw = dict(compute_dtype=torch.float32, input_norm=NORM, buckets=(8,),
               quantize="int8", device="cpu")
    model = tconvert.vit_from_jax(params, TTINY, "cpu")
    if kind == "logits":
        je = jserve.vit_classifier_engine(params, JTINY, use_pallas=True, **kw)
        te = tserve.vit_classifier_engine(model, **tkw)
    else:
        je = jserve.vit_features_engine(params, JTINY, pool=kind,
                                        use_pallas=True, **kw)
        te = tserve.vit_features_engine(model, pool=kind, **tkw)
    imgs = _images(5, 7)
    want, got = je(imgs), te(imgs)
    assert got.shape == want.shape == (5, 10 if kind == "logits" else 32)
    assert _rel(got, want) <= ENGINE_RTOL


def test_carried_jax_int8_tree_serves_like_jax():
    """A JAX-quantized tree ({"q", "s"} leaves, q [in, out]) carried into
    the port's holders: the same int8 weights, the same logits."""
    qparams = jquant.quantize_vit_blocks(
        jvit.init_vit_params(jax.random.PRNGKey(3), JTINY))
    model = tconvert.vit_from_jax(qparams, TTINY, "cpu")
    wq = model.blocks[1].mlp.fc1.weight
    np.testing.assert_array_equal(
        wq.q.numpy(), np.asarray(qparams["blocks"][1]["fc1_w"]["q"]).T)
    np.testing.assert_array_equal(
        wq.s.numpy(), np.asarray(qparams["blocks"][1]["fc1_w"]["s"]))
    je = jserve.vit_classifier_engine(qparams, JTINY, use_pallas=True,
                                      compute_dtype=jnp.float32,
                                      input_norm=NORM, buckets=(4,))
    te = tserve.vit_classifier_engine(model, compute_dtype=torch.float32,
                                      input_norm=NORM, buckets=(4,),
                                      device="cpu")
    imgs = _images(3, 8)
    assert _rel(te(imgs), je(imgs)) <= ENGINE_RTOL


def _clip_setup():
    jcfg = jclip.tiny_clip_config()
    params = jclip.init_clip_params(jax.random.PRNGKey(1), jcfg)
    spec = jadora.dora_spec(jcfg.visual.layers, jcfg.text.layers, 1, 1)
    trainable, static, acfg = jadora.apply_dora(
        params, spec, r=4, alpha=16, key=jax.random.PRNGKey(2))
    trainable = jax.tree_util.tree_map(lambda x: x + 0.05, trainable)
    tokens = np.random.RandomState(3).randint(
        0, jcfg.text.vocab_size, (6, jcfg.text.context_length)).astype(
            np.int32)
    imgs = np.random.RandomState(8).rand(4, 32, 32, 3).astype(np.float32)
    return jcfg, params, trainable, static, acfg, tokens, imgs


def _torch_tree(tree):
    return {t: {i: {k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in d.items()} for i, d in b.items()}
            for t, b in tree.items()}


def test_quantized_clip_engine_equals_jax():
    """Bake, then quantize both towers, in both packages: equal scores."""
    jcfg, params, trainable, static, _, tokens, imgs = _clip_setup()
    je = jserve.clip_hba_engine(params, tokens, jcfg, trainable=trainable,
                                static=static, alpha=16, r=4,
                                compute_dtype=jnp.float32, use_pallas=True,
                                buckets=(8,), quantize="int8")
    tcfg = tclip.tiny_clip_config()
    te = tserve.clip_hba_engine(
        tconvert.clip_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               tcfg, "cpu"), tokens,
        trainable=_torch_tree(trainable), static=_torch_tree(static),
        alpha=16, r=4, compute_dtype=torch.float32, buckets=(8,),
        quantize="int8", device="cpu")
    assert tquant.is_quantized(te.model.visual.transformer.resblocks[1]
                               .attn.out_proj.weight)
    want, got = je(imgs), te(imgs)
    assert got.shape == (4, 6)
    assert _rel(got, want) <= ENGINE_RTOL


def test_clip_engine_bakes_then_quantizes():
    """The quantized engine serves scores close to the adapted f32 forward,
    and closer than quantizing the un-adapted model: the bake came first
    (JAX test_clip_engine_bake_then_quantize)."""
    jcfg, params, trainable, static, acfg, tokens, imgs = _clip_setup()
    tcfg = tclip.tiny_clip_config()
    nparams = jax.tree_util.tree_map(np.asarray, params)

    def engine(**kw):
        return tserve.clip_hba_engine(
            tconvert.clip_from_jax(nparams, tcfg, "cpu"), tokens, alpha=16,
            r=4, compute_dtype=torch.float32, buckets=(8,), quantize="int8",
            device="cpu", **kw)
    got = engine(trainable=_torch_tree(trainable),
                 static=_torch_tree(static))(imgs)
    want = np.asarray(jclip.clip_hba_forward(
        params, jnp.asarray(imgs), jnp.asarray(tokens), jcfg,
        adapters=jadora.assemble(trainable, static), adapter_cfg=acfg,
        deterministic=True, use_pallas=True))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 0.08, rel
    plain = engine()(imgs)
    assert np.linalg.norm(plain - want) / np.linalg.norm(want) > rel
