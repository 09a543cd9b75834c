"""The port's ModifiedResNet CLIP family (models/resnet.py, the RN branches
of models/clip.py and models/convert.py), --pos_embedding, the RN serving
engine, adapters/finetune.py and adapters/lora.py against the JAX package.

A tiny RN CLIP (stages (1, 2, 1, 1), width 8, 64 px; a 2-block text tower
of width 32, context 16) starts as JAX's init_clip_params tree with its
BatchNorm affine leaves moved off identity, crosses to the port through
``clip_state_dict_from_jax_params``, and has its running statistics filled
from real batches by a torch oracle in train mode (OpenAI's forward on the
port's own modules: nn.Conv2d, nn.BatchNorm2d, F.multi_head_attention_forward),
so a swapped or ignored mean / var mapping shows. JAX then reads the
populated state dict with its own converter. The JAX attention runs the
Pallas kernel in interpret mode (use_pallas=True); JAX matmuls are "highest"
(tests/conftest.py). Inputs are numpy-seeded and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_project_tpu.adapters import finetune as jft
from vit_project_tpu.adapters import lora as jlora
from vit_project_tpu.cli import serve as jcli
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import convert as jconvert
from vit_project_tpu.models import resnet as jresnet
from vit_project_tpu.models import vit as jvit
from vit_project_tpu.ops import quant as jquant
from vit_project_torch.adapters import finetune as tft
from vit_project_torch.adapters import lora as tlora
from vit_project_torch.cli import serve as tcli
from vit_project_torch.core.prng import Key
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import resnet as tresnet
from vit_project_torch.ops import quant as tquant

RN = dict(layers=(1, 2, 1, 1), width=8, heads=4, image_size=64, out_dim=16)
TEXT = dict(width=32, layers=2, heads=2, vocab_size=512, context_length=16)
JCFG = jclip.CLIPConfig(visual=jresnet.ResNetConfig(**RN),
                        text=jclip.TextConfig(**TEXT), embed_dim=16)
TCFG = tclip.CLIPConfig(visual=tresnet.ResNetConfig(**RN),
                        text=tclip.TextConfig(**TEXT), embed_dim=16)
N_IMG, N_PROMPTS = 3, 5
# f32 on the CPU: the same arithmetic in another order of summation (the
# convs' and the f32 products' sums; measured: 3.3e-7 with embeddings of
# |value| <= 0.54)
F32_ATOL = 1e-5
# bf16 compute in both packages: each conv output, BatchNorm and pool is
# rounded to bf16 (2^-8 relative) where XLA's CPU fusions and PyTorch's
# kernels may round at other places; through 5 bottlenecks and the pool
# that is a few bf16 spacings of the embeddings (measured: 7.3e-3 of the
# largest |value|)
BF16_RTOL = 2e-2


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(sd: dict) -> dict:
    """JAX's reader on the port's state dict (numpy), with the explicit
    config's heads (the reader infers width // 64)."""
    params, _ = jconvert.clip_params_from_state_dict(
        {k: v.detach().numpy() for k, v in sd.items()})
    return jax.tree_util.tree_map(jnp.asarray, params)


# -- OpenAI's forward on the port's modules (the oracle) -----------------------

def _oracle_block(blk, x):
    out = F.relu(blk.bn1(blk.conv1(x)))
    out = F.relu(blk.bn2(blk.conv2(out)))
    if blk.stride > 1:
        out = F.avg_pool2d(out, blk.stride)
    out = blk.bn3(blk.conv3(out))
    sc = x if blk.downsample is None else blk.downsample(x)
    return F.relu(out + sc)


def _oracle_visual(v, x_nchw, use_pos=True):
    x = F.relu(v.bn1(v.conv1(x_nchw)))
    x = F.relu(v.bn2(v.conv2(x)))
    x = F.relu(v.bn3(v.conv3(x)))
    x = F.avg_pool2d(x, 2)
    for layer in v.stages():
        for blk in layer:
            x = _oracle_block(blk, x)
    p = v.attnpool
    x = x.flatten(start_dim=2).permute(2, 0, 1)
    x = torch.cat([x.mean(dim=0, keepdim=True), x], dim=0)
    if use_pos:
        x = x + p.positional_embedding[:, None, :]
    x, _ = F.multi_head_attention_forward(
        query=x[:1], key=x, value=x, embed_dim_to_check=x.shape[-1],
        num_heads=p.heads, in_proj_weight=None,
        in_proj_bias=torch.cat([p.q_proj.bias, p.k_proj.bias, p.v_proj.bias]),
        bias_k=None, bias_v=None, add_zero_attn=False, dropout_p=0.0,
        out_proj_weight=p.c_proj.weight, out_proj_bias=p.c_proj.bias,
        use_separate_proj_weight=True, q_proj_weight=p.q_proj.weight,
        k_proj_weight=p.k_proj.weight, v_proj_weight=p.v_proj.weight,
        training=False, need_weights=False)
    return x.squeeze(0)


def _jax_tree(cfg, seed: int) -> dict:
    """A tree of JAX's init_clip_params layout (jax.eval_shape: nothing is
    compiled) with numpy-seeded values: matrices and kernels at std
    fan_in^-0.5, LayerNorm and BatchNorm scales 1 + 0.3 N(0, 1) (JAX's init
    zeroes bn3's scale, which would make each block its shortcut), other
    vectors 0.1 N(0, 1), BatchNorm statistics at identity and the logit
    scale log(1 / 0.07)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jclip.init_clip_params(k, cfg),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['logit_scale']"):
            return np.full(s.shape, np.log(1 / 0.07), np.float32)
        if name.endswith(("['mean']", "['var']")):
            return np.full(s.shape, float(name.endswith("['var']")),
                           np.float32)
        if len(s.shape) >= 2:
            std = float(np.prod(s.shape[:-1])) ** -0.5
            return (std * rs.randn(*s.shape)).astype(np.float32)
        base = 1.0 if name.endswith("['scale']") else 0.0
        scale = 0.3 if name.endswith("['scale']") else 0.1
        return (base + scale * rs.randn(*s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _populated_state_dict():
    """The port state dict of the module's tiny RN CLIP, its BatchNorm
    statistics filled from two real batches."""
    tree = _jax_tree(JCFG, 1)
    model = tconvert.clip_from_state_dict(
        tconvert.clip_state_dict_from_jax_params(tree, TCFG), "cpu", TCFG)
    model.visual.train()
    with torch.no_grad():
        for seed in (0, 1):
            g = torch.Generator().manual_seed(seed)
            _oracle_visual(model.visual, torch.randn(4, 3, 64, 64,
                                                     generator=g))
    model.eval()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def rn():
    sd = _populated_state_dict()
    rs = np.random.RandomState(2)
    imgs = rs.randn(N_IMG, 64, 64, 3).astype(np.float32)
    tokens = rs.randint(1, TEXT["vocab_size"] - 2,
                        (N_PROMPTS, TEXT["context_length"]))
    tokens[:, -1] = TEXT["vocab_size"] - 1           # EOT, the largest id
    return sd, _jax_params(sd), imgs, tokens.astype(np.int32)


def _model(sd):
    return tconvert.clip_from_state_dict(sd, "cpu", TCFG)


# the JAX side under jit (eager JAX compiles each primitive at each shape)
_jencode = jax.jit(jclip.encode_image, static_argnums=2,
                   static_argnames=("use_pos_embedding", "compute_dtype"))
_jforward = jax.jit(jclip.clip_hba_forward, static_argnums=3,
                    static_argnames=("use_pallas", "use_pos_embedding"))


def _jax_scores(params, imgs, tokens, **kw):
    return np.asarray(_jforward(params, jnp.asarray(imgs),
                                jnp.asarray(tokens), JCFG, use_pallas=True,
                                **kw))


# -- the tower ------------------------------------------------------------------

def test_statistics_populated_and_weights_channels_last(rn):
    sd, _, _, _ = rn
    assert sd["visual.layer2.0.bn1.num_batches_tracked"].item() == 2
    assert sd["visual.layer2.0.bn1.running_mean"].abs().max() > 1e-3
    assert (sd["visual.layer2.0.bn1.running_var"] - 1).abs().max() > 1e-2
    model = _model(sd)
    for name, p in model.visual.named_parameters():
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), name


@pytest.mark.parametrize("use_pos", [True, False])
def test_resnet_encode_matches_jax_f32(rn, use_pos):
    sd, params, imgs, _ = rn
    want = np.asarray(_jencode(params, jnp.asarray(imgs), JCFG,
                                         use_pos_embedding=use_pos))
    with torch.no_grad():
        got = tresnet.resnet_encode(_model(sd).visual, torch.from_numpy(imgs),
                                    use_pos_embedding=use_pos)
        oracle = _oracle_visual(_model(sd).visual,
                                torch.from_numpy(imgs).permute(0, 3, 1, 2),
                                use_pos)
    assert got.shape == (N_IMG, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=F32_ATOL,
                               rtol=0)


def test_positions_change_the_embedding(rn):
    sd, _, imgs, _ = rn
    model = _model(sd)
    with torch.no_grad():
        on, off = (tclip.encode_image(model, torch.from_numpy(imgs),
                                      use_pos_embedding=p)
                   for p in (True, False))
    assert float((on - off).abs().max()) > 1e-3


@pytest.mark.parametrize("use_pos", [True, False])
def test_resnet_encode_matches_jax_bf16(rn, use_pos):
    sd, params, imgs, _ = rn
    want = np.asarray(_jencode(params, jnp.asarray(imgs), JCFG,
                                         use_pos_embedding=use_pos,
                                         compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = tclip.encode_image(_model(sd), torch.from_numpy(imgs),
                                 use_pos_embedding=use_pos,
                                 compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= BF16_RTOL


def test_remat_equals_the_plain_run(rn):
    """Each stage recomputed in the backward: the same output and the same
    gradients, bit for bit."""
    sd, _, imgs, _ = rn
    x = torch.from_numpy(imgs)
    outs, grads = [], []
    for remat in (False, True):
        model = _model(sd)
        tft.split_rn_image_layers(model)
        y = tresnet.resnet_encode(model.visual, x, remat=remat)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append({n: p.grad.clone() for n, p in
                      model.named_parameters() if p.grad is not None})
    assert torch.equal(outs[0], outs[1])
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_bn_ignores_train_mode(rn):
    """The forward reads the running statistics whatever .train() says (the
    reference's CLIPHBA forces eval), and leaves them unchanged."""
    sd, _, imgs, _ = rn
    model = _model(sd)
    with torch.no_grad():
        a = tclip.encode_image(model, torch.from_numpy(imgs))
        model.train()
        b = tclip.encode_image(model, torch.from_numpy(imgs))
    assert torch.equal(a, b)
    assert torch.equal(model.visual.bn1.running_mean,
                       sd["visual.bn1.running_mean"])


@pytest.mark.parametrize("use_pos", [False, True])
def test_clip_hba_forward_matches_jax(rn, use_pos):
    """[B, n_prompts] scores, f32, atol 1e-4 (the logit scale, ~14.3,
    amplifies the cosine error), the text tower on the kernel's plain
    version against JAX's Pallas kernel in interpret mode."""
    sd, params, imgs, tokens = rn
    want = _jax_scores(params, imgs, tokens, use_pos_embedding=use_pos)
    with torch.no_grad():
        got = tclip.clip_hba_forward(_model(sd), torch.from_numpy(imgs),
                                     torch.from_numpy(tokens).long(),
                                     use_pos_embedding=use_pos)
    assert got.shape == (N_IMG, N_PROMPTS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_vit_tower_without_positions_matches_jax():
    """use_pos_embedding=False on a ViT tower: the full forward and the
    frozen prefix skip the visual positions, as JAX's."""
    jcfg = jclip.tiny_clip_config()
    params = _jax_tree(jcfg, 3)
    tcfg = tclip.tiny_clip_config()
    model = tconvert.clip_from_state_dict(
        tconvert.clip_state_dict_from_jax_params(_np_tree(params), tcfg),
        "cpu", tcfg)
    rs = np.random.RandomState(4)
    imgs = rs.randn(2, 32, 32, 3).astype(np.float32)
    tokens = rs.randint(0, 512, (4, 16)).astype(np.int32)
    want = np.asarray(_jforward(params, jnp.asarray(imgs),
                                jnp.asarray(tokens), jcfg, use_pallas=True,
                                use_pos_embedding=False))
    want_prefix = np.asarray(jvit.clip_visual_prefix(
        params["visual"], jnp.asarray(imgs), jcfg.visual, n_suffix=1,
        use_pallas=True, use_pos_embedding=False))
    with torch.no_grad():
        got = tclip.clip_hba_forward(model, torch.from_numpy(imgs),
                                     torch.from_numpy(tokens).long(),
                                     use_pos_embedding=False)
        on = tclip.clip_hba_forward(model, torch.from_numpy(imgs),
                                    torch.from_numpy(tokens).long())
        prefix = tclip.clip_visual_prefix(model, torch.from_numpy(imgs),
                                          n_suffix=1, use_pos_embedding=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(prefix.numpy(), want_prefix, atol=1e-5,
                               rtol=0)
    assert float((got - on).abs().max()) > 1e-4


# -- configurations and the weights bridge --------------------------------------

@pytest.mark.parametrize("name", sorted(jclip.CLIP_CONFIGS))
def test_clip_config_geometry_matches_jax(name, monkeypatch):
    """Every CLIP_CONFIGS name of the JAX package resolves in the port with
    JAX's geometry, and the port's model (built on the meta device) has the
    parameter shapes of JAX's init_clip_params (jax.eval_shape) under the
    converter's names; no weights are allocated."""
    jcfg, tcfg = jclip.CLIP_CONFIGS[name], tclip.CLIP_CONFIGS[name]
    assert type(jcfg.visual).__name__ == type(tcfg.visual).__name__
    for j, t in ((jcfg.visual, tcfg.visual), (jcfg.text, tcfg.text)):
        common = ({f.name for f in dataclasses.fields(j)} &
                  {f.name for f in dataclasses.fields(t)})
        assert {f: getattr(t, f) for f in common} == \
            {f: getattr(j, f) for f in common}
    assert tcfg.embed_dim == jcfg.embed_dim
    if tclip.is_resnet(tcfg):
        assert (tcfg.visual.feature_dim, tcfg.visual.pool_grid) == \
            (jcfg.visual.feature_dim, jcfg.visual.pool_grid)
    shapes = jax.eval_shape(lambda k: jclip.init_clip_params(k, jcfg),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    monkeypatch.setattr(tconvert, "_t", lambda x: torch.empty(
        np.shape(np.asarray(x)), device="meta"))
    want = {k: tuple(v.shape) for k, v in
            tconvert.clip_state_dict_from_jax_params(tree, tcfg).items()}
    with torch.device("meta"):
        model = tclip.CLIP(tcfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_config_inference_matches_jax(rn):
    sd, _, _, _ = rn
    np_sd = {k: v.numpy() for k, v in sd.items()}
    want = jconvert.clip_config_from_state_dict(np_sd)
    got = tconvert.clip_config_from_state_dict(sd)
    assert tclip.is_resnet(got)
    assert dataclasses.asdict(got.visual) == dataclasses.asdict(want.visual)
    assert dataclasses.asdict(got.text) == dataclasses.asdict(want.text)
    assert got.embed_dim == want.embed_dim


@pytest.mark.parametrize("counters", [True, False])
def test_strict_load_of_jax_exported_state_dict(rn, counters, tmp_path):
    """JAX's clip_state_dict_from_params output (with its int64 zero
    counters, or without them, as JAX's reader ignores them) loads with
    strict=True, through a written .pt too, and holds the same weights."""
    sd, params, _, _ = rn
    jsd = jconvert.clip_state_dict_from_params(_np_tree(params), JCFG)
    assert jsd["visual.bn1.num_batches_tracked"].dtype == np.int64
    if not counters:
        jsd = {k: v for k, v in jsd.items()
               if not k.endswith("num_batches_tracked")}
    path = tmp_path / "rn.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in jsd.items()},
               path)
    loaded = tconvert.load_torch_state_dict(str(path))
    if counters:
        assert loaded["visual.bn1.num_batches_tracked"].dtype == torch.long
    model = tconvert.clip_from_state_dict(loaded, "cpu", TCFG)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert v.dtype == torch.long and v.item() == 0, k
        else:
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_state_dict_from_jax_params_matches_jax_exporter(rn):
    _, params, _, _ = rn
    want = jconvert.clip_state_dict_from_params(_np_tree(params), JCFG)
    got = tconvert.clip_state_dict_from_jax_params(_np_tree(params), TCFG)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_init_fills_every_buffer():
    """empty_clip leaves memory uninitialized; the init fills every
    parameter and buffer, seeded."""
    a, b = (tclip.init_clip_weights_(tclip.empty_clip(TCFG, "cpu"),
                                     torch.Generator().manual_seed(7))
            for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    v = a.visual
    assert torch.equal(v.bn1.running_var, torch.ones(4))
    assert v.layer1[0].bn3.weight.abs().max() == 0
    assert v.layer1[0].downsample[2].num_batches_tracked.item() == 0
    c = v.layer1[0].conv2.weight      # He fan-out: std sqrt(2 / (9 * 8))
    assert abs(float(c.detach().std()) - (2 / 72) ** 0.5) < 0.05


# -- int8 -----------------------------------------------------------------------

def test_int8_leaves_the_rn_tower_float_and_matches_jax(rn):
    sd, params, imgs, tokens = rn
    qparams = jquant.quantize_clip_blocks(params)
    want = _jax_scores(qparams, imgs, tokens, use_pos_embedding=False)
    model = tquant.quantize_clip_blocks(_model(sd))
    assert not any(tquant.is_quantized(m) for m in model.visual.modules())
    assert all(tquant.is_quantized(b.attn.in_proj_weight)
               for b in model.transformer.resblocks)
    from_jax = tconvert.clip_from_jax(_np_tree(qparams), TCFG, "cpu")
    with torch.no_grad():
        got = tclip.clip_hba_forward(model, torch.from_numpy(imgs),
                                     torch.from_numpy(tokens).long(),
                                     use_pos_embedding=False)
        got_j = tclip.clip_hba_forward(from_jax, torch.from_numpy(imgs),
                                       torch.from_numpy(tokens).long(),
                                       use_pos_embedding=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_j.numpy(), want, atol=1e-4, rtol=0)


# -- refusals, in JAX's words ------------------------------------------------------

def test_jax_refusals(rn):
    sd, params, imgs, tokens = rn
    model = _model(sd)
    x = torch.from_numpy(imgs)
    tok = torch.from_numpy(tokens).long()
    jx = jnp.asarray(imgs)
    cases = [
        ("finetune", lambda: tclip.encode_image(model, x, adapters={0: {}}),
         lambda: jclip.encode_image(params, jx, JCFG, adapters={0: {}})),
        ("conv pyramid",
         lambda: tclip.encode_image(model, x, seq_shard=object()),
         lambda: jclip.encode_image(params, jx, JCFG, seq_shard=object())),
        ("frozen-prefix caching",
         lambda: tclip.clip_hba_suffix_forward(
             model, x, x, tok[:, 0], n_vis_suffix=1, n_txt_suffix=1),
         lambda: jclip.clip_hba_suffix_forward(
             params, jx, jx, jnp.asarray(tokens[:, 0]), JCFG,
             n_vis_suffix=1, n_txt_suffix=1)),
    ]
    for match, port, jax_fn in cases:
        with pytest.raises(ValueError, match=match) as got:
            port()
        with pytest.raises(ValueError, match=match) as want:
            jax_fn()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="frozen-prefix caching"):
        tclip.clip_visual_prefix(model, x, n_suffix=1)
    with pytest.raises(ValueError, match="frozen-prefix caching"):
        tclip.clip_hba_suffix_forward_forks(
            model, x, x, tok[:, 0], 2, n_vis_suffix=1, n_txt_suffix=1)
    with pytest.raises(ValueError, match="finetune"):
        tclip.clip_hba_forward_forks(model, x, tok, 2)


def test_training_refuses_an_rn_tower_before_reading_data(rn, tmp_path):
    """cli.baseline, cli.sweep and cli.lengths all build their run through
    build_run_assets: an RN backbone or RN weights are refused there, in
    JAX's words, before the (here missing) dataset is read."""
    from vit_project_torch.core.configs import ClipRunConfig
    from vit_project_torch.train import clip_loop
    sd, _, _, _ = rn
    wpath = str(tmp_path / "rn.pt")
    torch.save(sd, wpath)
    missing = str(tmp_path / "no_such.csv")
    for kw in ({"backbone": "RN50"}, {"backbone": "RN50x64"},
               {"clip_weights": wpath}):
        cfg = ClipRunConfig(csv_file=missing, img_dir=str(tmp_path),
                            **kw)
        with pytest.raises(ValueError, match="ModifiedResNet visual tower; "
                           "the CLIP-HBA DoRA training pipeline is ViT-only"):
            clip_loop.build_run_assets(cfg, None, "cpu")


# -- finetune splits ---------------------------------------------------------------

_SPLITS = {
    "rn_image_layers": (lambda m: tft.split_rn_image_layers(m),
                        lambda p: jft.split_rn_image_layers(p)),
    "visual_tower": (lambda m: tft.split_visual_tower(m),
                     lambda p: jft.split_visual_tower(p)),
    "last_text_block": (lambda m: tft.split_last_blocks(m, "text", 1),
                        lambda p: jft.split_last_blocks(p, "text", 1)),
}
_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _as_port_names(trainable, frozen, fill_frozen, fill_trainable):
    """A JAX (trainable, frozen) pair's leaves filled by the two functions,
    merged and converted to the port's names."""
    tree = jft.merge(jax.tree_util.tree_map(fill_frozen, frozen),
                     jax.tree_util.tree_map(fill_trainable, trainable))
    return tconvert.clip_state_dict_from_jax_params(_np_tree(tree), TCFG)


@pytest.mark.parametrize("split", sorted(_SPLITS))
def test_finetune_split_matches_jax(rn, split):
    """The same leaves as JAX's selection (BatchNorm statistics are buffers
    in the port: the reference's unfreezers never train them), no name in
    both halves, and gradients only through the trainable half, within
    1e-4 of each leaf's largest |jax.grad|."""
    sd, params, imgs, tokens = rn
    port_split, jax_split = _SPLITS[split]
    jtr, jfr = jax_split(params)
    marks = _as_port_names(jtr, jfr, np.zeros_like, np.ones_like)
    want_names = {k for k, v in marks.items()
                  if v.numel() and bool((v == 1).all())
                  and not k.endswith(_BN_STATS)}

    model = _model(sd)
    trainable, frozen = port_split(model)
    assert set(trainable) == want_names
    assert not set(trainable) & set(frozen)
    assert set(trainable) | set(frozen) == {n for n, _ in
                                            model.named_parameters()}
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    full = tft.merge(frozen, trainable)
    assert tft.count_params(full) == sum(p.numel() for p in
                                         model.parameters())
    with pytest.raises(ValueError, match="both halves"):
        tft.merge(frozen, {**trainable, next(iter(frozen)): None})

    target = np.random.RandomState(9).randn(N_IMG, N_PROMPTS).astype(
        np.float32)

    def jloss(tr):
        s = jclip.clip_hba_forward(jft.merge(jfr, tr), jnp.asarray(imgs),
                                   jnp.asarray(tokens), JCFG,
                                   use_pallas=True, use_pos_embedding=False)
        return jnp.mean((s - target) ** 2)
    jgrads = _as_port_names(jax.jit(jax.grad(jloss))(jtr), jfr,
                            np.zeros_like, lambda g: g)
    s = tclip.clip_hba_forward(model, torch.from_numpy(imgs),
                               torch.from_numpy(tokens).long(),
                               use_pos_embedding=False)
    ((s - torch.from_numpy(target)) ** 2).mean().backward()
    for name, p in frozen.items():
        assert p.grad is None, name
    # a leaf whose exact gradient is 0 (the key bias: softmax ignores a
    # shift shared by every key) is held to 1e-3 of the largest gradient
    floor = 1e-3 * max(float(jgrads[n].abs().max()) for n in trainable)
    for name, p in trainable.items():
        want = jgrads[name].numpy()
        # no gradient reaches the positions a forward skips: JAX's is 0
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(got - want).max()) / scale
        assert err <= 1e-4, (name, err)


def test_split_refusals(rn):
    vit = tclip.init_clip_weights_(
        tclip.empty_clip(tclip.tiny_clip_config(), "cpu"),
        torch.Generator().manual_seed(0))
    jvit_tree = _jax_tree(jclip.tiny_clip_config(), 0)
    with pytest.raises(ValueError, match="not an RN visual tower") as got:
        tft.split_rn_image_layers(vit)
    with pytest.raises(ValueError, match="not an RN visual tower") as want:
        jft.split_rn_image_layers(jvit_tree)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no transformer blocks"):
        tft.split_last_blocks(_model(rn[0]), "visual", 1)


# -- LoRA -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_lora_matches_jax(dtype, bias):
    """JAX draws A and B; both layers run on them: within f32 rounding
    (f32) or one bf16 spacing of the output (bf16)."""
    lora = jlora.lora_init(jax.random.PRNGKey(4), 24, 16, 4)
    rs = np.random.RandomState(6)
    x = rs.randn(3, 5, 24).astype(np.float32)
    w = rs.randn(24, 16).astype(np.float32) * 0.2
    b = rs.randn(16).astype(np.float32) if bias else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlora.lora_linear(jnp.asarray(x, jdt), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), lora,
                             alpha=16, r=4)
    tl = {k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()}
    got = tlora.lora_linear(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                            None if b is None else torch.from_numpy(b), tl,
                            alpha=16, r=4)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert _rel(got.float().numpy(), want) <= tol
    np.testing.assert_allclose(
        tlora.lora_merged_weight(torch.from_numpy(w), tl, alpha=16,
                                 r=4).numpy(),
        np.asarray(jlora.lora_merged_weight(jnp.asarray(w), lora, alpha=16,
                                            r=4)), atol=1e-6, rtol=1e-6)


def test_lora_init_and_dropout():
    """lora_init is seeded, kaiming-uniform on both factors; dropout acts
    on the low-rank input (with the keep-mask given, or one drawn from the
    key), and without a key is refused in JAX's words."""
    a = tlora.lora_init(torch.Generator().manual_seed(1), 24, 16, 4)
    b = tlora.lora_init(torch.Generator().manual_seed(1), 24, 16, 4)
    assert a["lora_A"].shape == (4, 16) and a["lora_B"].shape == (24, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["lora_A"].abs().max()) <= 16 ** -0.5
    assert float(a["lora_B"].abs().max()) <= 4 ** -0.5
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(6, 24).astype(np.float32))
    w = torch.from_numpy(rs.randn(24, 16).astype(np.float32))
    keep = torch.from_numpy(rs.rand(6, 24) < 0.75)
    got = tlora.lora_linear(x, w, None, a, alpha=16, r=4, dropout_p=0.25,
                            deterministic=False, keep=keep)
    xd = torch.where(keep, x / 0.75, torch.zeros(()))
    want = x @ w + (xd @ a["lora_B"]) @ a["lora_A"] * 4
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    drawn = tlora.lora_linear(x, w, None, a, alpha=16, r=4, dropout_p=0.25,
                              deterministic=False, dropout_key=Key.root(3))
    again = tlora.lora_linear(x, w, None, a, alpha=16, r=4, dropout_p=0.25,
                              deterministic=False, dropout_key=Key.root(3))
    assert torch.equal(drawn, again)
    msg = ("lora_linear with dropout_p > 0 and deterministic=False requires "
           "a dropout_key")
    with pytest.raises(ValueError, match=msg):
        tlora.lora_linear(x, w, None, a, alpha=16, r=4, dropout_p=0.25,
                          deterministic=False)
    with pytest.raises(ValueError, match=msg):
        jlora.lora_linear(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                          None, {k: jnp.asarray(v.numpy())
                                 for k, v in a.items()},
                          alpha=16, r=4, dropout_p=0.25, deterministic=False)


# -- serving ------------------------------------------------------------------------

def _write_rn(tmp_path, name, visual, seed=0) -> str:
    """A seeded OpenAI-format RN checkpoint (fp16 floats, int64 counters)
    with the test's small text tower."""
    cfg = tclip.CLIPConfig(visual=visual, text=tclip.TextConfig(**TEXT),
                           embed_dim=visual.out_dim)
    model = tclip.init_clip_weights_(tclip.empty_clip(cfg, "cpu"),
                                     torch.Generator().manual_seed(seed))
    path = str(tmp_path / name)
    torch.save({k: v.half() if v.is_floating_point() else v
                for k, v in model.state_dict().items()}, path)
    return path


def _serve_args(wpath, *extra):
    return tcli.parse_args(["--clip_weights", wpath, "--allow_hash_tokenizer",
                            "--device", "cpu", "--param_dtype", "f32",
                            "--buckets", "2,4", "--http_port", "0", *extra])


def test_auto_pos_embedding_rule_matches_jax():
    for name in jclip.CLIP_CONFIGS:
        assert tcli.auto_use_pos_embedding(tclip.CLIP_CONFIGS[name]) == \
            jcli.auto_use_pos_embedding(jclip.CLIP_CONFIGS[name]), name
    assert not tcli.auto_use_pos_embedding(tclip.CLIP_CONFIGS["RN50"])
    assert tcli.auto_use_pos_embedding(tclip.CLIP_CONFIGS["RN101"])


def test_cli_serves_an_rn50_checkpoint(tmp_path):
    """RN50 geometry (stages (3, 4, 6, 3), width 64) at 32 px: --pos_embedding
    auto is off, the scores equal clip_hba_forward's without positions, and
    on / off differ; --dora_checkpoint is refused in JAX's words before any
    DoRA surgery."""
    wpath = _write_rn(tmp_path, "rn50.pt",
                      dataclasses.replace(tresnet.RN50, image_size=32))
    eng, size, norm = tcli.build_clip_engine(_serve_args(wpath))
    assert size == 32 and eng.use_pos_embedding is False
    on, _, _ = tcli.build_clip_engine(_serve_args(wpath, "--pos_embedding",
                                                  "on"))
    assert on.use_pos_embedding is True
    raw = np.random.RandomState(1).randint(0, 256, (3, 32, 32, 3), np.uint8)
    x = tcli._http_preprocess(norm)(raw)
    got = eng(x)
    assert got.shape == (3, 66) and np.all(np.isfinite(got))
    with torch.inference_mode():
        want = tclip.clip_hba_forward(eng.model, torch.from_numpy(x),
                                      eng.prompt_tokens,
                                      compute_dtype=torch.bfloat16,
                                      use_pos_embedding=False)
    np.testing.assert_array_equal(got, want.numpy())
    assert np.abs(on(x) - got).max() > 1e-4
    with pytest.raises(SystemExit, match="needs a ViT visual tower"):
        tcli.build_clip_engine(_serve_args(wpath, "--dora_checkpoint",
                                           str(tmp_path / "none.pth")))


def test_cli_rn_auto_rule_and_batch_mode(tmp_path):
    """RN101 geometry (and any other than RN50's) keeps the positions (auto
    on); --pos_embedding off overrides; batch mode writes the CSV of the
    engine's scores; int8 leaves the RN tower float."""
    from PIL import Image
    rn101 = _write_rn(tmp_path, "rn101.pt",
                      dataclasses.replace(tresnet.RN101, image_size=32))
    eng101, _, _ = tcli.build_clip_engine(_serve_args(rn101))
    assert eng101.model.cfg.visual.layers == (3, 4, 23, 3)
    assert eng101.use_pos_embedding is True
    del eng101
    wpath = _write_rn(tmp_path, "rn.pt", tresnet.ResNetConfig(**RN))
    eng, _, norm = tcli.build_clip_engine(_serve_args(wpath))
    off, _, _ = tcli.build_clip_engine(_serve_args(wpath, "--pos_embedding",
                                                   "off"))
    assert eng.use_pos_embedding is True and off.use_pos_embedding is False
    q, _, _ = tcli.build_clip_engine(_serve_args(wpath, "--quantize", "int8"))
    assert not any(tquant.is_quantized(m) for m in q.model.visual.modules())
    assert tquant.is_quantized(q.model.transformer.resblocks[0]
                               .attn.in_proj_weight)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(2)
    for i in range(5):
        Image.fromarray(rs.randint(0, 256, (70, 80, 3), np.uint8)).save(
            imgs / f"{i}.jpg")
    out = str(tmp_path / "scores.csv")
    assert tcli.main(["--clip_weights", wpath, "--allow_hash_tokenizer",
                      "--device", "cpu", "--param_dtype", "f32", "--buckets",
                      "2,4", "--images", str(imgs), "--out", out,
                      "--topk", "3"]) == 0
    paths = tcli.collect_images(str(imgs))
    batch = next(tcli.batched_reader(paths, 5, 64, normalize=norm))
    want = eng(batch)
    rows = open(out).read().splitlines()[1:]
    assert len(rows) == 5
    for row, w in zip(rows, want):
        cells = row.split(",")
        top = np.argsort(-w)[:3]
        assert [int(c) for c in cells[1::2]] == list(top)
        np.testing.assert_allclose([float(c) for c in cells[2::2]], w[top],
                                   atol=1e-6)


def test_export_artifact_equals_the_engine(tmp_path):
    """--export_dir on an RN checkpoint, served by load_serving: the
    engine's scores bit for bit, a full and a padded chunk."""
    from vit_project_torch.serve.export import load_serving
    wpath = _write_rn(tmp_path, "rn.pt", tresnet.ResNetConfig(**RN))
    art = str(tmp_path / "art")
    args = ["--clip_weights", wpath, "--allow_hash_tokenizer", "--device",
            "cpu", "--param_dtype", "f32", "--buckets", "4"]
    assert tcli.main(args + ["--export_dir", art]) == 0
    eng, _, norm = tcli.build_clip_engine(tcli.parse_args(
        args + ["--http_port", "0"]))
    aot = load_serving(art, device="cpu")
    x = tcli._http_preprocess(norm)(
        np.random.RandomState(3).randint(0, 256, (4, 64, 64, 3), np.uint8))
    for n in (3, 4):
        np.testing.assert_array_equal(aot(x[:n]), eng(x[:n]))


def test_new_modules_are_under_the_import_boundary_check():
    """tests/test_torch_clip.py's AST and subprocess checks cover every
    module under the package; the slice's new ones are there."""
    import pathlib
    port = pathlib.Path(tclip.__file__).resolve().parents[1]
    names = {p.relative_to(port).as_posix() for p in port.rglob("*.py")}
    assert {"models/resnet.py", "adapters/finetune.py",
            "adapters/lora.py"} <= names
