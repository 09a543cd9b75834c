"""The frozen-prefix split and remat: the port's clip_visual_prefix /
clip_visual_suffix, encode_text_prefix / encode_text_suffix and
clip_hba_suffix_forward against the port's full towers and against the JAX
package's split functions on carried-over weights, and the trainer's cached
and recomputed steps against its plain step.

A tiny CLIP (3 blocks per tower, width 32, 2 heads), f32, seeded with
numpy and JAX; adapters on the last 2 visual blocks and the last text block,
so the visual suffix's second block takes a qkv that depends on the first
one's adapter and runs the attention backward, as image block 23 does at
the reference configuration. JAX at "highest" matmul precision
(tests/conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import vit as jvit
from vit_project_torch.adapters import dora as tadora
from vit_project_torch.core.prng import Key
from vit_project_torch.data import things as tthings
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.ops import attention as tattn
from vit_project_torch.train import clip_loop as tloop

KW = dict(width=32, layers=3, heads=2, patch=16, image_size=32, embed_dim=16,
          vocab=512, context=16)
N_VIS, N_TXT = 2, 1
TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """JAX params and adapters (moved off init), the same weights and
    adapters in the port, normalized images and prompt tokens."""
    jcfg = jclip.tiny_clip_config(**KW)
    params = jclip.init_clip_params(jax.random.PRNGKey(3), jcfg)
    spec = jadora.dora_spec(3, 3, N_VIS, N_TXT)
    jtr, jst, acfg = jadora.apply_dora(params, spec, r=4, alpha=16,
                                       dropout=0.1,
                                       key=jax.random.PRNGKey(4))
    jtr = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.sin(jnp.arange(x.size).reshape(x.shape)),
        jtr)
    tcfg = tclip.tiny_clip_config(**KW)
    model = tconvert.clip_from_state_dict(
        tconvert.clip_state_dict_from_jax_params(_np_tree(params), tcfg),
        "cpu", tcfg)
    rs = np.random.RandomState(5)
    images_u8 = rs.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    tokens = rs.randint(1, 500, (7, 16)).astype(np.int32)
    return dict(jcfg=jcfg, params=params, jtr=jtr, jst=jst, acfg=acfg,
                model=model, images_u8=images_u8, tokens=tokens,
                ttr=tconvert.adapters_from_jax(_np_tree(jtr)),
                tst=tconvert.adapters_from_jax(_np_tree(jst)))


def _images(p):
    return tthings.normalize_uint8(torch.from_numpy(p["images_u8"]))


def _adapters(p):
    return tadora.assemble(p["ttr"], p["tst"])


# -- the split against the port's full towers ---------------------------------

@pytest.mark.parametrize("deterministic", [True, False])
def test_visual_prefix_suffix_equals_the_full_tower(pair, deterministic):
    """Dropout on (p = 0.1) draws the same masks: absolute block indices."""
    m, ad, key = pair["model"], _adapters(pair), Key.root(9)
    with torch.no_grad():
        full = tvit.clip_visual_encode(
            m.visual, _images(pair), adapters=ad["visual"],
            adapter_cfg=pair["acfg"], dropout_key=key,
            deterministic=deterministic)
        h = tvit.clip_visual_prefix(m.visual, _images(pair), n_suffix=N_VIS)
        split = tvit.clip_visual_suffix(
            m.visual, h, n_suffix=N_VIS, adapters=ad["visual"],
            adapter_cfg=pair["acfg"], dropout_key=key,
            deterministic=deterministic)
    assert h.shape == (6, 5, 32)
    np.testing.assert_allclose(split.numpy(), full.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("deterministic", [True, False])
def test_text_prefix_suffix_equals_the_full_tower(pair, deterministic):
    m, ad, key = pair["model"], _adapters(pair), Key.root(9)
    tokens = torch.from_numpy(pair["tokens"]).long()
    with torch.no_grad():
        full = tclip.encode_text(m, tokens, adapters=ad["text"],
                                 adapter_cfg=pair["acfg"], dropout_key=key,
                                 deterministic=deterministic)
        h, eot = tclip.encode_text_prefix(m, tokens, n_suffix=N_TXT)
        split = tclip.encode_text_suffix(
            m, h, eot, n_suffix=N_TXT, adapters=ad["text"],
            adapter_cfg=pair["acfg"], dropout_key=key,
            deterministic=deterministic)
    np.testing.assert_allclose(split.numpy(), full.numpy(), atol=TOL, rtol=0)


def test_suffix_forward_equals_clip_hba_forward(pair):
    """The dropout key splits into (vision, text) as the full forward's."""
    m, ad = pair["model"], _adapters(pair)
    tokens = torch.from_numpy(pair["tokens"]).long()
    kw = dict(adapters=ad, adapter_cfg=pair["acfg"],
              dropout_key=Key.root(11), deterministic=False)
    with torch.no_grad():
        full = tclip.clip_hba_forward(m, _images(pair), tokens, **kw)
        vh = tvit.clip_visual_prefix(m.visual, _images(pair), n_suffix=N_VIS)
        th, eot = tclip.encode_text_prefix(m, tokens, n_suffix=N_TXT)
        split = tclip.clip_hba_suffix_forward(m, vh, th, eot,
                                              n_vis_suffix=N_VIS,
                                              n_txt_suffix=N_TXT, **kw)
    assert split.shape == (6, 7)
    np.testing.assert_allclose(split.numpy(), full.numpy(), atol=TOL, rtol=0)


def test_split_refuses_adapters_below_it(pair):
    m, ad = pair["model"], _adapters(pair)
    h = tvit.clip_visual_prefix(m.visual, _images(pair), n_suffix=1)
    with pytest.raises(ValueError, match="below the prefix/suffix split"):
        tvit.clip_visual_suffix(m.visual, h, n_suffix=1,
                                adapters=ad["visual"],
                                adapter_cfg=pair["acfg"])
    with pytest.raises(ValueError, match="outside"):
        tvit.clip_visual_prefix(m.visual, _images(pair), n_suffix=4)


# -- the split against JAX's --------------------------------------------------

def test_split_matches_jax(pair):
    """Hidden activations, visual and text embeddings within 1e-5 of JAX's
    split functions; the scores (logit scale ~14.3 on cosines) within 1e-5
    relative to their largest magnitude."""
    jcfg, params = pair["jcfg"], pair["params"]
    jad = jadora.assemble(pair["jtr"], pair["jst"])
    jimg = jnp.asarray(np.asarray(_images(pair)))
    jtok = jnp.asarray(pair["tokens"])
    jvh = jvit.clip_visual_prefix(params["visual"], jimg, jcfg.visual,
                                  n_suffix=N_VIS)
    jth, jeot = jclip.encode_text_prefix(params, jtok, jcfg, n_suffix=N_TXT)
    jv = jvit.clip_visual_suffix(params["visual"], jvh, jcfg.visual,
                                 n_suffix=N_VIS, adapters=jad["visual"],
                                 adapter_cfg=pair["acfg"])
    jt = jclip.encode_text_suffix(params, jth, jeot, jcfg, n_suffix=N_TXT,
                                  adapters=jad["text"],
                                  adapter_cfg=pair["acfg"])
    js = jclip.clip_hba_suffix_forward(params, jvh, jth, jeot, jcfg,
                                       n_vis_suffix=N_VIS,
                                       n_txt_suffix=N_TXT, adapters=jad,
                                       adapter_cfg=pair["acfg"])
    m, ad = pair["model"], _adapters(pair)
    tokens = torch.from_numpy(pair["tokens"]).long()
    with torch.no_grad():
        vh = tvit.clip_visual_prefix(m.visual, _images(pair), n_suffix=N_VIS)
        th, eot = tclip.encode_text_prefix(m, tokens, n_suffix=N_TXT)
        v = tvit.clip_visual_suffix(m.visual, vh, n_suffix=N_VIS,
                                    adapters=ad["visual"],
                                    adapter_cfg=pair["acfg"])
        t = tclip.encode_text_suffix(m, th, eot, n_suffix=N_TXT,
                                     adapters=ad["text"],
                                     adapter_cfg=pair["acfg"])
        s = tclip.clip_hba_suffix_forward(m, vh, th, eot, n_vis_suffix=N_VIS,
                                          n_txt_suffix=N_TXT, adapters=ad,
                                          adapter_cfg=pair["acfg"])
    for got, want in ((vh, jvh), (th, jth), (v, jv), (t, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    np.testing.assert_array_equal(eot.numpy(), np.asarray(jeot))
    js = np.asarray(js)
    np.testing.assert_allclose(s.numpy(), js, atol=TOL * np.abs(js).max(),
                               rtol=0)


# -- the trainer: cached and recomputed steps ---------------------------------

def _trainer(pair, remat=False):
    m = pair["model"]
    return tloop.ClipHBATrainer(m.cfg, m, pair["acfg"], pair["tst"],
                                pair["tokens"], lr=1e-3,
                                compute_dtype=torch.float32, remat=remat)


def _step(pair, *, cached, remat=False, kind="none", counts=None):
    """One train step from the pair's adapters; returns (loss, updated
    adapters, calls of flash3_fwd and flash3_bwd)."""
    tr = _trainer(pair, remat)
    ttr = tadora.make_trainable(pair["ttr"])
    opt = tr.init_optimizer(ttr)
    imgs, tgts = tr.upload_dataset(
        pair["images_u8"],
        np.random.RandomState(6).rand(6, 7).astype(np.float32) * 2)
    src = imgs
    if cached:
        src = tr.build_prefix_cache(imgs)
        tr.text_prefix_cache  # noqa: B018  (built before the step, once)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn.flash3_fwd, tattn.flash3_bwd

    def cfwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def cbwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "flash3_fwd", cfwd)
        mp.setattr(tattn, "flash3_bwd", cbwd)
        loss, ok = tr.train_step(ttr, opt, src, tgts, np.arange(1, 6),
                                 Key.root(3).fold_in(0), perturb_type=kind,
                                 perturb_key=Key((42, 0)), batch_size=8,
                                 cached=cached)
    assert ok
    return loss, tadora.to_reference_names(ttr), calls


def test_cached_step_equals_the_full_tower_step(pair):
    """Dropout on: equal masks, so the loss and the post-AdamW adapters
    agree within 1e-5. The cached step runs 2 visual + 1 text blocks (3
    attention forwards, the text prefix built beforehand) instead of 3 + 3,
    and both run the attention backward once: the second visual suffix
    block's qkv depends on the first one's adapter; the text suffix block's
    qkv comes from the cache and needs no gradient."""
    full_loss, full_tr, full_calls = _step(pair, cached=False)
    loss, tr, calls = _step(pair, cached=True)
    assert abs(loss - full_loss) <= TOL * abs(full_loss)
    for k in full_tr:
        np.testing.assert_allclose(tr[k].detach().numpy(),
                                   full_tr[k].detach().numpy(), atol=TOL,
                                   rtol=0, err_msg=k)
    assert full_calls == {"fwd": 6, "bwd": 1}
    assert calls == {"fwd": 3, "bwd": 1}


@pytest.mark.parametrize("cached", [False, True])
def test_remat_step_gives_equal_bits(pair, cached):
    """Recomputed blocks rebuild their dropout generator from its key: the
    loss and every updated adapter are bit-identical. The recompute runs
    one more attention forward for each adapted block (2 visual + 1 text)."""
    loss, tr, calls = _step(pair, cached=cached)
    r_loss, r_tr, r_calls = _step(pair, cached=cached, remat=True)
    assert r_loss == loss
    for k in tr:
        assert torch.equal(r_tr[k], tr[k]), k
    assert r_calls == {"fwd": calls["fwd"] + 3, "bwd": 1}


@pytest.mark.parametrize("kind", ["random_target", "label_shuffle"])
def test_cached_step_takes_target_kinds(pair, kind):
    full_loss, _, _ = _step(pair, cached=False, kind=kind)
    loss, _, _ = _step(pair, cached=True, kind=kind)
    assert abs(loss - full_loss) <= TOL * abs(full_loss)


@pytest.mark.parametrize("kind", ["uniform_images", "image_noise"])
def test_cached_step_refuses_image_kinds(pair, kind):
    with pytest.raises(ValueError, match="replaces the input images"):
        _step(pair, cached=True, kind=kind)


def test_cache_chunks_eval_and_inference_agree(pair):
    """The cache built in chunks of 4 equals the one built whole; eval,
    RSA embeddings and chunked inference from the cache agree with the full
    tower within 1e-5; the text prefix is built once per trainer."""
    tr = _trainer(pair)
    ttr = tadora.make_trainable(pair["ttr"])
    imgs, tgts = tr.upload_dataset(
        pair["images_u8"],
        np.random.RandomState(7).rand(6, 7).astype(np.float32))
    cache = tr.build_prefix_cache(imgs)
    assert torch.equal(tr.build_prefix_cache(imgs, chunk=4), cache)
    assert tr.text_prefix_cache is tr.text_prefix_cache
    assert tr.suffix_sizes() == (N_VIS, N_TXT)
    full = tr.evaluate_resident(ttr, imgs, tgts, 6, 4)
    got = tr.evaluate_resident(ttr, imgs, tgts, 6, 4, cache=cache)
    assert abs(got - full) <= TOL * full
    a = tr.infer_in_chunks(ttr, imgs, 6, chunk=4)
    b = tr.infer_in_chunks(ttr, imgs, 6, chunk=4, cache=cache)
    assert a.shape == (6, 7)
    np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    rdm = np.random.RandomState(8).rand(6, 6).astype(np.float32)
    rdm = (rdm + rdm.T) / 2
    np.fill_diagonal(rdm, 0)
    _, _, _, e_full = tr.behavioral_rsa(ttr, imgs, torch.from_numpy(rdm))
    _, _, _, e_cached = tr.behavioral_rsa(ttr, imgs, torch.from_numpy(rdm),
                                          cache=cache)
    np.testing.assert_allclose(e_cached, e_full, atol=TOL, rtol=0)
