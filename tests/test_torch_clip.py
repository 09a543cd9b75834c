"""The port's ops, DoRA, weights bridge and CLIP-HBA forward against the JAX
package, plus the port's import boundary.

Inputs and weights are drawn once (numpy or JAX keys) and handed to both
packages; JAX runs with jax_default_matmul_precision="highest"
(tests/conftest.py) and, for attention, the Pallas kernel in interpret mode
(use_pallas=True)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.ckpt import clip_ckpt as jckpt
from vit_project_tpu.data import imagenet as jimagenet
from vit_project_tpu.data import spose66 as jspose
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import convert as jconvert
from vit_project_tpu.models import tokenizer as jtok
from vit_project_tpu.ops import dora as jdora
from vit_project_tpu.ops import nn as jnn
from vit_project_torch.adapters import dora as tadora
from vit_project_torch.ckpt import clip_ckpt as tckpt
from vit_project_torch.data import imagenet as timagenet
from vit_project_torch.data import spose66 as tspose
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import tokenizer as ttok
from vit_project_torch.ops import dora as tdora
from vit_project_torch.ops import nn as tnn

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "vit_project_torch"
RS = np.random.RandomState(0)


def _np(*shape):
    return RS.randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- ops/nn.py ----------------------------------------------------------------

class TestOps:
    @pytest.mark.parametrize("bias", [True, False])
    def test_dense(self, bias):
        x, w, b = _np(3, 5, 8), _np(8, 6), _np(6)
        want = jnn.dense(jnp.asarray(x), jnp.asarray(w),
                         jnp.asarray(b) if bias else None)
        got = tnn.dense(_t(x), _t(w), _t(b) if bias else None)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_layer_norm(self):
        x, s, b = 3 * _np(4, 7, 16) + 1, _np(16), _np(16)
        want = jnn.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
        got = tnn.layer_norm(_t(x), _t(s), _t(b))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_layer_norm_keeps_bf16(self):
        x = _t(_np(2, 16)).to(torch.bfloat16)
        y = tnn.layer_norm(x, torch.ones(16), torch.zeros(16))
        assert y.dtype == torch.bfloat16

    def test_quick_gelu(self):
        x = 4 * _np(50)
        np.testing.assert_allclose(tnn.quick_gelu(_t(x)).numpy(),
                                   jnn.quick_gelu(jnp.asarray(x)),
                                   atol=1e-6, rtol=1e-6)

    def test_mlp(self):
        x, w1, b1, w2, b2 = _np(2, 3, 8), _np(8, 32), _np(32), _np(32, 8), _np(8)
        p = {"fc1_w": w1, "fc1_b": b1, "fc2_w": w2, "fc2_b": b2}
        want = jnn.mlp(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
                       act=jnn.quick_gelu)
        got = tnn.mlp(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)

    def test_patch_embed(self):
        imgs, w = _np(2, 32, 48, 3), _np(8 * 8 * 3, 12)
        want = jnn.patch_embed(jnp.asarray(imgs), jnp.asarray(w), None, 8)
        got = tnn.patch_embed(_t(imgs), _t(w), None, 8)
        assert got.shape == (2, 4 * 6, 12)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_patch_matrix_round_trip(self):
        k = _np(12, 3, 8, 8)
        mat = jnn.conv_kernel_to_patch_matrix(k)
        np.testing.assert_array_equal(
            tnn.conv_kernel_to_patch_matrix(torch.from_numpy(k)).numpy(), mat)
        np.testing.assert_array_equal(
            tconvert.patch_matrix_to_conv_kernel(mat, 8), k)


# -- DoRA ---------------------------------------------------------------------

def _tiny_jax_clip(seed=1, cfg=None):
    cfg = cfg or jclip.tiny_clip_config()
    return cfg, jclip.init_clip_params(jax.random.PRNGKey(seed), cfg)


def _port_model(jparams, cfg=None):
    cfg = cfg or tclip.tiny_clip_config()
    sd = tconvert.clip_state_dict_from_jax_params(_tree_np(jparams), cfg)
    return tconvert.clip_from_state_dict(sd, "cpu", cfg)


def _jax_adapters(params, cfg, r=4, seed=2):
    spec = jadora.dora_spec(cfg.visual.layers, cfg.text.layers, 1, 1)
    trainable, static, acfg = jadora.apply_dora(
        params, spec, r=r, alpha=16, key=jax.random.PRNGKey(seed))
    # move the adapters away from init so the bake is not trivial
    trainable = jax.tree_util.tree_map(lambda x: x + 0.01, trainable)
    return spec, trainable, static, acfg


def _to_torch_tree(tree):
    return {t: {i: {k: _t(v) for k, v in d.items()} for i, d in blocks.items()}
            for t, blocks in tree.items()}


class TestDora:
    def test_dora_weight_matches_jax(self):
        w = _np(16, 8)
        tr, buf = jdora.dora_init(jax.random.PRNGKey(0), jnp.asarray(w), r=4)
        want = jdora.dora_weight(tr, buf["D"], alpha=16, r=4)
        got = tdora.dora_weight({k: _t(v) for k, v in tr.items()},
                                _t(buf["D"]), alpha=16, r=4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)

    def test_dora_init_decomposes_like_jax(self):
        w = _np(16, 8)
        w[:, 3] = 0.0   # a pruned column stays finite
        tr, buf = tdora.dora_init(torch.Generator().manual_seed(0), _t(w), r=4)
        jtr, jbuf = jdora.dora_init(jax.random.PRNGKey(0), jnp.asarray(w), r=4)
        np.testing.assert_allclose(tr["m"].numpy(), jtr["m"], rtol=1e-6)
        np.testing.assert_allclose(buf["D"].numpy(), jbuf["D"], atol=1e-7)
        assert tr["delta_D_A"].shape == (4, 8)
        assert tr["delta_D_B"].shape == (16, 4)
        bound = 1 / 8 ** 0.5    # kaiming-uniform(a=sqrt(5)) on [r, out]
        assert float(tr["delta_D_A"].abs().max()) <= bound

    def test_bake_matches_jax_bake(self):
        cfg, params = _tiny_jax_clip()
        _, trainable, static, _ = _jax_adapters(params, cfg)
        baked = jadora.bake(params, trainable, static, alpha=16, r=4)
        model = _port_model(params)
        tadora.bake(model, _to_torch_tree(trainable), _to_torch_tree(static),
                    alpha=16, r=4)
        for tower, blocks in (("visual", model.visual.transformer.resblocks),
                              ("text", model.transformer.resblocks)):
            jblocks = baked[tower]["blocks"]
            for i, blk in enumerate(blocks):
                np.testing.assert_allclose(
                    blk.attn.out_proj.weight.detach().numpy().T,
                    jblocks[i]["out_w"], atol=1e-6, rtol=1e-5)
                np.testing.assert_allclose(
                    blk.attn.out_proj.bias.detach().numpy(),
                    jblocks[i]["out_b"], atol=1e-7)

    def test_vit_l14_rank32_count(self):
        """183,040 adapter parameters at CLIP_VIT_L14 widths, rank 32, on the
        last 2 image blocks and the last text block (depth cut to those
        blocks: the count depends on widths only)."""
        c = tclip.CLIP_VIT_L14
        cfg = dataclasses.replace(
            c, visual=dataclasses.replace(c.visual, layers=2),
            text=dataclasses.replace(c.text, layers=1))
        model = tclip.empty_clip(cfg, "cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(0.5)
        spec = tadora.dora_spec(2, 1, 2, 1)
        trainable, static, acfg = tadora.apply_dora(
            model, spec, r=32, generator=torch.Generator().manual_seed(0))
        assert tadora.count_trainable_parameters(trainable) == 183040
        assert acfg == {"r": 32, "alpha": 16, "dropout": 0.1}
        assert sorted(static["visual"]) == [0, 1] and list(static["text"]) == [0]

    def test_reference_names_round_trip_and_torn(self):
        spec = {"visual": [1], "text": [0]}
        tr = {"visual": {1: {"m": torch.ones(3), "delta_D_A": torch.ones(2, 3),
                             "delta_D_B": torch.ones(3, 2)}}, "text": {}}
        flat = tadora.to_reference_names(tr)
        assert set(flat) == set(jadora.to_reference_names(
            _tree_np({"visual": {1: {k: v.numpy() for k, v in
                                     tr["visual"][1].items()}}})))
        back = tadora.from_reference_names(flat, spec)
        assert back["text"] == {} and set(back["visual"][1]) == {
            "m", "delta_D_A", "delta_D_B"}
        del flat["clip_model.visual.transformer.resblocks.1.attn.out_proj.m"]
        with pytest.raises(ValueError, match="torn"):
            tadora.from_reference_names(flat, spec)

    def test_load_dora_file_written_by_jax(self, tmp_path):
        """The JAX package's adapter checkpoint loads into the port."""
        cfg, params = _tiny_jax_clip()
        spec, trainable, static, _ = _jax_adapters(params, cfg)
        path = jckpt.save_dora_parameters(trainable, str(tmp_path), 0)
        model = _port_model(params)
        init, _, _ = tadora.apply_dora(model, spec, r=4,
                                       generator=torch.Generator())
        loaded = tckpt.load_dora_parameters(path, init, spec)
        for tower in ("visual", "text"):
            for i, d in trainable[tower].items():
                for k, v in d.items():
                    np.testing.assert_array_equal(loaded[tower][i][k].numpy(),
                                                  np.asarray(v))

    def test_load_dora_strict_refuses_what_a_resume_overlays(self, tmp_path):
        """strict=True (a bake) takes a file that matches the spec as the
        resume does, and refuses a spec block the file lacks or a file
        adapter outside the spec, which the resume's overlay lets pass."""
        cfg, params = _tiny_jax_clip()
        spec, trainable, _, _ = _jax_adapters(params, cfg)
        path = jckpt.save_dora_parameters(trainable, str(tmp_path), 0)

        def init(s):
            return tadora.apply_dora(_port_model(params), s, r=4,
                                     generator=torch.Generator())[0]
        lenient = tckpt.load_dora_parameters(path, init(spec), spec)
        strict = tckpt.load_dora_parameters(path, init(spec), spec,
                                            strict=True)
        for tower in ("visual", "text"):
            for i, d in lenient[tower].items():
                for k, v in d.items():
                    assert torch.equal(strict[tower][i][k], v)
        wide = tadora.dora_spec(cfg.visual.layers, cfg.text.layers, 2, 1)
        narrow = tadora.dora_spec(cfg.visual.layers, cfg.text.layers, 0, 1)
        for s, match in ((wide, "missing adapters"),
                         (narrow, "not covered by")):
            tckpt.load_dora_parameters(path, init(s), s)       # the resume
            with pytest.raises(ValueError, match=match):
                tckpt.load_dora_parameters(path, init(s), s, strict=True)


# -- weights bridge -----------------------------------------------------------

class TestConvert:
    def test_state_dict_matches_jax_exporter(self):
        cfg, params = _tiny_jax_clip()
        want = jconvert.clip_state_dict_from_params(params, cfg)
        got = tconvert.clip_state_dict_from_jax_params(_tree_np(params),
                                                       tclip.tiny_clip_config())
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])

    def test_module_names_are_openai_names(self):
        cfg, params = _tiny_jax_clip()
        want = jconvert.clip_state_dict_from_params(params, cfg)
        model = tclip.empty_clip(tclip.tiny_clip_config(), "cpu")
        assert set(model.state_dict()) == set(want)

    def test_config_inference(self):
        """heads = width / 64, as OpenAI's build_model infers them."""
        jcfg = jclip.tiny_clip_config(width=128, heads=2)
        _, params = _tiny_jax_clip(cfg=jcfg)
        tcfg = tclip.tiny_clip_config(width=128, heads=2)
        sd = tconvert.clip_state_dict_from_jax_params(_tree_np(params), tcfg)
        assert tconvert.clip_config_from_state_dict(sd) == tcfg

    @pytest.mark.parametrize("name", [
        n for n, c in jclip.CLIP_CONFIGS.items()
        if isinstance(c.visual, jclip.ViTConfig)])
    def test_vit_backbone_presets_match_jax(self, name, monkeypatch):
        """Every ViT backbone the JAX package names resolves in the port
        with JAX's widths, heads and embed_dim, and the port's model (built
        on the meta device) has the parameter shapes of JAX's
        init_clip_params (jax.eval_shape) under the converter's names. No
        weights are allocated: the converter reads zero-stride arrays and
        returns meta tensors."""
        jcfg, tcfg = jclip.CLIP_CONFIGS[name], tclip.CLIP_CONFIGS[name]
        for j, t in ((jcfg.visual, tcfg.visual), (jcfg.text, tcfg.text)):
            common = ({f.name for f in dataclasses.fields(j)} &
                      {f.name for f in dataclasses.fields(t)})
            assert {f: getattr(t, f) for f in common} == \
                {f: getattr(j, f) for f in common}
        assert tcfg.embed_dim == jcfg.embed_dim
        shapes = jax.eval_shape(lambda k: jclip.init_clip_params(k, jcfg),
                                jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
            shapes)
        monkeypatch.setattr(tconvert, "_t", lambda x: torch.empty(
            np.shape(np.asarray(x)), device="meta"))
        want = {k: tuple(v.shape) for k, v in
                tconvert.clip_state_dict_from_jax_params(tree, tcfg).items()}
        with torch.device("meta"):
            model = tclip.CLIP(tcfg)
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
            == want

    def test_strict_load_refuses_missing_keys(self):
        cfg, params = _tiny_jax_clip()
        sd = tconvert.clip_state_dict_from_jax_params(
            _tree_np(params), tclip.tiny_clip_config())
        del sd["visual.proj"]
        with pytest.raises((RuntimeError, ValueError)):
            tconvert.clip_from_state_dict(sd, "cpu", tclip.tiny_clip_config())

    def test_load_torch_state_dict_drops_archive_metadata(self, tmp_path):
        sd = {"a": torch.ones(2, dtype=torch.float16),
              "context_length": torch.tensor(77)}
        torch.save(sd, tmp_path / "w.pt")
        got = tconvert.load_torch_state_dict(str(tmp_path / "w.pt"))
        assert list(got) == ["a"] and got["a"].dtype == torch.float32


# -- the forward --------------------------------------------------------------

class TestClipForward:
    @pytest.fixture(scope="class")
    def pair(self):
        cfg, params = _tiny_jax_clip(seed=3)
        rs = np.random.RandomState(4)
        imgs = rs.randn(3, 32, 32, 3).astype(np.float32)
        tokens = rs.randint(0, cfg.text.vocab_size,
                            (6, cfg.text.context_length)).astype(np.int32)
        return cfg, params, _port_model(params), imgs, tokens

    def test_encode_image(self, pair):
        cfg, params, model, imgs, _ = pair
        want = jclip.encode_image(params, jnp.asarray(imgs), cfg,
                                  use_pallas=True)
        with torch.inference_mode():
            got = tclip.encode_image(model, torch.from_numpy(imgs))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)

    def test_encode_text(self, pair):
        cfg, params, model, _, tokens = pair
        want = jclip.encode_text(params, jnp.asarray(tokens), cfg,
                                 use_pallas=True)
        with torch.inference_mode():
            got = tclip.encode_text(model, torch.from_numpy(tokens).long())
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)

    def test_clip_hba_forward(self, pair):
        """[B, n_prompts] scores, f32, atol 1e-4: the logit scale (~14.3)
        amplifies the cosine error."""
        cfg, params, model, imgs, tokens = pair
        want = jclip.clip_hba_forward(params, jnp.asarray(imgs),
                                      jnp.asarray(tokens), cfg,
                                      use_pallas=True)
        with torch.inference_mode():
            got = tclip.clip_hba_forward(model, torch.from_numpy(imgs),
                                         torch.from_numpy(tokens).long())
        assert got.shape == (3, 6)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    def test_init_weights_are_seeded(self):
        cfg = tclip.tiny_clip_config()
        a, b = (tclip.init_clip_weights_(tclip.empty_clip(cfg, "cpu"),
                                         torch.Generator().manual_seed(7))
                for _ in range(2))
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(x, y), k
        assert float(a.logit_scale.detach()) == pytest.approx(np.log(1 / 0.07))


# -- copied data modules ------------------------------------------------------

def test_tokenizer_and_prompts_match_jax():
    assert tspose.SPOSE_DIMENSIONS_66 == jspose.SPOSE_DIMENSIONS_66
    for ctx, trunc in ((77, False), (8, True)):
        np.testing.assert_array_equal(
            ttok.tokenize(tspose.SPOSE_DIMENSIONS_66, context_length=ctx,
                          truncate=trunc),
            jtok.tokenize(jspose.SPOSE_DIMENSIONS_66, context_length=ctx,
                          truncate=trunc))


def test_resize_center_crop_matches_jax():
    from PIL import Image
    img = Image.fromarray(
        np.random.RandomState(2).randint(0, 256, (50, 70, 3), np.uint8))
    for size in (32, 300):
        np.testing.assert_array_equal(
            np.asarray(timagenet.resize_center_crop(img, size)),
            np.asarray(jimagenet.resize_center_crop(img, size)))


# -- import boundary ----------------------------------------------------------

def _port_modules():
    return sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)


def test_port_source_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "vit_project_tpu")
    names = {p.relative_to(PORT).as_posix() for p in _port_modules()}
    assert {"train/multi_fork.py", "core/hostcopy.py", "data/fastimage.py",
            "cli/pack.py", "cli/vit_rsa_eval.py", "cli/vit_measure.py",
            "analysis/figs.py", "analysis/parity.py",
            "analysis/manifest.py", "ops/quant.py", "serve/export.py",
            "cli/export_torch.py", "cli/serve.py", "serve/engine.py",
            "core/profiling.py", "models/convert.py",
            "data/things.py", "parallel/__init__.py", "parallel/dist.py",
            "parallel/mesh.py", "train/clip_loop.py", "cli/baseline.py",
            "cli/sweep.py", "cli/lengths.py",
            "perturb/injectors.py", "models/vit.py", "train/vit_loop.py",
            "cli/vit_train.py", "ckpt/serialization.py", "ckpt/vit_ckpt.py",
            "core/configs.py", "ops/moe.py"} <= names
    for path in _port_modules() + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: imports {n}"


def test_importing_every_port_module_loads_no_jax():
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _port_modules()]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vit_project_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
