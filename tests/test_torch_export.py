"""The port's AOT serving artifacts (serve/export.py, the JAX package's
tests/test_export.py cases) and cli/export_torch.py against the JAX
package's cli/export_torch.py on the same inputs, on the CPU."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.ckpt import clip_ckpt as jclip_ckpt
from vit_project_tpu.ckpt import vit_ckpt as jvit_ckpt
from vit_project_tpu.cli import export_torch as jxt
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import convert as jconvert
from vit_project_tpu.models import vit as jvit
from vit_project_torch.cli import export_torch as txt
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import vit as tvit
from vit_project_torch.ops import attention as tattn
from vit_project_torch.serve import export as sexport
from vit_project_torch.serve import (clip_hba_engine, vit_classifier_engine,
                                     vit_features_engine)

TINY = tvit.VIT_CONFIGS["test-tiny"]
SHAPE = (TINY.image_size, TINY.image_size, 3)
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _tiny_vit(seed=0):
    return tvit.init_vit_params(tvit.empty_vit(TINY, "cpu"),
                                torch.Generator().manual_seed(seed))


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, *SHAPE) * 255).astype(np.float32)


def _engine(ctor=vit_classifier_engine, **kw):
    kw.setdefault("compute_dtype", torch.float32)
    kw.setdefault("input_norm", NORM)
    return ctor(_tiny_vit(), device="cpu", **kw)


# -- the round trip -------------------------------------------------------------

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_outputs_equal_live_engine_bit_for_bit(tmp_path, quantize):
    live = _engine(buckets=(2, 4), quantize=quantize)
    d = str(tmp_path / "art")
    manifest = sexport.export_serving(live, SHAPE, d)
    assert manifest["buckets"] == [2, 4]
    aot = sexport.load_serving(d, device="cpu")
    assert aot.buckets == (2, 4)
    for n in (1, 2, 3, 4, 9):  # pad, exact, pad, exact, chunked
        imgs = _images(n, seed=n)
        np.testing.assert_array_equal(aot(imgs), live(imgs))


def test_features_and_bf16_artifacts_equal_live(tmp_path):
    for i, kw in enumerate((dict(ctor=vit_features_engine, pool="avg"),
                            dict(compute_dtype=torch.bfloat16,
                                 param_dtype=torch.bfloat16))):
        live = _engine(buckets=(4,), **kw)
        d = str(tmp_path / f"art{i}")
        sexport.export_serving(live, SHAPE, d)
        imgs = _images(3, seed=i)
        np.testing.assert_array_equal(
            sexport.load_serving(d, device="cpu")(imgs), live(imgs))


def test_map_stream_and_warmup(tmp_path):
    live = _engine(buckets=(2, 4))
    d = str(tmp_path / "art")
    sexport.export_serving(live, SHAPE, d)
    aot = sexport.load_serving(d, device="cpu")
    aot.warmup(SHAPE)
    batches = [_images(3, seed=1), _images(6, seed=2)]
    got = list(aot.map_stream(iter(batches)))
    assert len(got) == 2
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, live(b))


def test_artifact_layout(tmp_path):
    """One program per bucket, the weights once (params.pth), and the
    programs hold no weights: each is far smaller than a weight copy would
    make it at ViT-B/16 size, and equal across buckets."""
    d = str(tmp_path / "art")
    live = _engine(buckets=(2, 8))
    sexport.export_serving(live, SHAPE, d, extra={"mode": "logits"})
    assert sorted(os.listdir(d)) == ["bucket_00002.pt2", "bucket_00008.pt2",
                                     "manifest.json", "params.pth"]
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    assert m["format"] == "vit_project_torch.aot_serving/1"
    assert m["example_shape"] == list(SHAPE)
    assert m["input_dtype"] == "float32"
    assert m["platforms"] == ["cpu"]
    assert m["torch_version"] == torch.__version__ and m["mode"] == "logits"
    params = torch.load(os.path.join(d, "params.pth"), weights_only=True)
    want = dict(live.model.named_parameters())
    assert set(params) == set(want)
    for k, v in want.items():
        assert torch.equal(params[k], v.detach())
    sizes = {b: os.path.getsize(os.path.join(d, f"bucket_0000{b}.pt2"))
             for b in (2, 8)}
    assert sizes[2] == sizes[8]      # no example input stored either


def test_the_attention_is_one_node_of_the_program(tmp_path):
    """Each block's attention forward is the registered op: on the card it
    launches the kernel, on the CPU its plain version (which counts no
    launch)."""
    d = str(tmp_path / "art")
    sexport.export_serving(_engine(buckets=(2,), quantize="int8"), SHAPE, d)
    ep = torch.export.load(os.path.join(d, "bucket_00002.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count("vit_project_torch.flash3_fwd.default") \
        == TINY.layers
    assert targets.count("aten._int_mm.default") == 4 * TINY.layers
    tattn.reset_launch_counts()
    sexport.load_serving(d, device="cpu")(_images(2))
    assert tattn.LAUNCHES["flash3_fwd"] == 0


def test_flash3_fwd_meets_the_op_only_under_tracing(tmp_path, monkeypatch):
    """flash3_fwd asks whether a tracer holds its input: an eager serving
    call says no (on the card it then launches the kernel without the op's
    dispatch), the export's trace says yes (the op becomes the node)."""
    real = tattn._traced
    seen = []
    monkeypatch.setattr(tattn, "_traced",
                        lambda x: seen.append(real(x)) or seen[-1])
    eng = _engine(buckets=(2,))
    eng(_images(2))
    assert len(seen) == TINY.layers and not any(seen)
    seen.clear()
    sexport.export_serving(eng, SHAPE, str(tmp_path / "art"))
    assert len(seen) >= TINY.layers and all(seen)


def test_quantized_artifact_stores_int8_weights(tmp_path):
    d = str(tmp_path / "art")
    sexport.export_serving(_engine(buckets=(2,), quantize="int8"), SHAPE, d)
    params = torch.load(os.path.join(d, "params.pth"), weights_only=True)
    assert params["blocks.0.attn.qkv.weight.q"].dtype == torch.int8
    assert params["blocks.0.attn.qkv.weight.s"].dtype == torch.float32
    assert "blocks.0.attn.qkv.weight" not in params


def test_clip_artifact_equals_live(tmp_path):
    model = tclip.init_clip_weights_(tclip.empty_clip(
        tclip.tiny_clip_config(), "cpu"), torch.Generator().manual_seed(0))
    tokens = np.random.RandomState(3).randint(0, 512, (5, 16))
    live = clip_hba_engine(model, tokens, compute_dtype=torch.float32,
                           buckets=(4,), quantize="int8", device="cpu")
    d = str(tmp_path / "art")
    sexport.export_serving(live, SHAPE, d)
    imgs = np.random.RandomState(1).randn(3, *SHAPE).astype(np.float32)
    np.testing.assert_array_equal(sexport.load_serving(d, device="cpu")(imgs),
                                  live(imgs))


def test_input_dtype_is_enforced_by_cast(tmp_path):
    """A uint8 export: float requests are cast to the exported dtype."""
    live = _engine(buckets=(2,))
    d = str(tmp_path / "art")
    sexport.export_serving(live, SHAPE, d, input_dtype=np.uint8)
    aot = sexport.load_serving(d, device="cpu")
    imgs = _images(2).astype(np.uint8)
    np.testing.assert_array_equal(aot(imgs.astype(np.float32) + 0.25),
                                  live(imgs))


# -- refusals -------------------------------------------------------------------

@pytest.fixture
def artifact(tmp_path):
    d = str(tmp_path / "art")
    sexport.export_serving(_engine(buckets=(2,)), SHAPE, d)
    return d


def _edit_manifest(d, **kw):
    path = os.path.join(d, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m.update(kw)
    with open(path, "w") as f:
        json.dump(m, f)


def test_wrong_request_shape_refused(artifact):
    aot = sexport.load_serving(artifact, device="cpu")
    with pytest.raises(ValueError, match="exported example shape"):
        aot(np.zeros((2, 8, 8, 3), np.float32))


def test_non_artifact_dir_refused(tmp_path):
    d = tmp_path / "not_art"
    d.mkdir()
    with pytest.raises(ValueError, match="not an AOT serving artifact"):
        sexport.load_serving(str(d), device="cpu")
    (d / "manifest.json").write_text(json.dumps({"format": "something/else"}))
    with pytest.raises(ValueError, match="not an AOT serving artifact"):
        sexport.load_serving(str(d), device="cpu")


def test_device_mismatch_refused(artifact):
    _edit_manifest(artifact, platforms=["cuda"])
    with pytest.raises(ValueError, match="platform"):
        sexport.load_serving(artifact, device="cpu")


def test_jax_artifact_refused(artifact):
    _edit_manifest(artifact, format="vit_project_tpu.aot_serving/1",
                   platforms=["cpu"])
    with pytest.raises(ValueError, match="JAX package artifact"):
        sexport.load_serving(artifact, device="cpu")


def test_loading_defaults_to_the_card(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sexport.load_serving(artifact)


# -- cli/export_torch.py against the JAX package's ------------------------------

def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_export_torch_vit_equals_jax(tmp_path):
    """The timm state dict of one JAX-written checkpoint: equal names,
    shapes, dtypes and bits."""
    params = jvit.init_vit_params(jax.random.PRNGKey(2),
                                  jvit.VIT_CONFIGS["test-tiny"])
    jvit_ckpt.save_checkpoint(3, params, {"momentum": None},
                              {"last_epoch": 3}, 1.0, 2.0, 0.5,
                              str(tmp_path), sharded=False)
    ckpt = str(tmp_path / "checkpoint_epoch_003.pth")
    outs = {}
    for name, mod, extra in (("j", jxt, []), ("t", txt, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.pth")
        assert mod.main(["vit", "--checkpoint", ckpt, "--backbone",
                         "test-tiny", "--out", outs[name], *extra]) == 0
    want, got = _load(outs["j"]), _load(outs["t"])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _clip_run(tmp_path, trained_vision_layers=1):
    cfg = jclip.tiny_clip_config(width=64, layers=2, heads=1, patch=16,
                                 image_size=32, embed_dim=16, vocab=50,
                                 context=12)
    params = jclip.init_clip_params(jax.random.PRNGKey(0), cfg)
    base = str(tmp_path / "base_clip.pth")
    jconvert.save_torch_state_dict(
        base, jconvert.clip_state_dict_from_params(params, cfg))
    spec = jadora.dora_spec(cfg.visual.layers, cfg.text.layers,
                            trained_vision_layers, 1)
    trainable, _, _ = jadora.apply_dora(params, spec, r=2,
                                        key=jax.random.PRNGKey(1))
    trainable = jax.tree_util.tree_map(lambda x: x * 1.5 + 0.01, trainable)
    dora = jclip_ckpt.save_dora_parameters(trainable, str(tmp_path / "dora"),
                                           0)
    return base, dora


def test_export_torch_clip_equals_jax(tmp_path):
    """The baked OpenAI-format state dict: every unadapted tensor equal bit
    for bit; the two baked out_proj weights within 1e-6 (the DoRA weight m *
    colnorm(D + B A * alpha/r) takes column norms over f32 sums in another
    order; measured 1.1e-8). logit_scale keeps OpenAI's scalar shape [] where
    the JAX export writes [1] (load_state_dict takes either)."""
    base, dora = _clip_run(tmp_path)
    flags = ["--dora_checkpoint", dora, "--vision_layers", "1",
             "--transformer_layers", "1", "--rank", "2"]
    outs = {}
    for name, mod, extra in (("j", jxt, []), ("t", txt, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.pth")
        assert mod.main(["clip", "--clip_weights", base, "--out", outs[name],
                         *flags, *extra]) == 0
    want, got = _load(outs["j"]), _load(outs["t"])
    assert set(got) == set(want)
    baked = {"visual.transformer.resblocks.1.attn.out_proj.weight",
             "transformer.resblocks.1.attn.out_proj.weight"}
    assert got["logit_scale"].shape == () and want["logit_scale"].shape == (1,)
    got["logit_scale"] = got["logit_scale"].reshape(1)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        if k in baked:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)
            assert not torch.equal(got[k], _load(base)[k])   # it was baked
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layers,match", [(2, "missing adapters"),
                                          (0, "not covered by")])
def test_export_torch_clip_refuses_a_spec_mismatch(tmp_path, layers, match):
    base, dora = _clip_run(tmp_path)
    with pytest.raises(SystemExit, match=match):
        txt.main(["clip", "--clip_weights", base, "--dora_checkpoint", dora,
                  "--vision_layers", str(layers), "--transformer_layers",
                  "1", "--rank", "2", "--device", "cpu",
                  "--out", str(tmp_path / "x.pth")])


def test_export_torch_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, dora = _clip_run(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txt.main(["clip", "--clip_weights", base, "--dora_checkpoint", dora,
                  "--vision_layers", "1", "--rank", "2",
                  "--out", str(tmp_path / "x.pth")])

