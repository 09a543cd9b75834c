"""The port's serving stack on the CPU: the bucketed engine (mirroring
tests/test_serve.py), the baked-DoRA CLIP-HBA engine against the JAX
package's adapted forward, the ViT classifier and feature engines against
the JAX engines, the HTTP daemon, the CLI (CLIP-HBA and ViT, int8, and the
AOT artifacts, as tests/test_serve_cli.py runs the JAX CLI), and the rule
that entry points run on the GPU unless told otherwise."""
import csv
import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu import serve as jserve
from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.ckpt import clip_ckpt as jckpt
from vit_project_tpu.ckpt import vit_ckpt as jvit_ckpt
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import convert as jconvert
from vit_project_tpu.models import vit as jvit
from vit_project_torch.cli import serve as tcli
from vit_project_torch.core.device import resolve_device
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.models import vit as tvit
from vit_project_torch.serve import (InferenceEngine, ServingDaemon,
                                     clip_hba_engine, vit_classifier_engine,
                                     vit_features_engine)

CFG = tclip.tiny_clip_config()
N_PROMPTS = 5


@pytest.fixture(scope="module")
def model():
    return tclip.init_clip_weights_(tclip.empty_clip(CFG, "cpu"),
                                    torch.Generator().manual_seed(0))


def _tokens(n=N_PROMPTS, seed=3):
    rs = np.random.RandomState(seed)
    return rs.randint(0, CFG.text.vocab_size,
                      (n, CFG.text.context_length)).astype(np.int32)


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    s = CFG.visual.image_size
    return rs.randn(n, s, s, 3).astype(np.float32)


def _engine(model, **kw):
    kw.setdefault("compute_dtype", torch.float32)   # exact vs the direct call
    kw.setdefault("device", "cpu")
    return clip_hba_engine(model, _tokens(), **kw)


def _direct(model, imgs):
    with torch.inference_mode():
        return tclip.clip_hba_forward(
            model, torch.from_numpy(imgs),
            torch.from_numpy(_tokens()).long()).numpy()


class TestBucketing:
    def test_padding_equivalence(self, model):
        """B between buckets pads up; outputs equal the unpadded forward."""
        eng = _engine(model, buckets=(4, 8))
        imgs = _images(5)
        got = eng(imgs)
        assert got.shape == (5, N_PROMPTS)
        np.testing.assert_allclose(got, _direct(model, imgs), rtol=1e-5,
                                   atol=1e-5)

    def test_chunking_above_max_bucket(self, model):
        """B > max bucket splits into max-bucket chunks (here 4+4+2->4)."""
        eng = _engine(model, buckets=(2, 4))
        imgs = _images(10)
        np.testing.assert_allclose(eng(imgs), _direct(model, imgs), rtol=1e-5,
                                   atol=1e-5)

    def test_many_sizes(self, model):
        eng = _engine(model, buckets=(4, 8))
        for n in (1, 3, 4, 7, 9):
            assert eng(_images(n)).shape == (n, N_PROMPTS)

    def test_warmup_runs_buckets(self, model):
        eng = _engine(model, buckets=(2, 4))
        eng.warmup((32, 32, 3))
        eng.warmup((32, 32, 3), buckets=(4,))

    def test_empty_batch_rejected(self, model):
        eng = _engine(model, buckets=(4,))
        with pytest.raises(ValueError, match="empty"):
            eng(_images(4)[:0])

    @pytest.mark.parametrize("buckets", [(), (0, 4)])
    def test_bad_buckets_rejected(self, buckets):
        with pytest.raises(ValueError, match="positive"):
            InferenceEngine(lambda m, x: x, torch.nn.Linear(1, 1),
                            buckets=buckets, device="cpu")

    def test_bf16_params_serving_close(self, model):
        """bf16 weights + bf16 compute (the serving default) stay close to
        f32 (scores ~ 14.3 x cosine; bf16 keeps ~3 decimal digits)."""
        f32 = _engine(model, buckets=(8,))
        bf16 = _engine(tclip.init_clip_weights_(
            tclip.empty_clip(CFG, "cpu"), torch.Generator().manual_seed(0)),
            buckets=(8,), compute_dtype=torch.bfloat16,
            param_dtype=torch.bfloat16)
        assert bf16.model.logit_scale.dtype == torch.bfloat16
        imgs = _images(6)
        a, b = f32(imgs), bf16(imgs)
        assert b.dtype == np.float32 and np.all(np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=0.1, atol=0.25)


class TestStreaming:
    def test_map_stream_matches_calls_in_order(self, model):
        eng = _engine(model, buckets=(2, 4))
        batches = [_images(3, seed=1), _images(9, seed=2), _images(1, seed=3),
                   _images(4, seed=4)]
        outs = list(eng.map_stream(iter(batches), depth=2))
        assert len(outs) == len(batches)
        for got, imgs in zip(outs, batches):
            np.testing.assert_allclose(got, eng(imgs), rtol=1e-5, atol=1e-5)

    def test_map_stream_depth_one(self, model):
        eng = _engine(model, buckets=(4,))
        outs = list(eng.map_stream([_images(2, seed=5), _images(6, seed=6)],
                                   depth=1))
        assert [o.shape[0] for o in outs] == [2, 6]

    def test_map_stream_bad_depth(self, model):
        eng = _engine(model, buckets=(4,))
        with pytest.raises(ValueError, match="depth"):
            list(eng.map_stream([_images(2)], depth=0))


def _jax_setup(r=4):
    jcfg = jclip.tiny_clip_config()
    params = jclip.init_clip_params(jax.random.PRNGKey(1), jcfg)
    spec = jadora.dora_spec(jcfg.visual.layers, jcfg.text.layers, 1, 1)
    trainable, static, acfg = jadora.apply_dora(
        params, spec, r=r, alpha=16, key=jax.random.PRNGKey(2))
    trainable = jax.tree_util.tree_map(lambda x: x + 0.01, trainable)
    return jcfg, params, spec, trainable, static, acfg


def _torch_tree(tree):
    return {t: {i: {k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in d.items()} for i, d in b.items()}
            for t, b in tree.items()}


def test_baked_engine_equals_jax_adapted_forward():
    """The port's engine (DoRA baked into the weights) == the JAX training
    forward with live adapters and dropout off, f32, scores atol 2e-4."""
    jcfg, params, _, trainable, static, acfg = _jax_setup()
    tokens = _tokens(6)
    imgs = _images(5, seed=7)
    sd = tconvert.clip_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), CFG)
    eng = clip_hba_engine(tconvert.clip_from_state_dict(sd, "cpu", CFG), tokens,
                          trainable=_torch_tree(trainable),
                          static=_torch_tree(static), alpha=16, r=4,
                          compute_dtype=torch.float32, buckets=(8,),
                          device="cpu")
    got = eng(imgs)
    want = np.asarray(jclip.clip_hba_forward(
        params, jnp.asarray(imgs), jnp.asarray(tokens), jcfg,
        adapters=jadora.assemble(trainable, static), adapter_cfg=acfg,
        deterministic=True, use_pallas=True))
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_trainable_without_static_rejected(model):
    with pytest.raises(ValueError, match="both"):
        clip_hba_engine(model, _tokens(), trainable={}, device="cpu")


class TestDeviceRule:
    """Entry points run on the GPU unless the caller passes device='cpu'."""

    @pytest.fixture(autouse=True)
    def no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_engine_without_device_raises(self, model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            clip_hba_engine(model, _tokens())

    def test_inference_engine_without_device_raises(self, model):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(lambda m, x: x, model)

    def test_cli_default_device_raises(self, tmp_path):
        args = tcli.parse_args(["--clip_weights", str(tmp_path / "w.pt"),
                                "--allow_hash_tokenizer", "--http_port", "0"])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.build_clip_engine(args)

    def test_cpu_when_asked(self):
        assert resolve_device("cpu") == torch.device("cpu")


def _post(port, arr, query=""):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict{query}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def test_daemon_answers_post(model):
    eng = _engine(model, buckets=(4, 8))
    daemon = ServingDaemon(eng, image_shape=(32, 32, 3), port=0).start()
    try:
        imgs = _images(3, seed=9)
        got = np.load(io.BytesIO(_post(daemon.port, imgs)))
        np.testing.assert_allclose(got, eng(imgs), rtol=1e-5, atol=1e-5)
        one = np.load(io.BytesIO(_post(daemon.port, imgs[0])))  # unbatched
        assert one.shape == (1, N_PROMPTS)
        assert b"predictions" in _post(daemon.port, imgs, "?topk=2")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{daemon.port}/v1/healthz", timeout=10) as r:
            assert b'"ok"' in r.read()
        assert daemon.batcher.dispatches == 3
    finally:
        daemon.shutdown()


def _write_files(tmp_path, r=4):
    """JAX-made tiny CLIP weights as an OpenAI-format .pt and adapters as
    the JAX package writes them."""
    jcfg, params, _, trainable, _, _ = _jax_setup(r)
    sd = jconvert.clip_state_dict_from_params(params, jcfg)
    wpath = str(tmp_path / "clip.pt")
    jconvert.save_torch_state_dict(wpath, sd)
    dpath = jckpt.save_dora_parameters(trainable, str(tmp_path / "dora"), 0)
    return wpath, dpath, jadora.count_trainable_parameters(trainable)


def test_build_clip_engine_from_files(tmp_path):
    wpath, dpath, n = _write_files(tmp_path)
    args = tcli.parse_args(["--clip_weights", wpath, "--dora_checkpoint", dpath,
                            "--rank", "4", "--vision_layers", "1",
                            "--transformer_layers", "1",
                            "--allow_hash_tokenizer", "--device", "cpu",
                            "--buckets", "4,8", "--http_port", "0"])
    eng, size, norm = tcli.build_clip_engine(args)
    assert eng.adapter_params == n and size == 32 and eng.buckets == (4, 8)
    assert eng.model.visual.proj.dtype == torch.bfloat16
    pre = tcli._http_preprocess(norm)
    raw = np.random.RandomState(1).randint(0, 256, (3, 32, 32, 3), np.uint8)
    got = eng(pre(raw))
    assert got.shape == (3, 66) and np.all(np.isfinite(got))
    # uint8 and [0, 1] float posts preprocess to the same input
    np.testing.assert_allclose(pre(raw), pre(raw.astype(np.float32) / 255),
                               atol=1e-6)


@pytest.mark.parametrize("layers,match", [(2, "missing adapters"),
                                          (0, "not covered by")])
def test_build_clip_engine_refuses_an_adapter_mismatch(tmp_path, layers,
                                                       match):
    """Serving bakes the adapters as export does: a block of the spec with
    no trained adapter, or a trained adapter outside the spec, is refused
    (the same check as cli/export_torch's, in the shared loader)."""
    wpath, dpath, _ = _write_files(tmp_path)
    args = tcli.parse_args(["--clip_weights", wpath, "--dora_checkpoint", dpath,
                            "--rank", "4", "--vision_layers", str(layers),
                            "--transformer_layers", "1",
                            "--allow_hash_tokenizer", "--device", "cpu",
                            "--buckets", "4", "--http_port", "0"])
    with pytest.raises(SystemExit, match=match):
        tcli.build_clip_engine(args)


def test_cli_batch_mode_writes_csv(tmp_path):
    from PIL import Image
    wpath, _, _ = _write_files(tmp_path)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (40, 50, 3), np.uint8)).save(
            img_dir / f"im{i}.png")
    out = tmp_path / "scores.csv"
    assert tcli.main(["--clip_weights", wpath, "--allow_hash_tokenizer",
                      "--device", "cpu", "--images", str(img_dir),
                      "--out", str(out), "--buckets", "2", "--topk", "3"]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("filename,top1_index,top1_score")
    assert [ln.split(",")[0] for ln in lines[1:]] == ["im0.png", "im1.png",
                                                       "im2.png"]


def test_cli_needs_clip_weights(capsys):
    with pytest.raises(SystemExit):
        tcli.parse_args(["--http_port", "0"])
    assert "--clip_weights" in capsys.readouterr().err


def test_hash_tokenizer_needs_opt_in(tmp_path, monkeypatch):
    wpath, _, _ = _write_files(tmp_path)
    args = tcli.parse_args(["--clip_weights", wpath, "--device", "cpu",
                            "--http_port", "0"])
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    with pytest.raises(SystemExit, match="BPE vocab"):
        tcli.build_clip_engine(args)


# -- the ViT engines against the JAX engines -------------------------------------

VIT_TINY = tvit.VIT_CONFIGS["test-tiny"]
IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.mark.parametrize("kind", ["logits", "token", "avg"])
def test_vit_engines_equal_jax(kind):
    """The same parameters, raw 0..255 images, f32: max |port - JAX| over
    max |JAX| within 1e-5 (the two packages sum in another order; measured
    1.2e-6 at most, on the avg pooling)."""
    jtiny = jvit.VIT_CONFIGS["test-tiny"]
    params = jvit.init_vit_params(jax.random.PRNGKey(0), jtiny)
    model = tconvert.vit_from_jax(params, VIT_TINY, "cpu")
    kw = dict(input_norm=IMAGENET_NORM, buckets=(4, 8))
    if kind == "logits":
        je = jserve.vit_classifier_engine(params, jtiny, use_pallas=True,
                                          compute_dtype=jnp.float32, **kw)
        te = vit_classifier_engine(model, compute_dtype=torch.float32,
                                   device="cpu", **kw)
    else:
        je = jserve.vit_features_engine(params, jtiny, pool=kind,
                                        use_pallas=True,
                                        compute_dtype=jnp.float32, **kw)
        te = vit_features_engine(model, pool=kind,
                                 compute_dtype=torch.float32, device="cpu",
                                 **kw)
    imgs = (np.random.RandomState(7).rand(5, 32, 32, 3) * 255).astype(
        np.float32)
    want, got = je(imgs), te(imgs)
    assert got.shape == want.shape == ((5, 10) if kind == "logits"
                                       else (5, 32))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_features_token_pooling_is_the_classifier_cls():
    model = tvit.init_vit_params(tvit.empty_vit(VIT_TINY, "cpu"),
                                 torch.Generator().manual_seed(1))
    feats = vit_features_engine(model, compute_dtype=torch.float32,
                                buckets=(4,), device="cpu")
    imgs = np.random.RandomState(2).rand(3, 32, 32, 3).astype(np.float32)
    with torch.inference_mode():
        tokens = tvit.vit_encode(model, torch.from_numpy(imgs))
    np.testing.assert_array_equal(feats(imgs), tokens[:, 0].numpy())


def test_vit_http_preprocess_takes_raw_pixels():
    pre = tcli._http_preprocess(None)
    raw = np.random.RandomState(1).randint(0, 256, (2, 8, 8, 3), np.uint8)
    np.testing.assert_array_equal(pre(raw), raw.astype(np.float32))
    np.testing.assert_allclose(pre(raw.astype(np.float32) / 255), raw,
                               atol=1e-4)


# -- the CLI: ViT, int8 and the AOT artifacts (tests/test_serve_cli.py) ---------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for sub in ("a", "b"):
        os.makedirs(root / sub)
    for i, sub in enumerate(["a", "a", "b", "b", "b"]):
        arr = rs.randint(0, 255, (48, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / sub / f"img{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def vit_checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX package's vit_ckpt."""
    out = str(tmp_path_factory.mktemp("ckpt"))
    params = jvit.init_vit_params(jax.random.PRNGKey(0),
                                  jvit.VIT_CONFIGS["test-tiny"])
    jvit_ckpt.save_checkpoint(0, params, {"momentum": None}, {}, 1.0, 1.0,
                              10.0, out)
    return os.path.join(out, "checkpoint_epoch_000.pth")


def _vit_flags(ckpt, *extra):
    return ["--model", "test-tiny", "--checkpoint", ckpt, "--device", "cpu",
            *extra]


def test_cli_vit_logits_csv(image_dir, vit_checkpoint, tmp_path):
    out = str(tmp_path / "preds.csv")
    assert tcli.main(["--images", image_dir, "--out", out,
                      *_vit_flags(vit_checkpoint, "--buckets", "4,8",
                                  "--param_dtype", "f32", "--topk",
                                  "3")]) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5
    assert rows[0]["filename"] == os.path.join("a", "img0.png")
    for r in rows:
        assert 0 <= int(r["top1_index"]) < VIT_TINY.num_classes
        assert (float(r["top1_score"]) >= float(r["top2_score"])
                >= float(r["top3_score"]))


def test_cli_vit_deterministic_across_runs(image_dir, vit_checkpoint,
                                           tmp_path):
    outs = []
    for name in ("p1.csv", "p2.csv"):
        out = str(tmp_path / name)
        tcli.main(["--images", image_dir, "--out", out,
                   *_vit_flags(vit_checkpoint, "--buckets", "8")])
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def test_cli_vit_features_npy(image_dir, vit_checkpoint, tmp_path):
    out = str(tmp_path / "emb.npy")
    assert tcli.main(["--images", image_dir, "--out", out, "--mode",
                      "features", *_vit_flags(vit_checkpoint, "--buckets",
                                              "8", "--param_dtype",
                                              "f32")]) == 0
    assert np.load(out).shape == (5, VIT_TINY.width)
    names = (tmp_path / "emb.filenames.txt").read_text().split()
    assert names[0] == os.path.join("a", "img0.png") and len(names) == 5


def test_cli_vit_random_init_and_int8(image_dir, tmp_path):
    out = str(tmp_path / "q.csv")
    assert tcli.main(["--images", image_dir, "--out", out, "--model",
                      "test-tiny", "--random_init", "--quantize", "int8",
                      "--device", "cpu", "--buckets", "8"]) == 0
    with open(out) as f:
        assert len(list(csv.DictReader(f))) == 5


@pytest.mark.parametrize("argv,msg", [
    (["--model", "test-tiny"], "--checkpoint"),
    (["--model", "nope", "--random_init"], "unknown --model"),
    (["--clip_weights", "w.pt", "--mode", "features"], "ViT surface"),
])
def test_cli_refuses_before_loading(argv, msg, capsys, tmp_path):
    with pytest.raises(SystemExit):
        tcli.parse_args(["--images", str(tmp_path), "--out", "x.csv",
                         *argv])
    assert msg in capsys.readouterr().err


def test_cli_empty_dir_refused(vit_checkpoint, tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no images"):
        tcli.main(["--images", str(empty), "--out", str(tmp_path / "x.csv"),
                   *_vit_flags(vit_checkpoint)])


@pytest.mark.parametrize("quantize", [[], ["--quantize", "int8"]])
def test_cli_export_then_serve_equals_live(image_dir, vit_checkpoint,
                                           tmp_path, quantize):
    """--export_dir writes the artifact; --from_export serves it and the
    predictions CSV equals the live engine's byte for byte (float and int8
    engines)."""
    base = _vit_flags(vit_checkpoint, "--buckets", "4,8", "--param_dtype",
                      "f32", *quantize)
    art = str(tmp_path / "artifact")
    assert tcli.main(["--export_dir", art, *base]) == 0
    with open(os.path.join(art, "manifest.json")) as f:
        m = json.load(f)
    assert m["model"] == "test-tiny" and m["normalize"] is None
    live = str(tmp_path / "live.csv")
    tcli.main(["--images", image_dir, "--out", live, *base])
    aot = str(tmp_path / "aot.csv")
    assert tcli.main(["--from_export", art, "--device", "cpu", "--images",
                      image_dir, "--out", aot]) == 0
    with open(aot) as f, open(live) as g:
        assert f.read() == g.read()


def test_cli_features_mode_pinned_by_manifest(image_dir, vit_checkpoint,
                                              tmp_path):
    art = str(tmp_path / "feat_art")
    tcli.main(["--export_dir", art, "--mode", "features",
               *_vit_flags(vit_checkpoint, "--buckets", "8")])
    out = str(tmp_path / "emb.npy")
    assert tcli.main(["--from_export", art, "--device", "cpu", "--images",
                      image_dir, "--out", out]) == 0
    assert np.load(out).shape == (5, VIT_TINY.width)


def test_cli_export_and_from_export_are_exclusive(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--export_dir", str(tmp_path / "a"),
                   "--from_export", str(tmp_path / "b")])
    assert "at most one" in capsys.readouterr().err


def test_cli_clip_export_normalize_rides_manifest(image_dir, tmp_path):
    """A CLIP-HBA artifact reproduces the live scores byte for byte: the
    normalize constants and the mode travel in the manifest, so
    --from_export needs none of the CLIP flags."""
    wpath, _, _ = _write_files(tmp_path)
    base = ["--clip_weights", wpath, "--buckets", "8", "--param_dtype",
            "f32", "--allow_hash_tokenizer", "--topk", "2", "--device", "cpu"]
    art = str(tmp_path / "clip_art")
    assert tcli.main(base + ["--export_dir", art]) == 0
    with open(os.path.join(art, "manifest.json")) as f:
        m = json.load(f)
    assert m["model"] == "clip_hba" and len(m["normalize"]) == 2
    live = str(tmp_path / "live.csv")
    tcli.main(base + ["--images", image_dir, "--out", live])
    aot = str(tmp_path / "aot.csv")
    assert tcli.main(["--from_export", art, "--device", "cpu", "--images",
                      image_dir, "--out", aot, "--topk", "2"]) == 0
    with open(aot) as f, open(live) as g:
        assert f.read() == g.read()


def test_cli_clip_int8_engine(tmp_path):
    wpath, dpath, _ = _write_files(tmp_path)
    args = tcli.parse_args(["--clip_weights", wpath, "--dora_checkpoint",
                            dpath, "--rank", "4", "--vision_layers", "1",
                            "--transformer_layers", "1",
                            "--allow_hash_tokenizer", "--device", "cpu",
                            "--buckets", "4", "--quantize", "int8",
                            "--http_port", "0"])
    eng, size, norm = tcli.build_clip_engine(args)
    blk = eng.model.visual.transformer.resblocks[1]
    assert blk.attn.out_proj.weight.s.dtype == torch.float32
    assert blk.attn.out_proj.bias.dtype == torch.bfloat16
    got = eng(tcli._http_preprocess(norm)(
        np.random.RandomState(1).randint(0, 256, (3, 32, 32, 3), np.uint8)))
    assert got.shape == (3, 66) and np.all(np.isfinite(got))
