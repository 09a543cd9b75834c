"""The port's serving stack on the CPU: the bucketed engine (mirroring
tests/test_serve.py), the baked-DoRA CLIP-HBA engine against the JAX
package's adapted forward, the HTTP daemon, the CLI's engine build from
files, and the rule that entry points run on the GPU unless told otherwise."""
import io
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.adapters import dora as jadora
from vit_project_tpu.ckpt import clip_ckpt as jckpt
from vit_project_tpu.models import clip as jclip
from vit_project_tpu.models import convert as jconvert
from vit_project_torch.cli import serve as tcli
from vit_project_torch.core.device import resolve_device
from vit_project_torch.models import clip as tclip
from vit_project_torch.models import convert as tconvert
from vit_project_torch.serve import (InferenceEngine, ServingDaemon,
                                     clip_hba_engine)

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


@pytest.mark.parametrize("extra,msg", [
    (["--quantize", "int8"], "--quantize"),
    (["--model", "vit_base_patch16_224"], "ViT"),
    (["--export_dir", "x"], "AOT export"),
    (["--from_export", "x"], "AOT export"),
])
def test_cli_refuses_unported_modes(extra, msg, capsys):
    with pytest.raises(SystemExit):
        tcli.parse_args(["--clip_weights", "w.pt", "--http_port", "0", *extra])
    assert msg in capsys.readouterr().err


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
