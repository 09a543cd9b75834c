"""The port's reader and writer of the JAX package's `.orbax` checkpoints:
``ckpt/zstd.py`` (the from-scratch zstd decoder, ``csrc/zstd_decode.cpp``)
and ``ckpt/orbax.py`` (OCDBT, zarr v2 and the tree), routed by
``ckpt/vit_ckpt.py``.

The decoder is held against the host's ``libzstd.so.1`` (through ctypes, in
this file only: the package never loads it) at several levels, with and
without the checksum, over concatenated and skippable frames, and must raise
on flipped and truncated input. The reader is held against the JAX
package's own restore of what it wrote: from one process, from a tree
sharded into several chunks over the 8-device CPU mesh, and from two
``jax.distributed`` processes (one launch of this file's ``__main__`` as
each process, shared by the tests). The JAX package reads what
``write_tree`` writes, and a resume from a JAX-written `.orbax` equals the
resume from the `.pth` of the same state.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_orbax.py
    python tests/test_torch_orbax.py throughput   # decoder MB/s here
    JAX_PLATFORMS=cpu python tests/test_torch_orbax.py fixture
        # rewrites the committed JAX-written fixture, tests/data/jax_vit_orbax
"""
import ctypes
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO_PROCESS_TIMEOUT = 240


# ------------------------------------------------------------ libzstd oracle

class _LibZstd:
    """Compression through the host's libzstd (the decoder's oracle)."""

    LEVEL, WINDOW_LOG, LDM = 100, 101, 160
    CONTENT_SIZE, CHECKSUM = 200, 201

    def __init__(self):
        lib = ctypes.CDLL("libzstd.so.1")
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
        lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_size_t, ctypes.c_void_p,
                                       ctypes.c_size_t]
        lib.ZSTD_compress2.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        self.lib = lib

    def compress(self, data: bytes, level: int, checksum: bool = False,
                 content_size: bool = True, window_log: int = 0,
                 long: bool = False) -> bytes:
        lib = self.lib
        cctx = lib.ZSTD_createCCtx()
        try:
            for param, value in ((self.LEVEL, level),
                                 (self.CHECKSUM, int(checksum)),
                                 (self.CONTENT_SIZE, int(content_size)),
                                 (self.WINDOW_LOG, window_log),
                                 (self.LDM, int(long))):
                assert not lib.ZSTD_isError(
                    lib.ZSTD_CCtx_setParameter(cctx, param, value))
            cap = lib.ZSTD_compressBound(len(data))
            out = ctypes.create_string_buffer(cap)
            n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
            assert not lib.ZSTD_isError(n)
            return out.raw[:n]
        finally:
            lib.ZSTD_freeCCtx(cctx)

    def decompress(self, data: bytes, size: int) -> bytes:
        out = ctypes.create_string_buffer(max(size, 1))
        n = self.lib.ZSTD_decompress(out, size, data, len(data))
        assert not self.lib.ZSTD_isError(n)
        return out.raw[:n]


@pytest.fixture(scope="module")
def libzstd():
    return _LibZstd()


def _corpus(scale=1.0):
    rng = np.random.default_rng(0)
    n = lambda k: int(k * scale)                       # noqa: E731
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(300)]
    block = rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()
    return {
        "empty": b"",
        "small": b"abc",
        "zeros": bytes(n(1 << 20)),
        "text": b"".join(b"the quick brown fox %d jumps over the lazy dog\n"
                         % (i % 97) for i in range(n(6000))),
        "words": b" ".join(words[i] for i in rng.integers(0, 300, n(60_000))),
        "weights": (rng.standard_normal(n(600_000)) * 0.02).astype(
            np.float32).tobytes(),
        "ints": np.arange(n(100_000), dtype=np.int64).tobytes(),
        "zipf": rng.zipf(1.3, n(300_000)).clip(0, 255).astype(
            np.uint8).tobytes(),
        "few_symbols": rng.integers(0, 12, n(300_000)).astype(
            np.uint8).tobytes(),
        "random": rng.integers(0, 256, n(200_000), dtype=np.uint8).tobytes(),
        # a random block, then pieces of it each after one 0xff byte: the
        # later blocks' literals are that byte alone
        "one_literal": block + b"".join(
            b"\xff" + block[o:o + 32]
            for o in rng.integers(0, len(block) - 32, n(6000)).tolist()),
    }


LEVELS = (1, 3, 9, 19)
SHORT_AT_19 = 320_000        # the slowest level on the inputs' first bytes
# (checksum, content size); without the content size the frame carries a
# window descriptor
FRAME_FLAGS = ((False, True), (True, False), (True, True))


@pytest.fixture(scope="module")
def frames(libzstd):
    """{(level, name, checksum, content size): (frame, data)} over the
    corpus, compressed once for the module."""
    out = {}
    for name, data in _corpus().items():
        for level in LEVELS:
            d = data[:SHORT_AT_19] if level == 19 else data
            for checksum, content_size in FRAME_FLAGS:
                out[level, name, checksum, content_size] = (
                    libzstd.compress(d, level, checksum, content_size), d)
    return out


def _zstd():
    from vit_project_torch.ckpt import zstd
    return zstd


def test_decoder_is_built_by_the_host_compiler(monkeypatch, tmp_path):
    """g++ -O3 -std=c++17 -fPIC -shared into the build directory, named by
    the source's hash; four builds at once each rename a whole library into
    place; without g++ the build raises (no other decoder is used)."""
    import threading
    from vit_project_torch.ops import cuda_build
    cmd = cuda_build.gxx_command("g++", "zstd_decode", tmp_path / "l.so")
    assert cmd[1:5] == ["-O3", "-std=c++17", "-fPIC", "-shared"]
    assert cmd[-1] == str(cuda_build.CSRC_DIR / "zstd_decode.cpp")
    p = cuda_build.library_path("zstd_decode")
    assert p.parent == cuda_build.BUILD_DIR and p.name.startswith(
        "libzstd_decode-")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        cuda_build.build(["zstd_decode"])["zstd_decode"])) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 4 and len(set(got)) == 1
    left = os.listdir(tmp_path / "build")
    assert got[0].name in left and not any(f.endswith(".tmp") for f in left)
    lib = ctypes.CDLL(str(got[0]))
    assert lib.vp_zstd_error_name
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "other")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        cuda_build.build(["zstd_decode"])


@pytest.mark.parametrize("level", LEVELS)
def test_decoder_equals_libzstd(frames, level):
    """Every corpus entry at the level, with and without the checksum and
    the content size."""
    zstd = _zstd()
    zstd.take_stats()
    for (lvl, name, checksum, content_size), (frame, data) in frames.items():
        if lvl != level:
            continue
        assert zstd.decompress(frame) == data, (name, checksum)
        assert zstd.content_size(frame) == (len(data) if content_size
                                            else None)
    met = zstd.take_stats()
    assert met["checksum"] > 0 and met["compressed_block"] > 0


def test_corpus_reaches_every_form(frames):
    """Over the levels the corpus reaches every block type, literals form,
    Huffman weights form and sequence table mode."""
    zstd = _zstd()
    zstd.take_stats()
    for frame, data in frames.values():
        assert zstd.decompress(frame) == data
    met = zstd.take_stats()
    for key in zstd.STAT_NAMES:
        if key != "skippable_frame":
            assert met[key] > 0, (key, met)


def test_decoder_long_window(libzstd):
    """A windowed frame whose matches reach 2 MiB back (long-distance
    matching; libzstd fits the window to the input: 4 MiB), and a 4 MiB
    input in 32 blocks."""
    zstd = _zstd()
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    data = a + b + a + b[:1000]
    frame = libzstd.compress(data, 9, checksum=True, content_size=False,
                             window_log=23, long=True)
    assert len(frame) < len(a) + len(b) + 50_000   # the repeat was matched
    assert frame[4] & 0x20 == 0 and frame[5] >> 3 == 12   # a 4 MiB window
    assert zstd.decompress(frame) == data
    big = (rng.standard_normal(1 << 20) * 0.02).astype(np.float32).tobytes()
    assert zstd.decompress(libzstd.compress(big, 1, checksum=True)) == big


def test_concatenated_and_skippable_frames(libzstd):
    zstd = _zstd()
    corpus = _corpus(0.5)
    parts = [corpus["text"], corpus["weights"][:100_000], b"", b"x"]
    frames = [libzstd.compress(p, lvl, checksum=bool(i % 2))
              for i, (p, lvl) in enumerate(zip(parts, (1, 3, 9, 19)))]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"hello"
    stream = frames[0] + skip + frames[1] + frames[2] + skip + frames[3]
    zstd.take_stats()
    assert zstd.decompress(stream) == b"".join(parts)
    assert zstd.take_stats()["skippable_frame"] == 2
    assert zstd.content_size(stream) == sum(map(len, parts))
    assert zstd.decompress(skip) == b""
    # the port's Raw-block frames (write_tree's) are zstd libzstd reads
    for data in (b"", b"q", corpus["weights"][:300_001]):
        raw = b"".join(zstd.raw_frame_parts(data))
        assert libzstd.decompress(raw, len(data)) == data
        assert zstd.decompress(raw) == data


def test_checksum_over_every_tail_length(libzstd):
    """The from-scratch XXH64 against libzstd's frame checksums at every
    length class of the hash's tail and stripes; a wrong checksum
    raises."""
    zstd = _zstd()
    data = bytes(range(256)) * 4
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 100, 1000):
        frame = libzstd.compress(data[:n], 3, checksum=True)
        assert zstd.decompress(frame) == data[:n]
        bad = frame[:-4] + bytes(b ^ 1 for b in frame[-4:])
        with pytest.raises(zstd.ZstdError, match="checksum"):
            zstd.decompress(bad)


def test_malformed_frames_raise(libzstd):
    """Truncated frames, flipped bytes in checksummed frames, a bad magic
    and a dictionary ID raise ZstdError with the frame's offset; random
    damage elsewhere raises or decodes, and never crashes."""
    zstd = _zstd()
    rng = np.random.default_rng(7)
    corpus = _corpus(0.2)
    frames = [libzstd.compress(d, lvl, checksum=True)
              for d in (corpus["text"][:60_000], corpus["weights"][:80_000],
                        corpus["few_symbols"][:40_000])
              for lvl in (1, 19)]
    for frame in frames:
        for cut in sorted(set(rng.integers(1, len(frame), 40).tolist())):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(frame[:cut])
        # past the frame header (magic, descriptor, window, content size)
        for at in rng.integers(14, len(frame), 40).tolist():
            bad = bytearray(frame)
            bad[at] ^= 0xFF
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(bad))
    lead = libzstd.compress(b"lead frame", 1)
    with pytest.raises(zstd.ZstdError) as e:
        zstd.decompress(lead + b"\x00\x01\x02\x03\x04\x05")
    assert e.value.offset == len(lead)
    dict_frame = bytearray(libzstd.compress(b"abc" * 10, 1))
    dict_frame[4] |= 1                       # a one-byte dictionary ID
    dict_frame[5:5] = b"\x07"
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(bytes(dict_frame))
    with pytest.raises(zstd.ZstdError, match="too small"):
        zstd.decompress_into(frames[0], np.empty(100, np.uint8))
    # a header that states 1 TiB: refused before anything is allocated
    huge = (zstd.MAGIC.to_bytes(4, "little") + b"\xe0"
            + (1 << 40).to_bytes(8, "little") + b"\x01\x00\x00")
    with pytest.raises(zstd.ZstdError, match="more than"):
        zstd.decompress(huge)
    # random damage without the checksum: an error or some bytes
    plain = [libzstd.compress(d[:30_000], lvl, content_size=False)
             for d in corpus.values() if d for lvl in (1, 3, 19)]
    for _ in range(1500):
        bad = bytearray(plain[rng.integers(len(plain))])
        for at in rng.integers(0, len(bad), rng.integers(1, 4)).tolist():
            bad[at] = int(rng.integers(256))
        if rng.random() < 0.2:
            bad = bad[:rng.integers(len(bad))]
        try:
            zstd.decompress_into(bytes(bad), np.empty(40_000, np.uint8))
        except zstd.ZstdError:
            pass


# ------------------------------------------------------------ tree helpers

def _assert_same(got, want, where="root"):
    """Equal trees: the same containers and keys, Python scalars of the same
    type and value, arrays of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict), (where, type(got))
        assert sorted(got, key=str) == sorted(want, key=str), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}/{i}")
    elif want is None or isinstance(want, (bool, int, float)):
        assert type(got) is type(want) and got == want, (where, got, want)
    else:
        g, w = _bits(got), _bits(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (where, g.dtype,
                                                          w.dtype)
        assert g.tobytes() == w.tobytes(), where


def _bits(x) -> np.ndarray:
    """A leaf as numpy: the port's torch bfloat16 (numpy has none) as the
    ml_dtypes bfloat16 JAX restores, of the same bits."""
    import torch
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.bfloat16:
            return x.numpy()
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return np.asarray(x)


def _host(tree):
    import jax
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _jax_state(seed=0):
    """A tiny ViT's JAX params and a momentum tree of other values."""
    import jax
    from vit_project_tpu.models import vit as jvit
    cfg = jvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                         num_classes=3)
    params = jvit.init_vit_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    momentum = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    return params, momentum


SCHED = {"current_epoch": 4, "base_lrs": [0.1], "warmup_epochs": 1,
         "max_epochs": 9, "eta_min": 0, "lr": 0.05}


def test_single_process_jax_checkpoint_reads_as_jax_restores(tmp_path):
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_torch.ckpt import vit_ckpt as tck
    params, momentum = _jax_state()
    out = str(tmp_path)
    path = jck.save_checkpoint(3, params, momentum, SCHED, 1.25, 2.5, 37.5,
                               out, sharded=True)
    assert path.endswith("checkpoint_epoch_003.orbax")
    assert tck.latest_checkpoint(out) == jck.latest_checkpoint(out) == path
    assert tck.epoch_checkpoint(out, 3) == path
    got, want = tck.load_checkpoint(path), _host(jck.load_checkpoint(path))
    _assert_same(got, want)
    assert type(got["epoch"]) is int and type(got["train_loss"]) is float
    assert got["scheduler_state"] == SCHED
    _assert_same(got["params"], _host(params))
    with pytest.raises(ValueError, match="template"):
        tck.load_checkpoint(path, template={"params": {}})


def test_sharded_tree_of_several_chunks_reads_as_jax_restores(tmp_path):
    """ep-, tp- and fsdp-placed trees over the 8 CPU devices: orbax writes
    each shard as its own zarr chunk."""
    import dataclasses
    import jax
    from vit_project_tpu.ckpt import serialization as jser
    from vit_project_tpu.models import vit as jvit
    from vit_project_tpu.parallel import mesh as vmesh
    from vit_project_torch.ckpt import orbax
    cfg = jvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                         num_classes=10)
    moe = dataclasses.replace(cfg, moe_experts=4)
    ep = vmesh.shard_vit_params_ep(vmesh.make_mesh(n_data=2, n_expert=4),
                                   jvit.init_vit_params(
                                       jax.random.PRNGKey(0), moe))
    tp = vmesh.shard_vit_params_tp(vmesh.make_mesh(n_data=4, n_model=2),
                                   jvit.init_vit_params(
                                       jax.random.PRNGKey(1), cfg), heads=2)
    fsdp = vmesh.shard_params_fsdp(vmesh.make_mesh(n_data=8),
                                   jvit.init_vit_params(
                                       jax.random.PRNGKey(2), cfg))
    path = str(tmp_path / "state.orbax")
    jser.save_sharded(path, {"ep": ep, "tp": tp, "fsdp": fsdp, "epoch": 7,
                             "lst": [1.5, np.arange(3, dtype=np.int32)]})
    kv = orbax.read_kvstore(path)
    grids = {k[:-len(b"/.zarray")]: json.loads(v)
             for k, v in kv.items() if k.endswith(b"/.zarray")}
    several = [k for k, m in grids.items() if m["chunks"] != m["shape"]]
    assert {b"ep.blocks.1.moe.fc1_w", b"fsdp.blocks.0.fc1_w",
            b"tp.blocks.0.fc1_w"} <= set(several)
    _assert_same(orbax.read_tree(path), _host(jser.load_sharded(path)))


def _write_zarr(path, name, arr, chunks, order, compressor, fill):
    import tensorstore as ts
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                          "base": f"file://{path}"},
            "path": name,
            "metadata": {"shape": list(arr.shape), "chunks": chunks,
                         "dtype": arr.dtype.str, "order": order,
                         "compressor": compressor, "fill_value": fill}}
    store = ts.open(spec, create=True).result()
    # the last chunk of the first axis is never written: fill_value
    rows = (arr.shape[0] - 1) // chunks[0] * chunks[0]
    store[:rows].write(arr[:rows]).result()
    want = arr.copy()
    want[rows:] = fill
    return want


def test_zarr_edge_chunks_fill_value_order_and_no_compressor(tmp_path):
    """Arrays tensorstore writes with partial edge chunks, an absent chunk
    (the array's fill_value), Fortran order and no compressor, read as
    tensorstore reads them."""
    from vit_project_torch.ckpt import orbax
    path = str(tmp_path / "z.orbax")
    rng = np.random.default_rng(3)
    leaves = {
        "f": (rng.standard_normal((10, 7)).astype(np.float32), [4, 3], "C",
              {"id": "zstd", "level": 3}, 0.5),
        "g": (rng.integers(-9, 9, (9, 5, 3)).astype(np.int16), [2, 5, 2],
              "F", None, 3),
        "h": (rng.standard_normal(13), [5], "C", {"id": "zstd", "level": 1},
              "NaN"),
    }
    wants = {k: _write_zarr(path, k, a, c, o, comp, fill)
             for k, (a, c, o, comp, fill) in leaves.items()}
    meta = {"tree_metadata": {
        f"('{k}',)": {"key_metadata": [{"key": k, "key_type": 2}],
                      "value_metadata": {"value_type": "np.ndarray",
                                         "skip_deserialize": False}}
        for k in leaves}, "use_ocdbt": True, "use_zarr3": False}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    got = orbax.read_tree(path)
    for k, want in wants.items():
        np.testing.assert_array_equal(got[k], want)
        assert got[k].dtype == want.dtype
    assert np.isnan(got["h"][10:]).all()


def test_ocdbt_tree_of_many_nodes_and_versions(tmp_path):
    """A database of interior B-tree nodes (small nodes), inline and
    indirect values, and 20 versions: the keys and bytes tensorstore
    lists and reads."""
    import tensorstore as ts
    from vit_project_torch.ckpt import orbax
    path = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 16,
                                     "compression": {"id": "zstd",
                                                     "level": 5}}}).result()
    for g in range(20):
        txn = ts.Transaction()
        for i in range(12):
            kv.with_transaction(txn)[f"p/k{g:02d}_{i:03d}/.zarray"] = (
                b"v%d_%d_" % (g, i)) * (1 + i % 5)
        txn.commit_async().result()
    keys = kv.list().result()
    got = orbax.read_kvstore(path)
    assert sorted(got) == sorted(keys) and len(keys) == 240
    files = orbax._Files(path)
    try:
        for k in keys:
            v = got[k]
            raw = v if isinstance(v, bytes) else files.read(*v, "test")
            assert raw == kv.read(k).result().value, k
    finally:
        files.close()


# ------------------------------------------------------------ two processes

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_checkpoint(tmp_path_factory):
    """One collective .orbax written by two jax.distributed CPU processes
    (2 devices each, a 4-device FSDP placement), as
    examples/multihost_cpu_demo.py writes its pod checkpoint, and JAX's
    restore of it, gathered by process 0."""
    root = str(tmp_path_factory.mktemp("two_process"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    logs = [os.path.join(root, f"process_{i}.log") for i in range(2)]
    procs = []
    for i, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "jax_writer",
                 str(i), str(port), root], env=env, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.time() + TWO_PROCESS_TIMEOUT
    try:       # until both end, one fails (its peer would wait) or time's up
        while time.time() < deadline and any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        with open(log) as f:
            assert p.returncode == 0, f.read()[-3000:]
    with open(os.path.join(root, "jax_restored.pkl"), "rb") as f:
        restored = pickle.load(f)
    return root, restored


def test_two_process_jax_checkpoint_reads_as_jax_restores(
        two_process_checkpoint):
    from vit_project_torch.ckpt import orbax
    from vit_project_torch.ckpt import vit_ckpt as tck
    root, restored = two_process_checkpoint
    path = tck.latest_checkpoint(root)
    assert path == os.path.join(root, "checkpoint_epoch_002.orbax")
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(path))
    # the root database refers to both processes' data files
    refs = {v[0].split("/")[0] for v in orbax.read_kvstore(path).values()
            if not isinstance(v, bytes)}
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= refs
    _assert_same(tck.load_checkpoint(path), restored)
    assert restored["scheduler_state"] == SCHED


def _jax_writer(pid: int, port: int, root: str) -> None:
    """One process of the two-process write (this file's __main__)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                               process_id=pid)
    from jax.experimental import multihost_utils
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_tpu.parallel import mesh as vmesh
    mesh = vmesh.make_mesh(n_data=4)
    params, momentum = _jax_state(seed=4)
    params = vmesh.shard_params_fsdp(mesh, params)
    momentum = vmesh.shard_params_fsdp(mesh, momentum)
    path = jck.save_checkpoint(2, params, momentum, SCHED, 0.5, 0.75, 12.5,
                               root)
    assert path.endswith(".orbax")
    ck = jck.load_checkpoint(path)
    ck = jax.tree_util.tree_map(
        lambda x: np.asarray(multihost_utils.process_allgather(x, tiled=True))
        if isinstance(x, jax.Array) else x, ck)
    if pid == 0:
        with open(os.path.join(root, "jax_restored.pkl"), "wb") as f:
            pickle.dump(ck, f)
    multihost_utils.sync_global_devices("written")


# ------------------------------------------------------------ port -> JAX

def test_jax_reads_what_write_tree_writes(tmp_path):
    import ml_dtypes
    import torch
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_torch.ckpt import orbax
    rng = np.random.default_rng(5)
    tree = {
        "epoch": 4, "train_loss": 0.125, "flag": True, "none": None,
        "params": {"w": rng.standard_normal((40, 33)).astype(np.float32),
                   "b": rng.standard_normal(7).astype(np.float32),
                   "bf": rng.standard_normal((5, 6)).astype(
                       ml_dtypes.bfloat16),
                   "a.b": {"c": np.arange(12, dtype=np.int64).reshape(3, 4)}},
        "opt_state": {"t_bf": torch.randn(3, 9).bfloat16(),
                      "t_f": torch.randn(600),
                      "i32": np.arange(5, dtype=np.int32),
                      "u8": np.arange(300, dtype=np.uint8).reshape(3, 100) % 7,
                      "f16": np.float16([1.5, -2.0]),
                      "zero_d": np.array(2.5), "np_scalar": np.float32(3.5),
                      "empty": np.zeros((0, 4), np.float32)},
        "scheduler_state": {"base_lrs": [0.1, 0.2], "milestones": [],
                            "kw": {}, "last_epoch": 3},
    }
    path = str(tmp_path / "checkpoint_epoch_004.orbax")
    orbax.write_tree(path, tree)
    got = _host(jck.load_checkpoint(path))
    want = dict(tree, opt_state=dict(tree["opt_state"]))
    want["opt_state"]["t_bf"] = tree["opt_state"]["t_bf"].view(
        torch.int16).numpy().view(ml_dtypes.bfloat16)
    want["opt_state"]["t_f"] = tree["opt_state"]["t_f"].numpy()
    want["opt_state"]["np_scalar"] = np.asarray(np.float32(3.5))
    _assert_same(got, want)
    back = orbax.read_tree(path)
    _assert_same(back, got)
    assert back["opt_state"]["t_bf"].dtype == torch.bfloat16
    assert back["params"]["bf"].dtype == torch.bfloat16
    # writing again replaces the directory
    orbax.write_tree(path, {"epoch": 5})
    assert jck.load_checkpoint(path) == {"epoch": 5}


# ------------------------------------------------------------ the fixture

FIXTURE = os.path.join(REPO, "tests", "data", "jax_vit_orbax")
FIXTURE_VIT = {"patch": 8, "width": 48, "layers": 2, "heads": 2,
               "image_size": 32, "num_classes": 10}
# the decoder's forms that JAX's level-1 chunks and zstd-compressed B-tree
# nodes of the fixture reach
FIXTURE_FORMS = ("compressed_block", "literals_huffman_4",
                 "huffman_weights_fse", "sequences_predefined",
                 "sequences_fse")


def _make_fixture(out: str) -> None:
    """Write the committed fixture with the JAX package: a tiny ViT's epoch-1
    checkpoint as one process writes it sharded (level-1 zstd chunks,
    zstd-compressed OCDBT nodes), f32 params and a bfloat16 momentum, and
    ``leaves.json``: the ViT's shape and the digests of JAX's restore."""
    import jax
    import ml_dtypes
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_tpu.models import vit as jvit
    from vit_project_torch.ckpt import orbax
    shutil.rmtree(out, ignore_errors=True)
    params = jvit.init_vit_params(jax.random.PRNGKey(0),
                                  jvit.ViTConfig(**FIXTURE_VIT))
    rng = np.random.default_rng(0)
    momentum = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.02).astype(
            ml_dtypes.bfloat16), params)
    path = jck.save_checkpoint(1, params, momentum, dict(SCHED,
                               current_epoch=1), 2.25, 2.5, 12.5, out,
                               sharded=True)
    os.unlink(os.path.join(out, "training_metrics.csv"))
    with open(os.path.join(out, "leaves.json"), "w") as f:
        json.dump({"vit": FIXTURE_VIT, "forms": FIXTURE_FORMS,
                   "leaves": orbax.leaf_digests(
                       _host(jck.load_checkpoint(path)))},
                  f, indent=1, sort_keys=True)


def test_committed_jax_fixture_reads_to_its_digests():
    """The committed JAX-written fixture: JAX's restore and the port's read
    give the digests it was committed with, the read reaches the decoder's
    Huffman, FSE and sequence forms, and its bfloat16 momentum (a CPU
    torch.bfloat16 tree) goes through the resume's ``load_trees`` and the
    serving and export path's ``vit_from_jax``."""
    import torch
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_torch.ckpt import orbax, vit_ckpt as tck, zstd
    from vit_project_torch.models import convert, vit as tvit
    from vit_project_torch.train import vit_loop
    with open(os.path.join(FIXTURE, "leaves.json")) as f:
        meta = json.load(f)
    assert meta["vit"] == FIXTURE_VIT and tuple(meta["forms"]) == \
        FIXTURE_FORMS
    path = tck.latest_checkpoint(FIXTURE)
    assert path == jck.latest_checkpoint(FIXTURE) and path.endswith(
        "checkpoint_epoch_001.orbax")
    assert orbax.leaf_digests(_host(jck.load_checkpoint(path))) == \
        meta["leaves"]
    zstd.take_stats()
    got = tck.load_checkpoint(path)
    met = zstd.take_stats()
    assert orbax.leaf_digests(got) == meta["leaves"]
    assert all(met[k] > 0 for k in FIXTURE_FORMS), met
    assert {v.dtype for v in _leaves(got["opt_state"])} == {torch.bfloat16}
    cfg = tvit.ViTConfig(**FIXTURE_VIT)
    model = tvit.empty_vit(cfg, "cpu")
    momentum = {n: torch.empty_like(p) for n, p in model.named_parameters()}
    vit_loop.load_trees(model, got["params"], momentum, got["opt_state"])
    head = np.asarray(got["params"]["head_w"]).T
    assert np.array_equal(model.head.weight.detach().numpy(), head)
    assert torch.equal(momentum["head.weight"],
                       got["opt_state"]["head_w"].float().T)
    served = convert.vit_from_jax(got["opt_state"], cfg, "cpu")
    assert all(torch.equal(served.state_dict()[n], momentum[n])
               for n in momentum)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------ resolution

def test_resolution_and_pruning_follow_the_jax_rule(tmp_path):
    """latest / epoch / the RSA listing / pruning over .pth epochs, a newer
    .orbax epoch and its pointer, and the legacy full latest directory:
    the port resolves what the JAX package resolves."""
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_tpu.cli import vit_rsa_eval as jrsa
    from vit_project_torch.ckpt import vit_ckpt as tck
    from vit_project_torch.cli import vit_rsa_eval as trsa
    params, momentum = _jax_state(seed=1)
    a = str(tmp_path / "a")
    for e in (0, 1):
        jck.save_checkpoint(e, params, momentum, SCHED, 1.0, 1.0, 1.0, a)
        time.sleep(0.02)
    jck.save_checkpoint(1, params, momentum, SCHED, 1.0, 1.0, 1.0, a,
                        sharded=True)
    time.sleep(0.02)
    jck.save_checkpoint(2, params, momentum, SCHED, 1.0, 1.0, 1.0, a,
                        sharded=True)

    def same(out):
        assert tck.latest_checkpoint(out) == jck.latest_checkpoint(out)
        for e in range(4):
            assert tck.epoch_checkpoint(out, e) == jck.epoch_checkpoint(out,
                                                                        e)
        assert trsa.list_epoch_checkpoints(out) == \
            jrsa.list_epoch_checkpoints(out)
    same(a)
    assert tck.latest_checkpoint(a).endswith("checkpoint_epoch_002.orbax")
    assert tck.epoch_checkpoint(a, 1).endswith(".orbax")
    # a later single-host continuation: the .pth is newer again
    time.sleep(0.02)
    jck.save_checkpoint(2, params, momentum, SCHED, 1.0, 1.0, 1.0, a)
    same(a)
    assert tck.latest_checkpoint(a).endswith("checkpoint_latest.pth")
    # the legacy full latest directory, newest of all
    time.sleep(0.02)
    shutil.copytree(os.path.join(a, "checkpoint_epoch_001.orbax"),
                    os.path.join(a, "checkpoint_latest.orbax"))
    same(a)
    _assert_same(tck.load_checkpoint(tck.latest_checkpoint(a)),
                 _host(jck.load_checkpoint(jck.latest_checkpoint(a))))
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    got = tck.prune_checkpoints(a, keep_last=1, current_epoch=2)
    want = jck.prune_checkpoints(b, keep_last=1, current_epoch=2)
    assert sorted(got) == sorted(want) == [
        "checkpoint_epoch_000.pth", "checkpoint_epoch_001.orbax",
        "checkpoint_epoch_001.pth"]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def test_torn_directories_raise(tmp_path):
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_torch.ckpt import vit_ckpt as tck
    params, momentum = _jax_state(seed=2)
    path = jck.save_checkpoint(0, params, momentum, SCHED, 1.0, 1.0, 1.0,
                               str(tmp_path), sharded=True)
    for missing in ("manifest.ocdbt", "_METADATA"):
        torn = str(tmp_path / f"torn_{missing}.orbax")
        shutil.copytree(path, torn)
        os.unlink(os.path.join(torn, missing))
        with pytest.raises(RuntimeError, match=missing):
            tck.load_checkpoint(torn)
    # a damaged manifest fails its CRC-32C
    bad = str(tmp_path / "bad.orbax")
    shutil.copytree(path, bad)
    with open(os.path.join(bad, "manifest.ocdbt"), "r+b") as f:
        data = bytearray(f.read())
        data[20] ^= 0x40
        f.seek(0)
        f.write(data)
    with pytest.raises(RuntimeError, match="CRC-32C"):
        tck.load_checkpoint(bad)


# ------------------------------------------------------------ resume

@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """3 classes x 16 train + 8 val PNGs at 48x48 (the ViT tests' folder)."""
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


def test_resume_from_a_jax_orbax_equals_the_pth_resume(imagenet, tmp_path):
    """Epoch 0 of a 2-epoch port run, saved once as the .pth and once by the
    JAX package as a collective .orbax with its pointer: epoch 1 resumed from
    each writes the same row and the same parameters and momentum."""
    import torch
    from vit_project_tpu.ckpt import serialization as jser
    from vit_project_tpu.ckpt import vit_ckpt as jck
    from vit_project_torch.ckpt import serialization as tser
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as tvit
    from vit_project_torch.train import vit_loop as tloop
    tiny = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2,
                          image_size=32, num_classes=3)

    def run(out, epochs):
        torch.set_num_threads(2)
        tloop.run_vit_training(ViTTrainConfig(
            data_path=imagenet, output_dir=out, batch_size=8, epochs=epochs,
            lr=0.01, warmup_epochs=1, num_workers=2, num_classes=3,
            image_size=32, compute_dtype="float32", random_seed=0),
            vit_cfg=tiny, device="cpu")
    base, from_pth, from_orbax = (str(tmp_path / n)
                                  for n in ("base", "pth", "orbax"))
    run(base, 2)
    pth = os.path.join(base, "checkpoint_epoch_000.pth")
    csv = os.path.join(base, "training_metrics.csv")
    os.makedirs(from_pth)
    shutil.copyfile(pth, os.path.join(from_pth, "checkpoint_latest.pth"))
    ck = jser.load(pth)
    jck.save_checkpoint(ck["epoch"], ck["params"], ck["opt_state"],
                        ck["scheduler_state"], ck["train_loss"],
                        ck["val_loss"], ck["val_acc"], from_orbax,
                        sharded=True)
    assert os.path.exists(os.path.join(from_orbax,
                                       "checkpoint_latest.orbax.ptr"))
    with open(csv) as f:
        first_row = "".join(f.readlines()[:2])
    for out in (from_pth, from_orbax):
        with open(os.path.join(out, "training_metrics.csv"), "w") as f:
            f.write(first_row)
        run(out, 2)
    rows = [open(os.path.join(o, "training_metrics.csv")).read()
            for o in (from_pth, from_orbax)]
    assert rows[0] == rows[1] and len(rows[0].splitlines()) == 3
    a, b = (tser.load(os.path.join(o, "checkpoint_latest.pth"))
            for o in (from_pth, from_orbax))
    assert a["epoch"] == b["epoch"] == 1
    _assert_same(b["params"], a["params"])
    _assert_same(b["opt_state"], a["opt_state"])


# ------------------------------------------------------------ __main__

def _throughput() -> None:
    """The decoder's MB/s on libzstd frames of f32 weights N(0, 0.02) (how
    JAX's level-1 chunks look), of words, and on a Raw-block frame, beside
    libzstd's own into the same preallocated buffer, on the host's CPU
    (one thread, best of 5)."""
    sys.path.insert(0, REPO)
    from vit_project_torch.ckpt import zstd
    lz = _LibZstd()
    rng = np.random.default_rng(0)
    weights = (rng.standard_normal(16 << 20) * 0.02).astype(np.float32)
    inputs = {"f32 weights, level 1": (weights.tobytes(), 1),
              "f32 weights, level 3": (weights.tobytes(), 3),
              "words, level 3": (_corpus(40.0)["words"], 3)}
    print(f"host: {os.cpu_count()} CPUs; one decoding thread")
    for name, (data, level) in inputs.items():
        frame = lz.compress(data, level)
        out = np.empty(len(data), np.uint8)
        ref = ctypes.create_string_buffer(len(data))
        best = min(_timed(lambda: zstd.decompress_into(frame, out))
                   for _ in range(5))
        lib = min(_timed(lambda: lz.lib.ZSTD_decompress(
            ref, len(data), frame, len(frame))) for _ in range(5))
        assert out.tobytes() == data == ref.raw
        print(f"{name}: {len(data) / 1e6:.1f} MB in {len(frame) / 1e6:.1f} "
              f"MB; decoder {len(data) / best / 1e6:.0f} MB/s, libzstd "
              f"{len(data) / lib / 1e6:.0f} MB/s")
    data = weights.tobytes()
    raw = b"".join(zstd.raw_frame_parts(data))
    out = np.empty(len(data), np.uint8)
    best = min(_timed(lambda: zstd.decompress_into(raw, out))
               for _ in range(5))
    print(f"Raw-block frame: {len(data) / 1e6:.1f} MB; decoder "
          f"{len(data) / best / 1e6:.0f} MB/s")


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    if sys.argv[1] == "jax_writer":
        _jax_writer(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1] == "throughput":
        _throughput()
    elif sys.argv[1] == "fixture":       # rewrite tests/data/jax_vit_orbax
        sys.path.insert(0, REPO)
        _make_fixture(sys.argv[2] if len(sys.argv) > 2 else FIXTURE)
