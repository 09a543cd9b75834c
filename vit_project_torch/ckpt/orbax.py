"""Read and write the JAX package's pod-sharded ``.orbax`` checkpoints
without orbax, tensorstore or libzstd.

The JAX package's ``serialization.save_sharded`` writes a tree through
orbax's ``StandardCheckpointer`` into a directory of:

- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path to its
  keys (``key_type`` 2 a dict key, 1 a list index) and its value type
  (``np.ndarray``, ``jax.Array``, ``scalar``, or an empty container);
- an OCDBT database (tensorstore's "optionally-cooperative distributed
  B-tree") at the directory's root: ``manifest.ocdbt`` names the newest
  version's B-tree root, whose nodes and values lie in data files under
  ``d/`` or, written by process N of a pod, under ``ocdbt.process_N/d/``;
- inside it, one zarr v2 array per leaf, named by the key path joined with
  ``.``: ``<name>/.zarray`` (shape, chunks, dtype, order, fill value,
  compressor) and ``<name>/<i.j.k>``, one value per chunk, each a zstd
  frame.

``read_tree`` is the counterpart of JAX's ``serialization.load_sharded(path,
template=None)``: the same nested dicts and lists, arrays as numpy arrays and
``scalar`` leaves as Python ``int`` / ``float``. ``write_tree`` is the
single-process counterpart of ``save_sharded``: the same layout, with every
chunk a zstd frame of Raw blocks and the B-tree nodes stored uncompressed,
which JAX's ``load_checkpoint`` restores.

OCDBT files (manifest and B-tree nodes) carry a 14-byte header (magic,
length, format version, compression) and a CRC-32C trailer, both checked
here; zstd frames carry their own XXH64 where the writer asked for one
(``ckpt/zstd.py``). A directory without ``_METADATA`` or without
``manifest.ocdbt`` is a torn write and raises ``RuntimeError``.

numpy has no bfloat16 of its own, so bfloat16 arrays come back as CPU
``torch.bfloat16`` tensors on every host (JAX's restore gives
``ml_dtypes.bfloat16`` arrays of the same bits).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import struct
import time
import uuid

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
HEADER_BYTES = 14          # magic (4, big-endian), length (8), version, codec
NO_COMPRESSION, ZSTD = 0, 1
KEY_SEQUENCE, KEY_DICT = 1, 2
EMPTY_VALUES = {"None": None, "Dict": dict, "List": list, "Tuple": tuple}

# the database configuration orbax writes (tensorstore's defaults there)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


# ------------------------------------------------------------ primitives

def _crc32c_table() -> list:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT's files."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over one decoded OCDBT body; any overrun is a corrupt file."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise RuntimeError(f"{self.what}: {why} at byte {self.pos}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated (wanted {n} bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of one OCDBT file (a manifest or a B-tree node): checks its
    magic, length, version and CRC-32C, and decodes its zstd body."""
    if len(data) < HEADER_BYTES + 4:
        raise RuntimeError(f"{what}: {len(data)} bytes, too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], \
        struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise RuntimeError(f"{what}: magic {got_magic:08x}, expected "
                           f"{magic:08x}")
    if length != len(data):
        raise RuntimeError(f"{what}: header length {length}, file has "
                           f"{len(data)} bytes")
    hdr = _Reader(data[:len(data) - 4], what)
    hdr.pos = 12
    version, codec = hdr.varint(), hdr.varint()
    if version != 0:
        raise RuntimeError(f"{what}: format version {version} not supported")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise RuntimeError(f"{what}: CRC-32C mismatch")
    body = data[hdr.pos:-4]
    if codec == ZSTD:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise RuntimeError(f"{what}: {e}") from e
    if codec != NO_COMPRESSION:
        raise RuntimeError(f"{what}: compression {codec} not supported")
    return body


def _encode_file(body: bytes, magic: int) -> bytes:
    """One OCDBT file with an uncompressed body."""
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(NO_COMPRESSION) + body
    data = head + struct.pack("<Q", len(head) + 8 + len(rest) + 4) + rest
    return data + struct.pack("<I", crc32c(data))


# ------------------------------------------------------------ OCDBT read

def _read_file_table(r: _Reader) -> list:
    """A node's data file table: the files its references index, as paths
    relative to the database root (base path + relative path)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file path prefix longer than the previous path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(full):
            r.fail("data file base path longer than its path")
        paths.append(full.decode())
        prev = full
    return paths


def _safe_path(root: str, rel: str, what: str) -> str:
    parts = rel.split("/")
    if not rel or rel.startswith("/") or ".." in parts:
        raise RuntimeError(f"{what}: data file path {rel!r} leaves the "
                           f"checkpoint directory")
    return os.path.join(root, *parts)


class _Files:
    """Open data files of one database, read by (path, offset, length)."""

    def __init__(self, root: str):
        self.root, self.handles = root, {}

    def read(self, rel: str, offset: int, length: int, what: str) -> bytes:
        f = self.handles.get(rel)
        if f is None:
            path = _safe_path(self.root, rel, what)
            try:
                f = self.handles[rel] = open(path, "rb")
            except OSError as e:
                raise RuntimeError(f"{what}: cannot open data file {rel}: "
                                   f"{e}") from e
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise RuntimeError(f"{what}: data file {rel} ends before byte "
                               f"{offset + length}")
        return data

    def read_into(self, rel: str, offset: int, out: np.ndarray, what: str):
        f = self.handles.get(rel)
        if f is None:
            self.read(rel, 0, 0, what)
            f = self.handles[rel]
        f.seek(offset)
        if f.readinto(memoryview(out).cast("B")) != out.nbytes:
            raise RuntimeError(f"{what}: data file {rel} ends before byte "
                               f"{offset + out.nbytes}")

    def close(self):
        for f in self.handles.values():
            f.close()
        self.handles.clear()


def _read_manifest(root: str):
    """(root reference or None, height) of the newest version."""
    path = os.path.join(root, "manifest.ocdbt")
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(_decode_file(data, MANIFEST_MAGIC, path), path)
    r.take(16)                       # database uuid
    kind = r.varint()
    if kind != 0:
        raise RuntimeError(f"{path}: manifest kind {kind} (numbered "
                           f"manifests) not supported")
    r.varint()                       # max_inline_value_bytes
    r.varint()                       # max_decoded_node_bytes
    r.u8()                           # version_tree_arity_log2
    if r.varint() == ZSTD:           # node compression: zstd and its level
        r.u32()
    files = _read_file_table(r)
    n = r.varint()                   # the newest versions, inline
    if n == 0:
        raise RuntimeError(f"{path}: no version")
    gens = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    num_keys = r.varints(n)
    r.varints(n)                     # num_tree_bytes
    r.varints(n)                     # num_indirect_value_bytes
    for _ in range(n):
        r.u64()                      # commit_time
    i = max(range(n), key=lambda j: gens[j])
    if num_keys[i] == 0:
        return None, 0
    if ids[i] >= len(files):
        r.fail("root refers to a data file the table lacks")
    return (files[ids[i]], offsets[i], lengths[i]), heights[i]


def _read_node(files: _Files, ref, what: str) -> tuple:
    rel, offset, length = ref
    data = files.read(rel, offset, length, what)
    r = _Reader(_decode_file(data, NODE_MAGIC, what), what)
    return r.u8(), _read_file_table(r), r


def _keys(r: _Reader, n: int, with_subtree: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if with_subtree else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the previous key")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, subtree


def _walk(files: _Files, ref, height: int, prefix: bytes, out: dict,
          depth: int = 0) -> None:
    """Every (key, value) under the node at ``ref`` into ``out``: a value is
    bytes (inline) or (data file, offset, length)."""
    what = f"OCDBT node {ref[0]}@{ref[1]}"
    if depth > 64:
        raise RuntimeError(f"{what}: B-tree deeper than 64 levels")
    node_height, table, r = _read_node(files, ref, what)
    if node_height != height:
        r.fail(f"height {node_height}, its parent says {height}")
    n = r.varint()
    if height == 0:
        keys, _ = _keys(r, n, False)
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            r.fail("value kind other than inline (0) or indirect (1)")
        m = sum(kinds)
        ids, offsets = r.varints(m), r.varints(m)
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            if kind:
                if ids[j] >= len(table):
                    r.fail("value refers to a data file the table lacks")
                out[prefix + key] = (table[ids[j]], offsets[j], length)
                j += 1
            else:
                out[prefix + key] = r.take(length)
        if r.pos != len(r.data):
            r.fail("bytes after the leaf's values")
        return
    keys, subtree = _keys(r, n, True)
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    r.varints(3 * n)                 # num_keys, tree and value bytes
    for key, common, fid, off, length in zip(keys, subtree, ids, offsets,
                                             lengths):
        if common > len(key) or fid >= len(table):
            r.fail("child reference out of range")
        _walk(files, (table[fid], off, length), height - 1,
              prefix + key[:common], out, depth + 1)


def read_kvstore(path: str) -> dict:
    """Every key of the OCDBT database at ``path`` (its newest version):
    {key bytes: inline bytes or (data file, offset, length)}."""
    if not os.path.exists(os.path.join(path, "manifest.ocdbt")):
        raise RuntimeError(f"{path}: no manifest.ocdbt (a torn or "
                           f"unfinished checkpoint write)")
    root_ref, height = _read_manifest(path)
    out: dict = {}
    if root_ref is not None:
        files = _Files(path)
        try:
            _walk(files, root_ref, height, b"", out)
        finally:
            files.close()
    return out


# ------------------------------------------------------------ zarr v2

def _zarr_dtype(text: str):
    """(numpy dtype to decode into, whether it is bfloat16, decoded as
    uint16 bits)."""
    if text == "bfloat16":
        return np.dtype("<u2"), True
    if not isinstance(text, str):
        raise RuntimeError(f"structured zarr dtype {text!r} not supported")
    return np.dtype(text), False


def _fill(meta: dict):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):          # zarr v2 spells the float specials
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}.get(v, 0)
    return v


class _Chunks:
    """A value's bytes from the key-value map, read lazily."""

    def __init__(self, kv: dict, files: _Files):
        self.kv, self.files = kv, files

    def raw(self, key: bytes):
        v = self.kv.get(key)
        if v is None or isinstance(v, bytes):
            return v
        rel, offset, length = v
        return self.files.read(rel, offset, length, key.decode())


def _read_array(chunks: _Chunks, name: str):
    zkey = f"{name}/.zarray".encode()
    raw = chunks.raw(zkey)
    if raw is None:
        raise RuntimeError(f"zarr array {name}: no .zarray in the database")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise RuntimeError(f"zarr array {name}: zarr_format "
                           f"{meta.get('zarr_format')} not supported")
    if meta.get("filters"):
        raise RuntimeError(f"zarr array {name}: filters not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise RuntimeError(f"zarr array {name}: compressor {comp} not "
                           f"supported")
    shape = tuple(int(s) for s in meta["shape"])
    cshape = tuple(int(c) for c in meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    dtype, bits = _zarr_dtype(meta["dtype"])
    if len(cshape) != len(shape) or any(c <= 0 for c in cshape) \
            or order not in ("C", "F"):
        raise RuntimeError(f"zarr array {name}: bad chunks {cshape} for "
                           f"shape {shape} (order {order})")
    grid = [math.ceil(s / c) for s, c in zip(shape, cshape)]
    chunk_bytes = int(np.prod(cshape, dtype=np.int64)) * dtype.itemsize
    names = {idx: f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
             for idx in np.ndindex(*grid)}
    whole = cshape == shape and order == "C"   # one chunk: decode in place
    if all(k.encode() in chunks.kv for k in names.values()):
        out = np.empty(shape, dtype)
    else:                                      # absent chunks: fill_value
        out = np.full(shape, _fill(meta), dtype)
    for idx, ckey in names.items():
        v = chunks.kv.get(ckey.encode())
        if v is None:
            continue
        if comp is None:
            if whole and not isinstance(v, bytes):
                rel, offset, length = v
                if length != chunk_bytes:
                    raise RuntimeError(f"{ckey}: {length} bytes, expected "
                                       f"{chunk_bytes}")
                chunks.files.read_into(rel, offset, out.reshape(-1), ckey)
                continue
            data = np.frombuffer(chunks.raw(ckey.encode()), np.uint8)
            if data.size != chunk_bytes:
                raise RuntimeError(f"{ckey}: {data.size} bytes, expected "
                                   f"{chunk_bytes}")
        else:
            target = out.reshape(-1) if whole else np.empty(cshape, dtype)
            try:
                n = zstd.decompress_into(chunks.raw(ckey.encode()), target)
            except zstd.ZstdError as e:
                raise RuntimeError(f"{ckey}: {e}") from e
            if n != chunk_bytes:
                raise RuntimeError(f"{ckey}: decoded {n} bytes, expected "
                                   f"{chunk_bytes}")
            if whole:
                continue
            data = target.reshape(-1).view(np.uint8)
        block = data.view(dtype).reshape(cshape, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, cshape, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bits:
        import torch
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ------------------------------------------------------------ the tree

def _param_name(keys: list) -> str:
    return ".".join(str(k["key"]) for k in keys)


def _insert(tree: dict, keys: list, value, what: str) -> None:
    """Place ``value`` at ``keys`` ((key, key_type) pairs), making the dicts
    and the (index-keyed, listified later) sequences on the way."""
    node = tree
    for i, (key, kind) in enumerate(keys):
        last = i == len(keys) - 1
        if kind not in (KEY_SEQUENCE, KEY_DICT):
            raise RuntimeError(f"{what}: key type {kind} not supported")
        k = int(key) if kind == KEY_SEQUENCE else key
        if last:
            node[(kind, k)] = value
        else:
            node = node.setdefault((kind, k), {})


def _materialize(node, what: str):
    if not isinstance(node, dict) or not node or not all(
            isinstance(k, tuple) and len(k) == 2 for k in node):
        return node
    kinds = {k[0] for k in node}
    if kinds == {KEY_DICT}:
        return {k: _materialize(v, what) for (_, k), v in node.items()}
    if kinds == {KEY_SEQUENCE}:
        idx = sorted(k for _, k in node)
        if idx != list(range(len(idx))):
            raise RuntimeError(f"{what}: list indices {idx} are not 0..n-1")
        return [_materialize(node[(KEY_SEQUENCE, i)], what) for i in idx]
    raise RuntimeError(f"{what}: a node mixes dict keys and list indices")


class _Leaf:
    """Marks a leaf inside the building tree (so an empty dict leaf is not
    taken for an inner node)."""

    def __init__(self, value):
        self.value = value


def _unwrap(node):
    if isinstance(node, _Leaf):
        return node.value
    if isinstance(node, dict):
        return {k: _unwrap(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_unwrap(v) for v in node]
    return node


def read_tree(path: str) -> dict:
    """The tree of the ``.orbax`` directory at ``path``, as JAX's
    ``serialization.load_sharded(path)`` restores it without a template:
    nested dicts and lists, arrays as numpy arrays, ``scalar`` leaves as
    Python numbers. Raises ``RuntimeError`` on a torn or corrupt
    directory."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise RuntimeError(f"{path}: no _METADATA (a torn or unfinished "
                           f"checkpoint write)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise RuntimeError(f"{path}: only OCDBT with zarr v2 is supported "
                           f"(use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                           f"{meta.get('use_zarr3')})")
    entries = meta.get("tree_metadata")
    if not isinstance(entries, dict):
        raise RuntimeError(f"{meta_path}: no tree_metadata")
    kv = read_kvstore(path)
    files = _Files(path)
    chunks = _Chunks(kv, files)
    tree: dict = {}
    try:
        for where, entry in entries.items():
            keys = entry["key_metadata"]
            vmeta = entry["value_metadata"]
            vtype = vmeta["value_type"]
            what = f"{path} {where}"
            if vtype in EMPTY_VALUES:
                empty = EMPTY_VALUES[vtype]
                value = None if empty is None else empty()
            elif vmeta.get("skip_deserialize"):
                value = None
            else:
                value = _read_array(chunks, _param_name(keys))
                if vtype == "scalar":
                    if value.ndim != 0:
                        raise RuntimeError(f"{what}: scalar of shape "
                                           f"{value.shape}")
                    value = value.item()
                elif vtype not in ("np.ndarray", "jax.Array"):
                    raise RuntimeError(f"{what}: value type {vtype!r} not "
                                       f"supported")
            if not keys:
                return value
            _insert(tree, [(k["key"], k["key_type"]) for k in keys],
                    _Leaf(value), what)
    finally:
        files.close()
    return _unwrap(_materialize(tree, path))


# ------------------------------------------------------------ write

def _flatten(tree, keys=()):
    """(keys, leaf) pairs in the order orbax flattens: dicts by sorted key,
    lists and tuples by index. Each key is (str key, key type)."""
    if isinstance(tree, dict):
        if not tree:
            yield keys, tree
        for k in sorted(tree):
            yield from _flatten(tree[k], keys + ((str(k), KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield keys, tree
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), KEY_SEQUENCE),))
    else:
        yield keys, tree


def _as_array(leaf) -> tuple:
    """(zarr dtype string, C-contiguous numpy array of the leaf's bits,
    value type) of a leaf: bfloat16 (a torch tensor or an ml_dtypes array)
    as its uint16 bits."""
    import torch
    vtype = "np.ndarray"
    if isinstance(leaf, (bool, int, float)) and not isinstance(
            leaf, np.generic):               # Python numbers, not numpy's
        vtype = "scalar"
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(
                np.uint16), vtype
        leaf = t.numpy()
    a = np.asarray(leaf, order="C")
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.uint16), vtype
    if a.dtype.kind not in "biufc":
        raise TypeError(f"write_tree: dtype {a.dtype} not supported")
    return a.dtype.str, a, vtype


def leaf_digests(tree) -> dict:
    """{leaf's keys joined with "/": its digest}: an array's zarr dtype,
    shape and the SHA-256 of its bits, a Python number's type and value, an
    empty container's type. A tree read here and JAX's restore of the same
    checkpoint (whose bfloat16 leaves are ml_dtypes arrays) give the same
    digests."""
    out = {}
    for keys, leaf in _flatten(tree):
        where = "/".join(k for k, _ in keys)
        if isinstance(leaf, (dict, list, tuple)) or leaf is None:
            out[where] = type(leaf).__name__
            continue
        dstr, data, vtype = _as_array(leaf)
        out[where] = (f"{type(leaf).__name__} {leaf!r}" if vtype == "scalar"
                      else f"{dstr} {list(data.shape)} "
                           f"{hashlib.sha256(data.tobytes()).hexdigest()}")
    return out


def _zarr_meta(shape, dtype_str: str) -> bytes:
    chunks = [max(1, int(s)) for s in shape]
    meta = {"chunks": chunks, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype_str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": [int(s) for s in shape], "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def _file_table(paths: list) -> bytes:
    out = [_varint(len(paths))]
    enc = [p.encode() for p in paths]
    out.append(_varints([0] * (len(enc) - 1)))      # no shared prefixes
    out.append(_varints([len(p) for p in enc]))
    out.append(_varints([0] * len(enc)))            # no base path
    out.extend(enc)
    return b"".join(out)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def write_tree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts and lists of numpy arrays, tensors and
    Python numbers) as an ``.orbax`` directory at ``path``, the layout JAX's
    ``save_sharded`` writes from one process: ``_METADATA``, the OCDBT
    database at the root (one leaf node), and one zarr v2 array a leaf in a
    single chunk. Python ``int`` / ``float`` leaves are ``scalar`` (JAX's
    restore returns Python numbers), everything else ``np.ndarray``. The
    directory is written under a temporary name and renamed into place,
    replacing what was there."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "d"))
    try:
        _write(tmp, tree)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write(root: str, tree) -> None:
    t_ns = time.time_ns()
    entries = {}
    values = {}                                   # key -> bytes-like parts
    for keys, leaf in _flatten(tree):
        where = str(tuple(k for k, _ in keys))
        key_meta = [{"key": k, "key_type": kt} for k, kt in keys]
        if isinstance(leaf, (dict, list, tuple)) or leaf is None:
            vtype = ("None" if leaf is None else "Dict" if isinstance(
                leaf, dict) else "List" if isinstance(leaf, list) else "Tuple")
            entries[where] = {"key_metadata": key_meta, "value_metadata": {
                "value_type": vtype, "skip_deserialize": True}}
            continue
        dstr, data, vtype = _as_array(leaf)
        name = ".".join(k for k, _ in keys)
        values[f"{name}/.zarray".encode()] = [_zarr_meta(data.shape, dstr)]
        if data.size:
            ckey = ".".join("0" for _ in data.shape) if data.shape else "0"
            values[f"{name}/{ckey}".encode()] = zstd.raw_frame_parts(data)
        entries[where] = {"key_metadata": key_meta, "value_metadata": {
            "value_type": vtype, "skip_deserialize": False}}
    if not entries:
        raise ValueError("write_tree: the tree has no leaf")
    # values above the inline limit go, in key order, into one data file;
    # the leaf node follows them in the same file
    data_rel = f"d/{uuid.uuid4().hex}"
    keys = sorted(values)
    lengths, kinds, offsets, inline = [], [], [], []
    offset = 0
    with open(os.path.join(root, *data_rel.split("/")), "wb") as f:
        for k in keys:
            n = sum(len(p) for p in values[k])
            lengths.append(n)
            if n > MAX_INLINE_VALUE_BYTES:
                kinds.append(1)
                offsets.append(offset)
                for p in values[k]:
                    f.write(p)
                offset += n
            else:
                kinds.append(0)
                inline.append(b"".join(bytes(p) for p in values[k]))
        indirect_bytes = offset
        body = [bytes([0]), _file_table([data_rel]), _varint(len(keys))]
        body.append(_varints(_common(keys[i - 1], keys[i])
                             for i in range(1, len(keys))))
        body.append(_varints(len(k) - (_common(keys[i - 1], k) if i else 0)
                             for i, k in enumerate(keys)))
        body.extend(k[_common(keys[i - 1], k) if i else 0:]
                    for i, k in enumerate(keys))
        body.append(_varints(lengths))
        body.append(_varints(kinds))
        body.append(_varints([0] * len(offsets)))
        body.append(_varints(offsets))
        body.extend(inline)
        body = b"".join(body)
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"write_tree: {len(keys)} keys make a B-tree "
                             f"node of {len(body)} bytes, above "
                             f"{MAX_DECODED_NODE_BYTES}")
        node = _encode_file(body, NODE_MAGIC)
        f.write(node)
    manifest = b"".join([
        uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]),
        _varint(ZSTD), struct.pack("<i", 0),
        _file_table([data_rel]),
        _varint(1),                        # one version:
        _varint(1), bytes([0]),            # generation 1, height 0,
        _varint(0), _varint(offset), _varint(len(node)),   # its root node,
        _varint(len(keys)), _varint(len(node)), _varint(indirect_bytes),
        struct.pack("<Q", t_ns),           # commit time
        _varint(0)])                       # no version tree node
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_encode_file(manifest, MANIFEST_MAGIC))
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(root, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t_ns,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
