"""Zstandard decompression through the port's own decoder.

``csrc/zstd_decode.cpp`` is a from-scratch RFC 8878 decoder with a plain C
interface; ``ops/cuda_build`` builds it with the host compiler (``g++ -O3
-std=c++17 -fPIC -shared``) into ``_build/`` at first use and it is bound
here through ctypes. The port reads the JAX package's ``.orbax``
checkpoints with it (``ckpt/orbax.py``), whose array chunks and OCDBT nodes
are zstd frames. Nothing here loads the system's libzstd, and there is no
other path: if the library cannot be built or loaded, the caller gets that
error.

``raw_frame_parts`` writes the other way without an encoder: a frame of
Raw blocks, valid zstd that any decoder reads.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

_lib = None

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
DST_TOO_SMALL = 7            # csrc's kDstTooSmall
# the most ``decompress`` allocates (OCDBT nodes are at most 100 MB)
DECOMPRESS_MAX = 1 << 31

# what the decoder met (``take_stats``), in the order of csrc's enum Stat
STAT_NAMES = ("raw_block", "rle_block", "compressed_block", "literals_raw",
              "literals_rle", "literals_huffman_1", "literals_huffman_4",
              "literals_treeless", "huffman_weights_direct",
              "huffman_weights_fse", "sequences_predefined", "sequences_rle",
              "sequences_fse", "sequences_repeat", "checksum",
              "skippable_frame", "frame")


class ZstdError(ValueError):
    """Malformed or unsupported zstd input; ``offset`` is the byte offset of
    the frame at fault, ``code`` the decoder's error code."""

    def __init__(self, msg: str, offset: int, code: int = 0):
        super().__init__(msg)
        self.offset, self.code = offset, code


def _library():
    global _lib
    if _lib is None:
        from ..ops import cuda_build
        lib = cuda_build.load("zstd_decode")
        size_p = ctypes.POINTER(ctypes.c_size_t)
        lib.vp_zstd_decode.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                       ctypes.c_void_p, ctypes.c_size_t,
                                       size_p, size_p]
        lib.vp_zstd_decode.restype = ctypes.c_int
        lib.vp_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.vp_zstd_content_size.restype = ctypes.c_longlong
        lib.vp_zstd_error_name.argtypes = [ctypes.c_int]
        lib.vp_zstd_error_name.restype = ctypes.c_char_p
        lib.vp_zstd_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vp_zstd_stats.restype = ctypes.c_int
        _lib = lib
    return _lib


def _u8(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else data.reshape(-1).view(np.uint8)


def content_size(data) -> int | None:
    """The decoded size the frames' headers state, or None when a frame
    does not state it."""
    src = _u8(data)
    n = _library().vp_zstd_content_size(src.ctypes.data, src.size)
    if n == -2:
        raise ZstdError("malformed zstd frame header", 0)
    return None if n < 0 else int(n)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the contiguous array ``out`` (any
    dtype; its bytes are written). Returns the decoded byte count. Raises
    ``ZstdError`` on malformed input or when ``out`` is too small."""
    lib = _library()
    src = _u8(data)
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out must be a writeable C-contiguous array")
    got = ctypes.c_size_t()
    at = ctypes.c_size_t()
    rc = lib.vp_zstd_decode(src.ctypes.data, src.size, out.ctypes.data,
                            out.nbytes, ctypes.byref(got), ctypes.byref(at))
    if rc != 0:
        raise ZstdError(f"zstd: {lib.vp_zstd_error_name(rc).decode()} (frame "
                        f"at byte {at.value})", at.value, rc)
    return got.value


def decompress(data) -> bytes:
    """The decoded bytes of every frame in ``data``, into the size their
    headers state or, when a frame states none, a buffer that grows until
    the frames fit; more than ``DECOMPRESS_MAX`` bytes raise."""
    try:
        size = content_size(data)
    except ZstdError:           # the decoder names the fault and its frame
        size = None
    cap = max(size if size is not None else 4 * len(data), 64)
    while True:
        if cap > DECOMPRESS_MAX:
            raise ZstdError(f"zstd: more than {DECOMPRESS_MAX} bytes to "
                            f"decode", 0, DST_TOO_SMALL)
        out = np.empty(cap, np.uint8)
        try:
            n = decompress_into(data, out)
        except ZstdError as e:
            if size is None and e.code == DST_TOO_SMALL:
                cap *= 2
                continue
            raise
        return out[:n].tobytes()


def take_stats() -> dict:
    """How many of each block type, literals form and sequence table mode
    (``STAT_NAMES``) this thread's decodes met since the last call; the
    counts start again from 0."""
    out = np.zeros(len(STAT_NAMES), np.uint64)
    n = _library().vp_zstd_stats(out.ctypes.data, out.size)
    if n != len(STAT_NAMES):
        raise RuntimeError(f"zstd_decode counts {n} statistics, expected "
                           f"{len(STAT_NAMES)}")
    return dict(zip(STAT_NAMES, map(int, out)))


def raw_frame_parts(data) -> list:
    """``data`` as one zstd frame of Raw blocks, as a list of byte parts
    (views of ``data``, no copy): no compression, no checksum, the content
    size in the header. Valid zstd for any reader."""
    view = memoryview(_u8(data)).cast("B")
    n = len(view)
    # 0xC0: an 8-byte content size after a window descriptor; 0x38: a 128
    # KiB window (Raw blocks refer to no earlier byte), so no reader refuses
    # the frame for the memory a window as large as the content would take
    parts = [struct.pack("<IBBQ", MAGIC, 0xC0, 0x38, n)]
    if n == 0:
        parts.append(b"\x01\x00\x00")  # one empty last Raw block
    for at in range(0, n, BLOCK_MAX):
        size = min(BLOCK_MAX, n - at)
        parts.append((size << 3 | int(at + size >= n)).to_bytes(3, "little"))
        parts.append(view[at:at + size])
    return parts
