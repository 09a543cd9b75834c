"""ctypes bindings for the native image-decode core (counterpart of the JAX
package's data/fastimage.py; the library is the repository's
``native/libfastimage.so``, built from ``native/fastimage.cpp``).

The library is optional: `available()` reports whether it loads, from
``$FASTIMAGE_SO`` if set, else ``native/libfastimage.so``. The loaders check
it when they are built with ``use_native=True`` and raise there if it does
not load. The native path is deterministic under the same (seed, epoch,
index) contract as the PIL loader but is not byte-identical to PIL
(different bilinear filter taps), so a run sticks to one decoder.

The committed library needs ``libjpeg.so.62`` and ``libpng16.so.16``. On a
host that lacks them, the same libraries come from Pillow's wheel, which
bundles libjpeg-turbo and libpng under hashed names: a copy of each, given
its standard soname, is written to ``vit_project_torch/_build/`` and loaded
first, so the committed library binds to it (``_pillow_deps``).
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import struct

import numpy as np

MODE_RESIZE = 0          # THINGS: Resize((size, size))
MODE_RRC_FLIP = 1        # ImageNet train: RandomResizedCrop + h-flip
MODE_CENTER_CROP = 2     # ImageNet val: shorter-side resize + center crop

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_DEPS_DIR = os.path.join(_REPO, "vit_project_torch", "_build",
                         "fastimage-deps")
# (file pattern in Pillow's bundle, the soname the committed library needs)
_PILLOW_DEPS = (("libjpeg-*.so.62*", "libjpeg.so.62"),
                ("libpng16-*.so.16*", "libpng16.so.16"))


def _lib_path() -> str:
    return os.path.join(_REPO, "native", "libfastimage.so")


def _set_soname(path: str, soname: str) -> None:
    """Rewrite the DT_SONAME string of the ELF64 little-endian library at
    `path` in place (the new name must not be longer than the old)."""
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if data[:4] != b"\x7fELF" or data[4] != 2 or data[5] != 1:
            raise ValueError(f"{path}: not an ELF64 little-endian library")
        phoff, = struct.unpack_from("<Q", data, 0x20)
        phentsize, phnum = struct.unpack_from("<HH", data, 0x36)
        loads, dynamic = [], None
        for i in range(phnum):
            p_type, _, p_offset, p_vaddr, _, p_filesz, _, _ = \
                struct.unpack_from("<IIQQQQQQ", data, phoff + i * phentsize)
            if p_type == 1:                              # PT_LOAD
                loads.append((p_vaddr, p_offset, p_filesz))
            elif p_type == 2:                            # PT_DYNAMIC
                dynamic = (p_offset, p_filesz)
        if dynamic is None:
            raise ValueError(f"{path}: no dynamic section")
        tags = {}
        for off in range(dynamic[0], dynamic[0] + dynamic[1], 16):
            tag, val = struct.unpack_from("<qQ", data, off)
            if tag == 0:                                 # DT_NULL
                break
            tags.setdefault(tag, val)
        if 5 not in tags or 14 not in tags:              # DT_STRTAB, DT_SONAME
            raise ValueError(f"{path}: no soname")
        strtab = next((off + tags[5] - vaddr for vaddr, off, size in loads
                       if vaddr <= tags[5] < vaddr + size), None)
        if strtab is None:
            raise ValueError(f"{path}: string table outside every segment")
        at = strtab + tags[14]
        old = data[at:data.index(b"\0", at)]
        new = soname.encode()
        if len(new) > len(old):
            raise ValueError(f"{path}: soname {old!r} is shorter than "
                             f"{soname!r}")
        data[at:at + len(old)] = new + b"\0" * (len(old) - len(new))
        f.seek(0)
        f.write(data)


@functools.cache
def _pillow_deps() -> bool:
    """Load libjpeg and libpng from Pillow's bundle under the sonames the
    committed library needs. False if Pillow bundles no single match."""
    try:
        import PIL
    except ImportError:
        return False
    bundle = os.path.join(os.path.dirname(PIL.__path__[0]), "pillow.libs")
    found = [glob.glob(os.path.join(bundle, pattern))
             for pattern, _ in _PILLOW_DEPS]
    if any(len(f) != 1 for f in found):
        return False
    os.makedirs(_DEPS_DIR, exist_ok=True)
    for (src,), (_, soname) in zip(found, _PILLOW_DEPS):
        dst = os.path.join(_DEPS_DIR, soname)
        tmp = f"{dst}.{os.getpid()}.tmp"
        shutil.copyfile(src, tmp)
        _set_soname(tmp, soname)
        os.replace(tmp, dst)  # atomic: another process never sees half a file
        # local scope: the dynamic loader matches the committed library's
        # DT_NEEDED against the soname of every object already loaded, so
        # the copy need not enter the global symbol scope
        ctypes.CDLL(dst)
    return True


@functools.cache
def _open(path: str):
    """The library at `path` with its functions declared, or None if it is
    missing or does not load."""
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # a missing libjpeg / libpng: take Pillow's, then try once more
        try:
            if not _pillow_deps():
                return None
            lib = ctypes.CDLL(path)
        except (OSError, ValueError):
            return None
    lib.fi_transform.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
    lib.fi_transform.restype = ctypes.c_int
    lib.fi_transform_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int]
    lib.fi_transform_batch.restype = ctypes.c_int
    if hasattr(lib, "fi_transform_mem_batch"):  # fi_version >= 2
        lib.fi_transform_mem_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.fi_transform_mem_batch.restype = ctypes.c_int
    return lib


def _load():
    return _open(os.environ.get("FASTIMAGE_SO", _lib_path()))


def available() -> bool:
    return _load() is not None


def mem_available() -> bool:
    """True when the library also exposes the memory-decode API
    (fi_version >= 2): the packed-dataset loaders check this at
    construction, so a stale v1 library fails there, not at the first
    batch."""
    lib = _load()
    return lib is not None and hasattr(lib, "fi_transform_mem_batch")


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("libfastimage.so not built (make -C native)")
    return lib


def _check_crop(mode: int, out_h: int, out_w: int, resize_to: int) -> None:
    if mode == MODE_CENTER_CROP and max(out_h, out_w) > resize_to:
        # mode 2 center-crops the resize_to-short-side image; a larger crop
        # would copy from negative offsets in the C++ core
        raise ValueError(f"center crop {out_h}x{out_w} exceeds resize_to="
                         f"{resize_to}; pass a proportionally larger "
                         f"resize_to")


def _seeds(seeds, n: int, what: str) -> np.ndarray:
    seeds = np.ascontiguousarray(np.asarray(seeds, np.uint64))
    if len(seeds) != n:
        # the native loop reads seeds[i] for every image: a short array
        # would be an out-of-bounds read inside the library
        raise ValueError(f"seeds ({len(seeds)}) must match {what} ({n})")
    return seeds


def transform(path: str, mode: int, out_h: int, out_w: int,
              resize_to: int = 256, seed: int = 0) -> np.ndarray:
    lib = _lib()
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.fi_transform(
        path.encode(), mode, out_h, out_w, resize_to, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"fastimage failed ({rc}) on {path}")
    return out


def transform_batch(paths: list[str], mode: int, out_h: int, out_w: int,
                    seeds, resize_to: int = 256,
                    threads: int = 16) -> np.ndarray:
    lib = _lib()
    n = len(paths)
    seeds = _seeds(seeds, n, "paths")
    _check_crop(mode, out_h, out_w, resize_to)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failed = lib.fi_transform_batch(
        arr, n, mode, out_h, out_w, resize_to,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    if failed:
        raise IOError(f"fastimage: {failed}/{n} images failed to decode")
    return out


def transform_mem_batch(buffers, mode: int, out_h: int, out_w: int,
                        seeds, resize_to: int = 256,
                        threads: int = 16) -> np.ndarray:
    """Like transform_batch, but decodes encoded bytes (memoryview, bytes or
    uint8 arrays of JPEG/PNG) instead of file paths: the packed-dataset path,
    records straight from the mmapped shard with no per-image file open."""
    lib = _lib()
    if not hasattr(lib, "fi_transform_mem_batch"):
        raise RuntimeError("libfastimage.so predates the memory-decode API "
                           "(rebuild: make -C native)")
    n = len(buffers)
    seeds = _seeds(seeds, n, "buffers")
    _check_crop(mode, out_h, out_w, resize_to)
    # each record as a contiguous uint8 view, kept alive across the call
    views = [np.frombuffer(b, np.uint8) for b in buffers]
    ptrs = (ctypes.c_void_p * n)(
        *[v.ctypes.data_as(ctypes.c_void_p).value for v in views])
    lens = (ctypes.c_size_t * n)(*[v.size for v in views])
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    failed = lib.fi_transform_mem_batch(
        ptrs, lens, n, mode, out_h, out_w, resize_to,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    if failed:
        raise IOError(f"fastimage: {failed}/{n} buffers failed to decode")
    return out
