"""Build the port's CUDA kernels with nvcc, and its host C++ with g++, and
load them through ctypes.

Every kernel source under ``vit_project_torch/csrc/`` is compiled for Hopper
(``sm_90a``) into a shared library with a plain C interface; the host
sources (``HOST_SOURCES``: the zstd decoder the checkpoint reader uses) are
compiled by the host compiler the same way. A library is built at first use
into ``vit_project_torch/_build/`` (listed in ``.gitignore``), named by a
hash of its source, the headers beside it and the compiler flags, so an
edited source builds anew, and written under a temporary name then renamed,
so processes that build it at once never load half a library. ``build()``
starts one compiler process for each missing library, all at once, and
waits for all of them.

Nothing here runs when the module is imported: the CPU tests import every
module, and a host without ``nvcc`` never reaches a build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# library name -> its source under csrc/
SOURCES = {"flash3_fwd": "flash3_fwd.cu", "flash3_bwd": "flash3_bwd.cu",
           "dw_db": "dw_db.cu", "layernorm": "layernorm.cu"}

# host (g++) library name -> its source under csrc/
HOST_SOURCES = {"zstd_decode": "zstd_decode.cpp"}

GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels needs "
                       "the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")


def gxx_path() -> str:
    """The host C++ compiler: ``g++`` on PATH."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: building the port's host libraries "
                       "(the zstd decoder) needs a C++17 compiler on PATH")


def library_path(name: str) -> Path:
    """Where the library built from ``SOURCES[name]`` (or
    ``HOST_SOURCES[name]``) lives, by content hash."""
    h = hashlib.sha256()
    if name in HOST_SOURCES:
        h.update(" ".join(GXX_FLAGS).encode())
        h.update((CSRC_DIR / HOST_SOURCES[name]).read_bytes())
    else:
        h.update(" ".join(NVCC_FLAGS).encode())
        h.update((CSRC_DIR / SOURCES[name]).read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / SOURCES[name])]


def gxx_command(gxx: str, name: str, out: Path) -> list[str]:
    return [gxx, *GXX_FLAGS, "-o", str(out),
            str(CSRC_DIR / HOST_SOURCES[name])]


def build(names=None) -> dict[str, Path]:
    """Build every named library that is not built yet (the CUDA kernels
    when no name is given), one compiler process per source, all started
    together. Returns {name: library path}. Raises with the compiler's
    output if any build fails. The compiler's report (ptxas registers and
    shared memory) is kept beside each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    missing = [n for n, out in paths.items() if not out.exists()]
    nvcc = nvcc_path() if any(n not in HOST_SOURCES for n in missing) else ""
    gxx = gxx_path() if any(n in HOST_SOURCES for n in missing) else ""
    for n in missing:
        out = paths[n]
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = (gxx_command(gxx, n, tmp) if n in HOST_SOURCES
               else nvcc_command(nvcc, n, tmp))
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's report from the build of ``name`` ('' if none kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
