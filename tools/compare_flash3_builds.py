#!/usr/bin/env python3
"""Compare the attention kernels of two source trees, bit for bit, and time them.

    python3 tools/compare_flash3_builds.py OTHER_CSRC_DIR [--json PATH]
        [--may-differ ENTRY/DTYPE ...] [--entries ENTRY,...]

OTHER_CSRC_DIR holds another version of ``flash3_fwd.cu``, ``flash3_bwd.cu``
and ``attention.cuh`` (for example a parent commit's, written out with
``git show REV:vit_project_torch/csrc/flash3_fwd.cu``). The script builds them
with the port's nvcc flags beside the checkout's own build and runs both
through the same wrappers (``ops/attention.py``) on the same seeded inputs:

- ``flash3_fwd`` / ``flash3_bwd`` (packed qkv) at every shape of
  ``chip_smoke.py``'s ``attention_cases()`` (forward) and ``bwd_cases()``
  (backward);
- ``flash_fwd`` / ``flash_bwd`` (q, k, v [B, S, D]) and ``mha_fwd`` /
  ``mha_bwd`` ([B, H, S, 64]) at ``strided_cases()``;

in float32 and bfloat16. Both backwards of a flash pair take the same lse
(the checkout's forward). It reports whether the outputs have equal bits,
and times both builds in one process, in turns (other, checkout, checkout,
other; CUDA events over 10 calls each), with the ratio. Exits 1 if any bits
differ, except in the (entry, dtype) runs named by ``--may-differ`` (e.g.
``flash3_bwd/bfloat16`` where the other tree sums in another order).
``--entries`` runs a subset. The other build always gets the backward's
scratch, as a build without a whole-head route needs it. Needs one CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the shapes and the seeded inputs)
from vit_project_torch.ops import attention as vattn  # noqa: E402
from vit_project_torch.ops import cuda_build  # noqa: E402

LIBS = ("flash3_fwd", "flash3_bwd")


def build_other(src_dir: Path) -> dict[str, ctypes.CDLL]:
    """Build the other tree's two sources, one nvcc each, in parallel."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBS:
        out = cuda_build.BUILD_DIR / f"lib{name}-other-{os.getpid()}.so"
        procs[name] = (out, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(src_dir / cuda_build.SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {src_dir / cuda_build.SOURCES[name]}"
                             f":\n{log}")
        for line in log.splitlines():   # ptxas: registers and spills
            if "Used" in line or "spill" in line:
                print(f"[other build] {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out))
    return libs


@contextlib.contextmanager
def using(libs: dict[str, ctypes.CDLL]):
    """Make the wrappers load `libs` in place of the checkout's build."""
    saved = {n: cuda_build._loaded.get(n) for n in libs}
    saved_max_s = vattn.BWD_WHOLE_HEAD_MAX_S
    cuda_build._loaded.update(libs)
    vattn.BWD_WHOLE_HEAD_MAX_S = 0      # every call allocates the scratch
    try:
        yield
    finally:
        vattn.BWD_WHOLE_HEAD_MAX_S = saved_max_s
        for n, lib in saved.items():
            if lib is None:
                cuda_build._loaded.pop(n, None)
            else:
                cuda_build._loaded[n] = lib


ENTRIES = ("flash3_fwd", "flash3_bwd", "flash_fwd", "flash_bwd", "mha_fwd",
           "mha_bwd")


def cases(entry):
    return {"flash3_fwd": chip_smoke.attention_cases,
            "flash3_bwd": chip_smoke.bwd_cases}.get(
                entry, chip_smoke.strided_cases)()


def make_run(entry, B, S, H, causal, dtype):
    """A call of `entry` on seeded inputs at one shape, returning a tuple of
    outputs."""
    import torch
    D = H * 64
    if entry.startswith("flash3"):
        qkv, gen = chip_smoke._random_qkv(B, S, H, dtype)
        do = torch.randn(B, S, D, generator=gen, device="cuda").to(dtype)
        if entry == "flash3_fwd":
            return lambda: vattn.flash3_fwd(qkv, H, causal)
        _, lse = vattn.flash3_fwd(qkv, H, causal)
        return lambda: (vattn.flash3_bwd(qkv, do, lse, H, causal),)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    if entry.startswith("flash"):
        q = chip_smoke._randn((B, S, D), gen, dtype, 0.125)   # q prescaled
        k, v, do = (chip_smoke._randn((B, S, D), gen, dtype) for _ in range(3))
        if entry == "flash_fwd":
            return lambda: vattn.flash_fwd(q, k, v, H, causal)
        _, lse = vattn.flash_fwd(q, k, v, H, causal)
        return lambda: vattn.flash_bwd(q, k, v, do, lse, H, causal)
    q, k, v, do = (chip_smoke._randn((B, H, S, 64), gen, dtype)
                   for _ in range(4))
    if entry == "mha_fwd":
        return lambda: (vattn.mha_fwd(q, k, v, causal),)
    return lambda: vattn.mha_bwd(q, k, v, do, causal)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--json", default=None, help="also write the results here")
    ap.add_argument("--may-differ", action="append", default=[],
                    metavar="ENTRY/DTYPE",
                    help="runs whose bits may differ, e.g. mha_bwd/bfloat16")
    ap.add_argument("--entries", default=",".join(ENTRIES),
                    help="comma list of entries to compare (default: all)")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("compare_flash3_builds: no CUDA device is visible", file=sys.stderr)
        return 2
    print(f"[card] {chip_smoke.smi_line()}", flush=True)
    cuda_build.build(list(LIBS))
    other = build_other(opts.other_csrc)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for entry in opts.entries.split(","):
            for label, B, S, H, causal in cases(entry):
                run = make_run(entry, B, S, H, causal, dtype)
                mine = run()
                with using(other):
                    theirs = run()
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(mine, theirs))
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(mine, theirs))
                ms = {"other": [], "checkout": []}
                for side in ("other", "checkout", "checkout", "other"):
                    with using(other) if side == "other" else \
                            contextlib.nullcontext():
                        ms[side].append(chip_smoke.cuda_ms(run, 10))
                ms = {k: sum(v) / len(v) for k, v in ms.items()}
                results.append({"entry": entry, "case": label,
                                "dtype": dname, "bit_identical": equal,
                                "max_abs_diff": err,
                                "may_differ": f"{entry}/{dname}"
                                in opts.may_differ,
                                "ms_checkout": ms["checkout"],
                                "ms_other": ms["other"],
                                "speedup": ms["other"] / ms["checkout"]})
                print(f"[bits] {entry:10s} {label:10s} {dname:8s} "
                      f"{'equal bits' if equal else 'DIFFER'} (max |diff| "
                      f"{err:.3e}); kernel_ms checkout {ms['checkout']:.4f}, "
                      f"other {ms['other']:.4f}, "
                      f"{ms['other'] / ms['checkout']:.2f}x", flush=True)
                del run, mine, theirs
                torch.cuda.empty_cache()
    same = sum(r["bit_identical"] for r in results)
    print(f"[bits] {same} of {len(results)} (entry, shape, dtype) runs "
          f"bit-identical between the checkout and {opts.other_csrc}",
          flush=True)
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)), exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump(results, f, indent=1)
    held = [r for r in results if not r["may_differ"]]
    print(f"[bits] {sum(r['bit_identical'] for r in held)} of {len(held)} "
          f"runs held to equal bits are equal", flush=True)
    return 0 if all(r["bit_identical"] for r in held) else 1


if __name__ == "__main__":
    raise SystemExit(main())
