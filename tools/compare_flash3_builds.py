#!/usr/bin/env python3
"""Compare the packed flash3 attention kernels of two source trees, bit for bit.

    python3 tools/compare_flash3_builds.py OTHER_CSRC_DIR [--json PATH]

OTHER_CSRC_DIR holds another version of ``flash3_fwd.cu`` and
``flash3_bwd.cu`` (for example a parent commit's, written out with
``git show REV:vit_project_torch/csrc/flash3_fwd.cu``). The script builds them
with the port's nvcc flags beside the checkout's own build, runs both through
the same wrappers (``ops/attention.py flash3_fwd`` / ``flash3_bwd``) at every
shape of ``chip_smoke.py``'s ``attention_cases()`` (forward) and
``bwd_cases()`` (backward), in float32 and bfloat16, on the same seeded
inputs, and reports whether o, lse and dqkv have equal bits. It also times
both builds in one process, in turns (other, checkout, checkout, other; CUDA
events over 10 calls each). Exits 1 if any bits differ, except in the
(direction, dtype) runs named by ``--may-differ`` (e.g. ``bwd/bfloat16``
where the other tree's bf16 backward sums in another order). The other
build always gets a row-sum scratch, as a build without the whole-head
route needs one. Needs one CUDA card and nvcc.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--json", default=None, help="also write the results here")
    ap.add_argument("--may-differ", action="append", default=[],
                    metavar="DIRECTION/DTYPE",
                    help="runs whose bits may differ, e.g. bwd/bfloat16")
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
        for direction, cases in (("fwd", chip_smoke.attention_cases()),
                                 ("bwd", chip_smoke.bwd_cases())):
            for label, B, S, H, causal in cases:
                qkv, gen = chip_smoke._random_qkv(B, S, H, dtype)
                do = torch.randn(B, S, H * 64, generator=gen,
                                 device="cuda").to(dtype)
                _, lse = vattn.flash3_fwd(qkv, H, causal)   # both backwards' input

                def run():
                    if direction == "fwd":
                        return vattn.flash3_fwd(qkv, H, causal)
                    return (vattn.flash3_bwd(qkv, do, lse, H, causal),)
                mine = run()
                with using(other):
                    theirs = run()
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(mine, theirs))
                ms = {"other": [], "checkout": []}
                for side in ("other", "checkout", "checkout", "other"):
                    with using(other) if side == "other" else \
                            contextlib.nullcontext():
                        ms[side].append(chip_smoke.cuda_ms(run, 10))
                ms = {k: sum(v) / len(v) for k, v in ms.items()}
                results.append({"direction": direction, "case": label,
                                "dtype": dname, "bit_identical": equal,
                                "may_differ": f"{direction}/{dname}"
                                in opts.may_differ,
                                "ms_checkout": ms["checkout"],
                                "ms_other": ms["other"]})
                print(f"[bits] flash3_{direction} {label:10s} {dname:8s} "
                      f"{'equal bits' if equal else 'DIFFER'}; kernel_ms "
                      f"checkout {ms['checkout']:.4f}, other "
                      f"{ms['other']:.4f}", flush=True)
                del qkv, do, lse, mine, theirs
                torch.cuda.empty_cache()
    same = sum(r["bit_identical"] for r in results)
    print(f"[bits] {same} of {len(results)} (direction, shape, dtype) runs "
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
