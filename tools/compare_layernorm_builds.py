#!/usr/bin/env python3
"""Compare the LayerNorm kernels of two source trees, bit for bit, and time them.

    python3 tools/compare_layernorm_builds.py OTHER_CSRC_DIR [--json PATH]

OTHER_CSRC_DIR holds another version of ``layernorm.cu`` (for example a parent
commit's, written out with ``git show REV:vit_project_torch/csrc/layernorm.cu``).
The script builds it with the port's nvcc flags beside the checkout's own build
and runs both on the same seeded inputs at every shape of ``chip_smoke.py``'s
``ln_cases()`` (the ViT-B/16 step's, the CLIP-HBA image tower's and the causal
text tower's residual streams), in float32 and bfloat16 with float32 scale and
bias:

- ``ln_fwd``: y, mean and rstd must have equal bits;
- ``ln_bwd`` on the checkout forward's statistics: dx must have equal bits;
  dscale and dbias, whose sums may be partitioned otherwise, must agree within
  ``chip_smoke.LN_TOLERANCE``'s bound on them (max |diff| over the largest
  value).

The checkout runs through its wrappers (``ops/layernorm.py``). The other build
is called through its own C interface: that of this tree's sources if it
exports ``ln_bwd_schedule`` (whose last entry is the scratch ``ln_bwd`` takes),
else the first port's (``ln_fwd`` / ``ln_bwd`` with a per-call ``rows`` and a
two-kernel backward, whose rows per block this script computes as that
wrapper did).

Times, in one process and in turns (other, checkout, checkout, other): CUDA
events around 20 calls each (kernel_ms, the host's cost included where it is
the larger) and torch.profiler's device time per call (device_ms). Exits 1 if
any output held to equal bits differs or dscale / dbias leave the bound. Needs
one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the shapes, inputs, tolerances and timers)
from vit_project_torch.ops import cuda_build  # noqa: E402
from vit_project_torch.ops import layernorm as vln  # noqa: E402


def build_other(src_dir: Path) -> ctypes.CDLL:
    out = cuda_build.BUILD_DIR / f"liblayernorm-other-{os.getpid()}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
         str(src_dir / "layernorm.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src_dir / 'layernorm.cu'}:\n{log}")
    for line in log.splitlines():      # ptxas: registers and spills
        if "Used" in line or "spill" in line:
            print(f"[other build] {line.strip()}", flush=True)
    return ctypes.CDLL(str(out))


def first_port_block_rows(N: int) -> int:
    """Rows per block of the first port's backward: the most of 256, 128 and
    64 that still gives 264 blocks, else 32."""
    for rows in (256, 128, 64):
        if -(-N // rows) >= 264:
            return rows
    return 32


class Other:
    """ln_fwd / ln_bwd of the other build, with the wrappers' outputs."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        self.current_abi = hasattr(lib, "ln_bwd_schedule")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ln_fwd.restype = lib.ln_bwd.restype = i
        if self.current_abi:
            lib.ln_fwd.argtypes = [p] * 6 + [i, i, ctypes.c_float, i, i, p]
            lib.ln_bwd.argtypes = [p] * 8 + [i] * 4 + [p]
        else:
            lib.ln_fwd.argtypes = [p] * 6 + [i, i, ctypes.c_float, i, p]
            lib.ln_bwd.argtypes = [p] * 8 + [i] * 4 + [p]

    def fwd(self, x, scale, bias, eps=1e-5):
        import torch
        N, D = x.shape
        y = torch.empty_like(x)
        mean, rstd = torch.empty(2, N, 1, dtype=torch.float32,
                                 device=x.device).unbind(0)
        code = vln._DTYPE_CODES[x.dtype]
        stream = torch.cuda.current_stream().cuda_stream
        args = [x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), N, D, eps, code]
        if self.current_abi:
            args.append(x.device.index)
        err = self.lib.ln_fwd(*args, stream)
        if err:
            raise RuntimeError(f"other ln_fwd: CUDA error {err}")
        return y, mean, rstd

    def bwd(self, x, scale, mean, rstd, dy):
        import torch
        N, D = x.shape
        dx = torch.empty_like(x)
        dsb = torch.empty(2 * D, dtype=torch.float32, device=x.device)
        code = vln._DTYPE_CODES[x.dtype]
        stream = torch.cuda.current_stream().cuda_stream
        if self.current_abi:     # the schedule's last entry is the scratch
            out = (ctypes.c_long * 8)(*[-1] * 8)
            self.lib.ln_bwd_schedule(N, D, code, out)
            scratch = torch.empty([v for v in out if v >= 0][-1],
                                  dtype=torch.float32, device=x.device)
            tail = [N, D, code, x.device.index]
        else:
            rows = first_port_block_rows(N)
            scratch = torch.empty(-(-N // rows), 2 * D, dtype=torch.float32,
                                  device=x.device)
            tail = [N, D, rows, code]
        err = self.lib.ln_bwd(x.data_ptr(), scale.data_ptr(), mean.data_ptr(),
                              rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                              scratch.data_ptr(), dsb.data_ptr(), *tail,
                              stream)
        if err:
            raise RuntimeError(f"other ln_bwd: CUDA error {err}")
        return dx, dsb[:D], dsb[D:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--json", default=None, help="also write the results here")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("compare_layernorm_builds: no CUDA device is visible",
              file=sys.stderr)
        return 2
    print(f"[card] {chip_smoke.smi_line()}", flush=True)
    cuda_build.build(["layernorm"])
    for line in cuda_build.build_log("layernorm").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[checkout build] {line.strip()}", flush=True)
    other = Other(build_other(opts.other_csrc))
    results, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, B, S, D in chip_smoke.ln_cases():
            N = B * S
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
            x, scale, bias, dy = chip_smoke._ln_inputs(N, D, dtype, gen)
            mine_f = vln.ln_fwd(x, scale, bias)
            theirs_f = other.fwd(x, scale, bias)
            _, mean, rstd = mine_f
            mine_b = vln.ln_bwd(x, scale, mean, rstd, dy)
            theirs_b = other.bwd(x, scale, mean, rstd, dy)
            torch.cuda.synchronize()
            equal = {n: torch.equal(a.reshape(-1), b.reshape(-1)) for n, a, b
                     in zip(("y", "mean", "rstd", "dx"),
                            (*mine_f, mine_b[0]), (*theirs_f, theirs_b[0]))}
            rel = {n: ((a - b).abs().max()
                       / b.abs().max().clamp_min(1e-30)).item()
                   for n, a, b in zip(("dscale", "dbias"), mine_b[1:],
                                      theirs_b[1:])}
            params_equal = all(torch.equal(a, b) for a, b in
                               zip(mine_b[1:], theirs_b[1:]))
            bound = chip_smoke.LN_TOLERANCE[dname]["dparams"]
            row_ok = all(equal.values()) and max(rel.values()) <= bound
            ok &= row_ok
            calls = {
                "fwd": (lambda: vln.ln_fwd(x, scale, bias),
                        lambda: other.fwd(x, scale, bias)),
                "bwd": (lambda: vln.ln_bwd(x, scale, mean, rstd, dy),
                        lambda: other.bwd(x, scale, mean, rstd, dy))}
            times = {}
            for half, (mine, theirs) in calls.items():
                ms = {"other": [], "checkout": []}
                dev = {"other": [], "checkout": []}
                for side in ("other", "checkout", "checkout", "other"):
                    fn = mine if side == "checkout" else theirs
                    ms[side].append(chip_smoke.cuda_ms(fn, 20))
                    prof = chip_smoke._profile(fn, steps=10)
                    dev[side].append(prof and prof["device_ms_per_call"])
                times[half] = {
                    f"{k}_{side}": (sum(v[side]) / 2 if None not in v[side]
                                    else None)
                    for k, v in (("kernel_ms", ms), ("device_ms", dev))
                    for side in ("checkout", "other")}
            row = {"case": label, "dtype": dname, "shape": [N, D],
                   "equal_bits": equal, "dparams_equal_bits": params_equal,
                   "dparams_relative_diff": rel, "dparams_bound": bound,
                   "ok": row_ok, "times": times}
            results.append(row)
            print(f"[bits] {label:9s} {dname:8s} "
                  + " ".join(f"{n} {'equal' if e else 'DIFFER'}"
                             for n, e in equal.items())
                  + f"; dscale/dbias {'equal' if params_equal else 'differ'}"
                  f" (max rel {max(rel.values()):.2e}, bound {bound})",
                  flush=True)
            for half, t in times.items():
                print(f"[time] {label:9s} {dname:8s} ln_{half} kernel_ms "
                      f"checkout {t['kernel_ms_checkout']:.4f} other "
                      f"{t['kernel_ms_other']:.4f}; device_ms checkout "
                      f"{t['device_ms_checkout']} other "
                      f"{t['device_ms_other']}", flush=True)
            del x, scale, bias, dy, mine_f, theirs_f, mine_b, theirs_b
            torch.cuda.empty_cache()
    held = sum(r["ok"] for r in results)
    print(f"[bits] {held} of {len(results)} (shape, dtype) runs: y, mean, "
          f"rstd, dx equal and dscale, dbias within the bound", flush=True)
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)), exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
