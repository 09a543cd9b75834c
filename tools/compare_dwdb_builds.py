#!/usr/bin/env python3
"""Compare the dW+db kernel of two source trees: bits and time, in turns.

    python3 tools/compare_dwdb_builds.py OTHER_CSRC_DIR [--json PATH]

OTHER_CSRC_DIR holds another version of ``dw_db.cu`` (for example a parent
commit's, written out with ``git show REV:vit_project_torch/csrc/dw_db.cu``).
The script builds it with the port's nvcc flags beside the checkout's own
build and runs both on the same seeded inputs at every shape of
``chip_smoke.py``'s ``dwdb_cases()``, in float32 and bfloat16. It reports
whether dW and db have equal bits, each build's largest error against
``dw_db_reference`` over the largest |value| (held to ``DWDB_TOLERANCE``),
and both builds' times from CUDA events over 10 calls (3 in float32), taken
in turns: other, checkout, checkout, other.

The bits are expected to differ where the two builds sum in another order.
Two C interfaces are known: the checkout's (``ops/fused_dw.py`` calls it)
and the older split grid, ``dw_db(x, g, out, parts, N, Din, Dout, splits,
dtype, stream)``, whose wrapper chose ``splits`` to give about 264 blocks;
the script reads which one the other source has. Exits 1 if either build
is outside the tolerance. Needs one CUDA card and nvcc.

    python3 tools/compare_dwdb_builds.py --splits 1,3,5,7,9,13,22

times the checkout's build alone at those split counts, each forced on
every shape (rounded so that no split is empty), beside the count that
``ops/fused_dw.py schedule`` picks: the measurement its cost model is
fitted to.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the shapes, the tolerance and the timer)
from vit_project_torch.ops import cuda_build  # noqa: E402
from vit_project_torch.ops import fused_dw as vfdw  # noqa: E402

SPLIT_GRID_ABI = re.compile(
    r"int\s+dw_db\([^)]*int\s+Dout,\s*int\s+splits,\s*int\s+dtype,\s*void\*\s*stream\)")


def build_other(src: Path) -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # named by content: the loader hands back an already loaded path unchanged
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = cuda_build.BUILD_DIR / f"libdw_db-other-{digest}.so"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}")
    return ctypes.CDLL(str(out))


def split_grid_launcher(lib: ctypes.CDLL):
    """dw_db through the split-grid interface, with that wrapper's choice of
    splits: enough for about 264 blocks, never more than the row steps."""
    fn = lib.dw_db
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile = {"torch.bfloat16": (128, 32), "torch.float32": (64, 16)}

    def launch(x, g):
        import torch
        (N, Din), Dout = x.shape, g.shape[1]
        edge, step = tile[str(x.dtype)]
        tiles = -(-Din // edge) * -(-Dout // edge)
        splits = max(1, min(-(-264 // tiles), -(-N // step)))
        out = torch.empty(Din * Dout + Dout, dtype=torch.float32, device=x.device)
        parts = (torch.empty(splits, Din * Dout + Dout, dtype=torch.float32,
                             device=x.device) if splits > 1 else None)
        err = fn(x.data_ptr(), g.data_ptr(), out.data_ptr(),
                 None if parts is None else parts.data_ptr(), N, Din, Dout, splits,
                 1 if x.dtype == torch.bfloat16 else 0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"other dw_db failed: CUDA error {err}")
        return out[:Din * Dout].view(Din, Dout), out[Din * Dout:]
    return launch


def current_launcher(lib: ctypes.CDLL):
    """dw_db through the checkout's wrapper, with `lib` in place of its build."""
    def launch(x, g):
        saved = cuda_build._loaded.get("dw_db")
        cuda_build._loaded["dw_db"] = lib
        try:
            return vfdw.dw_db(x, g)
        finally:
            if saved is None:
                cuda_build._loaded.pop("dw_db", None)
            else:
                cuda_build._loaded["dw_db"] = saved
    return launch


def sweep_splits(counts: list[int]) -> list[dict]:
    """The checkout's build at every dwdb_cases() shape and dtype, timed with
    the schedule's own split count and with each of `counts` forced."""
    import torch
    chosen = vfdw.schedule
    results = []
    try:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            for label, N, Din, Dout in chip_smoke.dwdb_cases():
                gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
                x = torch.randn(N, Din, generator=gen, device="cuda").to(dtype)
                g = torch.randn(N, Dout, generator=gen, device="cuda").to(dtype)
                for want in [None, *counts]:
                    def forced(n, din, dout, r, want=want):
                        base = chosen(n, din, dout, r)
                        if want is None:
                            return base
                        per = -(-base.steps // want)
                        return dataclasses.replace(base, splits=-(-base.steps // per),
                                                   steps_per_split=per)
                    vfdw.schedule = forced
                    sched = forced(N, Din, Dout, vfdw.route(x, g))
                    ms = chip_smoke.cuda_ms(lambda: vfdw.dw_db(x, g),
                                            10 if dtype == torch.bfloat16 else 3)
                    results.append({"case": label, "dtype": dname, "chosen": want is None,
                                    "splits": sched.splits, "items": sched.items,
                                    "blocks": sched.blocks, "ms": ms})
                    print(f"[splits] dw_db {label:5s} {dname:8s} {sched.route} "
                          f"{'chosen' if want is None else 'forced'} splits "
                          f"{sched.splits:3d} items {sched.items:5d} waves "
                          f"{-(-sched.items // sched.blocks):3d} kernel_ms {ms:.4f}",
                          flush=True)
                del x, g
                torch.cuda.empty_cache()
    finally:
        vfdw.schedule = chosen
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=Path, nargs="?")
    ap.add_argument("--splits", default=None, metavar="N,N,...",
                    help="time the checkout's build at these split counts instead")
    ap.add_argument("--json", default=None, help="also write the results here")
    opts = ap.parse_args(argv)
    if (opts.other_csrc is None) == (opts.splits is None):
        ap.error("give OTHER_CSRC_DIR or --splits")
    import torch
    if not torch.cuda.is_available():
        print("compare_dwdb_builds: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {chip_smoke.smi_line()}", flush=True)
    if opts.splits is not None:
        results = sweep_splits([int(n) for n in opts.splits.split(",")])
        if opts.json:
            os.makedirs(os.path.dirname(os.path.abspath(opts.json)), exist_ok=True)
            with open(opts.json, "w") as f:
                json.dump(results, f, indent=1)
        return 0
    src = opts.other_csrc / cuda_build.SOURCES["dw_db"]
    cuda_build.build(["dw_db"])
    lib = build_other(src)
    split_grid = bool(SPLIT_GRID_ABI.search(src.read_text()))
    other = split_grid_launcher(lib) if split_grid else current_launcher(lib)
    print(f"[bits] other build: {src} ({'split-grid' if split_grid else 'current'}"
          f" interface)", flush=True)
    sides = {"checkout": vfdw.dw_db, "other": other}
    results, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, N, Din, Dout in chip_smoke.dwdb_cases():
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
            x = torch.randn(N, Din, generator=gen, device="cuda").to(dtype)
            g = torch.randn(N, Dout, generator=gen, device="cuda").to(dtype)
            got = {k: fn(x, g) for k, fn in sides.items()}
            torch.cuda.synchronize()
            ref = vfdw.dw_db_reference(x, g)
            rel = {k: max((a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                          for a, r in zip(v, ref)) for k, v in got.items()}
            ok &= all(e <= chip_smoke.DWDB_TOLERANCE for e in rel.values())
            equal = all(torch.equal(a, b) for a, b in zip(got["checkout"], got["other"]))
            del got, ref
            it = 10 if dtype == torch.bfloat16 else 3
            ms = {"other": [], "checkout": []}
            for side in ("other", "checkout", "checkout", "other"):
                ms[side].append(chip_smoke.cuda_ms(lambda: sides[side](x, g), it))
            ms = {k: sum(v) / len(v) for k, v in ms.items()}
            results.append({"case": label, "dtype": dname, "shape": [N, Din, Dout],
                            "bit_identical": equal, "relative_error": rel,
                            "ms_checkout": ms["checkout"], "ms_other": ms["other"],
                            "route": vfdw.route(x, g)})
            print(f"[bits] dw_db {label:5s} {dname:8s} "
                  f"{'equal bits' if equal else 'bits differ'}; max |err| / max |ref| "
                  f"checkout {rel['checkout']:.1e}, other {rel['other']:.1e}; kernel_ms "
                  f"checkout {ms['checkout']:.4f}, other {ms['other']:.4f} "
                  f"({ms['other'] / ms['checkout']:.2f}x)", flush=True)
            del x, g
            torch.cuda.empty_cache()
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)), exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump(results, f, indent=1)
    same = sum(r["bit_identical"] for r in results)
    print(f"[bits] {same} of {len(results)} (shape, dtype) runs bit-identical; both "
          f"builds within {chip_smoke.DWDB_TOLERANCE}: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
