#!/usr/bin/env python3
"""Drive the PyTorch port (vit_project_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from csrc/ with nvcc (one process
   per source, all started together) and prints the build time;
3. phase `kernel`: runs each kernel against its plain PyTorch version on
   the card at the shapes its main path gives it (the attention forward at
   the serving buckets and the ViT-B/16 step, the backward at the training
   steps' image and text shapes, the dW+db kernel at every dense layer of
   the ViT-B/16 step, and the attention library's four kernels, flash_fwd /
   flash_bwd and mha_fwd / mha_bwd, at the ViT-B/16 step, the CLIP-HBA
   training image shape and the causal text shape, and the LayerNorm pair
   ln_fwd / ln_bwd at those three shapes' residual streams), in float32 and
   bfloat16, checks the largest errors against stated tolerances, and times
   the kernel, the plain version and one PyTorch library call for the same
   function beside the card's bound for that work (the attention
   backwards, dW+db and LayerNorm rows also give torch.profiler's device
   time; the dW+db rows also time the product alone, and the mha_bwd rows
   SDPA's backward on float32 copies, the same function as the kernel's);
3b. phase `ops`: calls the attention library's entry points,
   ``flash_mha_packed`` and ``attention_core`` / ``attention_core_bshd``
   with ``use_kernel=True``, and ``layer_norm_fused``, as a user would on
   CUDA tensors at those three shapes in both dtypes, with the gradients
   through ``torch.autograd.grad``. It checks one forward and one backward
   launch per call, and the output and the gradients against the same
   calls on the plain versions;
4. phase `serve`: writes seeded random CLIP ViT-L/14 weights (OpenAI
   format) and rank-32 DoRA adapters (reference names) to a scratch
   directory in the checkout, builds the engine through the port's
   ``cli.serve.build_clip_engine``, starts the HTTP daemon on an ephemeral
   port and POSTs requests, some of them concurrently. It checks every
   answer, that each dispatched chunk launched the attention kernel 36 times
   (24 image + 12 text blocks), that the served scores agree with the same
   model running the plain attention, and times served images/s;
5. phase `train`: trains seeded random CLIP ViT-L/14 weights with rank-32
   DoRA (bf16 compute, batch 64, lr 3e-4) on synthetic THINGS data of the
   real size, held in memory, through ``ClipHBATrainer`` and ``train_model``
   for 2 epochs into a scratch directory. It checks the CSV rows and the
   checkpoint files, that every step launched the backward kernel once,
   that a fresh trainer resumed from the epoch-1 files reproduces the
   epoch-2 row, and that one step's adapter gradients agree with the
   kernel and with the plain backward; it times steps, eval and RSA;
6. phase `vit_train`: writes a seeded synthetic ImageFolder (8 classes,
   1,024 train and 256 val JPEGs at 256^2) and trains ViT-B/16 at full
   width and depth (bf16 compute, batch 256, SGD) for 2 epochs through
   ``run_vit_training`` with ``fused_dw=True``. It checks the CSV rows and
   checkpoint files, that every step launched the dW+db kernel 49 times and
   the attention backward 12 times (the forward 12 per forward), that a run
   stopped after epoch 1 and resumed equals the uninterrupted run bit for
   bit, and that one step with the kernel agrees with the same step on the
   plain dW+db; it times steps on a batch already on the card (fused and
   plain backward in turns, with their spread), training images/s with
   host decode, validation and peak memory;
6b. phase `vit_grid`: the measurement grid through the CLIs' ``main``, at
   ViT-B/16's full width and depth (bf16, batch 256, SGD, fused_dw off as
   the grid's CLIs run it): writes the seeded ImageFolder and 48 THINGS
   JPEGs with an RDM, packs the ImageFolder with ``cli.pack``, trains a
   2-epoch baseline with ``cli.vit_train --use_native_loader`` (and once
   with PIL decode, for its images/s), writes ``rsa_results.csv`` with
   ``cli.vit_rsa_eval`` and runs ``cli.vit_measure`` at perturb epoch 1
   for the four perturbation types. It checks the CSVs' columns, rows and
   deltas, the launches of each CLI against the prediction (a cell: 132
   flash3_fwd, 48 flash3_bwd), the unperturbed replay of epoch 1 against
   the baseline's row, a gaussian cell measured twice, and rho on the
   kernel path against the plain attention; it times each cell's
   checkpoint load, perturbed epoch, validation and RSA, a step, and the
   native decoder against PIL on this host;
6c. phase `serve_vit`: serves ViT-B/16 at full width and depth from a
   seeded random checkpoint in the JAX layout through the serving CLI's
   builders (bf16, buckets 8 and 256, host requests): 12 flash3_fwd
   launches a chunk, the logits against the same engine on the plain
   attention, images/s and the forward ms at bucket 256; `--mode features`
   (its CLS token equals the classifier's bit for bit); `--quantize int8`
   for ViT-B/16 and for the CLIP ViT-L/14 engine with baked adapters
   against bf16 (stated tolerances, 12 and 36 launches a chunk, images/s
   in turns, torch.profiler's device time by group); the registered
   flash3_fwd op against a direct kernel call in turns; an AOT artifact
   written by `cli.serve --export_dir` and served in a fresh process, whose
   outputs must equal the live engine's bit for bit with 12 launches a
   chunk there; and one ViT-B/16 training epoch (fused_dw) with
   `profile_dir`, whose trace must name the flash3 and dw_db kernels;
6d. phase `dist`: data parallelism over torch.distributed as a user
   launches it, at ViT-B/16's full width and depth (bf16, global batch
   256, SGD lr 0.01, 2 epochs on phase vit_train's ImageFolder):
   ``cli.vit_train
   --fused_dw`` alone and under ``torchrun --standalone --nproc_per_node
   1`` in dp, ``--zero1`` and ``--fsdp`` (NCCL; one card, so world size
   1), each in its own process, which reports its kernel launches and
   peak memory. It checks 49 dw_db, 12 flash3_bwd and 12 flash3_fwd a
   step in every mode, dp and zero1 equal to the run alone bit for bit,
   fsdp within a stated tolerance; ``cli.vit_rsa_eval`` and one
   ``cli.vit_measure`` cell under torchrun write the CSVs the CLIs write
   alone, byte for byte; it times a step of each mode in turns in one
   process; then two ranks under gloo share the card: a dp run within the
   tolerance of the run alone, and the RSA gathered in dataset order;
6e. phase `clip_dist`: CLIP-HBA training across ranks as users launch it,
   at full width and depth (ViT-L/14, rank-32 DoRA, bf16, batch 64, 2
   epochs) on THINGS at its real size on disk (the images phase sweep
   reuses, here with random targets): ``cli.baseline`` alone and under
   ``torchrun --standalone --nproc_per_node 1`` (NCCL: the data-parallel
   step at world size 1), each counting its launches from 0 (36 flash3_fwd
   and 1 flash3_bwd a step, 36 an eval and an RSA), rows, DoRA and
   random-state pickles bit-equal; two gloo ranks sharing the card within
   the stated tolerance, one log, no file written by rank 1, peak memory a
   rank; one sequential ``cli.sweep`` run, which restores the baseline's
   AdamW state, over the two gloo ranks within that tolerance of world
   size 1; ms a step alone
   and data-parallel in turns; ``cli.sweep --batched_forks 3
   --frozen_cache`` of runs 1, 2 under torchrun against the same
   invocation alone, bit for bit. Phases dist and clip_dist put their
   torchrun runs at world size 1 into one launch each (``--dist_worker``'s
   ``--then`` chain; the worker makes the group, the CLIs join it), since
   a process costs ~20 s to start;
7. phase `sweep`: writes THINGS at its real size to disk (1,806 training
   and 48 inference JPEGs at 224^2, whose targets are the initial model's
   own predictions) and seeded random ViT-L/14 weights, and drives the
   paradigm CLIs through their ``main``: a 3-epoch ``cli.baseline``,
   ``cli.sweep`` runs 1, 2 and 3 for each of the four perturbation kinds
   with ``--frozen_cache`` and for random_target without it, a repeated fork,
   and ``cli.lengths`` e2_l1 then e2_l2 (which resumes from e2_l1). It
   checks the CSV rows and window flags, that the target kinds raise the
   perturbed epoch's train loss above the baseline's, that the repeated
   fork writes equal rows and the cached fork the full-tower fork's rows
   within a bf16 tolerance, one attention backward launch per step over the
   runs, and the attention launches of one step on each path (full tower,
   cache, each with remat); it times cached and full-tower steps in turns,
   the prefix build, and reads the runs' epoch times from their logs;
7b. phase `forks`: on phase sweep's fixture, batched forks
   (train/multi_fork.py) through the CLIs' ``main``: ``cli.sweep
   --batched_forks 3`` of runs 1, 2, 3 for each kind with
   ``--frozen_cache`` (image kinds fall back to the full tower), for
   random_target on the full tower and once with ``--no-host_prefetch``,
   and ``cli.lengths --onsets 1,2`` at length 1, then 2 (cross-resumed),
   then 2 again (resumed in place, no row). It holds each fork's rows
   against phase sweep's solo rows (the cached-vs-full tolerance), the
   checkpoints written without the copy-out byte for byte against those
   written with it, one flash3_bwd per lock-step batch over each
   invocation, and a lock-step's launches at R = 1, 2, 3 (36/1 full, 3/1
   cached); it times a lock-step batch at R = 1, 2, 4, 8, cached and full
   in turns, with peak memory at R = 8, and the batched invocations
   against the sequential ones;
8. prints one JSON line of kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result. ``--json PATH`` also writes every number to PATH.
``--dist_drift [LRS]`` runs no phase: it measures how far two gloo ranks
drift from one process by learning rate (the reason for DIST_LR).
"""
from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 (NVIDIA data sheets, dense, at a 700 W limit on
# the SXM part): bytes/s of device memory and operations/s by type. A PCIe
# card has its own sheet. "tfloat32" is the tensor cores' TF32 rate, which is
# also the rate of a float32 operand split into two bf16 terms (two bf16
# products for each one).
PEAKS = {
    "SXM": {"bytes": 3.35e12, "bfloat16": 989e12, "tfloat32": 495e12,
            "float32": 67e12},
    "PCIe": {"bytes": 2.0e12, "bfloat16": 756e12, "tfloat32": 378e12,
             "float32": 51e12},
}

# kernel-vs-plain tolerances on the card (max abs error), per dtype:
#   float32: both versions are exact f32 arithmetic; they differ only in the
#     order of summation and the online rescaling of the kernel's softmax
#     (measured on an H100 SXM: 1.7e-6 on o, 1.4e-6 on lse).
#   bfloat16: o is rounded to bf16; the kernel rounds the unnormalized exp
#     to bf16 where the plain version rounds the normalized p, so the two
#     differ by up to one bf16 spacing of o, which is 1.6e-2 for |o| in
#     [2, 4) (measured: 1.6e-2 on the causal text tower, whose first rows
#     average few keys). lse is f32 in both (measured 1e-6).
# The attention library's forwards (flash_fwd, mha_fwd, and the `ops` phase)
# hold each bf16 element of o to the larger of 2e-2 and one bf16 spacing at
# its magnitude (_o_within_tolerance): 2e-2 covers one spacing only below
# |o| = 4 (measured on an H100 SXM: attention_core_bshd at the causal text
# shape reached |o| in [4, 8), where the versions differed by 3.125e-2, one
# spacing).
TOLERANCE = {"float32": {"o": 1e-5, "lse": 1e-5},
             "bfloat16": {"o": 2e-2, "lse": 1e-4}}

# backward kernel-vs-plain tolerances: max abs error of each of dq, dk, dv
# over the largest |value| of that gradient in the plain version, per dtype:
#   float32: exact f32 arithmetic in another order of summation; the row
#     sums c and the products run over up to 257 keys (measured on an H100
#     SXM: 1.4e-6 relative at most).
#   bfloat16: both versions round p and ds to bf16 before the products (the
#     flash entries; mha_bwd keeps them in float32, its kernel to 2^-16 as
#     two bf16 terms) and the gradients to bf16 at the end; f32 sums in
#     another order (and the kernel's p from ex2.approx, ~2^-22 relative)
#     move a value across a bf16 rounding boundary at most once, one bf16
#     spacing, which is at most 2^-7 of the largest |value| (measured: 2.3e-3
#     on flash3_bwd's dv at the ViT-B/16 and text shapes).
BWD_TOLERANCE = {"float32": 1e-5, "bfloat16": 2 ** -7}

# dW+db kernel-vs-plain tolerance: max abs error of dW and of db over the
# largest |value| of that output in the plain version, both dtypes. Both
# versions sum exact products (a bf16 product is exact in f32) in float32, in
# another order. A float32 sum over N = 50,432 rows carries a rounding error
# of about sqrt(N) * 2^-24 = 1.3e-5 of its size in each version (measured on
# an H100 SXM: 1.07e-5 on fc1 in float32); the tolerance is 8x that.
DWDB_TOLERANCE = 1e-4

# LayerNorm kernel-vs-plain tolerances (ln_fwd / ln_bwd):
#   y: float32 1e-5 abs (both compute the centred statistics and the affine
#     map in f32, summing in another order); bfloat16 `_o_within_tolerance`'s
#     rule, one bf16 spacing at the element (both round one f32 value once);
#   dx: max |err| over the largest |dx| of the plain version, 1e-5 in f32
#     (another order of the two row sums) and 2^-7 in bf16 (one bf16
#     spacing, as BWD_TOLERANCE);
#   dscale, dbias: max |err| over their largest value, DWDB_TOLERANCE's
#     1e-4 in both dtypes (f32 sums over up to 50,432 rows in another order).
# Measured on an H100 SXM: y 1.4e-6 in f32; dx 3.6e-7 (f32) and 2.5e-3
# (bf16) of the largest |dx|; dscale and dbias 2.5e-7 of their largest.
LN_TOLERANCE = {"float32": {"dx": 1e-5, "dparams": 1e-4},
                "bfloat16": {"dx": 2 ** -7, "dparams": 1e-4}}

SEED = 0
RESULTS: dict = {}
ALL_PHASES = ("kernel", "ops", "serve", "train", "vit_train", "vit_grid",
              "serve_vit", "dist", "clip_dist", "sweep", "forks")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call, from CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from vit_project_torch.ops import cuda_build
    t0 = time.time()
    paths = cuda_build.build()
    dt = time.time() - t0
    print(f"[build] {len(paths)} kernel libraries in {dt:.2f} s "
          f"(nvcc, sm_90a; cached builds take ~0 s)", flush=True)
    for name in paths:
        for line in cuda_build.build_log(name).splitlines():
            if "ptxas info" in line or "spill" in line:  # registers, spills
                print(f"[build] {name}: {line.strip()}")
    RESULTS["build_s"] = dt


def attention_cases():
    """(label, B, S, H, causal) at the serving path's shapes: the image
    tower at buckets 8, 32 and 256, and the 66 causal text prompts; the
    ViT-B/16 step; a ViT-B/16 RSA chunk (compute_rsa_score's batch of 8,
    72 of a grid cell's 132 forward launches); and the image tower of a
    lock-step of 8 batched forks (8 x 64 rows)."""
    return [("image_b8", 8, 257, 16, False), ("image_b32", 32, 257, 16, False),
            ("image_b256", 256, 257, 16, False), ("text_66", 66, 77, 12, True),
            ("vit_b256", 256, 197, 12, False), ("vit_b8", 8, 197, 12, False),
            ("image_b512", 512, 257, 16, False)]


def bwd_cases():
    """(label, B, S, H, causal) of the attention backward on the training
    path: the image tower at the training batch of 64, and the 66 causal
    text prompts (reached when a text block below the last is adapted), the
    ViT-B/16 training step (batch 256, S=197, 12 heads), and the image
    tower of a lock-step of 8 batched forks (8 x 64 rows)."""
    return [("image_b64", 64, 257, 16, False), ("text_66", 66, 77, 12, True),
            ("vit_b256", 256, 197, 12, False),
            ("image_b512", 512, 257, 16, False)]


def _random_qkv(B, S, H, dtype, seed=SEED):
    import torch
    D = H * 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda")
    qkv[..., :D] *= 0.125           # q prescaled by 1/sqrt(64)
    return qkv.to(dtype).contiguous(), g


def phase_kernel(peaks):
    return (phase_kernel_fwd(peaks) + phase_kernel_bwd(peaks)
            + phase_kernel_dwdb(peaks) + phase_kernel_strided(peaks)
            + phase_kernel_ln(peaks))


def strided_cases():
    """(label, B, S, H, causal) of the attention library's kernels
    (flash_mha_packed, attention_core(_bshd) with use_kernel=True) at the
    repo's model widths, dh 64: the ViT-B/16 step, the CLIP-HBA training
    step's image tower and the 66 causal text prompts."""
    return [("vit_b256", 256, 197, 12, False), ("image_b64", 64, 257, 16, False),
            ("text_66", 66, 77, 12, True)]


def _randn(shape, gen, dtype, scale=1.0):
    import torch
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _bound(nbytes, flops_by_type, peaks):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and the
    operations over the peak rate of their type, {type: operations}."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = sum(n / peaks[t] for t, n in flops_by_type.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _route(kernel, S, dtype) -> str:
    """The CUDA route an attention kernel takes at sequence length S
    (ops/attention.py's predicates, which CPU tests tie to the sources)."""
    from vit_project_torch.ops import attention as vattn
    import torch
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if kernel.endswith("fwd"):
        return "whole_head" if vattn.fwd_whole_head(S, dtype) else (
            "streamed" if dtype == torch.bfloat16 else "fma")
    if vattn.bwd_whole_head(S, dtype):
        return "whole_head"
    return "streamed" if dtype == torch.bfloat16 and kernel != "mha_bwd" \
        else "fma"


def _o_within_tolerance(got, ref, dname) -> bool:
    """Whether every element of a forward output is within TOLERANCE's
    absolute value of the plain version or, in bfloat16 where that is
    narrower, within one bf16 spacing at the larger of the two magnitudes:
    two nearest roundings of float32 values this close differ by at most one
    spacing, which is 2^-5 for |o| in [4, 8), wider than 2e-2."""
    import torch
    diff = (got.float() - ref.float()).abs()
    tol = torch.full_like(diff, TOLERANCE[dname]["o"])
    if dname == "bfloat16":
        big = torch.maximum(got.float().abs(), ref.float().abs())
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(
            big.clamp_min(2.0 ** -126))) - 7))
    return bool(torch.isfinite(diff).all() and (diff <= tol).all())


def _grad_errors(got, ref):
    """Max |err| of each of dq, dk, dv and that over the largest |ref|."""
    errs = {n: (a.float() - r.float()).abs().max().item()
            for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    rel = {n: errs[n] / max(r.abs().max().item(), 1e-30)
           for n, r in zip(("dq", "dk", "dv"), ref)}
    return errs, rel


def phase_kernel_strided(peaks):
    """The four kernels of the attention library against their plain
    versions: flash_fwd / flash_bwd on q (prescaled), k, v [B, S, D], and
    mha_fwd / mha_bwd on [B, H, S, 64] with the scale in the kernel. The
    library yardstick is SDPA on the same q, k, v (scale 1 for the flash
    pair, the default 1/sqrt(64) for the mha pair; its backward alone)."""
    import torch
    import torch.nn.functional as F
    from vit_project_torch.ops import attention as vattn
    rows = []

    def record(kernel, label, dtype, shape, H, causal, errs, extra, times,
               nbytes, flops):
        bound_ms, bound_by = _bound(nbytes, flops, peaks)
        row = {"kernel": kernel, "case": label, "dtype": dtype,
               "route": _route(kernel, shape[-2] if kernel.startswith("mha")
                               else shape[1], dtype),
               "shape": shape, "heads": H, "causal": causal,
               "max_abs_err": max(errs.values()), "errors": errs, **extra,
               **times, "bound_ms": bound_ms, "bound_by": bound_by,
               "mbytes": nbytes / 1e6,
               "gflop": sum(flops.values()) / 1e9}
        rows.append(row)
        print(f"[kernel] {kernel:9s} {label:9s} {dtype:8s} "
              f"{row['route']:10s} err "
              + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" | kernel_ms {times['ms']:.4f}"
              + (f" device_ms {times['device_ms']}" if "device_ms" in times
                 else "")
              + f" plain_ms {times['plain_ms']:.4f} library_ms "
              f"{times['library_ms']:.4f} "
              + (f"library_f32_ms {times['library_f32_ms']:.4f} "
                 if "library_f32_ms" in times else "")
              + f"bound_ms {bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{row['gflop']:.2f} GFLOP)", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, B, S, H, causal in strided_cases():
            D = H * 64
            isz = torch.finfo(dtype).bits // 8
            pairs = S * (S + 1) // 2 if causal else S * S
            fwd_flops = 4 * B * H * pairs * 64             # qk^T and pv
            gen = torch.Generator(device="cuda").manual_seed(SEED)

            # rows 3-4: flash_fwd / flash_bwd on [B, S, D]
            q = _randn((B, S, D), gen, dtype, 0.125)       # q prescaled
            k, v, do = (_randn((B, S, D), gen, dtype) for _ in range(3))
            o, lse = vattn.flash_fwd(q, k, v, H, causal)
            torch.cuda.synchronize()
            ro, rl = vattn.flash_mha_packed_reference(q, k, v, H, causal)
            errs = {"o": (o.float() - ro.float()).abs().max().item(),
                    "lse": (lse - rl).abs().max().item()}
            tol = TOLERANCE[dname]
            o_ok = _o_within_tolerance(o, ro, dname)
            del o, ro, rl
            if not (o_ok and np.isfinite(errs["lse"])) \
                    or errs["lse"] > tol["lse"]:
                fail(f"flash_fwd {label} {dname}: errors {errs}, tolerance "
                     f"{tol}")
            qh, kh, vh, doh = (x.reshape(B, S, H, 64).transpose(1, 2)
                               .contiguous().requires_grad_(True)
                               for x in (q, k, v, do))
            with torch.no_grad():
                times = {
                    "ms": cuda_ms(lambda: vattn.flash_fwd(q, k, v, H, causal),
                                  10),
                    "plain_ms": cuda_ms(
                        lambda: vattn.flash_mha_packed_reference(
                            q, k, v, H, causal), 3),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=causal, scale=1.0), 10)}
            record("flash_fwd", label, dname, [B, S, D], H, causal, errs,
                   {"tolerance": tol}, times,
                   4 * B * S * D * isz + B * S * H * 4, {dname: fwd_flops})

            got = vattn.flash_bwd(q, k, v, do, lse, H, causal)
            torch.cuda.synchronize()
            ref = vattn.flash_mha_packed_bwd_reference(q, k, v, do, lse, H,
                                                       causal)
            errs, rel = _grad_errors(got, ref)
            del got, ref
            btol = BWD_TOLERANCE[dname]
            if not all(np.isfinite(e) for e in errs.values()) \
                    or max(rel.values()) > btol:
                fail(f"flash_bwd {label} {dname}: max |err| / max |ref| "
                     f"{rel} over the tolerance {btol}")
            ol = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                                scale=1.0)
            times = {
                "ms": cuda_ms(lambda: vattn.flash_bwd(q, k, v, do, lse, H,
                                                      causal), 10),
                "plain_ms": cuda_ms(
                    lambda: vattn.flash_mha_packed_bwd_reference(
                        q, k, v, do, lse, H, causal), 3),
                # the SDPA backward alone, on q, k, v of the same values
                "library_ms": cuda_ms(lambda: torch.autograd.grad(
                    ol, (qh, kh, vh), doh, retain_graph=True), 10)}
            prof = _profile(lambda: vattn.flash_bwd(q, k, v, do, lse, H,
                                                    causal), steps=10)
            times["device_ms"] = prof and prof["device_ms_per_call"]
            record("flash_bwd", label, dname, [B, S, D], H, causal, errs,
                   {"relative_errors": rel, "tolerance_relative": btol},
                   times, 7 * B * S * D * isz + B * S * H * 4,
                   {dname: 10 * B * H * pairs * 64})
            del q, k, v, do, lse, qh, kh, vh, doh, ol

            # rows 5-6: mha_fwd / mha_bwd on [B, H, S, 64], scale in-kernel
            q, k, v, do = (_randn((B, H, S, 64), gen, dtype).requires_grad_(
                i < 3) for i in range(4))
            with torch.no_grad():
                o = vattn.mha_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                ro = vattn.mha_reference(q, k, v, causal=causal)
                errs = {"o": (o.float() - ro.float()).abs().max().item()}
                o_ok = _o_within_tolerance(o, ro, dname)
                del o, ro
                if not o_ok:
                    fail(f"mha_fwd {label} {dname}: max |o err| {errs['o']} "
                         f"over the tolerance {tol['o']} (or one bf16 "
                         f"spacing)")
                times = {
                    "ms": cuda_ms(lambda: vattn.mha_fwd(q, k, v, causal), 10),
                    "plain_ms": cuda_ms(lambda: vattn.mha_reference(
                        q, k, v, causal=causal), 3),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=causal), 10)}
            record("mha_fwd", label, dname, [B, H, S, 64], H, causal, errs,
                   {"tolerance": tol["o"]}, times, 4 * B * S * D * isz,
                   {dname: fwd_flops})

            with torch.no_grad():
                got = vattn.mha_bwd(q, k, v, do, causal)
                torch.cuda.synchronize()
                ref = vattn.mha_bwd_reference(q, k, v, do, causal)
                errs, rel = _grad_errors(got, ref)
                del got, ref
                if not all(np.isfinite(e) for e in errs.values()) \
                        or max(rel.values()) > btol:
                    fail(f"mha_bwd {label} {dname}: max |err| / max |ref| "
                         f"{rel} over the tolerance {btol}")
                times = {
                    "ms": cuda_ms(lambda: vattn.mha_bwd(q, k, v, do, causal),
                                  10),
                    "plain_ms": cuda_ms(lambda: vattn.mha_bwd_reference(
                        q, k, v, do, causal), 3)}
            prof = _profile(lambda: vattn.mha_bwd(q, k, v, do, causal),
                            steps=10)
            times["device_ms"] = prof and prof["device_ms_per_call"]
            ol = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            times["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                ol, (q, k, v), do, retain_graph=True), 10)
            # the same function as the kernel's: SDPA's backward on float32
            # copies of the inputs (the kernel forms p and ds in float32)
            if dtype == torch.float32:
                times["library_f32_ms"] = times["library_ms"]
            else:
                qf, kf, vf = (t.detach().float().requires_grad_(True)
                              for t in (q, k, v))
                dof = do.float()
                of = F.scaled_dot_product_attention(qf, kf, vf,
                                                    is_causal=causal,
                                                    scale=64 ** -0.5)
                times["library_f32_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    of, (qf, kf, vf), dof, retain_graph=True), 10)
                del qf, kf, vf, dof, of
            # the scores q k^T and dp = do v^T multiply the operands; dv,
            # dq and dk multiply float32 p or ds whatever the input type: in
            # bf16 as two bf16 terms each, at the TF32 rate
            flops = {dname: 4 * B * H * pairs * 64}
            split = "tfloat32" if dtype == torch.bfloat16 else "float32"
            flops[split] = flops.get(split, 0) + 6 * B * H * pairs * 64
            record("mha_bwd", label, dname, [B, H, S, 64], H, causal, errs,
                   {"relative_errors": rel, "tolerance_relative": btol},
                   times, 7 * B * S * D * isz, flops)
            del q, k, v, do, ol
            torch.cuda.empty_cache()
    RESULTS["kernel_strided"] = rows
    return rows


def ln_cases():
    """(label, B, S, D) of layer_norm_fused at the residual streams of the
    strided cases, [B * S, D] rows: the ViT-B/16 step (50,432 rows of 768,
    197 whole blocks of 256), the CLIP-HBA training image tower (16,448 of
    1,024: 64 rows past the last whole block) and the causal text tower
    (5,082 of 768: 218 rows past)."""
    return [(label, B, S, H * 64) for label, B, S, H, _ in strided_cases()]


def _ln_inputs(N, D, dtype, gen):
    """x [N, D] (rows off centre) and dy in `dtype`; scale, bias [D] f32."""
    import torch
    x = (torch.randn(N, D, generator=gen, device="cuda")
         + torch.randn(N, 1, generator=gen, device="cuda")).to(dtype)
    scale = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    return x, scale, bias, _randn((N, D), gen, dtype)


def _ln_plain(vln, x2d, scale, bias, dy):
    """(y, dx, dscale, dbias) of the plain versions, the forward's own
    statistics feeding the backward."""
    y, mean, rstd = vln.ln_fwd_reference(x2d, scale, bias)
    dx, dsc_p, dbi_p = vln.ln_bwd_reference(x2d, scale, mean, rstd, dy)
    return y, dx, vln.sum_partials(dsc_p), vln.sum_partials(dbi_p)


def _ln_errors(got, ref, dname):
    """(max |err| of y, dx, dscale, dbias; those of dx, dscale, dbias over
    the largest |value| of the plain version; whether all are within
    LN_TOLERANCE)."""
    names = ("y", "dx", "dscale", "dbias")
    errs = {n: (a.float() - r.float()).abs().max().item()
            for n, a, r in zip(names, got, ref)}
    rel = {n: errs[n] / max(r.float().abs().max().item(), 1e-30)
           for n, r in zip(names[1:], ref[1:])}
    tol = LN_TOLERANCE[dname]
    ok = (_o_within_tolerance(got[0], ref[0], dname)
          and all(np.isfinite(e) for e in errs.values())
          and rel["dx"] <= tol["dx"]
          and max(rel["dscale"], rel["dbias"]) <= tol["dparams"])
    return errs, rel, ok


def phase_kernel_ln(peaks):
    """ln_fwd and ln_bwd against their plain versions at ln_cases(), in f32
    and bf16 with f32 scale and bias. The library yardstick is F.layer_norm
    on the same x, scale and bias (in x's dtype where it refuses f32
    parameters beside bf16 x; the row says which), its backward alone."""
    import torch
    import torch.nn.functional as F
    from vit_project_torch.ops import layernorm as vln
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, B, S, D in ln_cases():
            N = B * S
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            x, scale, bias, dy = _ln_inputs(N, D, dtype, gen)
            y, mean, rstd = vln.ln_fwd(x, scale, bias)
            # the backward's inputs are the kernel forward's statistics
            dx, dsc, dbi = vln.ln_bwd(x, scale, mean, rstd, dy)
            torch.cuda.synchronize()
            ry, rmean, rrstd = vln.ln_fwd_reference(x, scale, bias)
            rdx, rsc_p, rbi_p = vln.ln_bwd_reference(x, scale, mean, rstd, dy)
            errs, rel, ok = _ln_errors(
                (y, dx, dsc, dbi),
                (ry, rdx, vln.sum_partials(rsc_p), vln.sum_partials(rbi_p)),
                dname)
            stats = {"mean": (mean - rmean).abs().max().item(),
                     "rstd_relative": ((rstd - rrstd).abs()
                                       / rrstd).max().item()}
            if not ok or max(stats.values()) > 1e-5:
                fail(f"ln_fwd/ln_bwd {label} {dname}: errors {errs}, "
                     f"relative {rel}, statistics {stats}; tolerance "
                     f"{LN_TOLERANCE[dname]} (y: {TOLERANCE[dname]['o']} "
                     f"or one bf16 spacing; statistics 1e-5)")
            del y, dx, dsc, dbi, ry, rmean, rrstd, rdx, rsc_p, rbi_p
            w, b = scale, bias
            try:
                F.layer_norm(x[:8], (D,), w, b)
            except RuntimeError:           # no f32 parameters beside bf16 x
                w, b = scale.to(dtype), bias.to(dtype)
            xl, wl, bl = (t.detach().clone().requires_grad_(True)
                          for t in (x, w, b))
            yl = F.layer_norm(xl, (D,), wl, bl)
            it = 20
            with torch.no_grad():
                fwd_times = {
                    "ms": cuda_ms(lambda: vln.ln_fwd(x, scale, bias), it),
                    "plain_ms": cuda_ms(lambda: vln.ln_fwd_reference(
                        x, scale, bias), 5),
                    "library_ms": cuda_ms(lambda: F.layer_norm(
                        x, (D,), w, b), it)}
                bwd_times = {
                    "ms": cuda_ms(lambda: vln.ln_bwd(x, scale, mean, rstd,
                                                     dy), it),
                    "plain_ms": cuda_ms(lambda: _ln_plain(
                        vln, x, scale, bias, dy), 5)}
            bwd_times["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                yl, (xl, wl, bl), dy, retain_graph=True), it)
            # device time alone (torch.profiler): where a call's host work
            # outlasts its kernels, the event times above measure the host
            for times, fn in (
                    (fwd_times, lambda: vln.ln_fwd(x, scale, bias)),
                    (bwd_times, lambda: vln.ln_bwd(x, scale, mean, rstd, dy))):
                prof = _profile(fn, steps=10)
                times["device_ms"] = prof and prof["device_ms_per_call"]
                times["wall_ms"] = prof and prof["wall_ms_per_call"]
            isz = x.element_size()
            n_b = -(-N // vln.BLOCK_ROWS)
            for kernel, kerrs, times, nbytes, flops in (
                    ("ln_fwd", {"y": errs["y"], **stats}, fwd_times,
                     2 * N * D * isz + 8 * N + 8 * D, 8 * N * D),
                    ("ln_bwd", {n: errs[n] for n in ("dx", "dscale", "dbias")},
                     bwd_times, 3 * N * D * isz + 8 * N + 4 * D + 8 * n_b * D,
                     12 * N * D)):
                bound_ms, bound_by = _bound(nbytes, {"float32": flops}, peaks)
                row = {"kernel": kernel, "case": label, "dtype": dname,
                       "shape": [N, D], "max_abs_err": max(kerrs.values()),
                       "errors": kerrs, **times, "bound_ms": bound_ms,
                       "bound_by": bound_by, "mbytes": nbytes / 1e6,
                       "gflop": flops / 1e9,
                       "library_params_dtype": str(w.dtype).replace(
                           "torch.", "")}
                if kernel == "ln_bwd":
                    row.update(relative_errors=rel,
                               tolerance_relative=LN_TOLERANCE[dname])
                rows.append(row)
                print(f"[kernel] {kernel} {label:9s} [{N}x{D}] {dname:8s} err "
                      + " ".join(f"{n} {e:.2e}" for n, e in kerrs.items())
                      + f" | kernel_ms {times['ms']:.4f} plain_ms "
                      f"{times['plain_ms']:.4f} library_ms "
                      f"{times['library_ms']:.4f} ({row['library_params_dtype']}"
                      f" parameters) device_ms {times['device_ms']} "
                      f"bound_ms {bound_ms:.4f} ({bound_by}: "
                      f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
                      flush=True)
            del x, scale, bias, dy, mean, rstd, xl, wl, bl, yl, w, b
            torch.cuda.empty_cache()
    RESULTS["kernel_ln"] = rows
    return rows


def _ops_calls(vattn, entry, B, S, H, causal, dtype, gen):
    """Inputs of one user call of `entry` and its plain counterpart:
    (inputs, do, call, plain) where plain(inputs, do) -> (o, (dq, dk, dv))."""
    import torch
    if entry == "flash_mha_packed":
        shape, scales = (B, S, H * 64), (0.125, 1.0, 1.0)   # q prescaled

        def call(q, k, v):
            return vattn.flash_mha_packed(q, k, v, num_heads=H, causal=causal)

        def plain(xs, do):
            o, lse = vattn.flash_mha_packed_reference(*xs, H, causal)
            return o, vattn.flash_mha_packed_bwd_reference(*xs, do, lse, H,
                                                           causal)
    elif entry == "attention_core":
        shape, scales = (B, H, S, 64), (1.0,) * 3

        def call(q, k, v):
            return vattn.attention_core(q, k, v, causal=causal,
                                        use_kernel=True)

        def plain(xs, do):
            return (vattn.mha_reference(*xs, causal=causal),
                    vattn.mha_bwd_reference(*xs, do, causal))
    else:
        shape, scales = (B, S, H, 64), (1.0,) * 3

        def call(q, k, v):
            return vattn.attention_core_bshd(q, k, v, causal=causal,
                                             use_kernel=True)

        def plain(xs, do):
            t = [x.transpose(1, 2) for x in (*xs, do)]
            return (vattn.mha_reference(*t[:3], causal=causal).transpose(1, 2),
                    tuple(g.transpose(1, 2) for g in
                          vattn.mha_bwd_reference(*t, causal)))
    xs = [_randn(shape, gen, dtype, s).requires_grad_(True) for s in scales]
    return xs, _randn(shape, gen, dtype), call, plain


def phase_ops():
    """The attention library's entry points as a user calls them: for each
    of flash_mha_packed, attention_core(use_kernel=True) and
    attention_core_bshd(use_kernel=True), at each strided case, in f32 and
    bf16: the forward and torch.autograd.grad on CUDA tensors, exactly one
    forward and one backward launch per call, and the output and the three
    gradients against the same call's plain versions; then
    layer_norm_fused (_ops_layer_norm). Returns the launch counts of the
    whole phase (each module's counted from 0)."""
    import torch
    from vit_project_torch.ops import attention as vattn
    kernels = {"flash_mha_packed": ("flash_fwd", "flash_bwd"),
               "attention_core": ("mha_fwd", "mha_bwd"),
               "attention_core_bshd": ("mha_fwd", "mha_bwd")}
    results = []
    # --- the main path: counts from 0, every entry-point call, counts read ---
    vattn.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, B, S, H, causal in strided_cases():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            for entry, (fwd, bwd) in kernels.items():
                xs, do, call, plain = _ops_calls(vattn, entry, B, S, H, causal,
                                                 dtype, gen)
                before = dict(vattn.LAUNCHES)
                o = call(*xs)
                grads = torch.autograd.grad(o, xs, do)
                torch.cuda.synchronize()
                launched = {n: vattn.LAUNCHES[n] - before[n] for n in before}
                if launched != {**dict.fromkeys(launched, 0), fwd: 1, bwd: 1}:
                    fail(f"{entry} {label} {dname}: launches {launched}, "
                         f"expected one {fwd} and one {bwd}")
                with torch.no_grad():
                    ro, rgrads = plain([x.detach() for x in xs], do)
                err_o = (o.float() - ro.float()).abs().max().item()
                errs, rel = _grad_errors(grads, rgrads)
                tol, btol = TOLERANCE[dname]["o"], BWD_TOLERANCE[dname]
                if not (_o_within_tolerance(o, ro, dname)
                        and all(np.isfinite(e) for e in errs.values())
                        and max(rel.values()) <= btol):
                    fail(f"{entry} {label} {dname}: |o err| {err_o:.3e} (tol "
                         f"{tol} or one bf16 spacing), gradients {rel} (tol "
                         f"{btol} relative)")
                results.append({"entry": entry, "case": label, "dtype": dname,
                                "launches": launched, "err_o": err_o,
                                "grad_errors": errs,
                                "grad_relative_errors": rel})
                print(f"[ops] {entry:19s} {label:9s} {dname:8s} launches "
                      f"{fwd} 1, {bwd} 1; |o err| {err_o:.2e}, gradients "
                      + " ".join(f"{n} {r:.1e}" for n, r in rel.items())
                      + " relative", flush=True)
                del xs, do, o, grads, ro, rgrads
            torch.cuda.empty_cache()
    launches = dict(vattn.LAUNCHES)
    launches.update(_ops_layer_norm(results))
    print(f"[ops] launches over the phase: {launches}", flush=True)
    RESULTS["ops"] = {"calls": results, "launches": launches}
    return launches


def _ops_layer_norm(results):
    """layer_norm_fused as a user calls it, on [B, S, D] at each ln_cases()
    shape in f32 and bf16 with f32 scale and bias: the forward and
    torch.autograd.grad for x, scale and bias, exactly one ln_fwd and one
    ln_bwd launch per call, and y and the three gradients against the same
    call on the plain versions. Returns the launch counts (counted from 0)."""
    import torch
    from vit_project_torch.ops import layernorm as vln
    # --- the main path: counts from 0, every entry-point call, counts read ---
    vln.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, B, S, D in ln_cases():
            gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
            x, scale, bias, dy = _ln_inputs(B * S, D, dtype, gen)
            xs = [x.reshape(B, S, D).requires_grad_(True),
                  scale.requires_grad_(True), bias.requires_grad_(True)]
            before = dict(vln.LAUNCHES)
            y = vln.layer_norm_fused(*xs)
            grads = torch.autograd.grad(y, xs, dy.reshape(B, S, D))
            torch.cuda.synchronize()
            launched = {n: vln.LAUNCHES[n] - before[n] for n in before}
            if launched != {"ln_fwd": 1, "ln_bwd": 1}:
                fail(f"layer_norm_fused {label} {dname}: launches {launched},"
                     f" expected one ln_fwd and one ln_bwd")
            with torch.no_grad():
                ref = _ln_plain(vln, x, scale, bias, dy)
            errs, rel, ok = _ln_errors(
                (y.reshape(-1, D), grads[0].reshape(-1, D), *grads[1:]), ref,
                dname)
            if not ok:
                fail(f"layer_norm_fused {label} {dname}: errors {errs}, "
                     f"relative {rel}, tolerance {LN_TOLERANCE[dname]} (y: "
                     f"{TOLERANCE[dname]['o']} or one bf16 spacing)")
            results.append({"entry": "layer_norm_fused", "case": label,
                            "dtype": dname, "launches": launched,
                            "errors": errs, "relative_errors": rel})
            print(f"[ops] layer_norm_fused    {label:9s} {dname:8s} launches "
                  f"ln_fwd 1, ln_bwd 1; |y err| {errs['y']:.2e}, gradients "
                  + " ".join(f"{n} {r:.1e}" for n, r in rel.items())
                  + " relative", flush=True)
            del x, scale, bias, dy, xs, y, grads, ref
        torch.cuda.empty_cache()
    return dict(vln.LAUNCHES)


def dwdb_cases():
    """(label, N, Din, Dout) of every dense layer with a bias in a ViT-B/16
    training step at batch 256: the block's qkv, output, fc1 and fc2
    projections over N = 256 x 197 token rows, and the head over the 256
    CLS rows."""
    N = 256 * 197
    return [("qkv", N, 768, 2304), ("proj", N, 768, 768), ("fc1", N, 768, 3072),
            ("fc2", N, 3072, 768), ("head", 256, 768, 1000)]


def _gemm_dwdb(x, g):
    """The product alone, x^T g with a float32 result (never called by the
    port)."""
    import torch
    if x.dtype == torch.float32:
        return torch.mm(x.t(), g)
    return torch.mm(x.t(), g, out_dtype=torch.float32)


def _library_dwdb(x, g):
    """The yardstick beside the kernel: the product and the row sum, taken in
    float32 without a float32 copy of g (never called by the port)."""
    import torch
    return _gemm_dwdb(x, g), g.sum(0, dtype=torch.float32)


def phase_kernel_dwdb(peaks):
    import torch
    from vit_project_torch.ops import fused_dw as vfdw
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, N, Din, Dout in dwdb_cases():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            x = torch.randn(N, Din, generator=gen, device="cuda").to(dtype)
            g = torch.randn(N, Dout, generator=gen, device="cuda").to(dtype)
            dw, db = vfdw.dw_db(x, g)
            torch.cuda.synchronize()
            rdw, rdb = vfdw.dw_db_reference(x, g)
            errs = {"dw": (dw - rdw).abs().max().item(),
                    "db": (db - rdb).abs().max().item()}
            rel = {"dw": errs["dw"] / max(rdw.abs().max().item(), 1e-30),
                   "db": errs["db"] / max(rdb.abs().max().item(), 1e-30)}
            if not all(np.isfinite(v) for v in errs.values()):
                fail(f"dw_db {label} {dname}: non-finite output")
            if max(rel.values()) > DWDB_TOLERANCE:
                fail(f"dw_db {label} {dname}: max |err| / max |ref| {rel} "
                     f"over the tolerance {DWDB_TOLERANCE}")
            del dw, db, rdw, rdb
            it = 10 if dtype == torch.bfloat16 else 3
            kernel_ms = cuda_ms(lambda: vfdw.dw_db(x, g), it)
            plain_ms = cuda_ms(lambda: vfdw.dw_db_reference(x, g), it)
            library_ms = cuda_ms(lambda: _library_dwdb(x, g), it)
            gemm_ms = cuda_ms(lambda: _gemm_dwdb(x, g), it)
            prof = _profile(lambda: vfdw.dw_db(x, g), steps=it)
            device_ms = prof and prof["device_ms_per_call"]
            route = vfdw.route(x, g)
            sched = vfdw.schedule(N, Din, Dout, route)
            isz = x.element_size()
            nbytes = N * (Din + Dout) * isz + (Din * Dout + Dout) * 4
            flops = 2 * N * Din * Dout
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = flops / peaks[dname] * 1e3
            row = {"kernel": "dw_db", "case": label, "dtype": dname,
                   "shape": [N, Din, Dout], "max_abs_err": max(errs.values()),
                   "errors": errs, "relative_errors": rel,
                   "tolerance_relative": DWDB_TOLERANCE,
                   "route": route, "splits": sched.splits,
                   "items": sched.items, "blocks": sched.blocks,
                   "ms": kernel_ms, "device_ms": device_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "gemm_ms": gemm_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "mbytes": nbytes / 1e6, "gflop": flops / 1e9}
            rows.append(row)
            print(f"[kernel] dw_db {label:5s} [{N}x{Din}]^T[{N}x{Dout}] "
                  f"{dname:8s} err dW {errs['dw']:.2e} ({rel['dw']:.1e} rel) "
                  f"db {errs['db']:.2e} ({rel['db']:.1e} rel) | route {route}, "
                  f"{sched.splits} splits, {sched.items} items on "
                  f"{sched.blocks} blocks | kernel_ms {kernel_ms:.4f} device_ms "
                  f"{'not measured' if device_ms is None else f'{device_ms:.4f}'}"
                  f" plain_ms {plain_ms:.4f} library_ms "
                  f"{library_ms:.4f} gemm_ms {gemm_ms:.4f} bound_ms "
                  f"{row['bound_ms']:.4f} "
                  f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.1f} GFLOP)", flush=True)
            del x, g
            torch.cuda.empty_cache()
    RESULTS["kernel_dwdb"] = rows
    return rows


def phase_kernel_bwd(peaks):
    import torch
    import torch.nn.functional as F
    from vit_project_torch.ops import attention as vattn
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        tol = BWD_TOLERANCE[dname]
        for label, B, S, H, causal in bwd_cases():
            D = H * 64
            qkv, g = _random_qkv(B, S, H, dtype)
            do = torch.randn(B, S, D, generator=g, device="cuda").to(dtype)
            _, lse = vattn.flash3_fwd(qkv, H, causal)
            got = vattn.flash3_bwd(qkv, do, lse, H, causal)
            torch.cuda.synchronize()
            ref = vattn.flash_mha_packed_qkv_bwd_reference(qkv, do, lse, H,
                                                           causal)
            errs, rel = {}, {}
            for i, name in enumerate(("dq", "dk", "dv")):
                a = got[..., i * D:(i + 1) * D].float()
                r = ref[..., i * D:(i + 1) * D].float()
                errs[name] = (a - r).abs().max().item()
                rel[name] = errs[name] / max(r.abs().max().item(), 1e-30)
            if not all(np.isfinite(v) for v in errs.values()):
                fail(f"flash3_bwd {label} {dname}: non-finite output")
            if max(rel.values()) > tol:
                fail(f"flash3_bwd {label} {dname}: max |err| / max |ref| "
                     f"{rel} over the tolerance {tol}")
            del got, ref
            q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, S, H, 64)
                       .transpose(1, 2).contiguous().requires_grad_(True)
                       for i in range(3))
            o = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                               scale=1.0)
            do_h = do.reshape(B, S, H, 64).transpose(1, 2).contiguous()
            it = 10
            kernel_ms = cuda_ms(
                lambda: vattn.flash3_bwd(qkv, do, lse, H, causal), it)
            plain_ms = cuda_ms(
                lambda: vattn.flash_mha_packed_qkv_bwd_reference(
                    qkv, do, lse, H, causal), 3)
            # the SDPA backward alone, on q, k, v of the same values
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                o, (q, k, v), do_h, retain_graph=True), it)
            del q, k, v, o, do_h
            # device time alone (torch.profiler), beside the event time
            prof = _profile(lambda: vattn.flash3_bwd(qkv, do, lse, H, causal),
                            steps=10)
            nbytes = (qkv.numel() * qkv.element_size()       # read qkv
                      + do.numel() * do.element_size()       # read do
                      + lse.numel() * 4                      # read lse
                      + qkv.numel() * qkv.element_size())    # write dqkv
            pairs = S * (S + 1) // 2 if causal else S * S
            flops = 10 * B * H * pairs * 64                  # 5 products
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = flops / peaks[dname] * 1e3
            row = {"kernel": "flash3_bwd", "case": label, "dtype": dname,
                   "route": _route("flash3_bwd", S, dtype),
                   "shape": [B, S, 3 * D], "heads": H, "causal": causal,
                   "max_abs_err": max(errs.values()), "errors": errs,
                   "relative_errors": rel, "tolerance_relative": tol,
                   "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "device_ms": prof and prof["device_ms_per_call"],
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "mbytes": nbytes / 1e6, "gflop": flops / 1e9}
            rows.append(row)
            print(f"[kernel] flash3_bwd {label:10s} {dname:8s} "
                  f"{row['route']:10s} err "
                  + " ".join(f"{n} {errs[n]:.2e} ({rel[n]:.1e} rel)"
                             for n in errs)
                  + f" | kernel_ms {kernel_ms:.4f} device_ms "
                  f"{row['device_ms']} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} bound_ms "
                  f"{row['bound_ms']:.4f} ({row['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
                  flush=True)
            del qkv, do, lse
            torch.cuda.empty_cache()
    RESULTS["kernel_bwd"] = rows
    return rows


def phase_kernel_fwd(peaks):
    import torch
    import torch.nn.functional as F
    from vit_project_torch.ops import attention as vattn
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        tol = TOLERANCE[dname]
        for label, B, S, H, causal in attention_cases():
            D = H * 64
            qkv, _ = _random_qkv(B, S, H, dtype)
            o, lse = vattn.flash3_fwd(qkv, H, causal)
            torch.cuda.synchronize()
            ro, rl = vattn.flash_mha_packed_qkv_reference(qkv, H, causal)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_l = (lse - rl).abs().max().item()
            if not (np.isfinite(err_o) and np.isfinite(err_l)):
                fail(f"flash3_fwd {label} {dname}: non-finite output")
            if err_o > tol["o"] or err_l > tol["lse"]:
                fail(f"flash3_fwd {label} {dname}: max |o err| {err_o:.3e} "
                     f"(tol {tol['o']}), max |lse err| {err_l:.3e} "
                     f"(tol {tol['lse']})")
            del o, lse, ro, rl
            q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, S, H, 64)
                       .transpose(1, 2).contiguous() for i in range(3))
            big = B * S > 10000
            it = 10 if big else 50
            kernel_ms = cuda_ms(lambda: vattn.flash3_fwd(qkv, H, causal), it)
            plain_ms = cuda_ms(
                lambda: vattn.flash_mha_packed_qkv_reference(qkv, H, causal),
                max(3, it // 5))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=1.0), it)
            del q, k, v
            nbytes = (qkv.numel() * qkv.element_size()       # read qkv once
                      + B * S * D * qkv.element_size()       # write o
                      + B * S * H * 4)                       # write lse
            pairs = S * (S + 1) // 2 if causal else S * S    # (row, key) pairs
            flops = 4 * B * H * pairs * 64                   # qk^T and pv
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = flops / peaks[dname] * 1e3
            row = {"kernel": "flash3_fwd", "case": label, "dtype": dname,
                   "route": _route("flash3_fwd", S, dtype),
                   "shape": [B, S, 3 * D],
                   "heads": H, "causal": causal, "max_abs_err_o": err_o,
                   "max_abs_err_lse": err_l, "ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "mbytes": nbytes / 1e6, "gflop": flops / 1e9}
            rows.append(row)
            print(f"[kernel] flash3_fwd {label:10s} {dname:8s} "
                  f"{row['route']:10s} err o {err_o:.2e} lse {err_l:.2e} | kernel_ms "
                  f"{kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                  f"{library_ms:.4f} bound_ms {row['bound_ms']:.4f} "
                  f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP)", flush=True)
            del qkv
            torch.cuda.empty_cache()
    RESULTS["kernel"] = rows
    return rows


def _post(port: int, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npy"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            fail(f"POST returned HTTP {resp.status}")
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def _write_random_checkpoints(tmp: str):
    """Seeded random ViT-L/14 weights as an OpenAI-format fp16 .pt and
    rank-32 DoRA adapters (last 2 image blocks, last text block) as a
    reference-named .pth. Returns (weights path, adapters path, count)."""
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.models import clip as vclip
    cfg = vclip.CLIP_VIT_L14
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = vclip.init_clip_weights_(vclip.empty_clip(cfg, "cuda"), gen)
    wpath = os.path.join(tmp, "ViT-L-14-random.pt")
    torch.save({k: v.half().cpu() for k, v in model.state_dict().items()},
               wpath)
    spec = adora.dora_spec(cfg.visual.layers, cfg.text.layers, 2, 1)
    trainable, _, _ = adora.apply_dora(model, spec, r=32, alpha=16,
                                       generator=gen)
    n = adora.count_trainable_parameters(trainable)
    dpath = os.path.join(tmp, "epoch1_dora_params.pth")
    torch.save({k: v.cpu() for k, v in
                adora.to_reference_names(trainable).items()}, dpath)
    del model, trainable
    torch.cuda.empty_cache()
    return wpath, dpath, n


def phase_serve(tmp: str):
    import torch
    from vit_project_torch.cli import serve as cli
    from vit_project_torch.models import clip as vclip
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.serve import ServingDaemon

    t0 = time.time()
    wpath, dpath, n_written = _write_random_checkpoints(tmp)
    if n_written != 183040:
        fail(f"DoRA adapters hold {n_written} parameters, expected 183,040")
    args = cli.parse_args(["--clip_weights", wpath, "--dora_checkpoint", dpath,
                           "--rank", "32", "--allow_hash_tokenizer",
                           "--http_port", "0"])
    eng, size, norm = cli.build_clip_engine(args)
    if eng.adapter_params != 183040:
        fail(f"engine baked {eng.adapter_params} adapter parameters, "
             f"expected 183,040")
    print(f"[serve] ViT-L/14 engine built in {time.time() - t0:.1f} s "
          f"(random weights, {eng.adapter_params} DoRA parameters baked, "
          f"bf16 weights)", flush=True)
    t0 = time.time()
    eng.warmup((size, size, 3), buckets=(8, 32))
    print(f"[serve] warmed buckets 8 and 32 in {time.time() - t0:.1f} s",
          flush=True)

    pre = cli._http_preprocess(norm)
    rs = np.random.RandomState(SEED)
    sizes = (1, 3, 8, 20)
    seq_in = [rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
              for n in sizes]
    conc_in = [rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
               for n in sizes]
    daemon = ServingDaemon(eng, image_shape=(size, size, 3), port=0,
                           max_delay_ms=20.0, request_timeout=600.0,
                           preprocess=pre).start()
    try:
        # --- the main path: counts from 0, HTTP requests, counts read ---
        vattn.reset_launch_counts()
        t0 = time.time()
        seq_out = [_post(daemon.port, a) for a in seq_in]
        conc_out = [None] * len(conc_in)
        errors = []

        def worker(i):
            try:
                conc_out[i] = _post(daemon.port, conc_in[i])
            except Exception as e:  # reported below, the run then fails
                errors.append(repr(e))
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(conc_in))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        http_s = time.time() - t0
        launches = vattn.LAUNCHES["flash3_fwd"]
        dispatches = daemon.batcher.dispatches
        stats = daemon.stats.snapshot()
    finally:
        daemon.shutdown()
    if errors or any(o is None for o in conc_out):
        fail(f"concurrent requests failed: {errors}")
    print(f"[serve] {len(sizes)} sequential + {len(sizes)} concurrent POSTs "
          f"({2 * sum(sizes)} images) in {http_s:.2f} s over "
          f"{dispatches} dispatches; latency {stats['latency_ms']}",
          flush=True)
    if launches != 36 * dispatches:
        fail(f"flash3_fwd launched {launches} times over {dispatches} "
             f"dispatched chunks, expected 36 per chunk")
    print(f"[serve] flash3_fwd launches {launches} = 36 x {dispatches} "
          f"chunks", flush=True)

    # every answer: shape, finite, equal to a direct engine call. A request
    # served alone runs the same bucket as the direct call and must agree to
    # f32 rounding; one coalesced with others ran in a larger bucket, where
    # cuBLAS may pick other bf16 GEMM kernels, so it gets a bf16 tolerance.
    worst = {"alone": 0.0, "coalesced": 0.0}
    for kind, ins, outs in (("alone", seq_in, seq_out),
                            ("coalesced", conc_in, conc_out)):
        for a, got in zip(ins, outs):
            if got.shape != (len(a), 66) or not np.all(np.isfinite(got)):
                fail(f"bad response: shape {got.shape}, finite "
                     f"{np.all(np.isfinite(got))}")
            want = eng(pre(a))
            worst[kind] = max(worst[kind], float(np.abs(got - want).max()))
    if worst["alone"] > 1e-4 or worst["coalesced"] > 5e-2:
        fail(f"served scores differ from direct engine calls: {worst}")
    print(f"[serve] responses [n,66], finite; max |served - direct|: alone "
          f"{worst['alone']:.2e} (tol 1e-4), coalesced "
          f"{worst['coalesced']:.2e} (tol 5e-2)", flush=True)

    # the same model with the attention op swapped for its plain version
    x8 = pre(seq_in[2])
    kernel_scores = eng(x8)
    swapped = vattn.flash_mha_packed_qkv
    vattn.flash_mha_packed_qkv = (
        lambda qkv, *, num_heads, causal=False:
        vattn.flash_mha_packed_qkv_reference(qkv, num_heads, causal)[0])
    try:
        plain_scores = eng(x8)
    finally:
        vattn.flash_mha_packed_qkv = swapped
    # bf16 activations: the two attention versions round p differently (up
    # to one bf16 spacing of o per call, 36 calls feeding the residual
    # streams), so the scores differ by a few bf16 roundings of the
    # embeddings (measured on an H100: 2.4e-2 with |scores| <= 0.85)
    model_err = float(np.abs(kernel_scores - plain_scores).max())
    scale = float(np.abs(plain_scores).max())
    print(f"[serve] scores with kernel vs plain attention (8 images, bf16): "
          f"max abs diff {model_err:.3e} (tol 5e-2; max |score| {scale:.3f})",
          flush=True)
    if not model_err <= 5e-2:
        fail(f"kernel and plain attention disagree on the served scores: "
             f"{model_err}")

    # served images/s (host arrays in, host scores out, synchronous calls)
    eng.warmup((size, size, 3), buckets=(256,))
    ips = {}
    for b, reps in ((8, 20), (256, 5)):
        x = pre(rs.randint(0, 256, (b, size, size, 3)).astype(np.uint8))
        call_s = _call_s(eng, x, reps)
        ips[b] = b / call_s
        print(f"[serve] bucket {b}: median {call_s * 1e3:.2f} ms per call, "
              f"{ips[b]:.1f} images/s", flush=True)
    batches = [pre(rs.randint(0, 256, (256, size, size, 3)).astype(np.uint8))
               for _ in range(4)]
    t0 = time.perf_counter()
    n = sum(len(o) for o in eng.map_stream(batches, depth=2))
    stream_ips = n / (time.perf_counter() - t0)
    print(f"[serve] map_stream 4 x 256 (depth 2): {stream_ips:.1f} images/s; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # where a call's time goes, on the host clock around work that ends in
    # a synchronize: the forward from inputs already on the card, the text
    # tower alone, and the rest of a call (host preparation, pinned copy in,
    # scores out)
    breakdown = {}
    with torch.inference_mode():
        for b, reps in ((8, 20), (256, 5)):
            x = eng._place(pre(rs.randint(0, 256, (b, size, size, 3))
                               .astype(np.uint8)))
            breakdown[b] = _wall_ms(lambda: eng._fn(eng.model, x), reps)
        text_ms = _wall_ms(lambda: vclip.encode_text(
            eng.model, eng.prompt_tokens, compute_dtype=torch.bfloat16), 20)
    for b in (8, 256):
        call_ms = b / ips[b] * 1e3
        print(f"[serve] bucket {b}: call {call_ms:.2f} ms = forward from "
              f"inputs on the card {breakdown[b]:.2f} ms (text tower alone "
              f"{text_ms:.2f} ms) + host and copies "
              f"{call_ms - breakdown[b]:.2f} ms", flush=True)
    RESULTS["serve"] = {
        "launches": launches, "dispatches": dispatches,
        "served_vs_direct": worst, "kernel_vs_plain_scores": model_err,
        "images_per_s": {str(k): v for k, v in ips.items()},
        "map_stream_images_per_s": stream_ips,
        "latency_ms": stats["latency_ms"],
        "forward_ms": {str(k): v for k, v in breakdown.items()},
        "text_tower_ms": text_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    return launches


# the serve_vit phase: ViT-B/16 served through the CLI's builders at buckets
# 8 and 256 (12 flash3_fwd launches a chunk), its features mode, int8 engines
# against bf16 ones (ViT-B/16 and CLIP ViT-L/14), an AOT artifact served
# from a fresh process, and the profiler trace of one training epoch
SERVE_VIT_BUCKETS = "8,256"
SERVE_VIT_REQUESTS = (3, 8, 200, 256)      # one chunk each: buckets 8, 8,
SERVE_VIT_CHUNKS = 4                       # 256, 256
# the ViT-B/16 logits with the kernel against the plain attention, bf16 on
# the card: max |difference| over the largest |plain logit|, the grid's rule
# for its CLS embeddings (GRID_EMB_KERNEL_RTOL): the two attentions round o
# to bf16 from f32 sums in another order, a few bf16 spacings through 12
# blocks
SERVE_VIT_KERNEL_RTOL = 2e-2
# int8 against bf16 serving: |int8 - bf16| / |bf16| over a batch's outputs
# (Frobenius norms), the JAX package's bounds for its int8 engines against
# their float ones (tests/test_quant.py: 0.05 for the ViT engine, 0.08 for
# CLIP-HBA after the bake)
INT8_VIT_RTOL = 0.05
INT8_CLIP_RTOL = 0.08

# run in a fresh process: load an artifact through the CLI's builder, serve
# the requests in argv[3] (.npz), write the outputs to argv[4], print counts
_FROM_EXPORT = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from vit_project_torch.cli import serve as cli
from vit_project_torch.ops import attention as vattn
torch.cuda.init()
import_s = time.perf_counter() - t0
args = cli.parse_args(["--from_export", sys.argv[2], "--http_port", "0"])
eng, size, norm = cli.build_engine(args)
load_s = time.perf_counter() - t0
reqs = np.load(sys.argv[3])
vattn.reset_launch_counts()
t1 = time.perf_counter()
outs = {k: eng(reqs[k]) for k in reqs.files}
first_s = time.perf_counter() - t1
launches = vattn.LAUNCHES["flash3_fwd"]
x = reqs[reqs.files[-1]]
times = []
for _ in range(5):
    t2 = time.perf_counter()
    eng(x)
    times.append(time.perf_counter() - t2)
np.savez(sys.argv[4], **outs)
print(json.dumps({"import_s": import_s, "load_s": load_s,
                  "first_requests_s": first_s,
                  "launches": launches, "buckets": list(eng.buckets),
                  "mode": args.mode, "warm_call_s": sorted(times)[2],
                  "warm_call_rows": len(x),
                  "device": torch.cuda.get_device_name(0)}))
"""


def _wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of `fn` over `reps` calls, each ending in a
    synchronize (one warm call first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _call_s(eng, x, reps: int = 5) -> float:
    """Median seconds of one synchronous engine call on host array x."""
    eng(x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng(x)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _in_turns(a, b, reps: int = 5):
    """(a's, b's) median call time, measured a, b, b, a; each the mean of
    its two medians."""
    ta1, tb1, tb2, ta2 = a(reps), b(reps), b(reps), a(reps)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def _fwd_ms(eng, xd, reps: int, op: bool) -> float:
    """_wall_ms of the engine's forward on xd (on the card), its attention
    as served (a direct launch in eager mode) or, with op, forced through
    the registered op, as a program loaded from an artifact runs it."""
    import torch
    from vit_project_torch.ops import attention as vattn
    served = vattn.flash3_fwd
    if op:
        vattn.flash3_fwd = (lambda qkv, num_heads, causal=False:
                            torch.ops.vit_project_torch.flash3_fwd(
                                qkv, num_heads, causal))
    try:
        return _wall_ms(lambda: eng._fn(eng.model, xd), reps)
    finally:
        vattn.flash3_fwd = served


def _rel_norm(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _clip_checkpoints(tmp: str):
    """The serve phase's seeded ViT-L/14 weights and adapters (written
    here when that phase did not run)."""
    wpath = os.path.join(tmp, "ViT-L-14-random.pt")
    dpath = os.path.join(tmp, "epoch1_dora_params.pth")
    if not (os.path.exists(wpath) and os.path.exists(dpath)):
        wpath, dpath, _ = _write_random_checkpoints(tmp)
    return wpath, dpath


def phase_serve_vit(tmp: str):
    import logging
    import torch
    from vit_project_torch.ckpt import vit_ckpt
    from vit_project_torch.cli import serve as cli
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import convert as vconvert
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.ops import quant as vquant
    from vit_project_torch.train import vit_loop

    res: dict = {}
    t0 = time.time()
    cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    model = vvit.init_vit_params(vvit.empty_vit(cfg, "cuda"),
                                 torch.Generator(device="cuda")
                                 .manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    tree = vconvert.vit_jax_from_state_dict(model.state_dict())
    ckdir = os.path.join(tmp, "vit_serve_ckpt")
    ckpt = vit_ckpt.save_checkpoint(0, tree, {"momentum": None}, {}, 0.0,
                                    0.0, 0.0, ckdir)
    del model, tree

    def vit_args(*extra):
        return cli.parse_args(["--model", "vit_base_patch16_224",
                               "--checkpoint", ckpt, "--buckets",
                               SERVE_VIT_BUCKETS, "--http_port", "0", *extra])
    eng, size, norm = cli.build_engine(vit_args())
    print(f"[serve_vit] ViT-B/16 engine ({n_params / 1e6:.1f}M parameters, "
          f"JAX-layout checkpoint, bf16 weights, buckets {eng.buckets}) "
          f"built in {time.time() - t0:.1f} s", flush=True)
    if n_params != 86567656:
        fail(f"ViT-B/16 has {n_params} parameters, expected 86,567,656")
    pre = cli._http_preprocess(norm)
    rs = np.random.RandomState(SEED)
    # uint8 pixels, as a client posts them (a float request is read as
    # [0, 1], the JAX wire contract)
    reqs = [rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
            for n in SERVE_VIT_REQUESTS]
    eng.warmup((size, size, 3))

    # --- the main path: counts from 0, requests through the engine ---
    vattn.reset_launch_counts()
    outs = [eng(pre(a)) for a in reqs]
    launches = vattn.LAUNCHES["flash3_fwd"]
    if launches != 12 * SERVE_VIT_CHUNKS:
        fail(f"flash3_fwd launched {launches} times over {SERVE_VIT_CHUNKS} "
             f"chunks, expected 12 per chunk")
    for a, o in zip(reqs, outs):
        if o.shape != (len(a), 1000) or not np.all(np.isfinite(o)):
            fail(f"bad logits: shape {o.shape}, finite "
                 f"{np.all(np.isfinite(o))}")
    print(f"[serve_vit] requests of {SERVE_VIT_REQUESTS} images: logits "
          f"[n, 1000], finite; flash3_fwd launches {launches} = 12 x "
          f"{SERVE_VIT_CHUNKS} chunks", flush=True)

    # the same engine with the attention swapped for its plain version: the
    # logits, and every token of the last block (the patch rows apart from
    # the CLS row the logits read)
    x8 = pre(reqs[1])

    def tokens():
        with torch.inference_mode():
            return vvit.vit_encode(eng.model, eng._place(x8),
                                   input_norm=vit_loop.IMAGENET_NORM,
                                   compute_dtype=torch.bfloat16).float()
    tok = tokens()
    swapped = vattn.flash_mha_packed_qkv
    vattn.flash_mha_packed_qkv = (
        lambda qkv, *, num_heads, causal=False:
        vattn.flash_mha_packed_qkv_reference(qkv, num_heads, causal)[0])
    try:
        plain = eng(x8)
        tok_plain = tokens()
    finally:
        vattn.flash_mha_packed_qkv = swapped
    kernel_err = float(np.abs(outs[1] - plain).max() / np.abs(plain).max())
    patch_err = float((tok - tok_plain)[:, 1:].abs().max()
                      / tok_plain[:, 1:].abs().max())
    print(f"[serve_vit] kernel vs plain attention (8 images, bf16): logits "
          f"max |diff| / max |logit| {kernel_err:.3e}; the last block's "
          f"patch tokens max |diff| / max |token| {patch_err:.3e} (max |token| "
          f"{float(tok_plain[:, 1:].abs().max()):.3f}); tol "
          f"{SERVE_VIT_KERNEL_RTOL} each", flush=True)
    if not kernel_err <= SERVE_VIT_KERNEL_RTOL:
        fail(f"kernel and plain attention disagree on the logits: "
             f"{kernel_err}")
    if not patch_err <= SERVE_VIT_KERNEL_RTOL:
        fail(f"kernel and plain attention disagree on the patch tokens: "
             f"{patch_err}")
    del tok, tok_plain

    # features mode: [n, 768], token pooling is the classifier's CLS token
    feng, _, _ = cli.build_engine(vit_args("--mode", "features"))
    feats = feng(x8)
    with torch.inference_mode():
        cls_tok = vvit.vit_encode(eng.model, eng._place(x8),
                                  input_norm=vit_loop.IMAGENET_NORM,
                                  compute_dtype=torch.bfloat16)[:, 0]
    if feats.shape != (8, cfg.width) or not np.array_equal(
            feats, cls_tok.float().cpu().numpy()):
        fail(f"features mode: shape {feats.shape}, or the token pooling "
             f"differs from the classifier's CLS token")
    print(f"[serve_vit] --mode features: [8, {cfg.width}], equal to the "
          f"classifier's CLS token bit for bit", flush=True)
    del feng, feats, cls_tok

    # int8 ViT-B/16: same checkpoint, the scales f32, 12 launches a chunk
    qeng, _, _ = cli.build_engine(vit_args("--quantize", "int8"))
    wq = qeng.model.blocks[0].attn.qkv.weight
    if not vquant.is_quantized(wq) or wq.s.dtype != torch.float32:
        fail("the int8 engine's qkv weight is not an int8 holder with f32 "
             "scales")
    qeng.warmup((size, size, 3))
    vattn.reset_launch_counts()
    qouts = [qeng(pre(a)) for a in reqs]
    q_launches = vattn.LAUNCHES["flash3_fwd"]
    if q_launches != 12 * SERVE_VIT_CHUNKS:
        fail(f"int8: flash3_fwd launched {q_launches} times over "
             f"{SERVE_VIT_CHUNKS} chunks, expected 12 per chunk")
    x256 = pre(reqs[3])
    q_err = _rel_norm(qouts[3], outs[3])
    top1 = float(np.mean(qouts[3].argmax(1) == outs[3].argmax(1)))
    print(f"[serve_vit] int8 ViT-B/16: flash3_fwd launches {q_launches} = "
          f"12 x {SERVE_VIT_CHUNKS} chunks; |int8 - bf16| / |bf16| over 256 "
          f"images' logits {q_err:.4f} (tol {INT8_VIT_RTOL}); top-1 agreement "
          f"{top1:.3f}", flush=True)
    if not q_err <= INT8_VIT_RTOL:
        fail(f"int8 ViT-B/16 logits differ from bf16 by {q_err}")
    bf_s, q_s = _in_turns(lambda r: _call_s(eng, x256, r),
                          lambda r: _call_s(qeng, x256, r))
    with torch.inference_mode():
        xd = eng._place(x256)
        fwd = {"bf16": _wall_ms(lambda: eng._fn(eng.model, xd), 5),
               "int8": _wall_ms(lambda: qeng._fn(qeng.model, xd), 5)}
        prof = {"bf16": _profile(lambda: eng._fn(eng.model, xd)),
                "int8": _profile(lambda: qeng._fn(qeng.model, xd))}
    print(f"[serve_vit] bucket 256, in turns: bf16 {256 / bf_s:.1f} "
          f"images/s ({bf_s * 1e3:.2f} ms a call), int8 {256 / q_s:.1f} "
          f"images/s ({q_s * 1e3:.2f} ms); forward from inputs on the card "
          f"bf16 {fwd['bf16']:.2f} ms, int8 {fwd['int8']:.2f} ms", flush=True)
    for k, p in prof.items():
        if p:
            print(f"[serve_vit] {k} forward at 256, device ms by group: "
                  + ", ".join(f"{g} {v:.2f}" for g, v in
                              p["ms_per_call"].items())
                  + f"; idle share {p['idle_share']:.3f}; top other "
                  f"{p['top_other_ms']}", flush=True)
    # the registered op against the served direct launch where the host
    # leads: the bucket-8 forward (12 dispatches in a few ms), in turns
    with torch.inference_mode():
        xd8 = eng._place(x8)
        op8, direct8 = _in_turns(lambda r: _fwd_ms(eng, xd8, r, True),
                                 lambda r: _fwd_ms(eng, xd8, r, False), 30)
    print(f"[serve_vit] bucket 8 forward from inputs on the card, in turns: "
          f"through the registered op {op8:.3f} ms, as served (the kernel "
          f"launched directly) {direct8:.3f} ms ({(op8 - direct8) / 12 * 1e3:.1f}"
          f" us a dispatch)", flush=True)
    res.update(launches=launches, chunks=SERVE_VIT_CHUNKS,
               kernel_vs_plain_rel=kernel_err,
               kernel_vs_plain_patch_rel=patch_err,
               forward_ms_8={"registered_op": op8, "direct_launch": direct8},
               int8_launches=q_launches,
               int8_vs_bf16_rel=q_err, int8_top1_agreement=top1,
               images_per_s_256={"bf16": 256 / bf_s, "int8": 256 / q_s},
               forward_ms_256=fwd, profile_256=prof)
    del qeng, qouts, xd, xd8
    torch.cuda.empty_cache()

    # an artifact: --export_dir through the CLI, --from_export in a fresh
    # process, its outputs against the live engine's on the same requests
    art = os.path.join(tmp, "vit_artifact")
    t0 = time.time()
    if cli.main(["--model", "vit_base_patch16_224", "--checkpoint", ckpt,
                 "--buckets", SERVE_VIT_BUCKETS, "--export_dir", art]) != 0:
        fail("--export_dir returned non-zero")
    export_s = time.time() - t0
    sizes = {f: os.path.getsize(os.path.join(art, f))
             for f in sorted(os.listdir(art))}
    req_path = os.path.join(tmp, "vit_requests.npz")
    out_path = os.path.join(tmp, "vit_artifact_outputs.npz")
    np.savez(req_path, **{f"r{i}": pre(a) for i, a in enumerate(reqs)})
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", _FROM_EXPORT, ROOT, art, req_path, out_path],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    sub_s = time.time() - t0
    if proc.returncode != 0:
        fail(f"--from_export process failed:\n{proc.stderr[-3000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    got = np.load(out_path)
    same = all(np.array_equal(got[f"r{i}"], o) for i, o in enumerate(outs))
    worst = max(float(np.abs(got[f"r{i}"] - o).max())
                for i, o in enumerate(outs))
    print(f"[serve_vit] artifact: exported buckets {sub['buckets']} in "
          f"{export_s:.1f} s; files {sizes} ({sum(sizes.values()) / 2**20:.1f}"
          f" MiB, parameters {n_params * 2 / 2**20:.1f} MiB in bf16); fresh "
          f"process {sub_s:.1f} s (ready {sub['load_s']:.2f} s from start, "
          f"of which imports and CUDA init {sub['import_s']:.2f} s; "
          f"first requests {sub['first_requests_s']:.2f} s, warm 256-image "
          f"call {sub['warm_call_s'] * 1e3:.2f} ms); flash3_fwd launches "
          f"{sub['launches']} = 12 x {SERVE_VIT_CHUNKS} chunks; outputs "
          f"equal to the live engine's: {same} (max |diff| {worst:.3e})",
          flush=True)
    if sub["launches"] != 12 * SERVE_VIT_CHUNKS:
        fail(f"the artifact launched flash3_fwd {sub['launches']} times, "
             f"expected 12 per chunk")
    if not same:
        fail(f"the artifact's outputs differ from the live engine's "
             f"(max |diff| {worst})")
    if sizes["params.pth"] < n_params * 2 or any(
            v > sizes["params.pth"] / 20 for k, v in sizes.items()
            if k.startswith("bucket_")):
        fail(f"the weights are not stored once: {sizes}")
    res["artifact"] = {"export_s": export_s, "files": sizes,
                       "process_s": sub_s, **sub}
    del eng, outs
    torch.cuda.empty_cache()

    # CLIP ViT-L/14 with baked adapters: int8 against bf16, 36 launches a
    # chunk, images/s in turns, and the registered op's dispatch cost
    wpath, dpath = _clip_checkpoints(tmp)

    def clip_engine(*extra):
        return cli.build_clip_engine(cli.parse_args(
            ["--clip_weights", wpath, "--dora_checkpoint", dpath, "--rank",
             "32", "--allow_hash_tokenizer", "--buckets", SERVE_VIT_BUCKETS,
             "--http_port", "0", *extra]))
    t0 = time.time()
    ceng, csize, cnorm = clip_engine()
    cqeng, _, _ = clip_engine("--quantize", "int8")
    print(f"[serve_vit] CLIP ViT-L/14 engines (bf16 and int8, rank-32 DoRA "
          f"baked) built in {time.time() - t0:.1f} s", flush=True)
    cpre = cli._http_preprocess(cnorm)
    creqs = [cpre(rs.randint(0, 256, (n, csize, csize, 3)).astype(np.uint8))
             for n in (8, 256)]
    cqeng.warmup((csize, csize, 3))
    ceng.warmup((csize, csize, 3))
    vattn.reset_launch_counts()
    cq = [cqeng(x) for x in creqs]
    c_launches = vattn.LAUNCHES["flash3_fwd"]
    cb = [ceng(x) for x in creqs]
    if c_launches != 36 * 2:
        fail(f"int8 CLIP: flash3_fwd launched {c_launches} times over 2 "
             f"chunks, expected 36 per chunk")
    c_err = _rel_norm(cq[1], cb[1])
    print(f"[serve_vit] int8 CLIP-HBA: flash3_fwd launches {c_launches} = 36 "
          f"x 2 chunks; |int8 - bf16| / |bf16| over 256 images' scores "
          f"{c_err:.4f} (tol {INT8_CLIP_RTOL}); max |score| "
          f"{float(np.abs(cb[1]).max()):.3f}", flush=True)
    if not c_err <= INT8_CLIP_RTOL or not np.all(np.isfinite(cq[1])):
        fail(f"int8 CLIP-HBA scores differ from bf16 by {c_err}")
    cbf_s, cq_s = _in_turns(lambda r: _call_s(ceng, creqs[1], r),
                            lambda r: _call_s(cqeng, creqs[1], r))
    with torch.inference_mode():
        xd = ceng._place(creqs[1])
        op_ms, direct_ms = _in_turns(lambda r: _fwd_ms(ceng, xd, r, True),
                                     lambda r: _fwd_ms(ceng, xd, r, False))
    print(f"[serve_vit] CLIP bucket 256, in turns: bf16 {256 / cbf_s:.1f} "
          f"images/s, int8 {256 / cq_s:.1f} images/s; forward from inputs "
          f"on the card through the registered op {op_ms:.2f} ms, as served "
          f"(the kernel launched directly) {direct_ms:.2f} ms", flush=True)
    res["clip"] = {"int8_launches": c_launches, "int8_vs_bf16_rel": c_err,
                   "images_per_s_256": {"bf16": 256 / cbf_s,
                                        "int8": 256 / cq_s},
                   "forward_ms_256": {"registered_op": op_ms,
                                      "direct_launch": direct_ms}}
    del ceng, cqeng, xd
    torch.cuda.empty_cache()

    # the profiler trace: one ViT-B/16 training epoch (4 steps at batch
    # 256, fused_dw) with profile_dir, as cli.vit_train --profile_dir runs
    data = os.path.join(tmp, "imagenet")
    if not os.path.isdir(data):
        _write_image_folder(data, np.random.RandomState(SEED))
    trace_dir = os.path.join(tmp, "vit_trace")
    logger = logging.getLogger("chip_smoke.serve_vit")
    logger.setLevel(logging.WARNING)
    stats = []
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    vit_loop.run_vit_training(
        ViTTrainConfig(data_path=data, output_dir=os.path.join(tmp, "vit_tr"),
                       batch_size=256, epochs=1, num_workers=8,
                       compute_dtype="bfloat16", fused_dw=True,
                       random_seed=SEED, profile_dir=trace_dir),
        logger=logger, vit_cfg=cfg, device="cuda", on_epoch=stats.append)
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"expected one trace file in {trace_dir}, got {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    named = {k: sum(n for name, n in kernels.items() if k in name)
             for k in ("attn_fwd", "attn_bwd", "dw_db")}
    steps = stats[0]["steps"]
    print(f"[serve_vit] trace of one epoch ({steps} steps, train "
          f"{stats[0]['train_s']:.2f} s): {files[0]} "
          f"{os.path.getsize(os.path.join(trace_dir, files[0])) / 2**20:.1f} "
          f"MiB, {len(events)} events, {sum(kernels.values())} kernel events; "
          f"flash3 forward {named['attn_fwd']}, backward {named['attn_bwd']}, "
          f"dw_db {named['dw_db']} (launches counted: flash3_fwd "
          f"{vattn.LAUNCHES['flash3_fwd']}, flash3_bwd "
          f"{vattn.LAUNCHES['flash3_bwd']}, dw_db {vfdw.LAUNCHES['dw_db']})",
          flush=True)
    if not all(named.values()):
        fail(f"the trace does not name the flash3 and dw_db kernels: {named}")
    res["trace"] = {"file_mib": os.path.getsize(
        os.path.join(trace_dir, files[0])) / 2**20, "events": len(events),
        "kernel_events": named, "epoch": stats[0]}
    RESULTS["serve_vit"] = res
    return launches


def _synthetic_things(rs: np.random.RandomState):
    """THINGS at its real size, in memory: 1,806 uint8 images at 224^2 with
    66 targets each, 48 inference images and a symmetric 48x48 RDM. The
    run skips the CSV and PNG readers (the card's machine has no PIL and no
    pandas) and hands the arrays to train_model directly."""
    images = rs.randint(0, 256, (1806, 224, 224, 3)).astype(np.uint8)
    targets = (rs.rand(1806, 66) * 2).astype(np.float32)
    inference = rs.randint(0, 256, (48, 224, 224, 3)).astype(np.uint8)
    rdm = rs.rand(48, 48)
    rdm = ((rdm + rdm.T) / 2).astype(np.float32)
    np.fill_diagonal(rdm, 0.0)
    return images, targets, inference, rdm


def _read_rows(path):
    import csv
    with open(path) as f:
        return list(csv.reader(f))


def phase_train(tmp: str):
    import logging
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.ckpt import clip_ckpt
    from vit_project_torch.data import things as dthings
    from vit_project_torch.data.spose66 import classnames66
    from vit_project_torch.models import clip as vclip
    from vit_project_torch.models import tokenizer as vtok
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.train import clip_loop

    t0 = time.time()
    cfg = vclip.CLIP_VIT_L14
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = vclip.init_clip_weights_(vclip.empty_clip(cfg, "cuda"), gen)
    spec = adora.dora_spec(cfg.visual.layers, cfg.text.layers, 2, 1)
    init_tr, static, acfg = adora.apply_dora(model, spec, r=32, alpha=16,
                                             dropout=0.1, generator=gen)
    n_params = adora.count_trainable_parameters(init_tr)
    if n_params != 183040:
        fail(f"DoRA adapters hold {n_params} parameters, expected 183,040")
    prompts = vtok.tokenize(classnames66, context_length=77, truncate=True)
    images, targets, inf_images, rdm = _synthetic_things(
        np.random.RandomState(SEED))
    train_idx, test_idx = dthings.random_split_indices(len(images), 0.8, SEED)
    batch, lr, epochs, data_seed, dropout_seed = 64, 3e-4, 2, SEED, SEED
    logger = logging.getLogger("chip_smoke.train")
    logger.setLevel(logging.WARNING)

    def new_trainer():
        return clip_loop.ClipHBATrainer(cfg, model, acfg, static, prompts,
                                        lr=lr, compute_dtype=torch.bfloat16)

    def run(trainable, optimizer, out, resume_from_epoch=0, previous=None,
            epoch_stats=None):
        trainer = new_trainer()
        hook = None if epoch_stats is None else epoch_stats.append
        return clip_loop.train_model(
            trainer, trainable, optimizer, train_images=images[train_idx],
            train_targets=targets[train_idx], test_images=images[test_idx],
            test_targets=targets[test_idx], inference_images=inf_images,
            reference_rdm=rdm,
            shuffler=dthings.EpochShuffler(len(train_idx), batch, data_seed),
            epochs=epochs, batch_size=batch,
            training_res_path=os.path.join(out, "training_res.csv"),
            training_run=0, perturb_length=0, perturb_seed=42,
            perturb_type="baseline", logger=logger,
            dora_parameters_path=os.path.join(out, "dora_params"),
            random_state_path=os.path.join(out, "random_states"),
            dropout_seed=dropout_seed, data_seed=data_seed,
            resume_from_epoch=resume_from_epoch,
            previous_training_res_path=previous, on_epoch=hook)[0]

    trainer = new_trainer()
    trainable = adora.make_trainable(init_tr, "cuda")
    optimizer = trainer.init_optimizer(trainable)
    print(f"[train] ViT-L/14 random weights, {n_params} DoRA parameters "
          f"(rank 32), THINGS-sized synthetic data ({len(train_idx)} train / "
          f"{len(test_idx)} test, 48 inference), set up in "
          f"{time.time() - t0:.1f} s", flush=True)

    # --- the main path: counts from 0, two epochs, counts read ---
    out = os.path.join(tmp, "train")
    stats = []
    torch.cuda.reset_peak_memory_stats()
    vattn.reset_launch_counts()
    t0 = time.time()
    run(trainable, optimizer, out, epoch_stats=stats)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = dict(vattn.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = sum(e["steps"] for e in stats)

    rows = _read_rows(os.path.join(out, "training_res.csv"))
    if len(rows) != 1 + epochs or [r[0] for r in rows[1:]] != ["1", "2"]:
        fail(f"expected CSV rows for epochs 1 and 2, got {rows}")
    for r in rows[1:]:
        vals = [float(v) for v in r[1:5]]
        if not all(np.isfinite(vals)) or abs(vals[2]) > 1:
            fail(f"bad CSV row {r}")
    for e in (1, 2):
        for path in (f"dora_params/epoch{e}_dora_params.pth",
                     f"random_states/epoch{e}_random_states.pth"):
            if not os.path.exists(os.path.join(out, path)):
                fail(f"missing checkpoint {path}")
    if launches["flash3_bwd"] != steps:
        fail(f"flash3_bwd launched {launches['flash3_bwd']} times over "
             f"{steps} steps, expected once per step")
    if launches["flash3_fwd"] == 0:
        fail("flash3_fwd was not launched by the training run")
    print(f"[train] 2 epochs ({steps} steps) in {run_s:.1f} s; launches "
          f"flash3_bwd {launches['flash3_bwd']} (one per step), flash3_fwd "
          f"{launches['flash3_fwd']}; rows "
          + "; ".join(",".join(r[:5]) for r in rows[1:]), flush=True)

    # a fresh trainer resumed from the epoch-1 files redoes epoch 2
    state = clip_ckpt.load_random_states(os.path.join(out, "random_states"),
                                         1, logger)
    resumed = adora.make_trainable(clip_ckpt.load_dora_parameters(
        os.path.join(out, "dora_params", "epoch1_dora_params.pth"),
        init_tr, spec), "cuda")
    opt2 = new_trainer().init_optimizer(resumed)
    if not clip_ckpt.adamw_state_matches(state["optimizer_state"], resumed):
        fail("the epoch-1 optimizer state does not match the adapters")
    clip_ckpt.adamw_state_from_optax(opt2, state["optimizer_state"], resumed)
    out2 = os.path.join(tmp, "resumed")
    run(resumed, opt2, out2, resume_from_epoch=1,
        previous=os.path.join(out, "training_res.csv"))
    rows2 = _read_rows(os.path.join(out2, "training_res.csv"))
    exact = rows2 == rows
    diff = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
               for a, b in zip(rows2[2][1:5], rows[2][1:5]))
    print(f"[train] resumed from the epoch-1 files: epoch-2 row "
          f"{'bit-exact' if exact else 'differs'} (max relative difference "
          f"{diff:.3e}, tolerance 1e-3)", flush=True)
    if not diff <= 1e-3:
        fail(f"resumed epoch-2 row {rows2[2]} vs {rows[2]}")

    # one step's adapter gradients, kernel backward vs plain backward
    trainer = new_trainer()
    g_tr = adora.make_trainable(init_tr, "cuda")
    imgs_dev, tgts_dev = trainer.upload_dataset(images[train_idx[:batch]],
                                                targets[train_idx[:batch]])

    def grads():
        for *_, leaf in adora.trainable_leaves(g_tr):
            leaf.grad = None
        preds = trainer.forward(g_tr, dthings.normalize_uint8(imgs_dev))
        torch.mean(torch.mean((preds - tgts_dev) ** 2, dim=-1)).backward()
        return {f"{t}.{i}.{n}": leaf.grad.clone()
                for t, i, n, leaf in adora.trainable_leaves(g_tr)}
    with_kernel = grads()
    kernel_bwd = vattn.flash3_bwd
    vattn.flash3_bwd = vattn.flash_mha_packed_qkv_bwd_reference
    try:
        with_plain = grads()
    finally:
        vattn.flash3_bwd = kernel_bwd
    # bf16: the two backwards differ by at most one bf16 spacing per element
    # of dqkv, which reaches only block 22's adapter through block 23's
    # qkv projection; the relative error is a few bf16 roundings
    grad_err = {k: (with_kernel[k] - with_plain[k]).abs().max().item()
                / max(with_plain[k].abs().max().item(), 1e-30)
                for k in with_plain}
    worst = max(grad_err.values())
    print(f"[train] adapter gradients, kernel vs plain backward: max "
          f"relative difference {worst:.2e} (tolerance 5e-2) over "
          f"{len(grad_err)} tensors", flush=True)
    if not worst <= 5e-2:
        fail(f"adapter gradients disagree: {grad_err}")

    # times: steps from the second epoch (the first warms cuBLAS up)
    e2 = stats[-1]
    step_ms = e2["train_s"] / e2["steps"] * 1e3
    ips = len(train_idx) / e2["train_s"]
    with torch.no_grad():
        tst_dev, tst_tgt = trainer.upload_dataset(images[test_idx],
                                                  targets[test_idx])
        inf_dev, _ = trainer.upload_dataset(inf_images)
        trainer.evaluate_resident(g_tr, tst_dev, tst_tgt, len(test_idx),
                                  batch)
        trainer.behavioral_rsa(g_tr, inf_dev, rdm)

        def wall_ms(fn, reps=3):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            return statistics.median(times)
        eval_ms = wall_ms(lambda: trainer.evaluate_resident(
            g_tr, tst_dev, tst_tgt, len(test_idx), batch))
        rsa_ms = wall_ms(lambda: trainer.behavioral_rsa(g_tr, inf_dev, rdm))
        # where a step goes: the forward of one batch without autograd, the
        # text tower alone; the rest of a step is the backward from the
        # first adapted block, AdamW and the host's per-step sync
        x_batch = dthings.normalize_uint8(imgs_dev)
        fwd_ms = wall_ms(lambda: trainer.forward(g_tr, x_batch), 5)
        text_ms = wall_ms(lambda: vclip.encode_text(
            model, trainer.prompts, compute_dtype=torch.bfloat16), 5)
    print(f"[train] epoch 2: {e2['epoch_s']:.2f} s ({e2['steps']} steps, "
          f"{step_ms:.2f} ms per step, {ips:.1f} training images/s); eval "
          f"{eval_ms:.1f} ms ({len(test_idx)} images); RSA {rsa_ms:.1f} ms; "
          f"peak device memory {peak_gib:.2f} GiB; {smi_line()}", flush=True)
    print(f"[train] a step {step_ms:.2f} ms = forward of {batch} images "
          f"without autograd {fwd_ms:.2f} ms (text tower alone "
          f"{text_ms:.2f} ms) + backward, AdamW and host "
          f"{step_ms - fwd_ms:.2f} ms", flush=True)
    RESULTS["train"] = {
        "steps": steps, "launches": launches, "run_s": run_s,
        "epochs": stats, "step_ms": step_ms, "train_images_per_s": ips,
        "epoch_s": e2["epoch_s"], "eval_ms": eval_ms, "rsa_ms": rsa_ms,
        "forward_ms": fwd_ms, "text_tower_ms": text_ms,
        "peak_mem_gib": peak_gib, "rows": rows[1:],
        "resume_bit_exact": exact, "resume_max_rel_diff": diff,
        "grad_kernel_vs_plain": grad_err}
    del model, trainable, optimizer, resumed, opt2, g_tr, trainer
    torch.cuda.empty_cache()
    return launches


def _write_image_folder(root: str, rs: np.random.RandomState,
                        classes: int = 8, train: int = 1024, val: int = 256,
                        size: int = 256) -> None:
    """A seeded ImageFolder of JPEGs at size^2: each class a tint over smooth
    random structure (8^2 noise upscaled) plus fine noise, so the images
    decode, crop and resize like photographs rather than flat colour."""
    from PIL import Image
    tints = rs.randint(40, 216, (classes, 3))
    for split, n in (("train", train), ("val", val)):
        for c in range(classes):
            d = os.path.join(root, split, f"class_{c:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n // classes):
                low = Image.fromarray(rs.randint(0, 256, (8, 8, 3))
                                      .astype(np.uint8))
                arr = np.asarray(low.resize((size, size), Image.BILINEAR),
                                 np.float32)
                arr = 0.5 * arr + 0.5 * tints[c] + rs.randn(size, size, 3) * 8
                Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                    os.path.join(d, f"{i:04d}.jpg"), quality=90)


def _ckpt_trees(out: str):
    from vit_project_torch.ckpt import serialization as ser
    ck = ser.load(os.path.join(out, "checkpoint_latest.pth"))
    return ck["params"], ck["opt_state"]


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y)
                                        for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b))


def _profile(fn, steps: int = 3):
    """Device time by kernel group over `steps` calls of `fn` (torch.profiler
    on the card), and the device's busy share of the host-clock window.
    Returns None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    others: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / steps
        name = e.key.lower()
        group = ("dw_db" if "dw_db" in name or "sum_splits" in name
                 else "attention" if "attn_" in name
                 else "gemm" if any(k in name for k in (
                     "gemm", "nvjet", "xmma", "cutlass", "cublas"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
        if group == "other":
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + ms
    busy = sum(groups.values())
    if busy == 0:
        return None
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    return {"ms_per_call": groups, "top_other_ms": top,
            "device_ms_per_call": busy, "wall_ms_per_call": wall_ms / steps,
            "idle_share": max(0.0, 1 - busy * steps / wall_ms)}


def phase_vit_train(tmp: str):
    import logging
    import torch
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.data.packed import make_loader
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.train import vit_loop

    t0 = time.time()
    data = os.path.join(tmp, "imagenet")
    _write_image_folder(data, np.random.RandomState(SEED))
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    logger = logging.getLogger("chip_smoke.vit_train")
    logger.setLevel(logging.WARNING)

    def cfg(out, epochs):
        return ViTTrainConfig(data_path=data, output_dir=out, batch_size=256,
                              epochs=epochs, num_workers=8,
                              compute_dtype="bfloat16", fused_dw=True,
                              random_seed=SEED)
    print(f"[vit_train] synthetic ImageFolder (8 classes, 1,024 train / 256 "
          f"val JPEGs at 256^2) written in {time.time() - t0:.1f} s; ViT-B/16 "
          f"(width 768, 12 blocks, 12 heads, S=197, 1,000 classes), batch "
          f"256, bf16, SGD lr 0.1 m 0.9 wd 1e-4, fused_dw", flush=True)

    # --- the main path: counts from 0, two epochs, counts read ---
    out_a = os.path.join(tmp, "vit_a")
    stats = []
    torch.cuda.reset_peak_memory_stats()
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    t0 = time.time()
    res = vit_loop.run_vit_training(cfg(out_a, 2), logger=logger,
                                    vit_cfg=vit_cfg, device="cuda",
                                    on_epoch=stats.append)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = {**vattn.LAUNCHES, **vfdw.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = sum(e["steps"] for e in stats)
    val_batches = 2            # one batch of 256 per validation, 2 epochs

    rows = _read_rows(os.path.join(out_a, "training_metrics.csv"))
    if rows[0] != ["epoch", "train_loss", "val_loss", "val_acc"] \
            or [r[0] for r in rows[1:]] != ["0", "1"]:
        fail(f"expected metrics rows for epochs 0 and 1, got {rows}")
    for r in rows[1:]:
        vals = [float(v) for v in r[1:]]
        if not all(np.isfinite(vals)) or not 0 <= vals[2] <= 100:
            fail(f"bad metrics row {r}")
    for name in ("checkpoint_epoch_000.pth", "checkpoint_epoch_001.pth",
                 "checkpoint_latest.pth"):
        if not os.path.exists(os.path.join(out_a, name)):
            fail(f"missing checkpoint {name}")
    want = {"dw_db": 49 * steps, "flash3_bwd": 12 * steps,
            "flash3_fwd": 12 * (steps + val_batches)}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"launches {launches} over {steps} steps and {val_batches} "
             f"validation batches, expected {want}")
    print(f"[vit_train] 2 epochs ({steps} steps) in {run_s:.1f} s; launches "
          f"dw_db {launches['dw_db']} (49 per step), flash3_bwd "
          f"{launches['flash3_bwd']} (12 per step), flash3_fwd "
          f"{launches['flash3_fwd']} (12 per forward); rows "
          + "; ".join(",".join(r) for r in rows[1:]), flush=True)

    # a run stopped after epoch 1 and resumed in place equals run A
    out_b = os.path.join(tmp, "vit_b")
    vit_loop.run_vit_training(cfg(out_b, 1), logger=logger, vit_cfg=vit_cfg,
                              device="cuda")
    vit_loop.run_vit_training(cfg(out_b, 2), logger=logger, vit_cfg=vit_cfg,
                              device="cuda")
    rows_b = _read_rows(os.path.join(out_b, "training_metrics.csv"))
    pa, ma = _ckpt_trees(out_a)
    pb, mb = _ckpt_trees(out_b)
    resume_exact = (rows_b == rows and _trees_equal(pa, pb)
                    and _trees_equal(ma, mb))
    print(f"[vit_train] stopped after epoch 1 and resumed: rows, parameters "
          f"and momentum {'bit-exact' if resume_exact else 'DIFFER'}",
          flush=True)
    if not resume_exact:
        fail(f"resumed run differs: rows {rows_b} vs {rows}")
    del pa, ma, pb, mb

    # one step twice from the same state and batch: the dW+db kernel, then
    # the plain dW+db swapped in
    model, momentum = res["model"], res["momentum_buf"]
    trainer = vit_loop.ViTTrainer(vit_cfg, cfg(out_a, 2), model, "cuda")
    loader = make_loader(os.path.join(data, "val"), 256, train=False,
                                  size=224, workers=8)
    imgs, lbls = trainer.place(*next(iter(loader.epoch(0))))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    m0 = {n: b.clone() for n, b in momentum.items()}

    def one_step():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(p0[n])
            for n, b in momentum.items():
                b.copy_(m0[n])
        trainer.step(momentum, imgs, lbls, 0.02)
        return {n: p.detach().clone() for n, p in model.named_parameters()}
    with_kernel = one_step()
    kernel_dw_db = vfdw.dw_db
    vfdw.dw_db = vfdw.dw_db_reference
    try:
        with_plain = one_step()
    finally:
        vfdw.dw_db = kernel_dw_db
    # f32 dW and db from exact products summed in another order: the
    # updates differ by float32 rounding, far below the update itself
    step_err = {n: (with_kernel[n] - with_plain[n]).abs().max().item()
                / max((with_plain[n] - p0[n]).abs().max().item(), 1e-30)
                for n in p0}
    worst = max(step_err.values())
    print(f"[vit_train] one bf16 step, kernel vs plain dW+db: max |diff| of "
          f"the updated parameters over the largest update {worst:.2e} "
          f"(tolerance 1e-3) over {len(step_err)} tensors", flush=True)
    if not worst <= 1e-3:
        fail(f"updated parameters disagree: {step_err}")
    del with_kernel, with_plain

    # device time of a step on a batch already on the card, with the fused
    # kernel and with the plain autograd backward, in turns (fused, plain,
    # plain, fused; 10 steps a turn, CUDA events between steps), so a drift
    # of the card's clock falls on both
    imgs_t, lbls_t = trainer.place(*next(iter(
        make_loader(os.path.join(data, "train"), 256, train=True,
                             size=224, workers=8, drop_last=True).epoch(0))))
    def turn(fused, steps=10):
        trainer.fused_dw = fused
        for _ in range(2):
            trainer.step(momentum, imgs_t, lbls_t, 0.02)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        for i in range(steps):
            trainer.step(momentum, imgs_t, lbls_t, 0.02)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    turns = {"fused": [], "plain": []}
    for name in ("fused", "plain", "plain", "fused"):
        turns[name].append(turn(name == "fused"))
    trainer.fused_dw = True
    spread = {k: {"turn_means": [statistics.mean(t) for t in v],
                  "min": min(min(t) for t in v), "max": max(max(t) for t in v),
                  "stdev": statistics.stdev([x for t in v for x in t])}
              for k, v in turns.items()}
    step_ms = statistics.mean(x for t in turns["fused"] for x in t)
    plain_step_ms = statistics.mean(x for t in turns["plain"] for x in t)
    print("[vit_train] step in turns (fused, plain, plain, fused; 10 steps "
          "each): " + "; ".join(
              f"{k} {statistics.mean(v['turn_means']):.2f} ms (turns "
              + ", ".join(f"{m:.2f}" for m in v["turn_means"])
              + f"; steps {v['min']:.2f}-{v['max']:.2f}, stdev "
              f"{v['stdev']:.2f})" for k, v in spread.items()), flush=True)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: trainer.logits(imgs_t), 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # profiler cycle note
        prof = _profile(lambda: trainer.step(momentum, imgs_t, lbls_t, 0.02))
    if prof is None:
        print("[vit_train] profiler: no device time seen (not measured)",
              flush=True)
    else:
        print("[vit_train] profiled step (3 steps, device ms per step): "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  prof["ms_per_call"].items()))
              + f"; device busy {prof['device_ms_per_call']:.2f} of "
              f"{prof['wall_ms_per_call']:.2f} ms (idle share "
              f"{prof['idle_share']:.3f}); largest of the rest: "
              + "; ".join(f"{k} {v:.2f}" for k, v in
                          prof["top_other_ms"].items()), flush=True)
    # host decode alone: one training epoch of the loader without the card
    t0 = time.time()
    n_dec = sum(len(b[1]) for b in make_loader(
        os.path.join(data, "train"), 256, train=True, size=224, workers=8,
        drop_last=True).epoch(1))
    decode_ips = n_dec / (time.time() - t0)
    print(f"[vit_train] host decode alone (8 threads, RandomResizedCrop of "
          f"256^2 JPEGs): {decode_ips:.1f} images/s", flush=True)
    e2 = stats[-1]
    ips = e2["images"] / e2["train_s"]
    print(f"[vit_train] step on a batch on the card: {step_ms:.2f} ms with "
          f"fused_dw ({256 / step_ms * 1e3:.1f} images/s), {plain_step_ms:.2f}"
          f" ms with the plain backward; forward alone {fwd_ms:.2f} ms; epoch "
          f"2: {e2['steps']} steps in {e2['train_s']:.2f} s with host decode "
          f"({ips:.1f} training images/s), validation of 256 images "
          f"{e2['val_s'] * 1e3:.1f} ms, epoch {e2['epoch_s']:.2f} s; peak "
          f"device memory {peak_gib:.2f} GiB; {smi_line()}", flush=True)
    RESULTS["vit_train"] = {
        "steps": steps, "launches": launches, "run_s": run_s,
        "epochs": stats, "rows": rows[1:], "resume_bit_exact": resume_exact,
        "step_kernel_vs_plain": step_err, "step_ms": step_ms,
        "plain_step_ms": plain_step_ms, "step_turns": turns,
        "step_spread": spread, "forward_ms": fwd_ms,
        "train_images_per_s": ips, "val_ms": e2["val_s"] * 1e3,
        "profile": prof, "decode_images_per_s": decode_ips,
        "epoch_s": e2["epoch_s"], "peak_mem_gib": peak_gib}
    del res, model, momentum, trainer, p0, m0
    torch.cuda.empty_cache()
    return launches

# the sweep phase: the perturbation kinds, and the target kinds (they change
# only the targets, so their forks train from the frozen-prefix cache in
# every epoch)
SWEEP_KINDS = ("random_target", "label_shuffle", "uniform_images",
               "image_noise")
TARGET_KINDS = ("random_target", "label_shuffle")
SWEEP_SEED = 1        # the CLIs' --random_seed (split, adapter init, dropout)
# cached vs full-tower CSV rows of one fork, bf16: the prefix comes from
# 256-image chunks and the full tower from 64-image batches, so a GEMM may
# round a value differently (one bf16 spacing, 2^-8 relative) before the
# adapted blocks; the clean epochs' losses are small (the targets are the
# initial model's own predictions), hence the absolute floor
SWEEP_LOSS_TOL = (2e-2, 1e-3)     # relative, absolute floor
SWEEP_RHO_TOL = 2e-2
_EPOCH_LINE = re.compile(r"Epoch (\d+): Training Loss: \S+, Validation "
                         r"Loss: \S+ \[epoch_time=\S+s images_per_sec="
                         r"([\d.]+)\]")
_CACHE_LINE = re.compile(r"Frozen-prefix cache built in ([\d.]+)s")


def _write_things(root: str, rs: np.random.RandomState, n_train=1806):
    """THINGS's images on disk at their real size: `n_train` training (1,806
    in THINGS) and 48 inference JPEGs at 224^2, each a tint over smooth
    random structure plus fine noise (as _write_image_folder draws them).
    Returns (image dir, names, the decoded uint8 pixels)."""
    from PIL import Image
    from vit_project_torch.data import things as dthings
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    names = [f"thing_{i:04d}.jpg" for i in range(n_train + 48)]
    tints = rs.randint(20, 236, (len(names), 3))
    for i, name in enumerate(names):
        low = Image.fromarray(rs.randint(0, 256, (8, 8, 3)).astype(np.uint8))
        arr = np.asarray(low.resize((224, 224), Image.BILINEAR), np.float32)
        arr = 0.5 * arr + 0.5 * tints[i] + rs.randn(224, 224, 3) * 8
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, name), quality=90)
    return img_dir, names, dthings.decode_images(img_dir, names, 224)


def _write_things_csvs(root: str, names, preds: np.ndarray,
                       n_train=1806) -> dict:
    """The annotation CSVs (a leading index column, image_name, 66 targets)
    and the RDM .mat: the targets are `preds`, the initial model's own
    predictions, and the RDM is 1 - corrcoef of its inference predictions.
    A baseline then starts near zero loss, and a perturbation of the targets
    shows as a higher loss."""
    import csv
    import scipy.io
    paths = {"csv_file": os.path.join(root, "train.csv"),
             "inference_csv_file": os.path.join(root, "val.csv"),
             "RDM48_triplet_dir": os.path.join(root, "rdm.mat")}
    for key, rows in (("csv_file", range(n_train)),
                      ("inference_csv_file", range(n_train, n_train + 48))):
        with open(paths[key], "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "image_name"] + [f"d{j}" for j in range(66)])
            for k, i in enumerate(rows):
                w.writerow([k, names[i]] + [repr(float(v)) for v in preds[i]])
    rdm = 1.0 - np.corrcoef(preds[n_train:].astype(np.float64))
    np.fill_diagonal(rdm, 0.0)
    scipy.io.savemat(paths["RDM48_triplet_dir"], {"RDM48_triplet": rdm})
    return paths


def _cli(main_fn, argv, log_path):
    """One CLI invocation with its log captured (the per-run loggers write
    to stdout): returns (main's result, the log text, seconds). When main
    raises or exits, prints the log's tail and re-raises."""
    import contextlib
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            result = main_fn(argv)
    except BaseException:  # SystemExit included: the phase fails
        print(buf.getvalue()[-6000:], flush=True)
        raise
    with open(log_path, "w") as f:
        f.write(buf.getvalue())
    return result, buf.getvalue(), time.time() - t0


# (epoch, window flag) rows of sweep runs 1, 2 and 3 at 3 epochs
_FORK_FLAGS = ([("1", "True"), ("2", "False"), ("3", "False")],
               [("2", "True"), ("3", "False")], [("3", "True")])


def _rows_within(got: dict, want: dict, what: str) -> dict:
    """Hold CSV rows {key: rows} against others: the same epochs and flags,
    losses within SWEEP_LOSS_TOL and rho within SWEEP_RHO_TOL. Returns the
    largest relative loss and absolute rho differences."""
    worst = {"loss": 0.0, "rho": 0.0}
    for key in want:
        if len(got[key]) != len(want[key]):
            fail(f"{what} {key}: {len(got[key])} rows, want "
                 f"{len(want[key])}")
        for a, b in zip(got[key][1:], want[key][1:]):
            if a[0] != b[0] or a[5:] != b[5:]:
                fail(f"{what} {key}: epochs or flags differ: {a} vs {b}")
            for i in (1, 2):
                d = abs(float(a[i]) - float(b[i]))
                worst["loss"] = max(worst["loss"], d / abs(float(b[i])))
                if d > SWEEP_LOSS_TOL[0] * abs(float(b[i])) + \
                        SWEEP_LOSS_TOL[1]:
                    fail(f"{what} {key}: row differs: {a} vs {b}")
            d = abs(float(a[3]) - float(b[3]))
            worst["rho"] = max(worst["rho"], d)
            if d > SWEEP_RHO_TOL:
                fail(f"{what} {key}: rho differs: {a} vs {b}")
    return worst


def _solo_lengths(lengths_cli, fork, root, logs, onset, length):
    """One solo `cli.lengths` condition random_target_e{onset}_l{length}
    from the cache: (rows, its DoRA files, log text, seconds)."""
    out = os.path.join(root, "lengths")
    cond = f"random_target_e{onset}_l{length}"
    _, text, sec = _cli(lengths_cli.main, fork + [
        "--perturb_type", "random_target", "--perturb_epoch", str(onset),
        "--perturb_length", str(length), "--output_dir", cond,
        "--output_base_directory", out, "--frozen_cache"],
        os.path.join(logs, f"{cond}.log"))
    return (_read_rows(os.path.join(out, cond, "training_res.csv")),
            sorted(os.listdir(os.path.join(out, cond,
                                           f"dora_params_{onset}"))),
            text, sec)


_CLIP_FIXTURE: dict = {}


def _clip_fixture(tmp: str) -> dict:
    """THINGS at its real size on disk and seeded random ViT-L/14 weights,
    written once and shared by phases clip_dist and sweep: the weights in
    OpenAI's layout (loaded back the way the CLIs load them), rank-32 DoRA
    from SWEEP_SEED, a trainer on them, 1,806 + 48 JPEGs whose targets are
    the initial model's predictions, the CSVs and the RDM, and the CLIs'
    data flags."""
    if _CLIP_FIXTURE:
        return _CLIP_FIXTURE
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.data.spose66 import classnames66
    from vit_project_torch.models import clip as vclip
    from vit_project_torch.models import convert as vconvert
    from vit_project_torch.models import tokenizer as vtok
    from vit_project_torch.train import clip_loop

    t0 = time.time()
    root = os.path.join(tmp, "clip_things")
    os.makedirs(root)
    cfg = vclip.CLIP_VIT_L14
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = vclip.init_clip_weights_(vclip.empty_clip(cfg, "cuda"), gen)
    wpath = os.path.join(root, "ViT-L-14-random.pt")
    torch.save({k: v.half().cpu() for k, v in model.state_dict().items()},
               wpath)
    model = vconvert.clip_from_state_dict(
        vconvert.load_torch_state_dict(wpath), "cuda")
    spec = adora.dora_spec(cfg.visual.layers, cfg.text.layers, 2, 1)
    init_tr, static, acfg = adora.apply_dora(
        model, spec, r=32, alpha=16, dropout=0.1,
        generator=torch.Generator(device="cuda").manual_seed(
            SWEEP_SEED + 123))
    prompts = np.minimum(vtok.tokenize(classnames66, context_length=77,
                                       truncate=True),
                         cfg.text.vocab_size - 1)
    trainer = clip_loop.ClipHBATrainer(cfg, model, acfg, static, prompts,
                                       lr=3e-4, compute_dtype=torch.bfloat16)
    img_dir, names, pixels = _write_things(root, np.random.RandomState(SEED))
    all_dev, _ = trainer.upload_dataset(pixels)
    preds = trainer.infer_in_chunks(adora.make_trainable(init_tr, "cuda"),
                                    all_dev, len(names))
    del all_dev
    data = _write_things_csvs(root, names, preds)
    _CLIP_FIXTURE.update(
        cfg=cfg, model=model, init_tr=init_tr, trainer=trainer,
        pixels=pixels, preds=preds, wpath=wpath, names=names,
        img_dir=img_dir,
        spread=float(preds.std(axis=0).mean()), seconds=time.time() - t0,
        model_args=["--clip_weights", wpath, "--allow_hash_tokenizer",
                    "--batch_size", "64", "--random_seed", str(SWEEP_SEED)])
    _CLIP_FIXTURE["common"] = [
        "--csv_file", data["csv_file"], "--img_dir", img_dir,
        "--inference_csv_file", data["inference_csv_file"],
        "--RDM48_triplet_dir", data["RDM48_triplet_dir"],
        *_CLIP_FIXTURE["model_args"]]
    print(f"[things] THINGS-sized fixture on disk (1,806 train / 48 "
          f"inference JPEGs at 224^2; targets = the initial model's "
          f"predictions, mean across-image std {_CLIP_FIXTURE['spread']:.3f})"
          f" and ViT-L/14 weights written in {_CLIP_FIXTURE['seconds']:.1f} "
          f"s", flush=True)
    return _CLIP_FIXTURE


def phase_sweep(tmp: str):
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.cli import baseline as baseline_cli
    from vit_project_torch.cli import lengths as lengths_cli
    from vit_project_torch.cli import sweep as sweep_cli
    from vit_project_torch.core.prng import Key
    from vit_project_torch.data import things as dthings
    from vit_project_torch.ops import attention as vattn

    t_phase = time.time()
    root = os.path.join(tmp, "sweep")
    logs = os.path.join(root, "logs")
    os.makedirs(logs)
    fx = _clip_fixture(tmp)
    trainer, init_tr, pixels, preds = (fx["trainer"], fx["init_tr"],
                                       fx["pixels"], fx["preds"])
    spread = fx["spread"]

    common = fx["common"] + ["--epochs", "3"]
    runs = []   # (label, log text, seconds)

    def launches():
        return {k: vattn.LAUNCHES[k] for k in ("flash3_fwd", "flash3_bwd")}

    # --- the main path: counts from 0, the CLIs, counts read ---
    torch.cuda.reset_peak_memory_stats()
    vattn.reset_launch_counts()
    base_out = os.path.join(root, "baseline")
    _, text, sec = _cli(baseline_cli.main, common + [
        "--output_dir", base_out], os.path.join(logs, "baseline.log"))
    runs.append(("baseline", text, sec))
    stamp = sorted(n for n in os.listdir(base_out)
                   if n.startswith("dora_params_"))[0][len("dora_params_"):]
    base_rows = _read_rows(os.path.join(base_out,
                                        f"training_res_{stamp}.csv"))
    rs_dir = os.path.join(base_out, f"random_states_{stamp}")
    fork = common + [
        "--baseline_dora_directory",
        os.path.join(base_out, f"dora_params_{stamp}"),
        "--baseline_random_state_path", rs_dir,
        "--baseline_split_indices_path",
        os.path.join(rs_dir, "dataset_split_indices.pth"),
        "--perturb_seed", "42"]

    def sweep(label, kind, order, *extra):
        out = os.path.join(root, label)
        failed, text, sec = _cli(sweep_cli.main, fork + [
            "--perturb_type", kind, "--training_order", order,
            "--output_base_directory", out, *extra],
            os.path.join(logs, f"{label}.log"))
        if failed:
            print(text[-6000:], flush=True)
            fail(f"sweep {label}: runs {failed} failed")
        runs.append((label, text, sec))
        return {int(r): _read_rows(os.path.join(
            out, f"training_run{r}", f"training_res_run{r}.csv"))
            for r in order.split(",")}

    rows = {k: sweep(f"sweep_{k}", k, "1,2,3", "--frozen_cache")
            for k in SWEEP_KINDS}
    full_rows = sweep("sweep_random_target_full", "random_target", "1,2,3")
    again = sweep("sweep_random_target_again", "random_target", "2",
                  "--frozen_cache")

    def lengths(length):
        rows, ckpts, text, sec = _solo_lengths(lengths_cli, fork, root,
                                               logs, 2, length)
        runs.append((f"random_target_e2_l{length}", text, sec))
        return rows, ckpts
    l1, _ = lengths(1)
    l2, l2_ckpts = lengths(2)
    torch.cuda.synchronize()
    path_launches = launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    path_s = sum(sec for _, _, sec in runs)

    # --- the CSVs ---
    flags = {k: 5 + i for i, k in enumerate(SWEEP_KINDS)}
    if [r[0] for r in base_rows[1:]] != ["1", "2", "3"] or any(
            r[5:] != ["False"] * 4 for r in base_rows[1:]):
        fail(f"baseline rows {base_rows}")
    for kind, by_run in list(rows.items()) + [("random_target", full_rows)]:
        f = flags[kind]
        got = tuple([(r[0], r[f]) for r in by_run[run][1:]]
                    for run in (1, 2, 3))
        if got != _FORK_FLAGS:
            fail(f"{kind} fork rows/flags {got}")
        for r in by_run[1][1:] + by_run[2][1:] + by_run[3][1:]:
            v = [float(x) for x in r[1:5]]
            if not all(np.isfinite(v)) or abs(v[2]) > 1:
                fail(f"bad {kind} row {r}")
    raised = {k: (float(rows[k][2][1][1]), float(base_rows[2][1]))
              for k in SWEEP_KINDS}
    print("[sweep] epoch-2 train loss, perturbed fork vs baseline: "
          + "; ".join(f"{k} {a:.4f} vs {b:.4f}"
                      for k, (a, b) in raised.items()), flush=True)
    for k in TARGET_KINDS:
        if not raised[k][0] > raised[k][1]:
            fail(f"{k} did not raise the perturbed epoch's train loss: "
                 f"{raised[k]}")
    if again[2] != rows["random_target"][2]:
        fail(f"a repeated fork wrote other rows: {again[2]} vs "
             f"{rows['random_target'][2]}")
    worst = _rows_within(rows["random_target"], full_rows,
                         "cached vs full-tower")
    if [r[0] for r in l1[1:]] != ["2", "3"] or l2[1] != l1[1] or \
            [r[0] for r in l2[1:]] != ["2", "3"] or l2[2][5] != "True" or \
            l2_ckpts != ["epoch3_dora_params.pth"]:
        fail(f"lengths e2_l2 did not resume from e2_l1: {l1} / {l2} / "
             f"{l2_ckpts}")
    print(f"[sweep] rows and flags right for the baseline, 5 sweeps x runs "
          f"1,2,3 and lengths e2_l1 -> e2_l2 (cross-resumed at epoch 2); a "
          f"repeated fork wrote equal rows; cached vs full tower "
          f"(random_target): max relative loss difference "
          f"{worst['loss']:.2e}, rho {worst['rho']:.2e} (tolerance "
          f"{SWEEP_LOSS_TOL[0]} relative + {SWEEP_LOSS_TOL[1]}, rho "
          f"{SWEEP_RHO_TOL})", flush=True)

    # --- the CLIs' own logs: epochs, training seconds, cache builds ---
    train_idx, _ = dthings.random_split_indices(1806, 0.8, SWEEP_SEED)
    n_train = len(train_idx)
    steps_per_epoch = -(-n_train // 64)
    epochs = {label: [n_train / float(m.group(2))
                      for m in _EPOCH_LINE.finditer(text)]
              for label, text, _ in runs}
    steps = steps_per_epoch * sum(len(v) for v in epochs.values())
    cache_s = [float(m.group(1)) for _, text, _ in runs
               for m in _CACHE_LINE.finditer(text)]
    if path_launches["flash3_bwd"] != steps:
        fail(f"flash3_bwd launched {path_launches['flash3_bwd']} times over "
             f"{steps} steps, expected once per step")
    if path_launches["flash3_fwd"] == 0:
        fail("flash3_fwd was not launched by the sweep path")
    train_s = {"full": statistics.median(epochs["sweep_random_target_full"]),
               "cached": statistics.median(epochs["sweep_random_target"])}
    print(f"[sweep] {len(runs)} CLI invocations, {steps} steps in "
          f"{path_s:.1f} s; launches flash3_bwd {path_launches['flash3_bwd']}"
          f" (one per step), flash3_fwd {path_launches['flash3_fwd']}; "
          f"training seconds an epoch (the CLI's images_per_sec): full tower "
          f"{train_s['full']:.3f}, cached {train_s['cached']:.3f}; prefix "
          f"cache builds {statistics.median(cache_s):.2f} s (median of "
          f"{len(cache_s)}); invocations "
          + ", ".join(f"{label} {sec:.1f} s" for label, _, sec in runs)
          + f"; peak device memory {peak_gib:.2f} GiB", flush=True)

    # --- a step on each path, outside the counted run: launches and time ---
    tr = adora.make_trainable(init_tr, "cuda")
    opt = trainer.init_optimizer(tr)
    imgs_dev, tgts_dev = trainer.upload_dataset(pixels[train_idx],
                                                preds[train_idx])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = trainer.build_prefix_cache(imgs_dev)
    trainer.text_prefix_cache  # noqa: B018  (built once, timed here)
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t0

    def step(k, cached):
        idx = np.arange(64) + (k % steps_per_epoch) * 64
        idx = idx[idx < n_train]
        return trainer.train_step(tr, opt, cache if cached else imgs_dev,
                                  tgts_dev, idx, Key((SWEEP_SEED, 0, k)),
                                  cached=cached)

    per_step = {}
    for label, cached, remat in (("full", False, False),
                                 ("cached", True, False),
                                 ("full_remat", False, True),
                                 ("cached_remat", True, True)):
        trainer.remat = remat
        step(0, cached)
        torch.cuda.synchronize()
        vattn.reset_launch_counts()
        step(1, cached)
        per_step[label] = launches()
    trainer.remat = False
    want = {"full": {"flash3_fwd": 36, "flash3_bwd": 1},
            "cached": {"flash3_fwd": 3, "flash3_bwd": 1},
            "full_remat": {"flash3_fwd": 39, "flash3_bwd": 1},
            "cached_remat": {"flash3_fwd": 6, "flash3_bwd": 1}}
    if per_step != want:
        fail(f"launches a step {per_step}, expected {want}")
    times = {"full": [], "cached": []}
    for label in ("full", "cached", "cached", "full"):   # in turns
        for k in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(k, label == "cached")
            times[label].append((time.perf_counter() - t0) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"[sweep] launches a step (flash3_fwd, flash3_bwd): full tower "
          f"36, 1; cached 3, 1; with remat 39, 1 and 6, 1 (one more forward "
          f"for each of the 3 adapted blocks)", flush=True)
    print(f"[sweep] a step, median of 20 in turns: full tower "
          f"{step_ms['full']:.2f} ms, cached {step_ms['cached']:.2f} ms "
          f"({step_ms['full'] / step_ms['cached']:.2f}x); prefix cache of "
          f"{n_train} images + the text prefix built in {prefix_s:.2f} s "
          f"({cache.numel() * cache.element_size() / 2**30:.2f} GiB bf16); "
          f"phase {time.time() - t_phase:.1f} s; {smi_line()}", flush=True)
    RESULTS["sweep"] = {
        "launches": path_launches, "steps": steps,
        "launches_per_step": per_step, "step_ms": step_ms,
        "step_ms_all": times, "prefix_build_s": prefix_s,
        "cli_prefix_build_s": cache_s, "epoch_train_s": epochs,
        "invocations_s": {label: sec for label, _, sec in runs},
        "peak_mem_gib": peak_gib, "cached_vs_full": worst,
        "perturbed_vs_baseline_train_loss": raised,
        "teacher_spread": spread, "phase_s": time.time() - t_phase}
    # what phase `forks` reuses: the fixture, the solo rows it is held
    # against, the trainer and the resident training set
    ctx = {"root": root, "logs": logs, "fork": fork, "rows": rows,
           "full_rows": full_rows, "l1": l1, "l2": l2, "runs": runs,
           "trainer": trainer, "init_tr": init_tr, "imgs_dev": imgs_dev,
           "tgts_dev": tgts_dev, "cache": cache, "n_train": n_train,
           "steps_per_epoch": steps_per_epoch}
    del tr, opt
    return path_launches, ctx


_GROUP_LINE = re.compile(r"Group \d+/\d+ .* completed \((\d+) lock-steps")
_CACHES_LINE = re.compile(r"Frozen-prefix caches built in ([\d.]+)s")
FORK_GROUP = 3            # --batched_forks of the phase's sweeps
FORK_TIMING_R = (1, 2, 4, 8)


def phase_forks(ctx):
    """Batched forks (train/multi_fork.py) through the CLIs' main on phase
    sweep's fixture, held against that phase's solo rows."""
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.cli import lengths as lengths_cli
    from vit_project_torch.cli import sweep as sweep_cli
    from vit_project_torch.core.prng import Key
    from vit_project_torch.ops import attention as vattn

    t_phase = time.time()
    root, logs, fork = ctx["root"], ctx["logs"], ctx["fork"]
    trainer, n_train = ctx["trainer"], ctx["n_train"]
    steps_per_epoch = ctx["steps_per_epoch"]
    runs = []   # (label, log text, seconds, flash3_bwd launches)

    def launches():
        return {k: vattn.LAUNCHES[k] for k in ("flash3_fwd", "flash3_bwd")}

    def batched_sweep(label, kind, *extra):
        out = os.path.join(root, label)
        bwd0 = vattn.LAUNCHES["flash3_bwd"]
        failed, text, sec = _cli(sweep_cli.main, fork + [
            "--perturb_type", kind, "--training_order", "1,2,3",
            "--batched_forks", str(FORK_GROUP),
            "--output_base_directory", out, *extra],
            os.path.join(logs, f"{label}.log"))
        if failed:
            print(text[-6000:], flush=True)
            fail(f"batched sweep {label}: runs {failed} failed")
        runs.append((label, text, sec, vattn.LAUNCHES["flash3_bwd"] - bwd0))
        return out, {r: _read_rows(os.path.join(
            out, f"training_run{r}", f"training_res_run{r}.csv"))
            for r in (1, 2, 3)}

    def batched_lengths(length, label):
        out = os.path.join(root, "lengths_batched")
        bwd0 = vattn.LAUNCHES["flash3_bwd"]
        failed, text, sec = _cli(lengths_cli.main, fork + [
            "--perturb_type", "random_target", "--onsets", "1,2",
            "--perturb_length", str(length), "--output_base_directory", out,
            "--frozen_cache"], os.path.join(logs, f"{label}.log"))
        if failed:
            print(text[-6000:], flush=True)
            fail(f"batched lengths {label}: {failed} failed")
        runs.append((label, text, sec, vattn.LAUNCHES["flash3_bwd"] - bwd0))
        return {e: _read_rows(os.path.join(
            out, f"random_target_e{e}_l{length}", "training_res.csv"))
            for e in (1, 2)}

    # the solo references at onset 1 (phase sweep ran onset 2)
    solo_len = {1: {2: ctx["l1"]}, 2: {2: ctx["l2"]}}
    for length in (1, 2):
        solo_len[length][1], *_ = _solo_lengths(lengths_cli, fork, root,
                                                logs, 1, length)

    # --- the main path: counts from 0, the CLIs, counts read ---
    vattn.reset_launch_counts()
    rows, outs = {}, {}
    for k in SWEEP_KINDS:
        outs[k], rows[k] = batched_sweep(f"forks_{k}", k, "--frozen_cache")
    _, full_rows = batched_sweep("forks_random_target_full", "random_target")
    outs["plain"], _ = batched_sweep("forks_random_target_no_prefetch",
                                     "random_target", "--frozen_cache",
                                     "--no-host_prefetch")
    b_len = {length: batched_lengths(length, f"lengths_l{length}")
             for length in (1, 2)}
    again = batched_lengths(2, "lengths_l2_again")
    torch.cuda.synchronize()
    path_launches = launches()
    path_s = sum(r[2] for r in runs)

    # --- rows against the solo rows ---
    worst = {k: _rows_within(rows[k], ctx["rows"][k], f"batched {k}")
             for k in SWEEP_KINDS}
    worst["random_target_full"] = _rows_within(
        full_rows, ctx["full_rows"], "batched random_target full tower")
    for length in (1, 2):
        worst[f"lengths_l{length}"] = _rows_within(
            b_len[length], solo_len[length], f"batched lengths l{length}")
    if b_len[2][2][1] != b_len[1][2][1] or again != b_len[2]:
        fail(f"batched lengths l2 did not cross-resume from l1, or a repeat "
             f"added rows: {b_len} / {again}")
    for k in SWEEP_KINDS:
        f = 5 + SWEEP_KINDS.index(k)
        got = tuple([(r[0], r[f]) for r in rows[k][run][1:]]
                    for run in (1, 2, 3))
        if got != _FORK_FLAGS:
            fail(f"batched {k} rows/flags {got}")
    fallback = [label for label, text, *_ in runs
                if "batched groups run the full tower" in text]
    if fallback != [f"forks_{k}" for k in SWEEP_KINDS
                    if k not in TARGET_KINDS]:
        fail(f"image kinds under --frozen_cache did not fall back to the "
             f"full tower: {fallback}")
    ckpt_equal = 0
    for d, _, names in os.walk(outs["random_target"]):
        for n in names:
            if not n.endswith(".pth"):
                continue
            rel = os.path.relpath(os.path.join(d, n), outs["random_target"])
            with open(os.path.join(d, n), "rb") as a, \
                    open(os.path.join(outs["plain"], rel), "rb") as b:
                if a.read() != b.read():
                    fail(f"{rel} differs with --no-host_prefetch")
            ckpt_equal += 1
    print(f"[forks] batched sweeps of runs 1,2,3 in groups of {FORK_GROUP} "
          f"(4 kinds from the cache, image kinds falling back to the full "
          f"tower; random_target on the full tower) and batched lengths "
          f"onsets 1,2 l1 -> l2 (cross-resumed; a repeat added no row) "
          f"against the solo rows: max relative loss difference "
          f"{max(w['loss'] for w in worst.values()):.2e}, rho "
          f"{max(w['rho'] for w in worst.values()):.2e} (tolerance "
          f"{SWEEP_LOSS_TOL[0]} relative + {SWEEP_LOSS_TOL[1]}, rho "
          f"{SWEEP_RHO_TOL}); {ckpt_equal} checkpoint files byte-equal with "
          f"--no-host_prefetch", flush=True)

    # --- launches over each invocation: one flash3_bwd a lock-step batch ---
    lock_steps = {}
    for label, text, _, bwd in runs:
        n = sum(int(m.group(1)) for m in _GROUP_LINE.finditer(text))
        lock_steps[label] = n
        if bwd != n * steps_per_epoch:
            fail(f"{label}: flash3_bwd launched {bwd} times over {n} "
                 f"lock-steps of {steps_per_epoch} batches")
    print(f"[forks] flash3_bwd over each invocation = its lock-steps x "
          f"{steps_per_epoch} batches (" + ", ".join(
              f"{label} {bwd} = {lock_steps[label]} x {steps_per_epoch}"
              for label, _, _, bwd in runs) + f"); main path flash3_fwd "
          f"{path_launches['flash3_fwd']}, flash3_bwd "
          f"{path_launches['flash3_bwd']}", flush=True)

    # --- one lock-step batch at R forks, outside the counted run ---
    src = {"full": ctx["imgs_dev"], "cached": ctx["cache"]}
    rs = np.random.RandomState(SEED)
    order = rs.permutation(n_train)

    def lock_step(R, label, k=0):
        trs = forks_state[R]
        idxs = [order[(64 * (f + k)) % (n_train - 64):][:64]
                for f in range(R)]
        return trainer.train_step_forks(
            trs[0], trs[1], src[label], ctx["tgts_dev"], idxs,
            [Key((SWEEP_SEED, 0, k, f)) for f in range(R)],
            cached=label == "cached")

    forks_state = {}
    for R in sorted(set(FORK_TIMING_R) | {1, 2, 3}):
        trs = [adora.make_trainable(ctx["init_tr"], "cuda") for _ in range(R)]
        forks_state[R] = (trs, [trainer.init_optimizer(t) for t in trs])
    per_r = {}
    for R in (1, 2, 3):
        for label in ("full", "cached"):
            lock_step(R, label)
            torch.cuda.synchronize()
            vattn.reset_launch_counts()
            losses, oks = lock_step(R, label, 1)
            per_r[f"{label}_R{R}"] = launches()
            if not all(oks) or not all(np.isfinite(losses)):
                fail(f"lock-step at R={R} {label}: {losses} {oks}")
    want = {f"{label}_R{R}": {"flash3_fwd": 36 if label == "full" else 3,
                              "flash3_bwd": 1}
            for R in (1, 2, 3) for label in ("full", "cached")}
    if per_r != want:
        fail(f"launches a lock-step {per_r}, expected {want}")
    print(f"[forks] launches a lock-step batch (flash3_fwd, flash3_bwd) at "
          f"R = 1, 2, 3: full tower 36, 1; cached 3, 1", flush=True)

    # the solo step (R = "solo") in the same turns, as the yardstick
    solo_tr = adora.make_trainable(ctx["init_tr"], "cuda")
    solo_opt = trainer.init_optimizer(solo_tr)

    def solo_step(label, k):
        return trainer.train_step(solo_tr, solo_opt, src[label],
                                  ctx["tgts_dev"], order[64 * k:][:64],
                                  Key((SWEEP_SEED, 0, k)),
                                  cached=label == "cached")

    sizes = ("solo",) + FORK_TIMING_R
    times = {(label, R): [] for label in ("full", "cached") for R in sizes}
    peak = {}
    for turn in ("full", "cached", "cached", "full"):   # in turns
        for R in sizes:
            if R == max(FORK_TIMING_R):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            for k in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if R == "solo":
                    solo_step(turn, k)
                else:
                    lock_step(R, turn, k)
                times[(turn, R)].append((time.perf_counter() - t0) * 1e3)
            if R == max(FORK_TIMING_R):
                peak[turn] = max(peak.get(turn, 0.0),
                                 torch.cuda.max_memory_allocated() / 2**30)
    step_ms = {f"{label}_R{R}": statistics.median(v)
               for (label, R), v in times.items()}
    for label in ("full", "cached"):
        solo = times[(label, "solo")]
        print(f"[forks] a lock-step batch, {label}, median of 10 in turns "
              f"(ms a lock-step; ms a fork-step; min-max): solo step "
              f"{step_ms[f'{label}_Rsolo']:.2f}; {min(solo):.2f}-"
              f"{max(solo):.2f}; " + "; ".join(
                  f"R={R} {step_ms[f'{label}_R{R}']:.2f}; "
                  f"{step_ms[f'{label}_R{R}'] / R:.2f}; "
                  f"{min(times[(label, R)]):.2f}-{max(times[(label, R)]):.2f}"
                  for R in FORK_TIMING_R)
              + f"; peak device memory at R={max(FORK_TIMING_R)} "
              f"{peak[label]:.2f} GiB", flush=True)
    seq = {k: next(sec for label, _, sec in ctx["runs"]
                   if label == f"sweep_{k}") for k in SWEEP_KINDS}
    seq["random_target_full"] = next(
        sec for label, _, sec in ctx["runs"]
        if label == "sweep_random_target_full")
    bat = {label[len("forks_"):]: sec for label, _, sec, _ in runs
           if label.startswith("forks_")}
    caches = [float(m.group(1)) for _, text, *_ in runs
              for m in _CACHES_LINE.finditer(text)]
    print(f"[forks] invocation seconds, runs 1,2,3 batched vs sequential: "
          + "; ".join(f"{k} {bat[k]:.1f} vs {seq[k]:.1f}" for k in seq)
          + f"; prefix caches built in {statistics.median(caches):.2f} s "
          f"(median of {len(caches)}); lengths l1 {runs[-3][2]:.1f} s, l2 "
          f"{runs[-2][2]:.1f} s, repeat {runs[-1][2]:.1f} s; phase "
          f"{time.time() - t_phase:.1f} s; {smi_line()}", flush=True)
    RESULTS["forks"] = {
        "launches": path_launches, "lock_steps": lock_steps,
        "launches_per_lock_step": per_r, "lock_step_ms": step_ms,
        "lock_step_ms_all": {f"{a}_R{b}": v for (a, b), v in times.items()},
        "peak_mem_gib_R8": peak, "invocation_s_batched": bat,
        "invocation_s_sequential": seq, "prefix_build_s": caches,
        "invocations_s": {r[0]: r[2] for r in runs},
        "batched_vs_solo": worst, "ckpt_files_equal": ckpt_equal,
        "path_s": path_s, "phase_s": time.time() - t_phase}
    del forks_state
    return path_launches


# the vit_grid phase: the grid's CSV columns (the JAX package's
# core/csvio.MEASURE_HEADERS, which tests/test_torch_vit_grid.py ties to
# the port's), its perturbation types, and the launches of one cell
MEASURE_COLUMNS = ["perturb_epoch", "perturbation_type", "baseline_loss",
                   "baseline_rsa", "perturbed_loss", "perturbed_rsa",
                   "delta_loss", "delta_rsa"]
GRID_TYPES = ("gaussian", "uniform_gray", "label_shuffle", "target_noise")
GRID_BATCH = 256
# one cell at the smoke's ImageFolder (1,024 train, 256 val, drop_last): 4
# steps of 12 blocks forward and backward, 1 validation batch, 48 THINGS
# images in 6 chunks of 8
GRID_STEPS, GRID_VAL_BATCHES, GRID_RSA_CHUNKS = 4, 1, 6
GRID_CELL_LAUNCHES = {
    "flash3_fwd": 12 * (GRID_STEPS + GRID_VAL_BATCHES + GRID_RSA_CHUNKS),
    "flash3_bwd": 12 * GRID_STEPS}
# the replay of epoch 1 against the baseline's row: bf16 on the card, the
# same arithmetic as the baseline's epoch when the decode and every kernel
# repeat their bits (then both differences are 0)
REPLAY_LOSS_RTOL = 1e-4
REPLAY_RHO_ATOL = 1e-3
# compute_rsa_score's CLS embeddings on the kernel path against the plain
# attention path, on the card in bf16: max |difference| over the largest
# |value| of the plain embeddings. The two attentions round o to bf16 from
# f32 sums in another order, one bf16 spacing (2^-8 relative) at most per
# element and block; through 12 blocks that stays a few spacings
GRID_EMB_KERNEL_RTOL = 2e-2
# and their rho, absolute: embeddings a few bf16 spacings apart reorder
# only near-tied pairs of the 1,128 in the RDM, which moves a Spearman rho
# by far less than this (a wrong kernel gives unrelated embeddings)
GRID_RHO_KERNEL_TOL = 1e-3
_CELL_LINE = re.compile(r"Cell seconds: load=([\d.]+) epoch=([\d.]+) "
                        r"validation=([\d.]+) rsa=([\d.]+)")
_IPS_LINE = re.compile(r"Epoch (\d+) training completed .*images_per_sec="
                       r"([\d.]+)\]")


def _loaded_jpeg_lib() -> str:
    """The libjpeg this process mapped (the native decoder's)."""
    with open("/proc/self/maps") as f:
        libs = {line.split()[-1] for line in f if "libjpeg" in line}
    return ", ".join(sorted(libs)) or "none"


def phase_vit_grid(tmp: str):
    """The measurement grid through the CLIs' main: a packed ImageFolder,
    a 2-epoch ViT-B/16 baseline with the native decoder, the per-epoch RSA
    and one perturb epoch of the four types; then the replay, determinism
    and kernel-vs-plain checks and the grid's numbers."""
    import logging
    import pandas as pd
    import scipy.io
    import torch
    from vit_project_torch.cli import vit_measure as measure_cli
    from vit_project_torch.cli import vit_rsa_eval as rsa_cli
    from vit_project_torch.cli import vit_train as train_cli
    from vit_project_torch.ckpt import vit_ckpt
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.data import fastimage
    from vit_project_torch.data.packed import make_loader
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.perturb import injectors
    from vit_project_torch.train import vit_loop

    t_phase = time.time()
    root = os.path.join(tmp, "vit_grid")
    logs = os.path.join(root, "logs")
    os.makedirs(logs)
    if not fastimage.available() or not fastimage.mem_available():
        fail("the native decoder (native/libfastimage.so) does not load")
    print(f"[vit_grid] native decoder loaded; libjpeg: {_loaded_jpeg_lib()}",
          flush=True)
    folder = os.path.join(root, "imagenet")
    _write_image_folder(folder, np.random.RandomState(SEED))
    rs = np.random.RandomState(SEED + 1)
    img_dir, names, _ = _write_things(root, rs, n_train=0)
    things = _write_things_csvs(root, names, rs.randn(len(names), 66),
                                n_train=0)
    packed = os.path.join(root, "packed")
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "vit_project_torch.cli.pack",
                    "--src", folder, "--out", packed], cwd=ROOT, check=True,
                   capture_output=True, text=True)
    pack_s = time.time() - t0
    print(f"[vit_grid] fixture written in {t0 - t_phase:.1f} s (8 classes, "
          f"1,024 train / 256 val JPEGs at 256^2; 48 THINGS JPEGs and an "
          f"RDM); `cli.pack` {pack_s:.2f} s for both splits", flush=True)
    things_args = ["--things_csv", things["inference_csv_file"],
                   "--things_img_dir", img_dir,
                   "--things_rdm_path", things["RDM48_triplet_dir"]]

    def counts():
        return {**vattn.LAUNCHES, **vfdw.LAUNCHES}

    def reset():
        vattn.reset_launch_counts()
        vfdw.reset_launch_counts()

    # --- the main path: cli.vit_train, cli.vit_rsa_eval, cli.vit_measure,
    # each with the counts set to 0 just before it and read just after ---
    base = os.path.join(root, "baseline")
    train_argv = ["--data_path", packed, "--batch_size", str(GRID_BATCH),
                  "--epochs", "2", "--num_workers", "8"]
    reset()
    _, train_log, train_s = _cli(
        train_cli.main, train_argv + ["--output_dir", base,
                                      "--use_native_loader"],
        os.path.join(logs, "vit_train.log"))
    train_launches = counts()
    steps = 2 * GRID_STEPS
    want = {"flash3_fwd": 12 * (steps + 2 * GRID_VAL_BATCHES),
            "flash3_bwd": 12 * steps, "dw_db": 0}
    if any(train_launches[k] != v for k, v in want.items()):
        fail(f"cli.vit_train launched {train_launches}, expected {want}")
    ips = {"native": float(_IPS_LINE.findall(train_log)[-1][1])}
    _, pil_log, pil_s = _cli(
        train_cli.main, train_argv + ["--output_dir",
                                      os.path.join(root, "baseline_pil")],
        os.path.join(logs, "vit_train_pil.log"))
    ips["pil"] = float(_IPS_LINE.findall(pil_log)[-1][1])
    print(f"[vit_grid] cli.vit_train 2 epochs, packed tree, "
          f"--use_native_loader: {train_s:.1f} s, launches flash3_fwd "
          f"{train_launches['flash3_fwd']}, flash3_bwd "
          f"{train_launches['flash3_bwd']}, dw_db {train_launches['dw_db']}; "
          f"epoch-2 training images/s: native decode {ips['native']:.1f}, "
          f"PIL decode {ips['pil']:.1f} (the same run with PIL: "
          f"{pil_s:.1f} s)", flush=True)

    rsa_csv = os.path.join(root, "rsa_results.csv")
    reset()
    rsa_df, _, rsa_s = _cli(
        rsa_cli.main, ["--checkpoint_dir", base, "--output_csv", rsa_csv,
                       *things_args], os.path.join(logs, "vit_rsa_eval.log"))
    rsa_launches = counts()
    want = {"flash3_fwd": 2 * 12 * GRID_RSA_CHUNKS, "flash3_bwd": 0,
            "dw_db": 0}
    if any(rsa_launches[k] != v for k, v in want.items()):
        fail(f"cli.vit_rsa_eval launched {rsa_launches}, expected {want}")
    if list(pd.read_csv(rsa_csv).columns) != [
            "checkpoint", "epoch", "train_loss", "val_loss", "val_acc",
            "rsa_score"] or list(rsa_df["epoch"]) != [0, 1] \
            or not np.isfinite(rsa_df[["train_loss", "val_loss", "val_acc",
                                       "rsa_score"]].to_numpy()).all():
        fail(f"bad rsa_results.csv:\n{rsa_df}")
    print(f"[vit_grid] cli.vit_rsa_eval over 2 checkpoints: {rsa_s:.1f} s, "
          f"flash3_fwd {rsa_launches['flash3_fwd']}; rsa_score "
          + ", ".join(f"{r:.4f}" for r in rsa_df["rsa_score"]), flush=True)

    effects = os.path.join(root, "perturbation_effects.csv")
    measure_argv = ["--baseline_checkpoint_dir", base,
                    "--baseline_metrics_csv", rsa_csv, "--data_path", packed,
                    "--output_csv", effects, *things_args,
                    "--perturb_epochs", "1", "--batch_size", str(GRID_BATCH),
                    "--use_native_loader"]
    reset()
    results, measure_log, measure_s = _cli(
        measure_cli.main, measure_argv, os.path.join(logs, "vit_measure.log"))
    grid_launches = counts()
    want = {k: len(GRID_TYPES) * v for k, v in GRID_CELL_LAUNCHES.items()}
    want["dw_db"] = 0
    print(f"[vit_grid] cli.vit_measure, perturb epoch 1 x "
          f"{len(GRID_TYPES)} types: {measure_s:.1f} s; launches flash3_fwd "
          f"{grid_launches['flash3_fwd']}, flash3_bwd "
          f"{grid_launches['flash3_bwd']} (predicted "
          f"{want['flash3_fwd']} and {want['flash3_bwd']}: "
          f"{GRID_CELL_LAUNCHES['flash3_fwd']} and "
          f"{GRID_CELL_LAUNCHES['flash3_bwd']} a cell)", flush=True)
    if any(grid_launches[k] != v for k, v in want.items()):
        fail(f"cli.vit_measure launched {grid_launches}, expected {want}")

    # --- the grid's CSVs ---
    df = pd.read_csv(effects, float_precision="round_trip")
    if list(df.columns) != MEASURE_COLUMNS:
        fail(f"perturbation_effects.csv columns {list(df.columns)}")
    if list(df["perturbation_type"]) != list(GRID_TYPES) \
            or list(df["perturb_epoch"]) != [1] * len(GRID_TYPES):
        fail(f"grid rows:\n{df}")
    if not np.isfinite(df.drop(columns="perturbation_type")
                       .to_numpy()).all():
        fail(f"non-finite grid values:\n{df}")
    for r in results:
        if r["delta_loss"] != r["perturbed_loss"] - r["baseline_loss"] or \
                r["delta_rsa"] != r["perturbed_rsa"] - r["baseline_rsa"]:
            fail(f"delta is not perturbed - baseline: {r}")
    summary = pd.read_csv(os.path.join(root,
                                       "perturbation_summary_table.csv"))
    if list(summary.columns) != ["perturb_epoch", "perturbation_type",
                                 "delta_loss", "delta_rsa", "baseline_loss",
                                 "baseline_rsa"] or len(summary) != len(df):
        fail(f"bad summary table:\n{summary}")
    cells = [dict(zip(("load_s", "epoch_s", "val_s", "rsa_s"),
                      map(float, m)))
             for m in _CELL_LINE.findall(measure_log)]
    if len(cells) != len(GRID_TYPES):
        fail(f"{len(cells)} cell timing lines in the vit_measure log")
    print("[vit_grid] rows: " + "; ".join(
        f"{r['perturbation_type']} loss {r['perturbed_loss']:.4f} "
        f"(delta {r['delta_loss']:+.4f}) rsa {r['perturbed_rsa']:.4f} "
        f"(delta {r['delta_rsa']:+.4f})" for r in results), flush=True)
    print("[vit_grid] seconds a cell (checkpoint load / perturbed epoch / "
          "validation / RSA): " + "; ".join(
              f"{t} {c['load_s']:.3f} / {c['epoch_s']:.3f} / "
              f"{c['val_s']:.3f} / {c['rsa_s']:.3f}"
              for t, c in zip(GRID_TYPES, cells)) + f"; {smi_line()}",
          flush=True)

    # --- one cell called directly: the replay, determinism, kernel vs
    # plain (the trainer and loaders as cli.vit_measure builds them) ---
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    cfg = ViTTrainConfig(data_path=packed, batch_size=GRID_BATCH,
                         num_workers=8, compute_dtype="bfloat16",
                         image_size=224, num_classes=1000)
    trainer = vit_loop.ViTTrainer(vit_cfg, cfg,
                                  vvit.empty_vit(vit_cfg, "cuda"), "cuda")
    train_loader = make_loader(os.path.join(packed, "train"), GRID_BATCH,
                               train=True, seed=0, size=224, workers=8,
                               drop_last=True, use_native=True)
    val_loader = make_loader(os.path.join(packed, "val"), GRID_BATCH,
                             train=False, size=224, workers=8,
                             use_native=True)
    _, things_u8 = measure_cli.load_things_for_vit(
        things["inference_csv_file"], img_dir, size=224)
    rdm = np.asarray(scipy.io.loadmat(things["RDM48_triplet_dir"])
                     ["RDM48_triplet"], np.float32)
    sched = dict(base_lr=0.1, warmup_epochs=5, max_epochs=2, eta_min=0.0)
    cache: dict = {}
    quiet = logging.getLogger("chip_smoke.vit_grid")
    quiet.setLevel(logging.WARNING)

    def cell(ptype):
        return measure_cli.measure_perturbation_effect(
            1, ptype, trainer, base, rsa_df, train_loader, val_loader,
            things_u8, rdm, sched, 0.1, logger=quiet, ckpt_cache=cache)
    reset()
    replay = cell(None)
    one_cell = counts()
    if {k: one_cell[k] for k in GRID_CELL_LAUNCHES} != GRID_CELL_LAUNCHES:
        fail(f"one cell launched {one_cell}, predicted {GRID_CELL_LAUNCHES}")
    row = rsa_df[rsa_df["epoch"] == 1].iloc[0]
    loss_rel = abs(replay["perturbed_loss"] - row["val_loss"]) / abs(
        row["val_loss"])
    rho_diff = abs(replay["perturbed_rsa"] - row["rsa_score"])
    loss_bits = replay["perturbed_loss"] == row["val_loss"]
    rho_bits = replay["perturbed_rsa"] == row["rsa_score"]
    print(f"[vit_grid] unperturbed replay of epoch 1 from checkpoint 0: "
          f"val_loss {replay['perturbed_loss']!r} vs the baseline's "
          f"{float(row['val_loss'])!r} "
          f"({'bit-equal' if loss_bits else 'differs'}; "
          f"relative {loss_rel:.3e}, tolerance {REPLAY_LOSS_RTOL}); rsa "
          f"{replay['perturbed_rsa']!r} vs {float(row['rsa_score'])!r} "
          f"({'bit-equal' if rho_bits else 'differs'}; {rho_diff:.3e}, "
          f"tolerance {REPLAY_RHO_ATOL}); one cell launched flash3_fwd "
          f"{one_cell['flash3_fwd']}, flash3_bwd {one_cell['flash3_bwd']}",
          flush=True)
    if not (loss_rel <= REPLAY_LOSS_RTOL and rho_diff <= REPLAY_RHO_ATOL):
        fail(f"the replay differs from the baseline's epoch-1 row: {replay} "
             f"vs {dict(row)}")
    g1, g2 = cell("gaussian"), cell("gaussian")
    print(f"[vit_grid] a gaussian cell twice: "
          f"{'equal bits' if g1 == g2 else 'DIFFERS'} (loss "
          f"{g1['perturbed_loss']!r}, rsa {g1['perturbed_rsa']!r})",
          flush=True)
    if g1 != g2:
        fail(f"a repeated gaussian cell differs: {g1} vs {g2}")

    # checkpoint 1's CLS embeddings and rho with the attention kernels and
    # with the plain attention swapped in, on the card, in
    # compute_rsa_score's chunks of 8 ([8, 197, 2304] a launch)
    vit_loop.load_trees(trainer.model, vit_ckpt.load_checkpoint(
        vit_ckpt.epoch_checkpoint(base, 1))["params"])

    def embeddings():
        return torch.cat([trainer._feature_step(torch.from_numpy(
            np.ascontiguousarray(things_u8[s:s + 8])).cuda()).float()
            for s in range(0, len(things_u8), 8)])
    reset()
    rho_kernel, _ = trainer.compute_rsa_score(things_u8, rdm)
    if counts()["flash3_fwd"] != 12 * GRID_RSA_CHUNKS:
        fail(f"compute_rsa_score launched {counts()}")
    emb_kernel = embeddings()
    swapped = vattn.flash_mha_packed_qkv
    vattn.flash_mha_packed_qkv = (
        lambda qkv, *, num_heads, causal=False:
        vattn.flash_mha_packed_qkv_reference(qkv, num_heads, causal)[0])
    try:
        rho_plain, _ = trainer.compute_rsa_score(things_u8, rdm)
        emb_plain = embeddings()
    finally:
        vattn.flash_mha_packed_qkv = swapped
    if not (torch.isfinite(emb_kernel).all() and emb_kernel.shape == (
            len(things_u8), vit_cfg.width)):
        fail(f"CLS embeddings: shape {tuple(emb_kernel.shape)} or "
             f"non-finite values")
    emb_rel = ((emb_kernel - emb_plain).abs().max()
               / emb_plain.abs().max()).item()
    print(f"[vit_grid] checkpoint 1, kernel vs plain attention (bf16): CLS "
          f"embeddings [{len(things_u8)}, {vit_cfg.width}] max relative "
          f"difference {emb_rel:.3e} (tolerance {GRID_EMB_KERNEL_RTOL}); rho "
          f"{rho_kernel:.6f} vs {rho_plain:.6f}, difference "
          f"{abs(rho_kernel - rho_plain):.3e} (tolerance "
          f"{GRID_RHO_KERNEL_TOL}); rsa_results.csv {row['rsa_score']:.6f}",
          flush=True)
    if not emb_rel <= GRID_EMB_KERNEL_RTOL:
        fail(f"CLS embeddings with the kernels differ from plain by "
             f"{emb_rel:.3e} relative")
    if not abs(rho_kernel - rho_plain) <= GRID_RHO_KERNEL_TOL:
        fail(f"rho with the kernels {rho_kernel} vs plain {rho_plain}")

    # --- numbers: a step, the decoders alone ---
    imgs_t, lbls_t = trainer.place(*next(iter(train_loader.epoch(1))))
    momentum = vit_loop.sgd_init(dict(trainer.model.named_parameters()))
    key = injectors.batch_perturb_key(42, 1, 0)

    def turn(perturb, steps=10):
        p = ("gaussian", key, 0.1) if perturb else None
        for _ in range(2):
            trainer.step(momentum, imgs_t, lbls_t, 0.02, p)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        for i in range(steps):
            trainer.step(momentum, imgs_t, lbls_t, 0.02, p)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    step_turns = {"clean": [], "gaussian": []}
    for name in ("clean", "gaussian", "gaussian", "clean"):
        step_turns[name].append(turn(name == "gaussian"))
    step_ms = {k: statistics.mean(x for t in v for x in t)
               for k, v in step_turns.items()}
    decode = {}
    for label, split_root, native in (
            ("packed native", packed, True), ("packed PIL", packed, False),
            ("folder PIL", folder, False), ("folder native", folder, True)):
        loader = make_loader(os.path.join(split_root, "train"), GRID_BATCH,
                             train=True, seed=0, size=224, workers=8,
                             drop_last=True, use_native=native)
        t0 = time.time()
        n = sum(len(b[1]) for b in loader.epoch(1))
        decode[label] = n / (time.time() - t0)
    print(f"[vit_grid] a step on a batch on the card (fused_dw off, as the "
          f"grid's CLIs run it; turns clean, gaussian, gaussian, clean, 10 "
          f"steps each): clean {step_ms['clean']:.2f} ms, gaussian "
          f"{step_ms['gaussian']:.2f} ms; host decode alone (8 threads, "
          f"RandomResizedCrop of 256^2 JPEGs, images/s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in decode.items())
          + f"; phase {time.time() - t_phase:.1f} s; {smi_line()}",
          flush=True)
    RESULTS["vit_grid"] = {
        "launches": {"vit_train": train_launches, "vit_rsa_eval": rsa_launches,
                     "vit_measure": grid_launches, "one_cell": one_cell},
        "predicted_cell_launches": GRID_CELL_LAUNCHES,
        "rows": results, "cell_seconds": dict(zip(GRID_TYPES, cells)),
        "rsa_results": rsa_df.to_dict("records"),
        "replay": {"row": replay, "loss_bit_equal": bool(loss_bits),
                   "rsa_bit_equal": bool(rho_bits),
                   "loss_rel": float(loss_rel), "rho_diff": float(rho_diff)},
        "gaussian_repeat_equal": g1 == g2,
        "rho_kernel": rho_kernel, "rho_plain": rho_plain,
        "step_ms": step_ms, "step_turns": step_turns,
        "decode_images_per_s": decode,
        "vit_train_epoch2_images_per_s": ips,
        "seconds": {"pack": pack_s, "vit_train": train_s,
                    "vit_train_pil": pil_s, "vit_rsa_eval": rsa_s,
                    "vit_measure": measure_s},
        "libjpeg": _loaded_jpeg_lib(), "phase_s": time.time() - t_phase}
    del trainer, momentum, imgs_t, lbls_t, cache
    torch.cuda.empty_cache()
    return grid_launches


# the dist phase: data parallelism over torch.distributed, launched as a
# user launches it (torchrun, one process per card; NCCL, so one rank on
# this one card), each run in its own process through _dist_worker
DIST_EPOCHS = 2
DIST_STEPS = 4 * DIST_EPOCHS          # 1,024 train images, batch 256
DIST_VAL_BATCHES = DIST_EPOCHS        # 256 val images, one batch an epoch
DIST_MODES = ("single", "dp", "zero1", "fsdp")
DIST_BATCH = 256
# the phase's learning rate: 0.01, where this synthetic set trains stably
# (its loss falls from 3.0 to 0.49 over the 8 steps). At the CLI's
# default 0.1 it rises from 4.8 to 9.5, and there runs that differ only in
# rounding drift apart (--dist_drift: a one-process run whose dW+db
# sums in another order by 1.9e-3 in loss, two gloo ranks by 1.0e-2)
DIST_LR = "0.01"
# fsdp against the one-process run at world size 1, and two gloo ranks
# against it: the same products, but fsdp's gradient lands through
# .backward() and a reduce-scatter of one rank, and the ranks sum two half
# batches in another order without the fused dW+db. Allowed: losses within
# 1e-2 relative, accuracy within 2 of 256 images, fsdp's parameters within
# 1e-2 of their tree's largest magnitude. At lr 0.01 two one-process runs
# whose dW+db sums in another order already differ by 2.3e-3 in loss and
# by one image (--dist_drift)
DIST_LOSS_RTOL = 1e-2
DIST_ACC_ATOL = 100 * 2 / 256
DIST_PARAM_RTOL = 1e-2
# the gathered RSA against one process: within the grid's kernel-vs-plain
# bound (a wrong row order gives an unrelated rho)
DIST_RHO_ATOL = 1e-3


class _WriteCounter:
    """The files this process opens for writing (open, torch.save,
    os.replace) under `root`, while installed."""

    def __init__(self, root: str):
        import builtins
        import torch
        self.root, self.paths = os.path.abspath(root), []
        self._real = (builtins.open, torch.save, os.replace)

    def _note(self, path):
        if isinstance(path, (str, os.PathLike)) and \
                os.path.abspath(path).startswith(self.root):
            self.paths.append(os.path.relpath(path, self.root))

    def __enter__(self):
        import builtins
        import torch
        real_open, real_save, real_replace = self._real

        def open_(file, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                self._note(file)
            return real_open(file, mode, *a, **k)

        def save(obj, f, *a, **k):
            self._note(f)
            return real_save(obj, f, *a, **k)

        def replace(src, dst, *a, **k):
            self._note(dst)
            return real_replace(src, dst, *a, **k)
        builtins.open, torch.save, os.replace = open_, save, replace
        return self

    def __exit__(self, *exc):
        import builtins
        import torch
        builtins.open, torch.save, os.replace = self._real
        return False


def _dist_worker(report: str, argv: list) -> int:
    """Run entry points in this process (under torchrun or alone) and write
    what each launched and used to `report`.rank{RANK}.json. argv:
    [--gloo] MODULE ARGS... [--then MODULE ARGS...]...; MODULE is a CLI
    module (its main(ARGS)), "time_modes" or "clip_step_ms" (ARGS: the
    weights file). --gloo makes the process group first, with gloo on the
    card; a chain (--then) under torchrun makes it first with the backend
    of the rank's card (NCCL); the CLIs then leave it alone. Each module
    counts its launches from 0 and its peak memory from what the earlier
    modules still hold (reported as start_gib); the report is the first
    module's, with the later ones under "then". A rank other than 0 also
    reports the files it opened for writing under the report's directory
    (none: rank 0 writes them all)."""
    import gc
    import importlib
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.parallel import dist
    gloo = argv[0] == "--gloo"
    if gloo:
        argv = argv[1:]
    chain = [[]]
    for a in argv:
        if a == "--then":
            chain.append([])
        else:
            chain[-1].append(a)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if gloo:
        tdist.init_process_group("gloo")
    elif len(chain) > 1 and dist.launched():
        dist.setup_distributed(dist.local_device("cuda"))
    backend = {}
    setup = dist.setup_distributed

    def recording_setup(*a, **k):
        ranks = setup(*a, **k)
        if dist.is_initialized():
            backend["name"] = tdist.get_backend()
        return ranks
    dist.setup_distributed = recording_setup
    outs = []
    for module, *args in chain:
        backend.clear()
        gc.collect()
        torch.cuda.empty_cache()
        vattn.reset_launch_counts()
        vfdw.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # what the chain's earlier modules still hold (a floor under this
        # module's peak)
        start_gib = torch.cuda.memory_allocated() / 2**30
        t0 = time.time()
        counter = _WriteCounter(os.path.dirname(report)) if rank else None
        if counter is not None:
            counter.__enter__()
        try:
            if module == "time_modes":
                extra = _time_modes()
            elif module == "clip_step_ms":
                extra = _clip_step_ms(args[0])
            else:
                result = importlib.import_module(module).main(args)
                extra = {"result": result if isinstance(result, list)
                         else None}
        finally:
            if counter is not None:
                counter.__exit__()
        torch.cuda.synchronize()
        outs.append({"module": module, "rank": rank, "world": world,
                     "s": time.time() - t0,
                     "launches": {**vattn.LAUNCHES, **vfdw.LAUNCHES},
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "start_gib": start_gib,
                     "backend": backend.get("name"),
                     "writes": None if counter is None else counter.paths,
                     **extra})
    if dist.is_initialized():
        tdist.destroy_process_group()
    with open(f"{report}.rank{rank}.json", "w") as f:
        json.dump({**outs[0], "then": outs[1:]}, f)
    return 0


def _time_modes() -> dict:
    """Under torchrun at world size 1 (NCCL): ViT-B/16 trainers of the four
    modes side by side (single trains alone, distributed=False), each from
    the same seed; a step's launches per mode, then ms a step in turns
    (single, dp, zero1, fsdp, fsdp, zero1, dp, single; 10 steps a turn
    after 2 unmeasured, CUDA events between steps) on one batch on the card."""
    import dataclasses
    import torch
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.parallel import dist
    from vit_project_torch.train import vit_loop
    dev = dist.local_device("cuda")
    dist.setup_distributed(dev)
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    base = ViTTrainConfig(batch_size=DIST_BATCH, compute_dtype="bfloat16",
                          fused_dw=True)
    trainers = {}
    for mode in DIST_MODES:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev), gen)
        tr = vit_loop.ViTTrainer(
            vit_cfg, dataclasses.replace(base, zero1=mode == "zero1",
                                         fsdp=mode == "fsdp"),
            model, dev, distributed=mode != "single")
        trainers[mode] = (tr, tr.init_momentum())
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    size = vit_cfg.image_size
    imgs = torch.randint(0, 256, (base.batch_size, size, size, 3),
                         generator=gen, device=dev, dtype=torch.uint8)
    lbls = torch.randint(0, vit_cfg.num_classes, (base.batch_size,),
                         generator=gen, device=dev)
    per_step = {}
    for mode, (tr, mom) in trainers.items():
        vattn.reset_launch_counts()
        vfdw.reset_launch_counts()
        tr.step(mom, imgs, lbls, 0.02)
        torch.cuda.synchronize()
        per_step[mode] = {**vattn.LAUNCHES, **vfdw.LAUNCHES}

    def turn(mode, steps=10):
        tr, mom = trainers[mode]
        for _ in range(2):
            tr.step(mom, imgs, lbls, 0.02)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        for i in range(steps):
            tr.step(mom, imgs, lbls, 0.02)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    turns = {m: [] for m in DIST_MODES}
    for mode in DIST_MODES + DIST_MODES[::-1]:
        turns[mode].append(turn(mode))
    return {"per_step": per_step, "turns": turns}


def _dist_run(tmp: str, name: str, argv: list, nproc: int | None = 1,
              timeout: int = 600) -> list:
    """`argv` ([--gloo] MODULE ARGS) through _dist_worker: under
    ``torchrun --standalone --nproc_per_node nproc``, or alone (nproc
    None). Returns the ranks' reports; on failure prints the output's tail
    and fails the phase."""
    report = os.path.join(tmp, f"{name}.report")
    log = os.path.join(tmp, f"{name}.log")
    me = os.path.abspath(__file__)
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc)] if nproc else [sys.executable])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    with open(log, "w") as f:
        res = subprocess.run(cmd + [me, "--dist_worker", report, *argv],
                             cwd=ROOT, env=env, stdout=f,
                             stderr=subprocess.STDOUT, timeout=timeout)
    if res.returncode != 0:
        with open(log) as f:
            print(f.read()[-6000:], flush=True)
        fail(f"[dist] {name} exited {res.returncode}")
    reports = []
    for r in range(nproc or 1):
        with open(f"{report}.rank{r}.json") as f:
            reports.append(json.load(f))
    return reports


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _rel_tree_diff(a, b) -> float:
    """max |a - b| over max |b|, over two trees' leaves."""
    la, lb = _tree_leaves(a), _tree_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    diff = max(float(np.abs(x.astype(np.float64) - y).max())
               for x, y in zip(la, lb))
    return diff / max(float(np.abs(y).max()) for y in lb)


def phase_dist(tmp: str):
    """Data parallelism as users launch it: cli.vit_train at ViT-B/16's full
    width and depth (bf16, global batch 256, fused_dw) alone and under
    ``torchrun --standalone --nproc_per_node 1`` in dp, --zero1 and --fsdp
    (NCCL); cli.vit_rsa_eval and one cli.vit_measure cell under torchrun
    against the same CLIs alone; ms a step per mode in turns; and two ranks
    under gloo on this one card (dp, the gathered RSA). The torchrun runs
    share one launch (a chain of the worker's, each CLI counted from 0),
    and so do the two gloo ones: a process costs ~20 s of start-up."""
    import pandas as pd
    from vit_project_torch.cli import vit_measure as measure_cli
    from vit_project_torch.cli import vit_rsa_eval as rsa_cli

    t_phase = time.time()
    root = os.path.join(tmp, "dist")
    os.makedirs(root)
    data = os.path.join(tmp, "imagenet")
    if not os.path.isdir(data):        # phase vit_train's, when it ran
        _write_image_folder(data, np.random.RandomState(SEED))
    rs = np.random.RandomState(SEED + 2)
    img_dir, names, _ = _write_things(root, rs, n_train=0)
    things = _write_things_csvs(root, names, rs.randn(len(names), 66),
                                n_train=0)
    things_args = ["--things_csv", things["inference_csv_file"],
                   "--things_img_dir", img_dir,
                   "--things_rdm_path", things["RDM48_triplet_dir"]]
    print(f"[dist] fixture ready in {time.time() - t_phase:.1f} s (the "
          f"vit_train ImageFolder; 48 THINGS JPEGs and an RDM); ViT-B/16, "
          f"batch 256, bf16, SGD lr {DIST_LR}, {DIST_EPOCHS} epochs a run",
          flush=True)
    train_cli = "vit_project_torch.cli.vit_train"
    train_args = ["--data_path", data, "--batch_size", "256", "--epochs",
                  str(DIST_EPOCHS), "--num_workers", "8", "--lr", DIST_LR]

    # --- the main path: cli.vit_train alone, then in one torchrun launch
    # dp, zero1, fsdp, cli.vit_rsa_eval, one cli.vit_measure cell and the
    # step timing; each CLI's counts start at 0 and are read at its end ---
    want = {"dw_db": 49 * DIST_STEPS, "flash3_bwd": 12 * DIST_STEPS,
            "flash3_fwd": 12 * (DIST_STEPS + DIST_VAL_BATCHES)}
    single = os.path.join(root, "single")
    by_mode = {"single": _dist_run(root, "single", [
        train_cli, *train_args, "--fused_dw", "--output_dir", single],
        nproc=None)[0]}
    rsa_one = os.path.join(root, "rsa_one.csv")
    _cli(rsa_cli.main, ["--checkpoint_dir", single, "--output_csv", rsa_one,
                        *things_args], os.path.join(root, "rsa_one.log"))
    cell = ["--baseline_checkpoint_dir", single, "--baseline_metrics_csv",
            rsa_one, "--data_path", data, *things_args, "--perturb_epochs",
            "1", "--perturbation_types", "gaussian", "--batch_size", "256",
            "--num_workers", "8", "--lr", DIST_LR]
    chain = []
    for mode in DIST_MODES[1:]:
        flags = {"zero1": ["--zero1"], "fsdp": ["--fsdp"]}.get(mode, [])
        chain += [train_cli, *train_args, "--fused_dw", "--output_dir",
                  os.path.join(root, mode), *flags, "--then"]
    chain += ["vit_project_torch.cli.vit_rsa_eval", "--checkpoint_dir",
              single, "--output_csv", os.path.join(root, "rsa_dp.csv"),
              *things_args, "--then", "vit_project_torch.cli.vit_measure",
              *cell, "--output_csv", os.path.join(root, "cell_dp.csv"),
              "--then", "time_modes"]
    first = _dist_run(root, "torchrun", chain)[0]
    steps = [first] + first.pop("then")
    by_mode.update(zip(DIST_MODES[1:], steps[:3]))
    rsa_rep, cell_rep, tm = steps[3:]
    runs, trees, rows = {}, {}, {}
    for mode in DIST_MODES:
        out = os.path.join(root, mode)
        rep = by_mode[mode]
        if rep["launches"] != {**{k: 0 for k in rep["launches"]}, **want}:
            fail(f"[dist] {mode}: launches {rep['launches']}, want {want}")
        if rep["backend"] != (None if mode == "single" else "nccl"):
            fail(f"[dist] {mode}: backend {rep['backend']}")
        runs[mode] = rep
        trees[mode] = _ckpt_trees(out)
        rows[mode] = _read_rows(os.path.join(out, "training_metrics.csv"))
        print(f"[dist] {mode}: {rep['s']:.1f} s, peak "
              f"{rep['peak_gib']:.3f} GiB ({rep['start_gib']:.3f} GiB held "
              f"at its start), launches "
              + ", ".join(f"{k} {v}" for k, v in sorted(
                  rep["launches"].items()) if v)
              + "; rows " + "; ".join(",".join(r) for r in rows[mode][1:]),
              flush=True)
    if [r[0] for r in rows["single"][1:]] != [str(e) for e in
                                               range(DIST_EPOCHS)]:
        fail(f"[dist] single rows {rows['single']}")
    for r in rows["single"][1:]:
        if not all(np.isfinite([float(v) for v in r[1:]])):
            fail(f"[dist] bad row {r}")
    cmp = {}
    for mode in ("dp", "zero1", "fsdp"):
        exact = rows[mode] == rows["single"] and all(
            _trees_equal(a, b) for a, b in zip(trees[mode], trees["single"]))
        got = np.array([[float(v) for v in r[1:]] for r in rows[mode][1:]])
        ref = np.array([[float(v) for v in r[1:]]
                        for r in rows["single"][1:]])
        rel = [_rel_tree_diff(a, b) for a, b in zip(trees[mode],
                                                    trees["single"])]
        cmp[mode] = {"bit_equal": exact, "tree_rel_diff": rel,
                     "loss_rel_diff": float(np.abs(got[:, :2] / ref[:, :2]
                                                   - 1).max()),
                     "acc_diff": float(np.abs(got[:, 2] - ref[:, 2]).max())}
        print(f"[dist] {mode} against single: "
              + ("bit-equal rows and checkpoints" if exact else
                 f"losses {cmp[mode]['loss_rel_diff']:.3e} relative, "
                 f"accuracy {cmp[mode]['acc_diff']:.3f} points, trees "
                 f"{rel[0]:.3e} / {rel[1]:.3e} of their largest"),
              flush=True)
        if mode in ("dp", "zero1") and not exact:
            fail(f"[dist] {mode} at world size 1 differs from one process")
        if mode == "fsdp" and not (
                cmp[mode]["loss_rel_diff"] <= DIST_LOSS_RTOL
                and cmp[mode]["acc_diff"] <= DIST_ACC_ATOL
                and max(rel) <= DIST_PARAM_RTOL):
            fail(f"[dist] fsdp outside the tolerance: {cmp[mode]}")
    del trees
    main_launches = {k: sum(runs[m]["launches"][k] for m in DIST_MODES
                            if m != "single") for k in want}

    # --- the per-epoch RSA and one grid cell: torchrun at world size 1
    # (above) against the same CLIs alone (in this process) ---
    _cli(measure_cli.main, cell + ["--output_csv",
                                   os.path.join(root, "cell_one.csv")],
         os.path.join(root, "cell_one.log"))
    same = {}
    for name in ("rsa", "cell"):
        with open(os.path.join(root, f"{name}_one.csv"), "rb") as f:
            one = f.read()
        with open(os.path.join(root, f"{name}_dp.csv"), "rb") as f:
            same[name] = f.read() == one
    print(f"[dist] torchrun world size 1 against one process: "
          f"cli.vit_rsa_eval {rsa_rep['s']:.1f} s, flash3_fwd "
          f"{rsa_rep['launches']['flash3_fwd']}, CSV "
          f"{'equal' if same['rsa'] else 'DIFFERS'}; cli.vit_measure "
          f"gaussian @ 1 {cell_rep['s']:.1f} s, flash3_fwd "
          f"{cell_rep['launches']['flash3_fwd']} flash3_bwd "
          f"{cell_rep['launches']['flash3_bwd']}, CSV "
          f"{'equal' if same['cell'] else 'DIFFERS'}", flush=True)
    if not all(same.values()):
        fail(f"[dist] torchrun CSVs differ from one process: {same}")
    if rsa_rep["launches"]["flash3_fwd"] != 2 * 12 * GRID_RSA_CHUNKS or \
            cell_rep["launches"]["flash3_fwd"] != \
            GRID_CELL_LAUNCHES["flash3_fwd"]:
        fail(f"[dist] launches {rsa_rep['launches']} {cell_rep['launches']}")

    # --- ms a step per mode, in turns, in one process (the launch above) ---
    per_step_want = {"dw_db": 49, "flash3_bwd": 12, "flash3_fwd": 12}
    for mode, got in tm["per_step"].items():
        if {k: got[k] for k in per_step_want} != per_step_want:
            fail(f"[dist] {mode}: a step launched {got}")
    step_ms = {m: statistics.mean(x for t in v for x in t)
               for m, v in tm["turns"].items()}
    print("[dist] a step's launches, every mode: flash3_fwd 12, flash3_bwd "
          "12, dw_db 49; ms a step in turns (single, dp, zero1, fsdp, and "
          "back; 10 steps a turn): " + "; ".join(
              f"{m} {step_ms[m]:.2f} (turns "
              + ", ".join(f"{statistics.mean(t):.2f}" for t in v)
              + f"; +{step_ms[m] - step_ms['single']:.2f})"
              for m, v in tm["turns"].items())
          + f"; peak in that process {tm['peak_gib']:.2f} GiB "
          f"(four models); {smi_line()}", flush=True)

    # --- two ranks on this card under gloo: dp and the gathered RSA ---
    gloo_out = os.path.join(root, "gloo_dp")
    g = _dist_run(root, "gloo", [
        "--gloo", train_cli, *train_args, "--device", "cuda:0",
        "--output_dir", gloo_out, "--then",
        "vit_project_torch.cli.vit_rsa_eval", "--checkpoint_dir", single,
        "--output_csv", os.path.join(root, "rsa_gloo.csv"), *things_args,
        "--device", "cuda:0"], nproc=2)
    g_rsa = [rep["then"][0] for rep in g]
    g_rows = _read_rows(os.path.join(gloo_out, "training_metrics.csv"))
    got = np.array([[float(v) for v in r[1:]] for r in g_rows[1:]])
    ref = np.array([[float(v) for v in r[1:]] for r in rows["single"][1:]])
    g_loss = float(np.abs(got[:, :2] / ref[:, :2] - 1).max())
    g_acc = float(np.abs(got[:, 2] - ref[:, 2]).max())
    half = {"flash3_fwd": 12 * (DIST_STEPS + DIST_VAL_BATCHES),
            "flash3_bwd": 12 * DIST_STEPS}
    for rep in g:
        if rep["backend"] != "gloo" or any(
                rep["launches"][k] != v for k, v in half.items()):
            fail(f"[dist] gloo rank {rep['rank']}: {rep}")
    rho_g = pd.read_csv(os.path.join(root, "rsa_gloo.csv"))["rsa_score"]
    rho_1 = pd.read_csv(rsa_one)["rsa_score"]
    rho_diff = float(np.abs(rho_g.to_numpy() - rho_1.to_numpy()).max())
    print(f"[dist] 2 ranks, gloo, one card (128 images a rank, no fused_dw): "
          f"{g[0]['s']:.1f} s, peak {max(r['peak_gib'] for r in g):.2f} GiB "
          f"a rank; rows " + "; ".join(",".join(r) for r in g_rows[1:])
          + f"; against one process: losses {g_loss:.3e} relative, accuracy "
          f"{g_acc:.3f} points; RSA over 2 ranks {g_rsa[0]['s']:.1f} s, rho "
          f"within {rho_diff:.2e} of one process's", flush=True)
    if not (g_loss <= DIST_LOSS_RTOL and g_acc <= DIST_ACC_ATOL
            and rho_diff <= DIST_RHO_ATOL):
        fail(f"[dist] gloo 2-rank run outside the tolerance: losses "
             f"{g_loss}, accuracy {g_acc}, rho {rho_diff}")
    RESULTS["dist"] = {
        "runs": runs, "compare": cmp, "rsa": rsa_rep, "cell": cell_rep,
        "time_modes": tm, "step_ms": step_ms, "gloo": g, "gloo_rsa": g_rsa,
        "gloo_rows": g_rows[1:], "gloo_loss_rel": g_loss,
        "gloo_acc_diff": g_acc, "gloo_rho_diff": rho_diff,
        "seconds": time.time() - t_phase}
    print(f"[dist] phase {time.time() - t_phase:.1f} s", flush=True)
    return main_launches


CLIP_DIST_EPOCHS = 2
# 1,444 training images at batch 64: 22 full batches and one of 36
CLIP_DIST_STEPS = 23 * CLIP_DIST_EPOCHS
# 36 flash3_fwd a full-tower forward (24 image blocks, 12 text): each step,
# and the eval (the 362 test images as one batch) and the RSA before
# training and after each epoch; one flash3_bwd a step (image block 23)
CLIP_DIST_WANT = {"flash3_fwd": 36 * (CLIP_DIST_STEPS
                                      + 2 * (CLIP_DIST_EPOCHS + 1)),
                  "flash3_bwd": CLIP_DIST_STEPS}
# two gloo ranks (32 rows a rank, bf16) against the run alone (64 rows):
# the cuBLAS GEMMs of the image tower see other shapes, so each layer may
# round otherwise. Measured on an H100 at 700 W: 1.839e-4 relative in the
# losses and 1.612e-4 in rho over 2 epochs (the same in two runs); the
# bounds are ten times that
CLIP_DIST_LOSS_RTOL = 2e-3
CLIP_DIST_RHO_ATOL = 2e-3


def _clip_step_ms(wpath: str) -> dict:
    """Under torchrun at world size 1 (NCCL): CLIP-HBA trainers alone and
    data-parallel (a mesh of one rank) on the same ViT-L/14 weights and
    adapters; a step's launches for each, then ms a step in turns (one, dp,
    dp, one; 10 steps a turn after 2 unmeasured, CUDA events between
    steps) on 64 images on the card."""
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.core.prng import Key
    from vit_project_torch.data.spose66 import classnames66
    from vit_project_torch.models import convert as vconvert
    from vit_project_torch.models import tokenizer as vtok
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import mesh as vmesh
    from vit_project_torch.train import clip_loop
    dev = dist.local_device("cuda")
    dist.setup_distributed(dev)
    model = vconvert.clip_from_state_dict(vconvert.load_torch_state_dict(
        wpath), dev)
    cfg = model.cfg
    init_tr, static, acfg = adora.apply_dora(
        model, adora.dora_spec(cfg.visual.layers, cfg.text.layers, 2, 1),
        r=32, alpha=16, dropout=0.1,
        generator=torch.Generator(device=dev).manual_seed(SWEEP_SEED + 123))
    prompts = np.minimum(vtok.tokenize(classnames66, context_length=77,
                                       truncate=True),
                         cfg.text.vocab_size - 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    imgs = torch.randint(0, 256, (64, 224, 224, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    tgts = torch.rand((64, 66), generator=gen, device=dev)
    trainers = {}
    for mode, mesh in (("one", None), ("dp", vmesh.make_mesh())):
        tr = clip_loop.ClipHBATrainer(cfg, model, acfg, static, prompts,
                                      lr=3e-4, compute_dtype=torch.bfloat16,
                                      mesh=mesh)
        trainable = adora.make_trainable(init_tr, dev)
        trainers[mode] = (tr, trainable, tr.init_optimizer(trainable))
    idx = np.arange(64)

    def step(mode, k):
        tr, trainable, opt = trainers[mode]
        return tr.train_step(trainable, opt, imgs, tgts, idx,
                             Key((SWEEP_SEED, 0, k)), batch_size=64)
    per_step = {}
    for mode in trainers:
        step(mode, 0)
        torch.cuda.synchronize()
        vattn.reset_launch_counts()
        step(mode, 1)
        torch.cuda.synchronize()
        per_step[mode] = {k: vattn.LAUNCHES[k]
                          for k in ("flash3_fwd", "flash3_bwd")}

    def turn(mode, steps=10):
        for k in range(2):
            step(mode, k)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        for k in range(steps):
            step(mode, k)
            ev[k + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    turns = {m: [] for m in trainers}
    for mode in ("one", "dp", "dp", "one"):
        turns[mode].append(turn(mode))
    return {"per_step": per_step, "turns": turns}


def _run_files(out: str) -> dict:
    """{path: bytes} of a run's files, timestamps in the names replaced by T
    and the logs left out."""
    files = {}
    for d, _, names in os.walk(out):
        for n in names:
            path = os.path.join(d, n)
            key = re.sub(r"_\d{8}_\d{6}", "_T", os.path.relpath(path, out))
            if "log" not in n:
                with open(path, "rb") as f:
                    files[key] = f.read()
            else:
                files[key] = None
    return files


def _alone(name: str, main_fn, argv: list, root: str) -> dict:
    """One CLI in this process, as _dist_run reports a process: its
    launches (counted from 0), seconds, result and log text."""
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    import torch
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    result, text, sec = _cli(main_fn, argv, os.path.join(root, f"{name}.log"))
    torch.cuda.synchronize()
    return {"rank": 0, "world": 1, "s": sec, "backend": None,
            "launches": {**vattn.LAUNCHES, **vfdw.LAUNCHES}, "writes": None,
            "result": result if isinstance(result, list) else None,
            "text": text}


def _epoch_train_s(text: str, n_train: int) -> list:
    """Each epoch's training seconds from a CLI log's epoch lines (the
    images_per_sec it prints over the training images)."""
    return [n_train / float(m.group(2)) for m in _EPOCH_LINE.finditer(text)]


def phase_clip_dist(tmp: str):
    """CLIP-HBA training across ranks as users launch it, at full width and
    depth (ViT-L/14, rank-32 DoRA, bf16, batch 64, 2 epochs, THINGS-sized
    images with random targets): cli.baseline alone against cli.baseline
    under torchrun at world size 1 (NCCL, the data-parallel step) and under
    two gloo ranks on this card; one sequential cli.sweep run, which
    restores the baseline's AdamW state, over two gloo ranks against world
    size 1; ms a step alone against dp in turns; and
    cli.sweep --batched_forks 3 --frozen_cache alone against torchrun. The
    alone runs are made in this process; the torchrun work at world size 1
    is one launch (a chain of the worker's: a process costs ~20 s)."""
    from vit_project_torch.cli import baseline as baseline_cli
    from vit_project_torch.cli import sweep as sweep_cli
    from vit_project_torch.data import things as dthings
    t_phase = time.time()
    root = os.path.join(tmp, "clip_dist")
    os.makedirs(root)
    fx = _clip_fixture(tmp)
    # targets as the train phase draws them (U[0, 2) a dimension), so the
    # losses sit near 0.7 and a relative bound means something
    data = _write_things_csvs(root, fx["names"], np.random.RandomState(
        SEED + 4).rand(len(fx["names"]), 66) * 2)
    args = ["--csv_file", data["csv_file"], "--img_dir", fx["img_dir"],
            "--inference_csv_file", data["inference_csv_file"],
            "--RDM48_triplet_dir", data["RDM48_triplet_dir"],
            *fx["model_args"], "--epochs", str(CLIP_DIST_EPOCHS)]
    n_train = len(dthings.random_split_indices(1806, 0.8, SWEEP_SEED)[0])
    base_cli = "vit_project_torch.cli.baseline"

    # --- the main path: cli.baseline alone (here); under torchrun at world
    # size 1 (NCCL), chained in one launch with the batched sweep below and
    # the step timing; two gloo ranks. Each CLI counts its launches from 0 ---
    base = os.path.join(root, "alone")

    def forks_argv(out):
        stamp = next(n for n in os.listdir(base)
                     if n.startswith("dora_params_"))[len("dora_params_"):]
        rs_dir = os.path.join(base, f"random_states_{stamp}")
        return args + [
            "--baseline_dora_directory",
            os.path.join(base, f"dora_params_{stamp}"),
            "--baseline_random_state_path", rs_dir,
            "--baseline_split_indices_path",
            os.path.join(rs_dir, "dataset_split_indices.pth"),
            "--perturb_seed", "42", "--perturb_type", "random_target",
            "--training_order", "1,2", "--batched_forks", "3",
            "--frozen_cache", "--output_base_directory", out]

    def resumed_argv(out):
        # one sequential sweep run, data-parallel: run 2 resumes the
        # baseline's epoch-1 adapters and AdamW state (its step count is
        # restored on the CPU beside moments on the card)
        argv = forks_argv(out)
        i = argv.index("--batched_forks")
        return argv[:argv.index("--training_order")] + [
            "--training_order", "2", *argv[i + 3:]]
    sweep_cli_name = "vit_project_torch.cli.sweep"
    runs, files, rows, epoch_s = {}, {}, {}, {}
    forks, resumed = {}, {}
    for name, nproc in (("alone", 0), ("dp1", 1), ("gloo2", 2)):
        out = os.path.join(root, name)
        argv = [*args, "--output_dir", out]
        res_out = os.path.join(root, f"resumed_{name}")
        if nproc == 0:
            reps = [_alone(name, baseline_cli.main, argv, root)]
            text = reps[0].pop("text")
        else:
            chain = (["--gloo", base_cli, *argv, "--device", "cuda:0",
                      "--then", sweep_cli_name, *resumed_argv(res_out),
                      "--device", "cuda:0"]
                     if nproc == 2 else
                     [base_cli, *argv, "--then", sweep_cli_name,
                      *forks_argv(os.path.join(root, "forks_dp1")), "--then",
                      sweep_cli_name, *resumed_argv(res_out), "--then",
                      "clip_step_ms", fx["wpath"]])
            reps = _dist_run(root, name, chain, nproc=nproc)
            if nproc == 1:
                forks["forks_dp1"], res, tm = reps[0].pop("then")
                resumed[name] = [res]
            else:
                resumed[name] = [rep.pop("then")[0] for rep in reps]
            for rep in resumed[name]:
                if rep["result"] != [] or rep["writes"]:
                    fail(f"[clip_dist] resumed sweep run {name} rank "
                         f"{rep['rank']}: {rep}")
            with open(os.path.join(root, f"{name}.log")) as f:
                text = f.read()
        for rep in reps:
            got = {k: v for k, v in rep["launches"].items() if v}
            if got != CLIP_DIST_WANT:
                fail(f"[clip_dist] {name} rank {rep['rank']}: launches "
                     f"{got}, want {CLIP_DIST_WANT}")
            if rep["writes"]:
                fail(f"[clip_dist] {name} rank {rep['rank']} wrote "
                     f"{rep['writes']}")
        backend = {"alone": None, "dp1": "nccl", "gloo2": "gloo"}[name]
        if any(rep["backend"] != backend for rep in reps):
            fail(f"[clip_dist] {name}: backend {reps[0]['backend']}")
        runs[name], files[name] = reps, _run_files(out)
        rows[name] = _read_rows(os.path.join(out, next(
            n for n in os.listdir(out) if n.startswith("training_res_"))))
        # the baseline's epochs (each rank prints its own; the resumed
        # sweep run's come after them)
        epoch_s[name] = _epoch_train_s(text, n_train)[
            :CLIP_DIST_EPOCHS * max(nproc, 1)]
        peak = (" / ".join(f"{r['peak_gib']:.2f}" for r in reps)
                + " GiB a rank" if nproc else "not read (in this process)")
        print(f"[clip_dist] cli.baseline {name}: {reps[0]['s']:.1f} s, peak "
              f"{peak}, launches a rank flash3_fwd "
              f"{reps[0]['launches']['flash3_fwd']} flash3_bwd "
              f"{reps[0]['launches']['flash3_bwd']}; epoch training s "
              + ", ".join(f"{x:.3f}" for x in epoch_s[name]) + "; rows "
              + "; ".join(",".join(r) for r in rows[name][1:]), flush=True)
    if [r[0] for r in rows["alone"][1:]] != ["1", "2"]:
        fail(f"[clip_dist] alone rows {rows['alone']}")
    logs = [k for k in files["gloo2"] if k.startswith("training_log_")]
    if sorted(files["gloo2"]) != sorted(files["alone"]) or len(logs) != 1:
        fail(f"[clip_dist] the 2-rank tree {sorted(files['gloo2'])} is not "
             f"the run alone's {sorted(files['alone'])}")
    dp1_equal = files["dp1"] == files["alone"]
    print(f"[clip_dist] torchrun world size 1 (NCCL) against alone: rows, "
          f"DoRA and random-state pickles "
          f"{'bit-equal' if dp1_equal else 'DIFFER'}", flush=True)
    if not dp1_equal:
        fail("[clip_dist] world size 1 differs from the run alone")
    got = np.array([[float(v) for v in r[1:5]] for r in rows["gloo2"][1:]])
    ref = np.array([[float(v) for v in r[1:5]] for r in rows["alone"][1:]])
    g_loss = float(np.abs(got[:, :2] / ref[:, :2] - 1).max())
    g_rho = float(np.abs(got[:, 2] - ref[:, 2]).max())
    print(f"[clip_dist] 2 gloo ranks on one card (32 rows a rank) against "
          f"alone: losses {g_loss:.3e} relative, rho {g_rho:.3e} "
          f"(tolerance {CLIP_DIST_LOSS_RTOL}, {CLIP_DIST_RHO_ATOL}); one "
          f"log, rank 1 wrote no file", flush=True)
    if [r[0] for r in rows["gloo2"][1:]] != ["1", "2"] or not (
            g_loss <= CLIP_DIST_LOSS_RTOL and g_rho <= CLIP_DIST_RHO_ATOL):
        fail(f"[clip_dist] 2 gloo ranks outside the tolerance: losses "
             f"{g_loss}, rho {g_rho}")

    # --- the resumed sweep run (restored AdamW state): two gloo ranks
    # against world size 1, whose baseline is the run alone's ---
    res_rows = {}
    for name in resumed:
        csvs = [os.path.join(d, n) for d, _, ns in os.walk(
            os.path.join(root, f"resumed_{name}")) for n in ns
            if n.startswith("training_res_")]
        if len(csvs) != 1:
            fail(f"[clip_dist] resumed {name}: result CSVs {csvs}")
        res_rows[name] = _read_rows(csvs[0])
    got = np.array([[float(v) for v in r[1:5]]
                    for r in res_rows["gloo2"][1:]])
    ref = np.array([[float(v) for v in r[1:5]] for r in res_rows["dp1"][1:]])
    r_loss = float(np.abs(got[:, :2] / ref[:, :2] - 1).max())
    r_rho = float(np.abs(got[:, 2] - ref[:, 2]).max())
    print(f"[clip_dist] cli.sweep run 2 (resumes epoch 1's adapters and "
          f"AdamW state): 2 gloo ranks {resumed['gloo2'][0]['s']:.1f} s, "
          f"world size 1 {resumed['dp1'][0]['s']:.1f} s; rows "
          + "; ".join(",".join(r) for r in res_rows["gloo2"][1:])
          + f"; against world size 1: losses {r_loss:.3e} relative, rho "
          f"{r_rho:.3e}; rank 1 wrote no file", flush=True)
    if [r[0] for r in res_rows["gloo2"][1:]] != [
            r[0] for r in res_rows["dp1"][1:]] or not (
            r_loss <= CLIP_DIST_LOSS_RTOL and r_rho <= CLIP_DIST_RHO_ATOL):
        fail(f"[clip_dist] the resumed run over 2 gloo ranks outside the "
             f"tolerance: losses {r_loss}, rho {r_rho}")

    # --- ms a step, alone and dp at world size 1, in turns (the dp1
    # launch) ---
    want_step = {"flash3_fwd": 36, "flash3_bwd": 1}
    if any(v != want_step for v in tm["per_step"].values()):
        fail(f"[clip_dist] a step launched {tm['per_step']}")
    # medians: a step is host-bound enough that a turn can catch a stall
    step_ms = {m: statistics.median(x for t in v for x in t)
               for m, v in tm["turns"].items()}
    print(f"[clip_dist] a step launches flash3_fwd 36, flash3_bwd 1 alone "
          f"and dp; ms a step in turns (one, dp, dp, one; 10 steps a turn), "
          f"median of 20: "
          + "; ".join(f"{m} {step_ms[m]:.2f} (turn means "
                      + ", ".join(f"{statistics.mean(t):.2f}" for t in v)
                      + ")" for m, v in tm["turns"].items())
          + f"; dp adds {step_ms['dp'] - step_ms['one']:+.2f} ms; "
          f"{smi_line()}", flush=True)

    # --- batched forks: under torchrun (the dp1 launch), every rank runs
    # the groups; against the same invocation alone (here) ---
    forks["forks_alone"] = _alone("forks_alone", sweep_cli.main, forks_argv(
        os.path.join(root, "forks_alone")), root)
    forks["forks_alone"].pop("text")
    for name, rep in forks.items():
        if rep["result"] != [] or rep["launches"]["flash3_bwd"] == 0:
            fail(f"[clip_dist] {name}: {rep}")
    trees = {name: _run_files(os.path.join(root, name)) for name in forks}
    f_equal = trees["forks_dp1"] == trees["forks_alone"]
    n_csv = sum(k.endswith(".csv") for k in trees["forks_alone"])
    print(f"[clip_dist] cli.sweep --batched_forks 3 --frozen_cache, runs 1,2: "
          f"alone {forks['forks_alone']['s']:.1f} s, torchrun "
          f"{forks['forks_dp1']['s']:.1f} s; {n_csv} CSVs and the "
          f"checkpoints {'bit-equal' if f_equal else 'DIFFER'}; launches "
          f"{forks['forks_dp1']['launches']['flash3_fwd']} / "
          f"{forks['forks_dp1']['launches']['flash3_bwd']}", flush=True)
    if not f_equal or n_csv != 2 or forks["forks_dp1"]["launches"] != \
            forks["forks_alone"]["launches"]:
        fail("[clip_dist] batched forks under torchrun differ from alone")
    RESULTS["clip_dist"] = {
        "runs": runs, "rows": rows, "epoch_train_s": epoch_s,
        "gloo_loss_rel": g_loss, "gloo_rho_diff": g_rho,
        "step_ms": step_ms, "time_modes": tm, "forks": forks,
        "resumed": resumed, "resumed_rows": res_rows,
        "resumed_loss_rel": r_loss, "resumed_rho_diff": r_rho,
        "seconds": time.time() - t_phase}
    print(f"[clip_dist] phase {time.time() - t_phase:.1f} s", flush=True)
    return {k: sum(r["launches"][k] for name in ("dp1", "gloo2")
                   for r in runs[name] + resumed[name])
            + forks["forks_dp1"]["launches"][k]
            for k in ("flash3_fwd", "flash3_bwd")}


def _dist_drift(lrs: list) -> int:
    """``--dist_drift [LRS]``, run alone: how far two data-parallel ranks
    drift from one process, by learning rate (the measurement behind
    DIST_LR). On phase vit_train's seeded ImageFolder, ViT-B/16 at batch
    256 in bf16 for 2 epochs, each run ``cli.vit_train`` in its own process
    (``--dist_worker``), at each learning rate: one process with
    ``--fused_dw``; one process with the plain dW+db (the same arithmetic
    summed in another order: the spread of a change that should not
    matter); two ranks under gloo sharing the card (128 images a rank, the
    plain dW+db). Prints each run's rows, then the largest relative loss
    difference and the accuracy difference against the fused run, and
    the card's name and power limit; no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    tmp = os.path.join(ROOT, "vit_project_torch", "_build",
                       f"drift-{os.getpid()}")
    os.makedirs(tmp)
    try:
        phase_build()
        data = os.path.join(tmp, "imagenet")
        _write_image_folder(data, np.random.RandomState(SEED))
        train = "vit_project_torch.cli.vit_train"
        for lr in lrs:
            args = ["--data_path", data, "--batch_size", "256", "--epochs",
                    "2", "--num_workers", "8", "--lr", lr]
            rows = {}
            for name, extra, nproc in (("fused", ["--fused_dw"], None),
                                       ("plain", [], None),
                                       ("gloo", ["--device", "cuda:0"], 2)):
                out = os.path.join(tmp, f"{name}_{lr}")
                argv = (["--gloo"] if name == "gloo" else []) + [
                    train, *args, *extra, "--output_dir", out]
                _dist_run(tmp, f"{name}_{lr}", argv, nproc=nproc)
                rows[name] = np.array([[float(v) for v in r[1:]] for r in
                                       _read_rows(os.path.join(
                                           out, "training_metrics.csv"))[1:]])
                print(f"[drift] lr {lr} {name}: rows "
                      + "; ".join(",".join(f"{v:.6f}" for v in r)
                                  for r in rows[name]), flush=True)
            ref = rows["fused"]
            for name in ("plain", "gloo"):
                got = rows[name]
                print(f"[drift] lr {lr} {name} against fused: losses "
                      f"{np.abs(got[:, :2] / ref[:, :2] - 1).max():.3e} "
                      f"relative, accuracy "
                      f"{np.abs(got[:, 2] - ref[:, 2]).max():.4f} points",
                      flush=True)
        print(smi_line(), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist_worker"]:      # a process of phase dist
        return _dist_worker(argv[1], argv[2:])
    if argv[:1] == ["--dist_drift"]:       # DIST_LR's measurement
        return _dist_drift((argv[1:] or ["0.1,0.01,0.001"])[0].split(","))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--json", default=None,
                    help="also write every measured number to this file")
    opts = ap.parse_args(argv)
    phases = set(opts.phases.split(","))
    if not os.path.isdir(os.path.join(ROOT, "vit_project_torch")):
        print("chip_smoke: vit_project_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # full f32 everywhere a reference is computed (matmuls and convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    print(f"[card] {smi}", flush=True)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    peaks = PEAKS["PCIe" if "PCIe" in smi else "SXM"]
    RESULTS["card"] = smi
    phase_build()
    rows = phase_kernel(peaks) if "kernel" in phases else []
    ops_launches = phase_ops() if "ops" in phases else None
    serve_launches = train_launches = vit_launches = sweep_launches = None
    forks_launches = grid_launches = serve_vit_launches = None
    dist_launches = clip_dist_launches = None
    tmp = os.path.join(ROOT, "vit_project_torch", "_build",
                       f"smoke-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    try:
        if "serve" in phases:
            serve_launches = phase_serve(tmp)
        if "train" in phases:
            train_launches = phase_train(tmp)
        if "vit_train" in phases:
            vit_launches = phase_vit_train(tmp)
        if "vit_grid" in phases:
            grid_launches = phase_vit_grid(tmp)
        if "serve_vit" in phases:
            serve_vit_launches = phase_serve_vit(tmp)
        if "dist" in phases:
            dist_launches = phase_dist(tmp)
        if "clip_dist" in phases:
            clip_dist_launches = phase_clip_dist(tmp)
        if "sweep" in phases or "forks" in phases:
            sweep_launches, ctx = phase_sweep(tmp)
            if "forks" in phases:
                forks_launches = phase_forks(ctx)
            del ctx
        _CLIP_FIXTURE.clear()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def row_of(kernel, case):
        return next((r for r in rows if r["kernel"] == kernel
                     and r["case"] == case and r["dtype"] == "bfloat16"), {})

    def vit(name):
        return vit_launches and vit_launches[name]

    def ops(name):
        return ops_launches and ops_launches[name]

    def sweep(name):
        return sweep_launches and sweep_launches[name]

    def forks(name):
        return forks_launches and forks_launches[name]

    def grid(name):
        return grid_launches and grid_launches[name]

    def dist(name):
        return dist_launches and dist_launches[name]

    def clip_dist(name):
        return clip_dist_launches and clip_dist_launches[name]

    def entry(name, source, replaces, launches, by_path, errors, main_row,
              at):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path,
                "max_abs_err": max(errors, default=None),
                **{k: main_row.get(k) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "at": at}
    kernels = [
        entry("flash3_fwd", "vit_project_torch/csrc/flash3_fwd.cu",
              "vit_project_tpu/ops/attention.py:465", serve_launches,
              {"serve": serve_launches, "serve_vit": serve_vit_launches,
               "train": train_launches and train_launches["flash3_fwd"],
               "vit_train": vit("flash3_fwd"),
               "vit_grid": grid("flash3_fwd"), "sweep": sweep("flash3_fwd"),
               "forks": forks("flash3_fwd"), "dist": dist("flash3_fwd"),
               "clip_dist": clip_dist("flash3_fwd")},
              [r["max_abs_err_o"] for r in rows
               if r["kernel"] == "flash3_fwd"],
              row_of("flash3_fwd", "image_b256"),
              "image tower, bucket 256, bfloat16, qkv [256, 257, 3072], "
              "H=16; launches: the serving run"),
        entry("flash3_bwd", "vit_project_torch/csrc/flash3_bwd.cu",
              "vit_project_tpu/ops/attention.py:480",
              train_launches and train_launches["flash3_bwd"],
              {"train": train_launches and train_launches["flash3_bwd"],
               "vit_train": vit("flash3_bwd"),
               "vit_grid": grid("flash3_bwd"), "sweep": sweep("flash3_bwd"),
               "forks": forks("flash3_bwd"), "dist": dist("flash3_bwd"),
               "clip_dist": clip_dist("flash3_bwd")},
              [r["max_abs_err"] for r in rows
               if r["kernel"] == "flash3_bwd"],
              row_of("flash3_bwd", "image_b64"),
              "image tower, training batch 64, bfloat16, qkv "
              "[64, 257, 3072], H=16; launches: the training run"),
        entry("dw_db", "vit_project_torch/csrc/dw_db.cu",
              "vit_project_tpu/ops/fused_dw.py:41", vit("dw_db"),
              {"vit_train": vit("dw_db"), "dist": dist("dw_db")},
              [r["max_abs_err"] for r in rows if r["kernel"] == "dw_db"],
              row_of("dw_db", "fc1"),
              "ViT-B/16 step at batch 256, bfloat16, fc1: x [50432, 768], "
              "g [50432, 3072]; launches: the vit_train run"),
    ]
    for name, source, line, shape in (
            ("flash_fwd", "flash3_fwd.cu", 344, "q, k, v [256, 197, 768]"),
            ("flash_bwd", "flash3_bwd.cu", 358, "q, k, v, do [256, 197, 768]"),
            ("mha_fwd", "flash3_fwd.cu", 61, "q, k, v [256, 12, 197, 64]"),
            ("mha_bwd", "flash3_bwd.cu", 118,
             "q, k, v, do [256, 12, 197, 64]")):
        kernels.append(entry(
            name, f"vit_project_torch/csrc/{source}",
            f"vit_project_tpu/ops/attention.py:{line}", ops(name),
            {"ops": ops(name)},
            [r["max_abs_err"] for r in rows if r["kernel"] == name],
            row_of(name, "vit_b256"),
            f"ViT-B/16 width at batch 256, bfloat16, {shape}, H=12; "
            f"launches: the ops run"))
    for name, line, shape in (("ln_fwd", 44, "x [50432, 768]"),
                              ("ln_bwd", 63, "x, dy [50432, 768]")):
        kernels.append(entry(
            name, "vit_project_torch/csrc/layernorm.cu",
            f"vit_project_tpu/ops/layernorm.py:{line}", ops(name),
            {"ops": ops(name)},
            [r["max_abs_err"] for r in rows if r["kernel"] == name],
            row_of(name, "vit_b256"),
            f"ViT-B/16 residual stream at batch 256, bfloat16, {shape}, f32 "
            f"scale and bias; launches: the ops run"))
    RESULTS["kernels"] = kernels
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)), exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if phases != set(ALL_PHASES):
        print("chip_smoke: partial run (--phases); no result line", flush=True)
        return 3
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
