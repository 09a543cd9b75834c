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
4b. phase `serve_rn`: writes seeded random CLIP RN50 weights (OpenAI format,
   fp16 floats, int64 BatchNorm counters, running statistics away from 0
   and 1) and a folder of 264 JPEGs, builds the engine through
   ``cli.serve.build_clip_engine`` (``--pos_embedding auto``: off for
   RN50) and streams the folder through it at buckets 256 and 8 (12
   flash3_fwd launches a chunk, the text tower's blocks); holds the bf16
   scores against the same weights in f32 on the plain attention, and the
   f32 engine with the kernel against that plain path; shows that
   ``--pos_embedding on`` changes the scores; times images/s at 8 and 256
   and the forward at 256 from inputs on the card with its device ms by
   group (conv, gemm, attention, other) and peak memory; int8's images/s
   and error against bf16; and one bucket-8 chunk of RN50x64 (448 px, text
   width 1024, 16 heads) in f32 against its plain path;
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
   the attention backward 12 times (the forward 12 per forward), that epoch
   1 trained again from the epoch-0 checkpoint equals the uninterrupted
   run's bit for bit, and that one step with the kernel agrees with the
   same step on the plain dW+db; it times steps on a batch already on the
   card (fused and plain backward in turns, with their spread), training
   images/s with host decode, validation and peak memory;
6a. phase `moe`: the MoE ViT on one card through ``cli.vit_train``'s
   ``main`` as a user runs it (``--backbone vit_base_patch16_224
   --moe_experts 8 --fused_dw``, batch 256, bf16, lr 0.01, 2 epochs on
   phase vit_train's ImageFolder): 37 dw_db, 12 flash3_bwd and 12
   flash3_fwd launches a step (12 a validation forward), the aux loss an
   epoch, peak memory; its epoch 0 resumed trains epoch 1 again bit for
   bit; ``--moe_topk 2`` for one epoch; the share of token choices each
   MoE block drops on a validation batch; the index dispatch of block 1
   against JAX's one-hot einsum form in plain PyTorch, f32 and bf16; a
   step against the dense ViT-B/16 step in turns, and the MoE step's
   profile by kernel group;
6b. phase `vit_grid`: the measurement grid through the CLIs' ``main``, at
   ViT-B/16's full width and depth (bf16, batch 256, SGD, fused_dw off as
   the grid's CLIs run it): takes phase vit_train's seeded ImageFolder
   (writes it when that phase did not run) and writes 48 THINGS JPEGs with
   an RDM, packs the ImageFolder with ``cli.pack``, trains a
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
   tolerance of the run alone, and the RSA gathered in dataset order; and,
   in the same launch, tensor parallelism (``--tp_devices 2``, batch 64:
   each rank's 6 heads through the flash3 kernels, 12 flash3_fwd and 12
   flash3_bwd a step on each rank): the rows and checkpoint within the
   tolerance of one process on the same data, the TP block's output and
   packed qkv gradient against the same block whole on the plain
   attention, ms a step; one process resumes the tp checkpoint; and
   expert parallelism (``--moe_experts 8 --ep_devices 2``, batch 64, 4
   experts of each MoE block on each rank): the rows and checkpoint
   within the same tolerance of one process, launches and ms a step; and
   sequence parallelism (``--sp_devices 2``, batch 64, 99 + 98 of the 197
   tokens a rank): one epoch in the gather form (12 flash3_fwd and 12
   flash3_bwd a step on each rank, on the gathered sequence) and a shorter
   one with ``--sp_ring`` (no attention kernel), each within the stated
   tolerance of one process on the same data; a block of each form
   against the same block whole on the plain attention, ms a step of each
   form in turns, and the gather's bf16 gradient sum against one in f32.
   The torchrun chain at world size 1 also trains phase moe's MoE run for
   one epoch, bit-equal to its epoch 0 alone; both launches end with mesh
   serving (serve/engine.py ``mesh=``): at world size 1 the dp-meshed
   ViT-B/16 classifier engine at bucket 256 bit-equal to the engine alone
   with images/s of both in turns, and on the two gloo ranks the dp engine
   and the tp engine (``shard_params``, --tp_devices 2's layout) against
   the engine alone within a stated bf16 bound, 12 flash3_fwd a rank a
   chunk;
6f. phase `profile` (after vit_train): the step profiler as a user runs
   it, ``cli.profile.main(["--batch", "256", "--steps", "3",
   "--fused_dw"])`` in this process: 12 flash3_fwd, 12 flash3_bwd and 49
   dw_db launches a step, every bucket of its table, the table's total
   within PROFILE_TOTAL_RTOL of phase vit_train's profiled step; then
   ``--memory`` at batch 256 on the card (world size 1): the arguments
   equal to the parameter, momentum and batch bytes, and the allocator's
   peak;
6g. phase `dryrun` (after profile): the port's compile check and
   multi-rank dry run as a user calls them (cli/dryrun.py). ``entry()``
   in this process: ViT-B/16's bf16 logits of 8 images, 12 flash3_fwd
   launches, against the same call on the plain attention. Beside phases
   moe and vit_grid: ``python -m vit_project_torch.cli.dryrun 4`` (4 gloo
   ranks sharing the card and a one-process oracle: every mode's trainer
   step at tiny widths, each loss within JAX's bounds, the flash3 launches
   a rank) and ViT-B/16's FSDP2 parameters and momentum on two gloo ranks
   through the sharded checkpoint and back, bit for bit, with the bytes a
   rank wrote and the save's seconds against the gather-then-primary
   `.pth` save in turns;
6e. phase `clip_dist`: CLIP-HBA training across ranks as users launch it,
   at full width (ViT-L/14's widths with its image tower cut to
   CLIP_FIXTURE_BLOCKS of 24 blocks, rank-32 DoRA, bf16, batch 64, 2
   epochs) on THINGS at its real size on disk (the images phase sweep
   reuses, here with random targets): ``cli.baseline`` alone and under
   ``torchrun --standalone --nproc_per_node 1`` (NCCL: the data-parallel
   step at world size 1), each counting its launches from 0 (CLIP_FULL_FWD
   flash3_fwd and 1 flash3_bwd a step, CLIP_FULL_FWD an eval and an RSA),
   rows, DoRA and
   random-state pickles bit-equal; two gloo ranks sharing the card within
   the stated tolerance, one log, no file written by rank 1, peak memory a
   rank; one sequential ``cli.sweep`` run, which restores the baseline's
   AdamW state, over the two gloo ranks within that tolerance of world
   size 1; ``cli.baseline --sp_devices 2`` and ``--sp_devices 2
   --sp_ring`` over the two gloo ranks (the visual tower's 257 tokens as
   129 + 128) for one epoch of a THINGS subset with the NOD inference set,
   against the same invocation alone (rows, adapters, AdamW moments, NOD
   embeddings), and a trainer's steps of each form against the trainer
   alone (launches, s a step, the trees' differences, beside a planted
   fault the check must catch); ms a step alone
   and data-parallel in turns; ``cli.sweep --batched_forks 3
   --frozen_cache`` of runs 1, 2 under torchrun against the same
   invocation alone, bit for bit. Phases dist and clip_dist put their
   torchrun runs at world size 1 into one launch each (``--dist_worker``'s
   ``--then`` chain; the worker makes the group, the CLIs join it), since
   a process costs ~20 s to start;
7. phase `sweep`: writes THINGS at its real size to disk (1,806 training
   and 48 inference JPEGs at 224^2, whose targets are the initial model's
   own predictions) and seeded random ViT-L/14 weights (its image tower cut
   to CLIP_FIXTURE_BLOCKS blocks), and drives the
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
   invocation, and a lock-step's launches at R = 1, 2, 3 (CLIP_FULL_FWD/1
   full, 3/1 cached); it times a lock-step batch at R = 1, 2, 4, 8, cached and full
   in turns, with peak memory at R = 8, and the batched invocations
   against the sequential ones;
8. prints one JSON line of kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result. ``--json PATH`` also writes every number to PATH.
``--dist_drift [LRS]`` runs no phase: it measures how far two gloo ranks
(dp at batch 256, tp at 64) drift from one process by learning rate,
beside a one-process change that should not matter (the reason for
DIST_LR and the tp bounds). ``--sp_drift [SEEDS [REPORT]]`` runs no
phase: one epoch at batch 64 from each seed, one process, a one-process
control (``--fused_dw``) and both sp forms over two gloo ranks (the
reason for SP_MOMENTUM_RTOL). ``--dwdb_drift [STEPS]`` runs no phase
either: ViT-B/16 at batch 64 with the dW+db kernel, its f32 plain version
and the plain autograd backward, step by step from one seed (where that
change's drift comes from; ``--dwdb_drift 8 report.json`` also writes
every number to the file).
"""
from __future__ import annotations

import argparse
import dataclasses
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
ALL_PHASES = ("kernel", "ops", "serve", "train", "vit_train", "orbax",
              "profile", "dryrun", "moe",
              "vit_grid",
              "serve_vit", "serve_rn", "dist", "clip_dist", "sweep", "forks")


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
    # the CUDA kernels and the host zstd decoder (phase orbax), one
    # compiler process each, all started together
    paths = cuda_build.build([*cuda_build.SOURCES, *cuda_build.HOST_SOURCES])
    dt = time.time() - t0
    print(f"[build] {len(cuda_build.SOURCES)} kernel libraries (nvcc, "
          f"sm_90a) and {len(cuda_build.HOST_SOURCES)} host library (g++) "
          f"in {dt:.2f} s (cached builds take ~0 s)", flush=True)
    for name in paths:
        for line in cuda_build.build_log(name).splitlines():
            if "ptxas info" in line or "spill" in line:  # registers, spills
                print(f"[build] {name}: {line.strip()}")
    RESULTS["build_s"] = dt


def attention_cases():
    """(label, B, S, H, causal) at the serving path's shapes: the image
    tower at buckets 8, 32 and 256, and the 66 causal text prompts; the
    ViT-B/16 step; a ViT-B/16 RSA chunk (compute_rsa_score's batch of 8,
    72 of a grid cell's 132 forward launches); the image tower of a
    lock-step of 8 batched forks (8 x 64 rows); one rank's 6 heads of
    the ViT-B/16 step under --tp_devices 2 (phase dist, batch 64); a
    microbatch of the ViT-B/16 step under --pp_stages 2 --pp_micro 4 (phase
    dist, batch 64: 16 images); and the RN towers' text prompts (phase
    serve_rn): width 512, 8 heads (RN50, RN101) and width 1024, 16 heads
    (RN50x64)."""
    return [("image_b8", 8, 257, 16, False), ("image_b32", 32, 257, 16, False),
            ("image_b256", 256, 257, 16, False), ("text_66", 66, 77, 12, True),
            ("vit_b256", 256, 197, 12, False), ("vit_b8", 8, 197, 12, False),
            ("image_b512", 512, 257, 16, False),
            ("vit_tp2_b64", 64, 197, 6, False),
            ("vit_pp_mb16", 16, 197, 12, False),
            ("text_rn50", 66, 77, 8, True), ("text_rn50x64", 66, 77, 16, True)]


def bwd_cases():
    """(label, B, S, H, causal) of the attention backward on the training
    path: the image tower at the training batch of 64, and the 66 causal
    text prompts (reached when a text block below the last is adapted), the
    ViT-B/16 training step (batch 256, S=197, 12 heads), the image
    tower of a lock-step of 8 batched forks (8 x 64 rows), one rank's
    6 heads of the ViT-B/16 step under --tp_devices 2 (batch 64), and a
    microbatch of it under --pp_stages 2 --pp_micro 4 (16 images)."""
    return [("image_b64", 64, 257, 16, False), ("text_66", 66, 77, 12, True),
            ("vit_b256", 256, 197, 12, False),
            ("image_b512", 512, 257, 16, False),
            ("vit_tp2_b64", 64, 197, 6, False),
            ("vit_pp_mb16", 16, 197, 12, False)]


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


def _ptxas_kernels(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas -v report (cuda_build keeps it beside the library)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _ln_ptxas(report: dict, kernel: str, D: int, dtype) -> dict:
    """The ptxas entry of the LayerNorm template instance that `kernel`
    (ln_fwd / ln_bwd) runs at width D and dtype (width_config's warps a row
    and chunks a thread)."""
    import torch
    chunks = D // 8
    wpr = 1 if chunks <= 128 else 2 if chunks <= 256 else 4
    vpl = min(4, -(-chunks // 32))
    t = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    key = f"{kernel}_kernelI{t}Li{wpr}ELi{vpl}E"
    return next((v for n, v in report.items() if key in n), {})


def _ln_host_candidates(N: int = 5082, D: int = 768, calls: int = 2000):
    """Host µs a call of each candidate piece of the LayerNorm wrappers' host
    path, on the host clock over `calls` calls (nothing waits for the card):
    the stream getters, the device context, the statistics' allocation, and
    whole forward calls on 8 rows (the C entry alone, the wrapper,
    F.layer_norm), whose kernels take less than their host time."""
    import torch
    from vit_project_torch.ops import layernorm as vln
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    stats = torch.empty(2 * N, 1, device=dev)
    vec = stats[:1, 0]
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    # whole calls on 8 rows, where the card outruns the host: what the host
    # pays a call, the C entry alone (its launch included) beside the wrapper
    x8 = torch.randn(8, D, device=dev)
    w8, b8 = torch.ones(D, device=dev), torch.zeros(D, device=dev)
    y8, m8, r8 = (torch.empty_like(t) for t in vln.ln_fwd(x8, w8, b8))
    entry = vln._entry("ln_fwd")
    entry_args = (x8.data_ptr(), w8.data_ptr(), b8.data_ptr(), y8.data_ptr(),
                  m8.data_ptr(), r8.data_ptr(), 8, D, 1e-5, 0, 0,
                  vln._stream(0))

    def device_context():
        with torch.cuda.device(dev):
            pass
    cands = {
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_cuda_getCurrentRawStream": raw and (lambda: raw(0)),
        "with torch.cuda.device": device_context,
        "empty(2, N, 1).unbind(0)": lambda: torch.empty(
            2, N, 1, device=dev).unbind(0),
        "empty(2N, 1) + 2 slices": lambda: (
            lambda t: (t[:N], t[N:]))(torch.empty(2 * N, 1, device=dev)),
        "empty(2N, 1).chunk(2)": lambda: torch.empty(
            2 * N, 1, device=dev).chunk(2),
        "2 x empty(N, 1)": lambda: (torch.empty(N, 1, device=dev),
                                    torch.empty(N, 1, device=dev)),
        "2 slices of a buffer": lambda: (stats[:N], stats[N:]),
        "empty_like(x)": lambda: torch.empty_like(stats),
        "_check": lambda: vln._check("ln_fwd", stats, vec, vec),
        "ln_fwd C entry, 8 rows": lambda: entry(*entry_args),
        "ln_fwd, 8 rows": lambda: vln.ln_fwd(x8, w8, b8),
        "F.layer_norm, 8 rows": lambda: F.layer_norm(x8, (D,), w8, b8),
    }
    out = {}
    for name, fn in cands.items():
        if fn is None:
            out[name] = None
            continue
        for _ in range(50):
            fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    print("[kernel] LayerNorm host path, us a call: " + "; ".join(
        f"{n} {v:.2f}" if v is not None else f"{n} n/a"
        for n, v in out.items()), flush=True)
    return out


def phase_kernel_ln(peaks):
    """ln_fwd and ln_bwd against their plain versions at ln_cases(), in f32
    and bf16 with f32 scale and bias. The library yardstick is F.layer_norm
    on the same x, scale and bias (in x's dtype where it refuses f32
    parameters beside bf16 x; the row says which), its backward alone.
    Each row also gives host_ms (kernel_ms, CUDA events around back-to-back
    calls, less the profiler's device_ms), the device events an ln_bwd call
    makes (one kernel), the backward's partition
    (bwd_schedule, held to the C source's ln_bwd_schedule, and the blocks
    the card holds at once: the whole grid, so one cooperative launch) and
    the kernel instance's registers and spills from the build's ptxas
    report."""
    import torch
    import torch.nn.functional as F
    from vit_project_torch.ops import cuda_build
    from vit_project_torch.ops import layernorm as vln
    rows = []
    ptxas = _ptxas_kernels(cuda_build.build_log("layernorm"))
    RESULTS["kernel_ln_host_us"] = _ln_host_candidates()
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
            it = 100

            def in_turns(kernel, library):
                """(kernel ms, library ms): CUDA events around `it` calls
                each, in turns (kernel, library, library, kernel), means."""
                k1, l1 = cuda_ms(kernel, it, 10), cuda_ms(library, it, 10)
                l2, k2 = cuda_ms(library, it, 10), cuda_ms(kernel, it, 10)
                return (k1 + k2) / 2, (l1 + l2) / 2
            with torch.no_grad():
                fwd_ms, fwd_lib = in_turns(
                    lambda: vln.ln_fwd(x, scale, bias),
                    lambda: F.layer_norm(x, (D,), w, b))
                fwd_times = {
                    "ms": fwd_ms,
                    "plain_ms": cuda_ms(lambda: vln.ln_fwd_reference(
                        x, scale, bias), 5),
                    "library_ms": fwd_lib}
                bwd_times = {"plain_ms": cuda_ms(lambda: _ln_plain(
                    vln, x, scale, bias, dy), 5)}
            bwd_times["ms"], bwd_times["library_ms"] = in_turns(
                lambda: vln.ln_bwd(x, scale, mean, rstd, dy),
                lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                            retain_graph=True))
            # device time alone (torch.profiler): where a call's host work
            # outlasts its kernels, the event times above measure the host
            for times, fn in (
                    (fwd_times, lambda: vln.ln_fwd(x, scale, bias)),
                    (bwd_times, lambda: vln.ln_bwd(x, scale, mean, rstd, dy))):
                prof = _profile(fn, steps=10)
                events = prof and prof["events_per_call"]
                # the profiler may drop an event of the 10: each event's mean
                # time, times its count a call (a whole number)
                times["device_ms"] = prof and sum(
                    e["ms"] / e["calls"] * round(e["calls"])
                    for e in events.values() if e["calls"])
                times["wall_ms"] = prof and prof["wall_ms_per_call"]
                times["host_ms"] = prof and times["ms"] - times["device_ms"]
                times["device_events_per_call"] = events
            sch = vln.bwd_schedule(N, D, dtype)
            if vln.native_bwd_schedule(N, D, dtype) != sch:
                fail(f"ln_bwd {label} {dname}: the C source's schedule "
                     f"{vln.native_bwd_schedule(N, D, dtype)} is not "
                     f"bwd_schedule's {sch}")
            events = bwd_times["device_events_per_call"] or {}
            bwd_times["kernels_per_call"] = sum(
                round(v["calls"]) for e, v in events.items()
                if "Memset" not in e and "Memcpy" not in e)
            bwd_times["memsets_per_call"] = sum(
                round(v["calls"]) for e, v in events.items() if "Memset" in e)
            bwd_times["partition"] = {"blocks": sch.blocks, "rows": sch.rows,
                                      "last_rows": N - sch.rows * (
                                          sch.blocks - 1),
                                      "stages": sch.stages,
                                      "smem_bytes": sch.smem,
                                      "resident": vln.bwd_resident(D, dtype)}
            if events and (bwd_times["kernels_per_call"] != 1
                           or bwd_times["memsets_per_call"]):
                fail(f"ln_bwd {label} {dname}: {events} device events a "
                     f"call, expected one kernel")
            for kernel, times in (("ln_fwd", fwd_times), ("ln_bwd", bwd_times)):
                times["ptxas"] = _ln_ptxas(ptxas, kernel, D, dtype)
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
                      f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
                      f"host_ms {times['host_ms']} ptxas {times['ptxas']}"
                      + (f" | {times['kernels_per_call']} kernel, "
                         f"{times['memsets_per_call']} memset a call, "
                         f"partition {times['partition']}"
                         if kernel == "ln_bwd" else ""),
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


def _plain_attention(fn):
    """fn() with the packed attention op swapped for its plain version."""
    from vit_project_torch.ops import attention as vattn
    served = vattn.flash_mha_packed_qkv
    vattn.flash_mha_packed_qkv = (
        lambda qkv, *, num_heads, causal=False:
        vattn.flash_mha_packed_qkv_reference(qkv, num_heads, causal)[0])
    try:
        return fn()
    finally:
        vattn.flash_mha_packed_qkv = served


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
    plain_scores = _plain_attention(lambda: eng(x8))
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
    plain, tok_plain = _plain_attention(lambda: (eng(x8), tokens()))
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
    # process, its outputs against the live engine's on the same requests.
    # The process (imports, CUDA and the load: most of its half minute)
    # runs beside the rest of the phase and is checked at its end
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
    art_log = {k: os.path.join(tmp, f"vit_artifact.{k}")
               for k in ("out", "err")}
    with open(art_log["out"], "w") as fo, open(art_log["err"], "w") as fe:
        art_job = {"name": "from_export", "t0": time.time(),
                   "proc": subprocess.Popen(
                       [sys.executable, "-c", _FROM_EXPORT, ROOT, art,
                        req_path, out_path], cwd=ROOT, stdout=fo,
                       stderr=fe, start_new_session=True)}
    _BACKGROUND.append(art_job)
    del eng
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
    try:
        rc = art_job["proc"].wait(
            timeout=max(1.0, art_job["t0"] + 600 - time.time()))
    except subprocess.TimeoutExpired:
        rc = "still running after 600 s"
    _dist_stop(art_job)
    if rc != 0:
        with open(art_log["err"]) as f:
            fail(f"--from_export process failed ({rc}):\n{f.read()[-3000:]}")
    # its seconds: from its start to the outputs it writes last
    sub_s = os.path.getmtime(out_path) - art_job["t0"]
    with open(art_log["out"]) as f:
        sub = json.loads(f.read().strip().splitlines()[-1])
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
    del outs
    RESULTS["serve_vit"] = res
    for d in ("vit_serve_ckpt", "vit_artifact", "vit_tr"):
        shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
    return launches


# the serve_rn phase: CLIP RN50 from an OpenAI-format .pt through the CLI's
# builder, a JPEG folder streamed at buckets 256 and 8 (12 flash3_fwd a
# chunk: the text tower; the conv trunk and the attention pool have no TPU
# kernel), bf16 and f32 against f32 on the plain attention, the positions
# on against off, int8, and one RN50x64 chunk
SERVE_RN_BUCKETS = "8,256"
SERVE_RN_IMAGES = 264                   # a 256-image chunk, then an 8-image
SERVE_RN_CHUNKS = 2
# bf16 serving against the same weights in f32 on the plain attention:
# |bf16 - f32| / |f32| over the scores (Frobenius norms). Every conv output,
# BatchNorm and pool of the 16 bottlenecks is rounded to bf16 (2^-8
# relative) and the scores are the logit scale (~14.3) times cosines of the
# rounded embeddings (the CPU tests see 7.3e-3 of the largest embedding
# value through a 5-bottleneck tower, tests/test_torch_resnet.py)
SERVE_RN_BF16_RTOL = 5e-2
# f32 with the kernel against f32 on the plain attention, max |diff| of the
# scores: the two attentions differ by up to TOLERANCE["float32"]["o"] (1e-5)
# an element; through 12 text blocks, the projection and the logit scale
# that stays under 1e-4 (the conv trunk and the pool run the same calls)
SERVE_RN_F32_ATOL = 1e-4
# --pos_embedding on against off (auto, for RN50): the scores must move
SERVE_RN_POS_MIN = 1e-3


def _off_identity_bn_(visual, gen) -> None:
    """Seeded BatchNorm leaves away from identity, so that a swapped or
    ignored mean / var mapping changes the scores: scales U(0.25, 0.75)
    (the init's bn3 scale is 0, which would make each block its shortcut),
    biases N(0, 0.05), means N(0, 0.2), variances U(0.5, 2), counters 1000
    (an int64 buffer no forward reads)."""
    import torch
    with torch.no_grad():
        for m in visual.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.25, 0.75, generator=gen)
                m.bias.normal_(0.0, 0.05, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.num_batches_tracked.fill_(1000)


def _random_rn(name: str):
    """Seeded random CLIP `name` (an RN tower) on the card, f32."""
    import torch
    from vit_project_torch.models import clip as vclip
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = vclip.init_clip_weights_(
        vclip.empty_clip(vclip.CLIP_CONFIGS[name], "cuda"), gen)
    _off_identity_bn_(model.visual, gen)
    return model


def _write_jpegs(root: str, n: int, rs: np.random.RandomState) -> None:
    """n JPEGs at 256 x 320: smooth seeded colour fields plus noise."""
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        low = Image.fromarray(rs.randint(0, 256, (4, 5, 3), np.uint8))
        img = np.asarray(low.resize((320, 256), Image.BILINEAR), np.int16)
        img = np.clip(img + rs.randint(-24, 25, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, f"{i:04d}.jpg"), quality=90)


def phase_serve_rn(tmp: str):
    import torch
    from vit_project_torch.cli import serve as cli
    from vit_project_torch.models import clip as vclip
    from vit_project_torch.models import convert as vconvert
    from vit_project_torch.models import resnet as vresnet
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import quant as vquant
    from vit_project_torch.serve import clip_hba_engine

    res: dict = {}
    t0 = time.time()
    model = _random_rn("RN50")
    n_params = sum(p.numel() for p in model.parameters())
    wpath = os.path.join(tmp, "RN50-random.pt")
    torch.save({k: v.half().cpu() if v.is_floating_point() else v.cpu()
                for k, v in model.state_dict().items()}, wpath)
    del model
    jdir = os.path.join(tmp, "rn_jpegs")
    _write_jpegs(jdir, SERVE_RN_IMAGES, np.random.RandomState(SEED))
    out_csv = os.path.join(tmp, "rn_scores.csv")

    def rn_args(*extra):
        return cli.parse_args(["--clip_weights", wpath,
                               "--allow_hash_tokenizer", "--pos_embedding",
                               "auto", "--buckets", SERVE_RN_BUCKETS,
                               "--images", jdir, "--out", out_csv, *extra])
    args = rn_args()
    eng, size, norm = cli.build_clip_engine(args)
    visual = eng.model.visual
    if (not isinstance(visual, vresnet.ModifiedResNet) or size != 224
            or eng.use_pos_embedding is not False
            or visual.conv1.weight.dtype != torch.bfloat16
            or visual.bn1.num_batches_tracked.dtype != torch.int64
            or not visual.layer1[0].conv2.weight.is_contiguous(
                memory_format=torch.channels_last)):
        fail(f"RN50 engine: tower {type(visual).__name__}, {size} px, "
             f"positions {eng.use_pos_embedding}, conv weights "
             f"{visual.conv1.weight.dtype} (channels_last expected), "
             f"counters {visual.bn1.num_batches_tracked.dtype}")
    print(f"[serve_rn] RN50 engine ({n_params / 1e6:.1f}M parameters, "
          f"OpenAI-format fp16 .pt, bf16 weights, --pos_embedding auto -> "
          f"off, buckets {eng.buckets}) and {SERVE_RN_IMAGES} JPEGs built in "
          f"{time.time() - t0:.1f} s", flush=True)

    # --- the main path: counts from 0, the folder streamed, counts read ---
    paths = cli.collect_images(jdir)
    vattn.reset_launch_counts()
    t0 = time.perf_counter()
    reader = cli.batched_reader(paths, eng.buckets[-1], size, normalize=norm)
    scores = np.concatenate(list(eng.map_stream(reader, depth=args.depth)))
    stream_s = time.perf_counter() - t0
    launches = vattn.LAUNCHES["flash3_fwd"]
    cli.write_outputs(paths, scores, args)
    if launches != 12 * SERVE_RN_CHUNKS:
        fail(f"flash3_fwd launched {launches} times over {SERVE_RN_CHUNKS} "
             f"chunks, expected 12 per chunk")
    if scores.shape != (SERVE_RN_IMAGES, 66) or not np.all(
            np.isfinite(scores)):
        fail(f"bad RN50 scores: shape {scores.shape}, finite "
             f"{np.all(np.isfinite(scores))}")
    with open(out_csv) as f:
        n_rows = sum(1 for _ in f) - 1
    print(f"[serve_rn] streamed {SERVE_RN_IMAGES} JPEGs (buckets 256 and 8, "
          f"decode included) in {stream_s:.2f} s, "
          f"{SERVE_RN_IMAGES / stream_s:.1f} images/s; scores [n, 66], "
          f"finite, {n_rows} CSV rows; flash3_fwd launches {launches} = 12 "
          f"x {SERVE_RN_CHUNKS} chunks", flush=True)

    # the same weights in f32: the engine with the kernel and on the plain
    # attention; the bf16 scores against the plain f32 ones
    x = next(cli.batched_reader(paths, 256, size, normalize=norm))
    m32 = vconvert.clip_from_state_dict(
        vconvert.load_torch_state_dict(wpath), "cuda")
    feng = clip_hba_engine(m32, eng.prompt_tokens.cpu().numpy(),
                           compute_dtype=torch.float32,
                           use_pos_embedding=False,
                           buckets=eng.buckets, device="cuda")
    f_kernel = feng(x)
    f_plain = _plain_attention(lambda: feng(x))
    bf_err = _rel_norm(scores[:256], f_plain)
    f_err = float(np.abs(f_kernel - f_plain).max())
    print(f"[serve_rn] 256 images: bf16 served vs f32 plain |diff| / |f32| "
          f"{bf_err:.3e} (tol {SERVE_RN_BF16_RTOL}; max |diff| "
          f"{float(np.abs(scores[:256] - f_plain).max()):.3e}, max |score| "
          f"{float(np.abs(f_plain).max()):.3f}); f32 kernel vs f32 plain max "
          f"|diff| {f_err:.3e} (tol {SERVE_RN_F32_ATOL})", flush=True)
    if not bf_err <= SERVE_RN_BF16_RTOL:
        fail(f"bf16 RN50 scores differ from f32 plain by {bf_err}")
    if not f_err <= SERVE_RN_F32_ATOL:
        fail(f"f32 RN50 scores with the kernel differ from plain by {f_err}")
    del feng, m32
    torch.cuda.empty_cache()

    # --pos_embedding on against auto (off)
    on, _, _ = cli.build_clip_engine(rn_args("--pos_embedding", "on"))
    pos_diff = float(np.abs(on(x[:8]) - scores[:8]).max())
    print(f"[serve_rn] --pos_embedding on vs auto (off): max |score diff| "
          f"{pos_diff:.3e} over 8 images (must exceed {SERVE_RN_POS_MIN})",
          flush=True)
    if not on.use_pos_embedding or not pos_diff > SERVE_RN_POS_MIN:
        fail(f"--pos_embedding on did not change the scores ({pos_diff})")
    del on
    torch.cuda.empty_cache()

    # images/s (host arrays in, scores out), the forward from inputs on
    # the card, its device time by group, peak memory
    torch.cuda.reset_peak_memory_stats()
    ips = {}
    for b, reps in ((8, 20), (256, 5)):
        call_s = _call_s(eng, x[:b], reps)
        ips[b] = b / call_s
    with torch.inference_mode():
        xd = eng._place(x)
        fwd = _wall_ms(lambda: eng._fn(eng.model, xd), 5)
        prof = _profile(lambda: eng._fn(eng.model, xd))
        text_ms = _wall_ms(lambda: vclip.encode_text(
            eng.model, eng.prompt_tokens, compute_dtype=torch.bfloat16), 20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve_rn] bucket 8: {ips[8]:.1f} images/s; bucket 256: "
          f"{ips[256]:.1f} images/s ({256 / ips[256] * 1e3:.2f} ms a call); "
          f"forward at 256 from inputs on the card {fwd:.2f} ms (text tower "
          f"alone {text_ms:.2f} ms); peak device memory {peak:.2f} GiB",
          flush=True)
    if prof:
        print(f"[serve_rn] forward at 256, device ms by group: "
              + ", ".join(f"{g} {v:.2f}" for g, v in
                          prof["ms_per_call"].items())
              + f"; idle share {prof['idle_share']:.3f}; top other "
              f"{prof['top_other_ms']}", flush=True)

    # int8: the text tower's blocks quantize, the RN tower stays float
    qeng, _, _ = cli.build_clip_engine(rn_args("--quantize", "int8"))
    if any(vquant.is_quantized(m) for m in qeng.model.visual.modules()) or \
            not vquant.is_quantized(
                qeng.model.transformer.resblocks[0].attn.in_proj_weight):
        fail("int8 RN50: the RN tower must stay float and the text blocks "
             "quantize")
    vattn.reset_launch_counts()
    q256 = qeng(x)
    q_launches = vattn.LAUNCHES["flash3_fwd"]
    q_err = _rel_norm(q256, scores[:256])
    bf_s, q_s = _in_turns(lambda r: _call_s(eng, x, r),
                          lambda r: _call_s(qeng, x, r))
    print(f"[serve_rn] int8 (text blocks): flash3_fwd launches {q_launches}; "
          f"|int8 - bf16| / |bf16| over 256 images {q_err:.4f} (tol "
          f"{INT8_CLIP_RTOL}); bucket 256 in turns: bf16 {256 / bf_s:.1f} "
          f"images/s, int8 {256 / q_s:.1f}", flush=True)
    if q_launches != 12 or not q_err <= INT8_CLIP_RTOL:
        fail(f"int8 RN50: {q_launches} launches, error {q_err}")
    prompts = eng.prompt_tokens.cpu().numpy()   # every RN tower's context
    res.update(launches=launches, chunks=SERVE_RN_CHUNKS,
               stream_images_per_s=SERVE_RN_IMAGES / stream_s,
               bf16_vs_f32_plain_rel=bf_err, f32_kernel_vs_plain=f_err,
               pos_on_vs_off=pos_diff,
               images_per_s={str(k): v for k, v in ips.items()},
               forward_ms_256=fwd, text_tower_ms=text_ms, profile_256=prof,
               peak_mem_gib=peak, int8_vs_bf16_rel=q_err,
               images_per_s_256_in_turns={"bf16": 256 / bf_s,
                                          "int8": 256 / q_s})
    del eng, qeng, xd
    torch.cuda.empty_cache()

    # RN50x64: one bucket-8 chunk in f32, the kernel against plain
    t0 = time.time()
    m64 = _random_rn("RN50x64")
    cfg64 = m64.cfg
    e64 = clip_hba_engine(
        m64, prompts, compute_dtype=torch.float32,
        use_pos_embedding=cli.auto_use_pos_embedding(cfg64), buckets=(8,),
        device="cuda")
    x64 = np.random.RandomState(SEED).randn(
        8, cfg64.visual.image_size, cfg64.visual.image_size, 3).astype(
            np.float32)
    vattn.reset_launch_counts()
    t1 = time.perf_counter()
    s64 = e64(x64)
    chunk_s = time.perf_counter() - t1
    l64 = vattn.LAUNCHES["flash3_fwd"]
    p64 = _plain_attention(lambda: e64(x64))
    err64 = float(np.abs(s64 - p64).max())
    n64 = sum(p.numel() for p in m64.parameters())
    print(f"[serve_rn] RN50x64 ({n64 / 1e6:.1f}M parameters, "
          f"{cfg64.visual.image_size} px, text width "
          f"{cfg64.text.width}, {cfg64.text.heads} heads) f32 bucket 8: "
          f"flash3_fwd launches {l64}; kernel vs plain max |diff| "
          f"{err64:.3e} (tol {SERVE_RN_F32_ATOL}); first chunk "
          f"{chunk_s:.2f} s; phase part {time.time() - t0:.1f} s", flush=True)
    if l64 != 12 or not np.all(np.isfinite(s64)) or \
            not err64 <= SERVE_RN_F32_ATOL:
        fail(f"RN50x64: {l64} launches, kernel vs plain {err64}")
    res["rn50x64"] = {"launches": l64, "kernel_vs_plain": err64,
                      "first_chunk_s": chunk_s}
    RESULTS["serve_rn"] = res
    del e64, m64
    torch.cuda.empty_cache()
    shutil.rmtree(jdir, ignore_errors=True)
    os.remove(wpath)
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


def _resume_from_epoch0(src: str, dst: str, rows: list) -> None:
    """A run tree holding only epoch 0 of `src`: its checkpoint as latest
    (a hard link: no bytes written) and its first metrics row."""
    os.makedirs(dst)
    os.link(os.path.join(src, "checkpoint_epoch_000.pth"),
            os.path.join(dst, "checkpoint_latest.pth"))
    with open(os.path.join(dst, "training_metrics.csv"), "w") as f:
        f.write("\n".join(",".join(r) for r in rows[:2]) + "\n")


def _ckpt_trees(out: str, name: str = "checkpoint_latest.pth"):
    from vit_project_torch.ckpt import serialization as ser
    ck = ser.load(os.path.join(out, name))
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


_CONV = ("fprop", "implicit", "winograd", "convolve", "cudnn", "conv2d",
         "nhwc")


def _group_of(name: str) -> str:
    """cli.profile.bucket_of's short label, and "conv" for the cuDNN
    convolutions of the RN towers (the step profiler has no conv bucket)."""
    from vit_project_torch.cli import profile as cli_profile
    n = name.lower()
    if "dw_db" not in n and "attn_" not in n and (
            any(k in n for k in _CONV) or ("conv" in n and "convert" not in n)):
        return "conv"
    return cli_profile.bucket_of(name).split(" (")[0]


def _profile(fn, steps: int = 3):
    """Device time by kernel group over `steps` calls of `fn` (torch.profiler
    on the card, grouped as cli.profile groups it), and the device's busy
    share of the host-clock window. Returns None when the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vit_project_torch.cli import profile as cli_profile
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
    rest: dict = {}
    events: dict = {}
    for name, count, us in cli_profile.device_rows(prof.key_averages()):
        ms = us / 1e3 / steps
        e = events.setdefault(name[:80], {"calls": 0.0, "ms": 0.0})
        e["calls"] += count / steps
        e["ms"] += ms
        group = _group_of(name)
        groups[group] = groups.get(group, 0.0) + ms
        if group in ("elementwise/reduce", "copies", "other"):
            rest[name[:60]] = rest.get(name[:60], 0.0) + ms
    busy = sum(groups.values())
    if busy == 0:
        return None
    top = dict(sorted(rest.items(), key=lambda kv: -kv[1])[:6])
    return {"ms_per_call": groups, "top_other_ms": top,
            "device_ms_per_call": busy, "wall_ms_per_call": wall_ms / steps,
            "idle_share": max(0.0, 1 - busy * steps / wall_ms),
            "events_per_call": events}


def _vit_train_cfg(data: str, out: str, epochs: int):
    """Phase vit_train's run: ViT-B/16, batch 256, bf16, fused_dw."""
    from vit_project_torch.core.configs import ViTTrainConfig
    return ViTTrainConfig(data_path=data, output_dir=out, batch_size=256,
                          epochs=epochs, num_workers=8,
                          compute_dtype="bfloat16", fused_dw=True,
                          random_seed=SEED)


def phase_vit_train(tmp: str, keep_run: bool = False):
    """Returns the launches of the main path's run (run A); with
    `keep_run` run A's output directory stays for phase orbax."""
    import logging
    import torch
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
        return _vit_train_cfg(data, out, epochs)
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

    # run A's epoch 0 resumed: epoch 1 trained again equals run A's
    out_b = os.path.join(tmp, "vit_b")
    _resume_from_epoch0(out_a, out_b, rows)
    vit_loop.run_vit_training(cfg(out_b, 2), logger=logger, vit_cfg=vit_cfg,
                              device="cuda")
    rows_b = _read_rows(os.path.join(out_b, "training_metrics.csv"))
    pa, ma = _ckpt_trees(out_a)
    pb, mb = _ckpt_trees(out_b)
    resume_exact = (rows_b == rows and _trees_equal(pa, pb)
                    and _trees_equal(ma, mb))
    print(f"[vit_train] epoch 0 resumed, epoch 1 trained again: rows, "
          f"parameters and momentum "
          f"{'bit-exact' if resume_exact else 'DIFFER'}", flush=True)
    if not resume_exact:
        fail(f"resumed run differs: rows {rows_b} vs {rows}")
    del pa, ma, pb, mb
    shutil.rmtree(out_b)

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
    if not keep_run:
        shutil.rmtree(out_a)
    del res, model, momentum, trainer, p0, m0
    torch.cuda.empty_cache()
    return launches

# the orbax phase: phase vit_train's run A (ViT-B/16, batch 256, bf16,
# fused_dw) at epoch 1, written by the port's single-process writer of the
# JAX package's pod-sharded layout (ckpt/orbax.py write_tree) and read back
# through vit_ckpt as a resume reads it; one more epoch resumed from the
# .orbax and from the .pth in turn, each in its own directory. A step
# launches what a vit_train step launches
ORBAX_PER_STEP = {"flash3_fwd": 12, "flash3_bwd": 12, "dw_db": 49}
ORBAX_VAL_FWD = 12             # the validation forward's, one batch of 256
ORBAX_PHASE_LIMIT_S = 60


def _du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _same_leaves(a, b, where="") -> list:
    """Where two trees differ: containers and keys, Python scalar types and
    values, array dtypes, shapes and bits."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [where or "/"]
        return [w for k in a for w in _same_leaves(a[k], b[k],
                                                   f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return [where]
        return [w for i, (x, y) in enumerate(zip(a, b))
                for w in _same_leaves(x, y, f"{where}/{i}")]
    if a is None or isinstance(a, (bool, int, float)):
        return [] if type(a) is type(b) and a == b else [where]
    x, y = np.asarray(a), np.asarray(b)
    same = (x.dtype == y.dtype and x.shape == y.shape
            and x.tobytes() == y.tobytes())
    return [] if same else [where]


def _orbax_fixture(smi: str, device: str = "cuda") -> dict:
    """The committed JAX-written tiny ViT .orbax (tests/data/jax_vit_orbax:
    level-1 zstd chunks and zstd-compressed B-tree nodes, which write_tree
    does not make) read through vit_ckpt on this host: every leaf's digest
    against leaves.json, the decoder's Huffman, FSE and sequence forms
    reached, and its bfloat16 momentum through the resume's load_trees onto
    the card."""
    import torch
    from vit_project_torch.ckpt import orbax, vit_ckpt, zstd
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.train import vit_loop

    fx = os.path.join(ROOT, "tests", "data", "jax_vit_orbax")
    with open(os.path.join(fx, "leaves.json")) as f:
        want = json.load(f)
    zstd.take_stats()
    t0 = time.time()
    tree = vit_ckpt.load_checkpoint(vit_ckpt.latest_checkpoint(fx))
    read_s = time.time() - t0
    met = zstd.take_stats()
    got = orbax.leaf_digests(tree)
    differ = sorted(k for k in want["leaves"].keys() | got.keys()
                    if want["leaves"].get(k) != got.get(k))
    unmet = [k for k in want["forms"] if not met[k]]
    cfg = vvit.ViTConfig(**want["vit"])
    model = vvit.empty_vit(cfg, device)
    mom = {n: torch.empty_like(p) for n, p in model.named_parameters()}
    vit_loop.load_trees(model, tree["params"], mom, tree["opt_state"])
    head_m = tree["opt_state"]["head_w"]
    loaded = isinstance(head_m, torch.Tensor) and \
        head_m.dtype == torch.bfloat16 and torch.equal(
        mom["head.weight"].cpu(), head_m.float().T) and np.array_equal(
        model.head.weight.detach().cpu().numpy(),
        np.asarray(tree["params"]["head_w"]).T)
    same = "match leaves.json" if not differ else f"DIFFER {differ[:5]}"
    print(f"[orbax] JAX-written tiny ViT fixture: load_checkpoint "
          f"{read_s:.3f} s, {len(got)} leaves {same}; decoder forms met {({k: met[k] for k in want['forms']})}; "
          f"bfloat16 momentum through load_trees onto the card "
          f"{'equal' if loaded else 'DIFFERS'}; {smi}", flush=True)
    if differ or unmet or not loaded:
        fail(f"the JAX-written fixture read wrong: leaves {differ[:10]}, "
             f"forms not met {unmet}, load_trees equal {loaded}")
    del model, mom
    return {"read_s": read_s, "leaves": len(got), "forms": met}


def phase_orbax(tmp: str):
    import logging
    import torch
    from vit_project_torch.ckpt import orbax
    from vit_project_torch.ckpt import serialization as ser
    from vit_project_torch.ckpt import vit_ckpt
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.train import vit_loop

    t_phase = time.time()
    smi = smi_line()
    data, run_a = os.path.join(tmp, "imagenet"), os.path.join(tmp, "vit_a")
    pth = os.path.join(run_a, "checkpoint_epoch_001.pth")
    if not os.path.exists(pth):
        fail("phase orbax needs phase vit_train's run A (--phases "
             "vit_train,orbax)")
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    logger = logging.getLogger("chip_smoke.orbax")
    logger.setLevel(logging.WARNING)
    fixture = _orbax_fixture(smi)
    ck = ser.load(pth)
    pth_mb = os.path.getsize(pth) / 1e6

    # the write, as the JAX package lays out an epoch (the epoch directory
    # and the pointer 'latest' names), and the read as a resume reads it
    out_o, out_p = (os.path.join(tmp, n) for n in ("orbax_o", "orbax_p"))
    os.makedirs(out_o)
    opath = os.path.join(out_o, "checkpoint_epoch_001.orbax")
    t0 = time.time()
    orbax.write_tree(opath, ck)
    write_s = time.time() - t0
    with open(os.path.join(out_o, "checkpoint_latest.orbax.ptr"), "w") as f:
        f.write(os.path.basename(opath))
    disk_mb = _du(opath) / 1e6
    latest = vit_ckpt.latest_checkpoint(out_o)
    if latest != opath:
        fail(f"latest_checkpoint resolved {latest}, expected {opath}")
    t0 = time.time()
    back = vit_ckpt.load_checkpoint(latest)
    read_s = time.time() - t0
    differ = _same_leaves(back, ck)
    print(f"[orbax] ViT-B/16 epoch-1 state (params, momentum, scheduler, "
          f"metrics): write_tree {write_s:.2f} s ({disk_mb / write_s:.0f} "
          f"MB/s), load_checkpoint of the .orbax {read_s:.2f} s "
          f"({disk_mb / read_s:.0f} MB/s; Raw-block frames, not JAX's "
          f"level-1 chunks); {disk_mb:.1f} MB on disk against "
          f"the .pth's {pth_mb:.1f} MB; read back against the .pth: "
          f"{'every leaf bit-equal' if not differ else differ[:5]}; {smi}",
          flush=True)
    if differ:
        fail(f"the .orbax read back differs from the .pth at {differ[:10]}")
    del back, ck

    # one more epoch from each, rows and trees compared
    with open(os.path.join(run_a, "training_metrics.csv")) as f:
        rows_a = f.read()
    os.makedirs(out_p)
    os.link(pth, os.path.join(out_p, "checkpoint_latest.pth"))
    for out in (out_o, out_p):
        with open(os.path.join(out, "training_metrics.csv"), "w") as f:
            f.write(rows_a)
    stats = []
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    t0 = time.time()
    vit_loop.run_vit_training(_vit_train_cfg(data, out_o, 3), logger=logger,
                              vit_cfg=vit_cfg, device="cuda",
                              on_epoch=stats.append)
    torch.cuda.synchronize()
    resume_s = time.time() - t0
    launches = {**vattn.LAUNCHES, **vfdw.LAUNCHES}
    vit_loop.run_vit_training(_vit_train_cfg(data, out_p, 3), logger=logger,
                              vit_cfg=vit_cfg, device="cuda")
    steps = sum(e["steps"] for e in stats)
    want = {k: v * steps for k, v in ORBAX_PER_STEP.items()}
    want["flash3_fwd"] += ORBAX_VAL_FWD
    if [e["epoch"] for e in stats] != [2] or any(
            launches[k] != v for k, v in want.items()):
        fail(f"the resume from the .orbax trained epochs "
             f"{[e['epoch'] for e in stats]} with launches {launches}, "
             f"expected epoch 2 and {want}")
    rows_o, rows_p = (_read_rows(os.path.join(o, "training_metrics.csv"))
                      for o in (out_o, out_p))
    if [r[0] for r in rows_o[1:]] != ["0", "1", "2"]:
        fail(f"expected rows for epochs 0-2 after the resume, got {rows_o}")
    po, mo = _ckpt_trees(out_o)
    pp, mp = _ckpt_trees(out_p)
    exact = (rows_o == rows_p and not _same_leaves(po, pp)
             and not _same_leaves(mo, mp))
    e = stats[0]
    print(f"[orbax] epoch 2 resumed from the .orbax: {steps} steps, "
          f"{resume_s:.2f} s in all (epoch {e['epoch_s']:.2f} s, training "
          f"{e['train_s']:.2f} s); launches dw_db {launches['dw_db']}, "
          f"flash3_bwd {launches['flash3_bwd']}, flash3_fwd "
          f"{launches['flash3_fwd']}; against the resume from the .pth: "
          f"rows, parameters and momentum "
          f"{'bit-exact' if exact else 'DIFFER'} (row "
          f"{','.join(rows_o[-1])}); {smi}", flush=True)
    if not exact:
        fail(f"the resumes differ: rows {rows_o} vs {rows_p}")
    del po, mo, pp, mp
    for out in (out_o, out_p, run_a):
        shutil.rmtree(out)
    phase_s = time.time() - t_phase
    print(f"[orbax] phase {phase_s:.1f} s (limit {ORBAX_PHASE_LIMIT_S} s); "
          f"{smi}", flush=True)
    RESULTS["orbax"] = {
        "write_s": write_s, "read_s": read_s, "disk_mb": disk_mb,
        "pth_mb": pth_mb, "write_mb_per_s": disk_mb / write_s,
        "read_mb_per_s": disk_mb / read_s, "resume_s": resume_s,
        "epoch": e, "launches": launches, "resume_bit_exact": exact,
        "fixture": fixture, "phase_s": phase_s, "card": smi}
    if phase_s > ORBAX_PHASE_LIMIT_S:
        fail(f"phase orbax took {phase_s:.1f} s, above its "
             f"{ORBAX_PHASE_LIMIT_S} s")
    torch.cuda.empty_cache()
    return launches


# the profile phase: the step profiler (cli/profile.py) as a user runs it,
# at ViT-B/16 batch 256, bf16, --fused_dw, PROFILE_STEPS traced steps after
# its warm-up step. Its table's total against phase vit_train's profiled
# step (the same step on another batch of the same size) within
# PROFILE_TOTAL_RTOL
PROFILE_STEPS = 3
PROFILE_PER_STEP = {"flash3_fwd": 12, "flash3_bwd": 12, "dw_db": 49}
PROFILE_TOTAL_RTOL = 0.15


def phase_profile(tmp: str):
    """``python -m vit_project_torch.cli.profile --batch 256 --steps 3
    --fused_dw`` in this process (``main``), then ``--memory`` at the same
    batch (world size 1). Checks the kernels' launches a step, every
    bucket, the total against phase vit_train's profiled step, and the
    memory rows: arguments equal to the parameters, momentum and batch
    bytes counted here, a peak above them."""
    import contextlib
    import torch
    from vit_project_torch.cli import profile as cli_profile
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw

    t0 = time.time()
    raw = os.path.join(tmp, "profile_raw.json")
    argv = ["--batch", "256", "--steps", str(PROFILE_STEPS), "--fused_dw",
            "--raw", raw]
    out = io.StringIO()
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = cli_profile.main(argv)
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**vattn.LAUNCHES, **vfdw.LAUNCHES}.items()
                if k in PROFILE_PER_STEP}
    trace_s = time.time() - t0
    for line in out.getvalue().splitlines():
        print(f"[profile] {line}", flush=True)
    with open(raw) as f:
        rows = [(r["name"], r["count"], r["self_device_us"])
                for r in json.load(f)]
    table, _ = cli_profile.summarize(rows, PROFILE_STEPS)
    total = sum(v["ms"] for v in table.values())
    # the CLI's warm-up step and its traced steps
    want = {k: v * (PROFILE_STEPS + 1) for k, v in PROFILE_PER_STEP.items()}
    if rc != 0 or launches != want:
        fail(f"[profile] rc {rc}, launches {launches}, want {want}")
    if any(v["ms"] < 0 for v in table.values()) or not total > 0:
        fail(f"[profile] buckets {table}")
    by_bucket = {b.split(" (")[0]: v["ms"] for b, v in table.items()}
    other = sorted(((us / 1e3 / PROFILE_STEPS, n) for n, _, us in rows
                    if cli_profile.bucket_of(n) == cli_profile.BUCKETS[6]),
                   reverse=True)[:4]
    ref = (RESULTS.get("vit_train") or {}).get("profile")
    rel = None
    if ref is not None:
        rel = total / ref["device_ms_per_call"] - 1
        print(f"[profile] table total {total:.2f} device ms a step against "
              f"phase vit_train's profiled step {ref['device_ms_per_call']:.2f}"
              f": {rel:+.3%} (bound {PROFILE_TOTAL_RTOL:.0%})", flush=True)
        if not abs(rel) <= PROFILE_TOTAL_RTOL:
            fail(f"[profile] total {total} against {ref}")
    else:
        print("[profile] total not compared: phase vit_train did not run",
              flush=True)
    print(f"[profile] launches over {PROFILE_STEPS + 1} steps (the warm-up "
          f"and the traced): " + ", ".join(f"{k} {v}" for k, v in
                                           launches.items())
          + "; largest of 'other': " + ("; ".join(
              f"{n[:70]} {ms:.3f}" for ms, n in other) or "none")
          + f"; {trace_s:.1f} s", flush=True)

    # --memory on the card: one real step of the dp trainer, world size 1
    torch.cuda.empty_cache()
    t1 = time.time()
    raw_mem = os.path.join(tmp, "profile_memory.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_profile.main(["--memory", "--batch", "256", "--raw",
                               raw_mem])
    for line in out.getvalue().splitlines():
        print(f"[profile] {line}", flush=True)
    with open(raw_mem) as f:
        mem = json.load(f)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in vvit.VisionTransformerClassifier(
            vvit.VIT_CONFIGS["vit_base_patch16_224"]).parameters())
    want_args = 2 * 4 * n_params + 256 * (224 * 224 * 3 + 8)
    print(f"[profile] --memory: arguments {mem['arguments']:,} bytes "
          f"(parameters and momentum 2 x 4 x {n_params:,}, batch 256 uint8 "
          f"images and int64 labels: {want_args:,}); peak allocated "
          f"{mem['peak_allocated'] / 2**30:.3f} GiB, reserved "
          f"{mem['peak_reserved'] / 2**30:.3f} GiB; {time.time() - t1:.1f} s"
          f"; {smi_line()}", flush=True)
    if rc != 0 or mem["n_ranks"] != 1 or mem["arguments"] != want_args or \
            not mem["peak_allocated"] > want_args:
        fail(f"[profile] --memory {mem}, want arguments {want_args}")
    RESULTS["profile"] = {"launches": launches, "table": table,
                          "by_bucket_ms": by_bucket, "total_ms": total,
                          "against_vit_train": rel, "top_other": other,
                          "trace_s": trace_s, "memory": mem}
    torch.cuda.empty_cache()
    return launches


# the MoE phase: ViT-B/16 with 8 experts in every other block (6 MoE
# blocks), on phase vit_train's ImageFolder at batch 256, lr DIST_LR (the
# rate where this set trains stably; see phase dist)
MOE_EXPERTS = 8
MOE_EPOCHS = 2
MOE_STEPS = 4 * MOE_EPOCHS
MOE_BLOCKS = 6
# a step's launches under --fused_dw: dW+db for qkv and proj of every
# block, fc1 and fc2 of the 6 dense ones, and the head (the expert FFNs are
# batched products); the attention pair in all 12 blocks
MOE_PER_STEP = {"dw_db": 4 * 6 + 2 * MOE_BLOCKS + 1, "flash3_bwd": 12,
                "flash3_fwd": 12}
# the index dispatch (ops/moe.py) against the one-hot einsum oracle at one
# MoE block (the trained block 1, x [64, 197, 768]): max |err| over the
# largest |value| of the oracle's y and dx. Both compute the same products:
# in float32 they differ by summation order (1e-5); in bfloat16 the expert
# FFNs' GEMMs may round an element of h and of y one bf16 spacing apart
# (2^-8 of the element each), so 2^-6 of the largest value. aux: the same
# f32 sums, 1e-5 relative
MOE_ORACLE_BATCH = 64
MOE_ORACLE_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
MOE_TIMED_STEPS = 5


def _moe_oracle(x, moe, act, capacity_factor, topk=1):
    """JAX's one-hot einsum form of the MoE FFN in plain PyTorch: [T, E, C]
    dispatch and combine one-hots (never called by the port)."""
    import torch
    import torch.nn.functional as F
    from vit_project_torch.ops import moe as vmoe
    B, S, D = x.shape
    T, E = B * S, moe.router_w.shape[1]
    C = vmoe.expert_capacity(T, E, capacity_factor * topk)
    xt = x.reshape(T, D)
    logits = xt.float() @ moe.router_w.float()
    probs = torch.softmax(logits, -1)
    e1 = probs.argmax(-1)
    gate = probs.gather(1, e1[:, None])[:, 0]
    oh = F.one_hot(e1, E).float()
    pos = torch.cumsum(oh, 0) * oh - 1
    keep = oh * (pos < C)
    pos_oh = F.one_hot(pos.max(-1).values.long().clamp(0, C - 1), C).float()
    dispatch = keep[:, :, None] * pos_oh[:, None, :]
    combine = dispatch * gate[:, None, None]
    dt = x.dtype
    xe = torch.einsum("tec,td->ecd", dispatch.to(dt), xt)
    h = act(torch.einsum("ecd,edh->ech", xe, moe.fc1_w.to(dt))
            + moe.fc1_b[:, None, :].to(dt))
    ye = (torch.einsum("ech,ehd->ecd", h, moe.fc2_w.to(dt))
          + moe.fc2_b[:, None, :].to(dt))
    y = torch.einsum("tec,ecd->td", combine.to(dt), ye)
    aux = E * (oh.mean(0) * probs.mean(0)).sum()
    return y.reshape(B, S, D), aux


def _moe_oracle_check(model) -> dict:
    """The index dispatch against `_moe_oracle` on block 1 of `model`
    (its trained router and experts, in f32), in f32 and bf16, on the same
    seeded input and output gradient: y, aux and dx."""
    import torch
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import moe as vmoe
    moe = model.blocks[1].moe
    act = vvit._activation(model.cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x0 = torch.randn(MOE_ORACLE_BATCH, 197, model.cfg.width, generator=gen,
                     device="cuda")
    dy0 = torch.randn(x0.shape, generator=gen, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        res = []
        for fn in (lambda x: vmoe.moe_mlp(x, moe, act=act),
                   lambda x: _moe_oracle(x, moe, act, 1.25)):
            x = x0.to(dtype).requires_grad_()
            y, aux = fn(x)
            (dx,) = torch.autograd.grad(y, x, dy0.to(dtype))
            res.append((y.float(), aux.item(), dx.float()))
            del x, y, dx
        (y, aux, dx), (ry, raux, rdx) = res
        err = {"y": ((y - ry).abs().max() / ry.abs().max()).item(),
               "dx": ((dx - rdx).abs().max() / rdx.abs().max()).item(),
               "aux": abs(aux / raux - 1)}
        out[dname] = err
        if not (err["y"] <= MOE_ORACLE_TOL[dname]
                and err["dx"] <= MOE_ORACLE_TOL[dname]
                and err["aux"] <= 1e-5):
            fail(f"[moe] index dispatch against the one-hot oracle, {dname}: "
                 f"{err} (tolerance {MOE_ORACLE_TOL[dname]})")
        del res
        torch.cuda.empty_cache()
    return out


def _moe_recorders():
    """Wrap ops.moe's route and moe_mlp (module globals, so the model's
    calls see the wrappers): every call's dropped share of its token
    choices, and the aux of each training forward's MoE layer (grad
    enabled), kept on the device. Returns (records, restore)."""
    import torch
    from vit_project_torch.ops import moe as vmoe
    route, moe_mlp = vmoe.route, vmoe.moe_mlp
    rec = {"dropped": [], "aux": []}

    def recording_route(*a, **k):
        r = route(*a, **k)
        rec["dropped"].append((r.slots < 0).float().mean().detach())
        return r

    def recording_moe(*a, **k):
        y, aux = moe_mlp(*a, **k)
        if torch.is_grad_enabled():
            rec["aux"].append(aux.detach())
        return y, aux
    vmoe.route, vmoe.moe_mlp = recording_route, recording_moe

    def restore():
        vmoe.route, vmoe.moe_mlp = route, moe_mlp
    return rec, restore


def _moe_drop_shares(model, images) -> list:
    """The dropped share of each MoE block's token choices in one forward
    of `images` (raw uint8 on the card) through `model`."""
    import torch
    from vit_project_torch.train.vit_loop import IMAGENET_NORM
    rec, restore = _moe_recorders()
    try:
        with torch.no_grad():
            model(images, input_norm=IMAGENET_NORM,
                  compute_dtype=torch.bfloat16)
    finally:
        restore()
    return [float(d) for d in rec["dropped"]]


def _moe_args(data: str) -> list:
    """cli.vit_train's flags of phase moe's main run (but --epochs and
    --output_dir)."""
    return ["--data_path", data, "--backbone", "vit_base_patch16_224",
            "--moe_experts", str(MOE_EXPERTS), "--fused_dw", "--batch_size",
            "256", "--num_workers", "8", "--lr", DIST_LR, "--random_seed",
            str(SEED)]


def phase_moe(tmp: str):
    """The MoE ViT on one card through cli.vit_train's main (module
    docstring, 6a)."""
    import logging
    import torch
    from vit_project_torch.cli import vit_train as train_cli
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.data.packed import make_loader
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.train import vit_loop

    t_phase = time.time()
    root = os.path.join(tmp, "moe")
    os.makedirs(root)
    data = os.path.join(tmp, "imagenet")
    if not os.path.isdir(data):        # phase vit_train's, when it ran
        _write_image_folder(data, np.random.RandomState(SEED))
    args = _moe_args(data)
    print(f"[moe] ViT-B/16 with {MOE_EXPERTS} experts in blocks 1, 3, ..., "
          f"11 (top-1, capacity factor 1.25, aux weight 0.01), batch 256, "
          f"bf16, SGD lr {DIST_LR}, fused_dw, vit_train's ImageFolder",
          flush=True)

    # --- the main path: counts from 0, two epochs through the CLI, counts
    # read; the aux of every training forward recorded on the way ---
    out_a = os.path.join(root, "moe_a")
    rec, restore = _moe_recorders()
    torch.cuda.reset_peak_memory_stats()
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    try:
        _, _, run_s = _cli(train_cli.main, args + [
            "--epochs", str(MOE_EPOCHS), "--output_dir", out_a],
            os.path.join(root, "moe_a.log"))
        torch.cuda.synchronize()
    finally:
        restore()
    launches = {**vattn.LAUNCHES, **vfdw.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * MOE_STEPS for k, v in MOE_PER_STEP.items()}
    want["flash3_fwd"] += 12 * MOE_EPOCHS          # one validation batch
    if {k: launches[k] for k in want} != want:
        fail(f"[moe] launches {launches}, expected {want}")
    aux = torch.stack(rec["aux"]).view(MOE_EPOCHS, -1, MOE_BLOCKS)
    aux_epoch = aux.sum(-1).mean(-1).tolist()         # a step's sum of 6
    rows = _read_rows(os.path.join(out_a, "training_metrics.csv"))
    if [r[0] for r in rows[1:]] != [str(e) for e in range(MOE_EPOCHS)] or \
            not all(np.isfinite([float(v) for r in rows[1:] for v in r[1:]])):
        fail(f"[moe] rows {rows}")
    print(f"[moe] {MOE_EPOCHS} epochs ({MOE_STEPS} steps) in {run_s:.1f} s; "
          f"launches dw_db {launches['dw_db']} ({MOE_PER_STEP['dw_db']} a "
          f"step), flash3_bwd {launches['flash3_bwd']} (12), flash3_fwd "
          f"{launches['flash3_fwd']} (12 a forward); peak {peak_gib:.2f} GiB; "
          f"aux (a step's sum over the 6 MoE blocks, mean an epoch) "
          + ", ".join(f"{a:.4f}" for a in aux_epoch) + "; rows "
          + "; ".join(",".join(r) for r in rows[1:]), flush=True)

    # --- its epoch 0 resumed: epoch 1 again from the same state, bit for
    # bit (the same computation twice, and the resume) ---
    out_b = os.path.join(root, "moe_b")
    _resume_from_epoch0(out_a, out_b, rows)
    _cli(train_cli.main, args + ["--epochs", str(MOE_EPOCHS), "--output_dir",
                                 out_b], os.path.join(root, "moe_b.log"))
    rows_b = _read_rows(os.path.join(out_b, "training_metrics.csv"))
    exact = rows_b == rows and all(
        _trees_equal(a, b) for a, b in zip(_ckpt_trees(out_a),
                                           _ckpt_trees(out_b)))
    print(f"[moe] epoch 0 resumed, epoch 1 trained again: rows, parameters "
          f"and momentum {'bit-exact' if exact else 'DIFFER'}", flush=True)
    if not exact:
        fail(f"[moe] resumed run differs: {rows_b} vs {rows}")
    shutil.rmtree(out_b)

    # --- top-2 at a smaller depth: one epoch from the same seed through
    # the trainer's epoch loop and validation (cli.vit_train's epoch
    # without the checkpoint: a MoE checkpoint is 2.3 GB of disk) ---
    dev = torch.device("cuda")
    vit_cfg = dataclasses.replace(vvit.VIT_CONFIGS["vit_base_patch16_224"],
                                  moe_experts=MOE_EXPERTS)
    cfg2 = dataclasses.replace(vit_cfg, moe_topk=2)
    quiet = logging.getLogger("chip_smoke.moe")
    quiet.setLevel(logging.WARNING)
    models = {"top2": vvit.init_vit_params(
        vvit.empty_vit(cfg2, dev),
        torch.Generator(device=dev).manual_seed(SEED))}
    tr2 = vit_loop.ViTTrainer(cfg2, ViTTrainConfig(
        batch_size=256, compute_dtype="bfloat16", fused_dw=True,
        moe_experts=MOE_EXPERTS, moe_topk=2), models["top2"], dev)
    val = make_loader(os.path.join(data, "val"), 256, train=False, size=224,
                      workers=8)
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    t0 = time.time()
    row2 = [tr2.train_one_epoch(tr2.init_momentum(), make_loader(
        os.path.join(data, "train"), 256, train=True, seed=SEED, size=224,
        workers=8, drop_last=True), 0, float(DIST_LR), logger=quiet),
        *tr2.validate(val, logger=quiet)]
    torch.cuda.synchronize()
    top2_s = time.time() - t0
    launches2 = {**vattn.LAUNCHES, **vfdw.LAUNCHES}
    want2 = {k: v * MOE_STEPS // MOE_EPOCHS for k, v in MOE_PER_STEP.items()}
    want2["flash3_fwd"] += 12
    if {k: launches2[k] for k in want2} != want2 or \
            not all(np.isfinite(row2)):
        fail(f"[moe] top-2: launches {launches2} (want {want2}), row {row2}")
    del tr2

    # --- the trained models: dropped shares, the oracle, a step in turns
    # against the dense step, the step's profile ---
    models["top1"] = vvit.empty_vit(vit_cfg, dev)
    vit_loop.load_trees(models["top1"], _ckpt_trees(out_a)[0])
    trainer = vit_loop.ViTTrainer(vit_cfg, ViTTrainConfig(
        batch_size=256, compute_dtype="bfloat16", fused_dw=True,
        moe_experts=MOE_EXPERTS), models["top1"], dev)
    imgs, lbls = trainer.place(*next(iter(val.epoch(0))))
    drops = {k: _moe_drop_shares(m, imgs) for k, m in models.items()}
    del models["top2"]
    oracle = _moe_oracle_check(models["top1"])
    print(f"[moe] top-2, 1 epoch (the trainer's epoch loop and validation, "
          f"no checkpoint): {top2_s:.1f} s, launches "
          + ", ".join(f"{k} {launches2[k]}" for k in sorted(want2))
          + ", train loss, val loss, val accuracy "
          + ", ".join(f"{v:.6f}" for v in row2)
          + "; dropped share of the token "
          f"choices a MoE block (blocks 1, 3, ..., 11; a validation batch "
          f"of 256 after training): top-1 "
          + ", ".join(f"{d:.4f}" for d in drops["top1"]) + "; top-2 "
          + ", ".join(f"{d:.4f}" for d in drops["top2"])
          + "; index dispatch against the one-hot einsum at block 1, "
          f"x [{MOE_ORACLE_BATCH}, 197, 768]: "
          + "; ".join(f"{d} y {e['y']:.2e} dx {e['dx']:.2e} aux "
                      f"{e['aux']:.1e} (tolerance {MOE_ORACLE_TOL[d]:.1e})"
                      for d, e in oracle.items()), flush=True)

    dense_model = vvit.init_vit_params(
        vvit.empty_vit(vvit.VIT_CONFIGS["vit_base_patch16_224"], dev),
        torch.Generator(device=dev).manual_seed(SEED))
    dense = vit_loop.ViTTrainer(dense_model.cfg, ViTTrainConfig(
        batch_size=256, compute_dtype="bfloat16", fused_dw=True),
        dense_model, dev)
    moms = {"moe": trainer.init_momentum(), "dense": dense.init_momentum()}
    trainers = {"moe": trainer, "dense": dense}
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    trainer.step(moms["moe"], imgs, lbls, 0.01)
    torch.cuda.synchronize()
    per_step = {**vattn.LAUNCHES, **vfdw.LAUNCHES}
    if {k: per_step[k] for k in MOE_PER_STEP} != MOE_PER_STEP:
        fail(f"[moe] a step launched {per_step}, want {MOE_PER_STEP}")

    def turn(name):
        tr, mom = trainers[name], moms[name]
        tr.step(mom, imgs, lbls, 0.01)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(MOE_TIMED_STEPS + 1)]
        ev[0].record()
        for i in range(MOE_TIMED_STEPS):
            tr.step(mom, imgs, lbls, 0.01)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1])
                for i in range(MOE_TIMED_STEPS)]
    turns = {"moe": [], "dense": []}
    for name in ("moe", "dense", "dense", "moe"):
        turns[name].append(turn(name))
    step_ms = {k: statistics.mean(x for t in v for x in t)
               for k, v in turns.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prof = _profile(lambda: trainer.step(moms["moe"], imgs, lbls, 0.01))
    print("[moe] a step's launches "
          + ", ".join(f"{k} {per_step[k]}" for k in sorted(MOE_PER_STEP))
          + "; "
          f"device ms a step in turns (moe, dense, dense, moe; "
          f"{MOE_TIMED_STEPS} steps each): "
          + "; ".join(f"{k} {step_ms[k]:.2f} (turns "
                      + ", ".join(f"{statistics.mean(t):.2f}" for t in v)
                      + ")" for k, v in turns.items())
          + (" ; profiler: no device time seen (not measured)" if prof is None
             else "; profiled MoE step (device ms a step): "
             + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                 prof["ms_per_call"].items()))
             + f"; busy {prof['device_ms_per_call']:.2f} of "
             f"{prof['wall_ms_per_call']:.2f} ms (idle share "
             f"{prof['idle_share']:.3f}); largest of the rest: "
             + "; ".join(f"{k} {v:.2f}" for k, v in
                         prof["top_other_ms"].items()))
          + f"; {smi_line()}", flush=True)
    RESULTS["moe"] = {
        "run_s": run_s, "launches": launches, "peak_gib": peak_gib,
        "aux_per_epoch": aux_epoch, "rows": rows[1:], "resume_exact": exact,
        "top2_s": top2_s, "top2_launches": launches2, "top2_row": row2,
        "dropped": drops, "oracle": oracle, "per_step": per_step,
        "turns": turns, "step_ms": step_ms, "profile": prof,
        "seconds": time.time() - t_phase}
    print(f"[moe] phase {time.time() - t_phase:.1f} s", flush=True)
    for name in ("checkpoint_epoch_001.pth", "checkpoint_latest.pth"):
        os.unlink(os.path.join(out_a, name))   # epoch 0 stays for phase dist
    del trainer, dense, trainers, moms, models, dense_model
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


# the CLIP fixture of phases clip_dist, sweep and forks: ViT-L/14's widths,
# text tower and adapted blocks (the last 2 image blocks, the last text
# block), with its image tower cut from 24 blocks to CLIP_FIXTURE_BLOCKS so
# that the CLIs' many invocations load and run half of it (the script's time
# limit); a full-tower forward launches flash3_fwd CLIP_FULL_FWD times
CLIP_FIXTURE_BLOCKS = 12
CLIP_FULL_FWD = CLIP_FIXTURE_BLOCKS + 12

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
    """THINGS at its real size on disk and seeded random ViT-L/14 weights
    (CLIP_FIXTURE_BLOCKS image blocks), written once and shared by phases
    clip_dist and sweep: the weights in
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
    cfg = dataclasses.replace(vclip.CLIP_VIT_L14, visual=dataclasses.replace(
        vclip.CLIP_VIT_L14.visual, layers=CLIP_FIXTURE_BLOCKS))
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
          f" and ViT-L/14 weights ({CLIP_FIXTURE_BLOCKS} image blocks) "
          f"written in {_CLIP_FIXTURE['seconds']:.1f} s", flush=True)
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
    want = {"full": {"flash3_fwd": CLIP_FULL_FWD, "flash3_bwd": 1},
            "cached": {"flash3_fwd": 3, "flash3_bwd": 1},
            "full_remat": {"flash3_fwd": CLIP_FULL_FWD + 3, "flash3_bwd": 1},
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
          f"{CLIP_FULL_FWD}, 1; cached 3, 1; with remat {CLIP_FULL_FWD + 3}, "
          f"1 and 6, 1 (one more forward for each of the 3 adapted blocks)",
          flush=True)
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
    want = {f"{label}_R{R}": {"flash3_fwd": CLIP_FULL_FWD if label == "full"
                              else 3, "flash3_bwd": 1}
            for R in (1, 2, 3) for label in ("full", "cached")}
    if per_r != want:
        fail(f"launches a lock-step {per_r}, expected {want}")
    print(f"[forks] launches a lock-step batch (flash3_fwd, flash3_bwd) at "
          f"R = 1, 2, 3: full tower {CLIP_FULL_FWD}, 1; cached 3, 1",
          flush=True)

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
    folder = os.path.join(tmp, "imagenet")   # phase vit_train's, if it ran
    if not os.path.isdir(folder):
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
    print(f"[vit_grid] fixture ready in {t0 - t_phase:.1f} s (phase "
          f"vit_train's ImageFolder, written here if that phase did not run: "
          f"8 classes, 1,024 train / 256 val JPEGs at 256^2; 48 THINGS JPEGs "
          f"and an RDM); `cli.pack` {pack_s:.2f} s for both splits",
          flush=True)
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
    (rho_plain, _), emb_plain = _plain_attention(
        lambda: (trainer.compute_rsa_score(things_u8, rdm), embeddings()))
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
    shutil.rmtree(root)       # the disk: the runs and the pack
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
# tensor parallelism on the card: two gloo ranks share cuda:0 (NCCL takes
# one rank a card), one model group, a data axis of 1. Each block
# all-reduces [B, 197, 768] bf16 twice forward and twice backward through
# the host: 14.5 MB of payload an image a training step whatever B, so B
# sets the size of each all-reduce and the count of them. B = 64: 19.4 MB
# an all-reduce (a pinned host buffer of that size a rank), 48 a step, 16
# steps an epoch over the 1,024 train images, 4 validation batches
TP_BATCH = 64
TP_TIMED_STEPS = 3
TP_STEPS = 1024 // TP_BATCH * DIST_EPOCHS
TP_VAL_BATCHES = 256 // TP_BATCH * DIST_EPOCHS
# the two gloo dp ranks at batch 256 train GLOO_EPOCHS, held to the first
# row of the run alone (a gloo step's round-trips cost the script's time)
GLOO_EPOCHS = 1
# the TP block (the kernels on each rank's 6 heads, [B, 197, 1152]) against
# the same block whole on the plain attention, bf16, max |err| over the
# largest |value| of the plain version, for the block's output and for the
# packed qkv gradient at the rank's columns: the attention's own versions
# differ by one bf16 spacing (TOLERANCE, BWD_TOLERANCE: 2^-7 of the
# largest value), and the two partial products of each row-split dense,
# rounded to bf16 and summed, add one more rounding on the way out and one
# on the way back
TP_BLOCK_RTOL = 2e-2
# the tp run (and its epoch 0 resumed in one process) against one process
# on the same data at TP_BATCH. At batch 64 a change that should not
# matter drifts further than at 256: `--dist_drift 0.01` on an H100
# measured one process with the fused dW+db against the plain one at
# 9.474e-3 in the losses, 0 images, 5.626e-4 of the parameters' largest
# value and 1.291e-2 of the momentum's (tp: 6.370e-3, 0, 7.275e-4,
# 1.520e-2; at 256, two gloo dp ranks' momentum 1.409e-2). Allowed: twice
# that spread in the losses and the momentum, DIST_ACC_ATOL and
# DIST_PARAM_RTOL as phase dist's other runs
TP_LOSS_RTOL = 2e-2
TP_MOMENTUM_RTOL = 3e-2
# expert parallelism on the card: two gloo ranks share cuda:0 as one
# expert group (a data axis of 1), the MoE ViT-B/16 of phase moe at
# TP_BATCH for EP_EPOCHS (one: 16 steps), held to one process on the same
# data by the tp bounds above. Each MoE block all-reduces its gathered
# expert outputs [B * 197, 768] bf16 forward and the dispatched tokens'
# gradient backward
EP_TIMED_STEPS = 3
EP_EPOCHS = 1
# sequence parallelism on the card: two gloo ranks share cuda:0 as one
# model group (a data axis of 1), ViT-B/16 at TP_BATCH with 99 and 98 of
# the 197 tokens a rank. The gather form all-gathers each block's packed
# qkv ([64, 99, 2304] bf16, 29 MB a rank) and all-reduces its gradient
# over the whole sequence (58 MB); the ring sends k and v (9.7 MB) a hop
# forward, and k, v and their f32 gradients a hop backward: a step is
# seconds of gloo round-trips on the H100 machine. So the gather form
# trains one epoch of the tp run's data (SP_STEPS steps, SP_VAL_BATCHES
# validation batches), held to the epoch-0 checkpoint and row of _check_tp's
# one-process run (the same computation: epoch 0 trains at the base lr
# whatever the epoch count), and the ring one epoch of a smaller seeded
# ImageFolder (SP_TRAIN / SP_VAL images: SP_RING_STEPS steps and one
# validation batch) against the same invocation in one process; sp_check
# times 1 + 2 * SP_TIMED_STEPS steps of each form (in turns) on one batch
SP_TRAIN, SP_VAL = 256, 64
SP_STEPS = 1024 // TP_BATCH
SP_VAL_BATCHES = 256 // TP_BATCH
SP_RING_STEPS = SP_TRAIN // TP_BATCH
SP_RING_VAL_BATCHES = SP_VAL // TP_BATCH
SP_TIMED_STEPS = 1
# two of the ring run's validation images, as DIST_ACC_ATOL is two of 256
SP_ACC_ATOL = 100 * 2 / SP_VAL
# the momentum after the gather form's one epoch (16 steps) against one
# process's, over the largest momentum (the head weight's, every time).
# After one epoch at batch 64 the momentum differs further than after two
# (TP_MOMENTUM_RTOL's readings), whatever changed: `--sp_drift 0,1` on an
# H100 at 700 W measured, from seeds 0 and 1, the one-process control
# (--fused_dw against the plain dW+db: the same sums in another order) at
# 3.978e-2 and 1.768e-2, the gather form at 8.168e-2 and 1.849e-2, the
# ring at 6.118e-2 and 2.329e-2 (losses within 1.658e-2, parameters within
# 8.185e-4 of their largest). The gather rounds each rank's share of the
# whole-sequence dqkv to bf16 in the kernel before the sum (the sum itself
# is the f32 sum rounded once: _sp_check). Allowed: the largest reading
# with TP_MOMENTUM_RTOL's margin over its own, under a fault's ~1 (the
# head weight's gradient counted twice)
SP_MOMENTUM_RTOL = 1.5e-1
# one block on each rank's tokens (the gather form through the kernels on
# the whole sequence, the ring in f32 einsums) against the whole block on
# the plain attention, bf16, max |err| over the largest |value| of the
# plain version, for the output rows and the gradient of the block's input
# at the rank's rows: TP_BLOCK_RTOL's reasoning (one bf16 spacing of the
# attention, the roundings of the block's GEMMs)
SP_BLOCK_RTOL = 2e-2
# CLIP-HBA with its visual tower sequence-parallel over the two gloo ranks
# (the fixture's ViT-L/14, 129 and 128 of 257 tokens a rank; a gather-form
# forward moves CLIP_FIXTURE_BLOCKS x 1.6 MB an image through the host).
# Through cli.baseline: one epoch of a THINGS subset (CLIP_SP_IMAGES images split 80/20: 2 steps at batch
# CLIP_SP_BATCH, one eval batch; the 48 inference images; CLIP_SP_NOD
# others as the NOD set) against the same invocation alone. The gather form runs the
# flash kernels on the whole sequence: its rows within CLIP_DIST_LOSS_RTOL
# and CLIP_DIST_RHO_ATOL, as the dp ranks are held. The ring computes
# every block's attention in f32 einsums from bf16 q, k, v where the
# kernels round p to bf16 (one bf16 spacing, 2^-8 relative, a block, over
# the image blocks; the bounds below were measured over 24):
# CLIP_RING_LOSS_RTOL and CLIP_RING_RHO_ATOL. Both forms'
# adapters, AdamW moments and NOD embeddings within the bounds below; and _clip_sp_check's CLIP_SP_STEPS trainer steps on as many
# images of each form against the trainer alone within the same bounds,
# beside a planted fault the moment bound must catch
CLIP_SP_IMAGES = 80
CLIP_SP_NOD = 32
CLIP_SP_STEPS = 2
CLIP_SP_BATCH = 32
CLIP_RING_LOSS_RTOL = 1e-2
CLIP_RING_RHO_ATOL = 1e-2
# after 2 AdamW steps, by tower (_adapter_diffs): the adapters' difference
# over their move from the initial ones in L2 (AdamW's first steps move
# each element by about lr whatever its gradient's size, so an element
# whose gradient is near 0 may move either way: the largest difference
# reads 1.0-1.9 of the largest move in sound runs, and is printed, not
# bounded), and the moments' largest difference over their largest value.
# Measured on an H100 at 700 W (PERF.md): adapters 1.247e-3-
# 2.065e-2 (gather) and 3.197e-2-4.592e-2 (ring), moments 9.948e-4-
# 2.424e-3 (gather) and 2.348e-3-1.136e-2 (ring), through the CLI and the
# trainer alike. A gradient scaled by a constant leaves AdamW's steps as
# they were (the planted fault's adapters read as the gather's) and moves
# its moments by the scale: the fault's text moments read 1.000 (mu) and
# 3.001 (nu). Allowed: about twice the largest adapter reading, four times
# the largest moment reading, twenty times under the fault's
CLIP_SP_PARAM_RTOL = 1e-1
CLIP_SP_MOMENT_RTOL = 5e-2
# the NOD embeddings after the epoch, max |err| over the largest |value|:
# measured 2.764e-3 (gather) and 1.567e-2 (ring, whose adapters differ
# further); about three times each
CLIP_SP_EMB_RTOL = 1e-2
CLIP_RING_EMB_RTOL = 5e-2
# pipeline parallelism on the card: two gloo ranks share cuda:0 as one
# stage group (a data axis of 1), ViT-B/16 at TP_BATCH in PP_MICRO
# microbatches of 16 images, blocks 0-5 on stage 0 and 6-11 on stage 1.
# Each step hops 4 microbatch activations [16, 197, 768] bf16 (4.8 MB)
# forward and their gradients back, through the host; with the bubble
# ticks skipped a rank launches 6 x 4 flash3_fwd and as many flash3_bwd a
# step. cli.vit_train --pp_stages 2 --pp_micro 4 trains one epoch of the
# sp ring run's ImageFolder (SP_RING_STEPS steps, one validation batch),
# held to the same invocation in one process (ring_one) by the ring run's
# bounds: its arithmetic differs from one process's only in the GEMMs'
# shapes (16 x 197 rows where one process has 64 x 197) and in the sum of
# the weight gradients over the microbatches, less than the ring's f32
# attention does; and its epoch 0 resumed in one process, its epoch-1 row
# against the one-process run's own epoch 1
PP_STAGES, PP_MICRO = 2, 4
PP_TIMED_STEPS = 3
# pp_check: one pipelined forward and one pipelined step's gradients
# (after the stage group's sum) at TP_BATCH against vit_classify and the
# plain step of the whole model on the same rank, both on the kernels,
# ||a - b|| over ||b|| (logits; every leaf the rank holds). The attention
# is per image, so the kernels agree; a GEMM over 16 x 197 rows may take
# another cuBLAS kernel than over 64 x 197, one bf16 rounding (2^-8 of
# an element) apart, and through 12 blocks the residual stream sums those
# roundings (TP_BLOCK_RTOL's reasoning for one block, 2e-2 of the largest
# value). A weight gradient is 4 microbatch products each rounded to bf16
# and summed, where the plain step rounds one product of 64 x 197 rows:
# another rounding on top, hence the larger gradient bound. Written
# before any chip run. The planted faults (the stage hop's backward
# sending zeros; the last stage's microbatches pooled in reversed order)
# read O(1) against them
PP_LOGITS_RTOL = 2e-2
PP_GRAD_RTOL = 5e-2


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
            elif module == "tp_check":
                extra = _tp_check()
            elif module == "ep_check":
                extra = _ep_check()
            elif module == "sp_check":
                extra = _sp_check()
            elif module == "pp_check":
                extra = _pp_check()
            elif module == "serve_mesh":
                extra = _serve_mesh()
            elif module == "clip_sp_check":
                extra = _clip_sp_check(args[0])
            elif module == "sharded_ckpt":
                extra = _sharded_ckpt_check(args[0])
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


def _plain_packed_qkv(qkv, num_heads):
    """The packed attention op on its plain versions (forward and
    backward), differentiable as the kernel's autograd Function is."""
    import torch
    from vit_project_torch.ops import attention as vattn

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv):
            o, lse = vattn.flash_mha_packed_qkv_reference(qkv, num_heads)
            ctx.save_for_backward(qkv, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            qkv, lse = ctx.saved_tensors
            return vattn.flash_mha_packed_qkv_bwd_reference(
                qkv, do.contiguous(), lse, num_heads)
    return Plain.apply(qkv)


def _tp_check() -> dict:
    """Under two gloo ranks sharing the card (one model group),
    ViT-B/16's width with tp_devices 2: one block tensor-parallel, each
    rank's 6 heads through the kernels, against the same block whole on
    the plain attention: the output, and the packed qkv gradient
    [B, 197, 1152] against the whole block's at the rank's columns (max
    |err| over the largest |value|); the kernel launches of that block and
    of one training step; ms a step over TP_TIMED_STEPS (CUDA events) at
    batch TP_BATCH."""
    import torch
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import mesh as vmesh
    from vit_project_torch.train import vit_loop
    dev = dist.local_device("cuda:0")        # the card both ranks share
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    D, H, T = vit_cfg.width, vit_cfg.heads, 2
    mesh = vmesh.make_mesh(n_model=T)
    group, t = mesh.get_group("model"), mesh.get_local_rank("model")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    blk = vvit.Block(D, vit_cfg.mlp_ratio).to(dev)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            unit = name.startswith("norm") and name.endswith("weight")
            p.copy_(float(unit) + 0.02 * torch.randn(
                p.shape, generator=gen, device=dev))
    x = torch.randn(TP_BATCH, vit_cfg.seq_len, D, generator=gen,
                    device=dev).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    act = vvit._activation(vit_cfg)
    seen = {}
    kernel_op = vattn.flash_mha_packed_qkv

    def capturing(op):
        def attn(qkv, *, num_heads, causal=False):
            qkv.retain_grad()
            seen["qkv"] = qkv
            return op(qkv, num_heads)
        return attn
    vattn.flash_mha_packed_qkv = capturing(_plain_packed_qkv)
    try:
        y_ref = vvit.classifier_block(blk, x, H, act=act)
        y_ref.backward(dy)
    finally:
        vattn.flash_mha_packed_qkv = kernel_op
    cols = [c for j in range(3)
            for c in range(j * D + t * D // T, j * D + (t + 1) * D // T)]
    g_ref = seen["qkv"].grad[..., cols].float()
    local = vvit.Block(D, vit_cfg.mlp_ratio).to(dev)
    state = {f"blocks.0.{n}": p.detach() for n, p in blk.named_parameters()}
    for name, v in vmesh.shard_vit_params_tp(state, T, t, heads=H).items():
        owner, leaf = name[len("blocks.0."):].rsplit(".", 1)
        setattr(local.get_submodule(owner), leaf, torch.nn.Parameter(v))
    vattn.reset_launch_counts()
    vattn.flash_mha_packed_qkv = capturing(
        lambda qkv, h: kernel_op(qkv, num_heads=h))
    try:
        y = vvit.classifier_block_tp(local, x, H, act=act, group=group)
        y.backward(dy)
    finally:
        vattn.flash_mha_packed_qkv = kernel_op
    torch.cuda.synchronize()
    block = {"launches": dict(vattn.LAUNCHES),
             "qkv_shape": list(seen["qkv"].shape),
             "y_rel_err": ((y.float() - y_ref.float()).abs().max()
                           / y_ref.float().abs().max()).item(),
             "dqkv_rel_err": ((seen["qkv"].grad.float() - g_ref).abs().max()
                              / g_ref.abs().max()).item()}
    del blk, local, x, dy, y, y_ref, seen, g_ref

    cfg = ViTTrainConfig(batch_size=TP_BATCH, compute_dtype="bfloat16",
                         tp_devices=T)
    model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev),
                                 torch.Generator(device=dev).manual_seed(SEED))
    tr = vit_loop.ViTTrainer(vit_cfg, cfg, model, dev)
    mom = tr.init_momentum()
    size = vit_cfg.image_size
    imgs = torch.randint(0, 256, (TP_BATCH, size, size, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    lbls = torch.randint(0, vit_cfg.num_classes, (TP_BATCH,), generator=gen,
                         device=dev)
    vattn.reset_launch_counts()
    tr.step(mom, imgs, lbls, 0.01)
    torch.cuda.synchronize()
    per_step = dict(vattn.LAUNCHES)
    # a step is ~1.1-1.4 s of gloo round-trips on the H100 machine: one
    # turn of TP_TIMED_STEPS after one unmeasured step
    tr.step(mom, imgs, lbls, 0.01)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(TP_TIMED_STEPS + 1)]
    ev[0].record()
    for i in range(TP_TIMED_STEPS):
        tr.step(mom, imgs, lbls, 0.01)
        ev[i + 1].record()
    torch.cuda.synchronize()
    turns = [[ev[i].elapsed_time(ev[i + 1]) for i in range(TP_TIMED_STEPS)]]
    return {"block": block, "per_step": per_step, "turns": turns}


def _ep_check() -> dict:
    """Under two gloo ranks sharing the card (one expert group), the MoE
    ViT-B/16 of phase moe with ep_devices 2: a training step's kernel
    launches and ms a step over EP_TIMED_STEPS (CUDA events) at batch
    TP_BATCH, each rank holding 4 of the 8 experts of each MoE block."""
    import torch
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.parallel import dist
    from vit_project_torch.train import vit_loop
    dev = dist.local_device("cuda:0")        # the card both ranks share
    vit_cfg = dataclasses.replace(vvit.VIT_CONFIGS["vit_base_patch16_224"],
                                  moe_experts=MOE_EXPERTS)
    cfg = ViTTrainConfig(batch_size=TP_BATCH, compute_dtype="bfloat16",
                         moe_experts=MOE_EXPERTS, ep_devices=2)
    model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev),
                                 torch.Generator(device=dev).manual_seed(SEED))
    tr = vit_loop.ViTTrainer(vit_cfg, cfg, model, dev)
    mom = tr.init_momentum()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    size = vit_cfg.image_size
    imgs = torch.randint(0, 256, (TP_BATCH, size, size, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    lbls = torch.randint(0, vit_cfg.num_classes, (TP_BATCH,), generator=gen,
                         device=dev)
    vattn.reset_launch_counts()
    vfdw.reset_launch_counts()
    tr.step(mom, imgs, lbls, 0.01)
    torch.cuda.synchronize()
    per_step = {**vattn.LAUNCHES, **vfdw.LAUNCHES}
    tr.step(mom, imgs, lbls, 0.01)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(EP_TIMED_STEPS + 1)]
    ev[0].record()
    for i in range(EP_TIMED_STEPS):
        tr.step(mom, imgs, lbls, 0.01)
        ev[i + 1].record()
    torch.cuda.synchronize()
    turns = [[ev[i].elapsed_time(ev[i + 1]) for i in range(EP_TIMED_STEPS)]]
    return {"per_step": per_step, "turns": turns,
            "experts_here": int(model.blocks[1].moe.fc1_w.shape[0])}


# mesh serving (serve/engine.py mesh= / shard_params=) inside phase dist's
# launches: the ViT-B/16 classifier engine, bf16 weights and compute,
# seeded random weights, uint8 requests with the ImageNet normalization
# folded in. At world size 1 under NCCL, bucket SERVE_MESH_BUCKET: the dp
# engine (its rows and its all-gather over a data axis of one) bit-equal
# to the engine alone, images/s of both in turns. On the two gloo ranks
# sharing the card, bucket SERVE_MESH_GLOO_BUCKET (the tp training's
# TP_BATCH: a tp chunk all-reduces [64, 197, 768] bf16 24 times through
# the host): the dp engine (32 rows a rank, gathered) and the tp engine
# (--tp_devices 2's layout: 6 heads a rank through the flash3 kernel)
# against the engine alone on the same rank, max |err| over the largest
# |logit|, within SERVE_MESH_GLOO_RTOL. Measured on an H100 at 700 W: dp
# 0 (bit-equal: the 32-row products take the 64-row ones' kernels), tp
# 1.512e-2 (each block's two partial products rounded to bf16 before
# their sum, through 12 blocks), the bound set from it. Two planted tp
# faults (the partial products left unsummed; the output projection of
# the other rank's heads) must each read above it
SERVE_MESH_BUCKET = 256
SERVE_MESH_GLOO_BUCKET = 64
SERVE_MESH_REPS = 5
SERVE_MESH_GLOO_RTOL = 2e-2


def _serve_mesh() -> dict:
    """Under torchrun (NCCL at world size 1, or gloo on two ranks sharing
    cuda:0): the ViT-B/16 classifier engines over the launch's mesh
    against the engine alone (module constants above); each engine's
    flash3_fwd launches for one chunk."""
    import hashlib
    import torch
    import torch.distributed as tdist
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import mesh as vmesh
    from vit_project_torch.serve import vit_classifier_engine
    dist.setup_distributed(dist.local_device("cuda"))   # a chain made it
    gloo = tdist.get_backend() == "gloo"
    dev = (torch.device("cuda", 0) if gloo else
           torch.device("cuda", torch.cuda.current_device()))
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    b = SERVE_MESH_GLOO_BUCKET if gloo else SERVE_MESH_BUCKET
    side = vit_cfg.image_size
    imgs = np.random.RandomState(SEED + 7).randint(
        0, 256, (b, side, side, 3)).astype(np.uint8)

    def engine(**kw):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev), gen)
        return vit_classifier_engine(
            model, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
            input_norm=((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
            buckets=(b,), device=dev, **kw)

    def chunk(eng):
        """One call: its output and the flash3_fwd launches it made."""
        eng(imgs)                      # warm
        torch.cuda.synchronize()
        vattn.reset_launch_counts()
        out = eng(imgs)
        torch.cuda.synchronize()
        return out, vattn.LAUNCHES["flash3_fwd"]

    solo = engine()
    want, solo_launches = chunk(solo)
    rep = {"backend": tdist.get_backend(), "world": dist.world_size(),
           "bucket": b, "launches_solo": solo_launches,
           "solo_sha": hashlib.sha256(want.tobytes()).hexdigest()}
    engines = {"dp": engine(mesh=vmesh.make_mesh())}
    if gloo:
        engines["tp"] = engine(
            mesh=vmesh.make_mesh(n_model=2),
            shard_params=lambda m, st: vmesh.shard_vit_params_tp_mesh(
                m, st, heads=vit_cfg.heads))
    for name, eng in engines.items():
        got, launches = chunk(eng)
        rep[name] = {
            "launches": launches, "bit_equal": bool(np.array_equal(got,
                                                                   want)),
            "rel_err": float(np.abs(got - want).max() / np.abs(want).max()),
            "finite": bool(np.isfinite(got).all()),
            "shape": list(got.shape),
            "sha": hashlib.sha256(got.tobytes()).hexdigest(),
            "qkv_rows": int(eng.model.blocks[0].attn.qkv.weight.shape[0])}
    if gloo:
        # two planted tp faults, which the bound must reject: every block's
        # partial products left unsummed (each rank drops the other's), and
        # the output projection's columns of the other rank's heads
        def err(got):
            return float(np.abs(got - want).max() / np.abs(want).max())
        reduce_op = dist.ReduceFromGroup

        class _Unsummed:
            apply = staticmethod(lambda x, group: x)
        dist.ReduceFromGroup = _Unsummed
        try:
            rep["fault_unsummed"] = err(engines["tp"](imgs))
        finally:
            dist.ReduceFromGroup = reduce_op

        def other_heads_proj(m, st):
            other = vmesh.shard_vit_params_tp(
                st, 2, 1 - m.get_local_rank("model"))
            return {**vmesh.shard_vit_params_tp_mesh(m, st,
                                                     heads=vit_cfg.heads),
                    **{k: v for k, v in other.items()
                       if k.endswith("attn.proj.weight")}}
        rep["fault_other_heads"] = err(engine(
            mesh=vmesh.make_mesh(n_model=2),
            shard_params=other_heads_proj)(imgs))
        for name, eng in engines.items():
            rep[name]["call_s"] = _call_s(eng, imgs, reps=3)
    else:
        solo_s, dp_s = _in_turns(
            lambda r: _call_s(solo, imgs, r),
            lambda r: _call_s(engines["dp"], imgs, r), SERVE_MESH_REPS)
        rep["solo_images_per_s"] = b / solo_s
        rep["dp"]["images_per_s"] = b / dp_s
    return rep


def _sp_check() -> dict:
    """Under two gloo ranks sharing the card (one model group),
    ViT-B/16's width with sp_devices 2: one block on each rank's tokens in
    the gather form (the kernels on the gathered [B, 197, 2304]) and in the
    ring form, each against the same block whole on the plain attention
    (the output rows and the input gradient at the rank's rows; max |err|
    over the largest |value|) with its kernel launches; gloo's bf16
    all-reduce (the gather's backward) against the f32 sum of the same
    gradients rounded to bf16 once; then a training step of each form: its
    launches (that step warms the form up), ms a step in turns (gather,
    ring, ring, gather; SP_TIMED_STEPS a turn, CUDA events) and the peak a
    step adds over the trainer's resident state, at batch TP_BATCH. The
    runs' CLIs hold the forms to one process (_check_sp)."""
    import torch
    import torch.distributed as tdist
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import mesh as vmesh
    from vit_project_torch.train import vit_loop
    dev = dist.local_device("cuda:0")        # the card both ranks share
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    D, H, S = vit_cfg.width, vit_cfg.heads, vit_cfg.seq_len
    seq = vmesh.seq_sharding(vmesh.make_mesh(n_model=2))
    lo, hi = seq.bounds(S)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    blk = vvit.Block(D, vit_cfg.mlp_ratio).to(dev)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            unit = name.startswith("norm") and name.endswith("weight")
            p.copy_(float(unit) + 0.02 * torch.randn(
                p.shape, generator=gen, device=dev))
    x = torch.randn(TP_BATCH, S, D, generator=gen,
                    device=dev).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    act = vvit._activation(vit_cfg)
    kernel_op = vattn.flash_mha_packed_qkv
    vattn.flash_mha_packed_qkv = \
        lambda qkv, *, num_heads, causal=False: _plain_packed_qkv(qkv,
                                                                  num_heads)
    try:
        xr = x.clone().requires_grad_(True)
        y_ref = vvit.classifier_block(blk, xr, H, act=act)
        y_ref.backward(dy)
    finally:
        vattn.flash_mha_packed_qkv = kernel_op
    y_ref, dx_ref = y_ref[:, lo:hi].float(), xr.grad[:, lo:hi].float()
    blocks = {}
    for form in ("gather", "ring"):
        xs, sp = vvit._seq_parallel_enter(x, seq, form == "ring")
        xs = xs.clone().requires_grad_(True)
        vattn.reset_launch_counts()
        y = vvit.classifier_block(blk, xs, H, act=act, sp=sp)
        dys = torch.zeros_like(y)
        dys[:, :hi - lo] = dy[:, lo:hi]
        y.backward(dys)
        torch.cuda.synchronize()
        blocks[form] = {
            "launches": {k: vattn.LAUNCHES[k]
                         for k in ("flash3_fwd", "flash3_bwd")},
            "y_rel_err": ((y[:, :hi - lo].float() - y_ref).abs().max()
                          / y_ref.abs().max()).item(),
            "dx_rel_err": ((xs.grad[:, :hi - lo].float() - dx_ref).abs().max()
                           / dx_ref.abs().max()).item()}
    del blk, x, dy, xr, y_ref, dx_ref
    # the gather's backward sums each rank's bf16 dqkv in bf16 (gloo): at
    # two ranks one rounding of the exact sum, as an f32 sum cast once
    g = torch.randn((TP_BATCH, S, 3 * D), generator=torch.Generator(
        device=dev).manual_seed(SEED + 10 + seq.index), device=dev).to(
        torch.bfloat16)
    g16, g32 = g.clone(), g.float()
    tdist.all_reduce(g16, group=seq.group)
    tdist.all_reduce(g32, group=seq.group)
    bf16_sum = {"elements": g.numel(),
                "differ": int((g16 != g32.to(torch.bfloat16)).sum())}
    del g, g16, g32

    size = vit_cfg.image_size
    imgs = torch.randint(0, 256, (TP_BATCH, size, size, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    lbls = torch.randint(0, vit_cfg.num_classes, (TP_BATCH,), generator=gen,
                         device=dev)
    trainers, per_step, peak_gib = {}, {}, {}
    for form in ("gather", "ring"):
        cfg = ViTTrainConfig(batch_size=TP_BATCH, compute_dtype="bfloat16",
                             sp_devices=2, sp_ring=form == "ring")
        model = vvit.init_vit_params(
            vvit.empty_vit(vit_cfg, dev),
            torch.Generator(device=dev).manual_seed(SEED))
        tr = vit_loop.ViTTrainer(vit_cfg, cfg, model, dev, distributed=True)
        trainers[form] = (tr, tr.init_momentum())

    def step(form):
        tr, mom = trainers[form]
        tr.step(mom, imgs, lbls, 0.01)
    for form in ("gather", "ring"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        vattn.reset_launch_counts()
        step(form)
        torch.cuda.synchronize()
        per_step[form] = {k: vattn.LAUNCHES[k]
                          for k in ("flash3_fwd", "flash3_bwd")}
        peak_gib[form] = (torch.cuda.max_memory_allocated() - resident) / 2**30

    def turn(form):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(SP_TIMED_STEPS + 1)]
        ev[0].record()
        for i in range(SP_TIMED_STEPS):
            step(form)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(SP_TIMED_STEPS)]
    turns = {form: [] for form in ("gather", "ring")}
    for form in ("gather", "ring", "ring", "gather"):
        turns[form].append(turn(form))
    return {"blocks": blocks, "bf16_sum": bf16_sum, "per_step": per_step,
            "turns": turns, "step_peak_gib": peak_gib, "bounds": [lo, hi]}


def _norm_rel(a, b) -> float:
    """||a - b|| over ||b||, in f64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _pp_check() -> dict:
    """Under two gloo ranks sharing the card (one stage group), ViT-B/16
    with pp_stages 2 and pp_micro 4 at batch TP_BATCH: the whole model's
    logits and one plain step's gradients on this rank alone, then the
    same model staged (ViTTrainer, the other stage's blocks freed): one
    pipelined forward and one pipelined step's gradients against them
    (``_norm_rel``), each with its kernel launches and the attention's
    packed qkv shapes; two planted faults the bounds must catch (the stage
    hop's backward sending zeros; the last stage's microbatches pooled in
    reverse order); the state the rank holds whole and staged; then ms a
    step over PP_TIMED_STEPS (CUDA events) after one unmeasured step, and
    the peak a step adds over the trainer's resident state."""
    import torch
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import pipeline as vpp
    from vit_project_torch.train import vit_loop
    dev = dist.local_device("cuda:0")        # the card both ranks share
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    size = vit_cfg.image_size
    # each image a tint of its own under noise, so the images' logits
    # differ (at the random init, i.i.d. noise images' nearly coincide)
    tint = torch.randint(40, 216, (TP_BATCH, 1, 1, 3), generator=gen,
                         device=dev)
    imgs = (tint + torch.randint(-40, 41, (TP_BATCH, size, size, 3),
                                 generator=gen, device=dev)).to(torch.uint8)
    lbls = torch.randint(0, vit_cfg.num_classes, (TP_BATCH,), generator=gen,
                         device=dev)
    model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, dev),
                                 torch.Generator(device=dev).manual_seed(SEED))
    one = vit_loop.ViTTrainer(vit_cfg, ViTTrainConfig(
        batch_size=TP_BATCH, compute_dtype="bfloat16"), model, dev,
        distributed=False)
    with torch.no_grad():
        ref_logits = one.logits(imgs)
    named = list(model.named_parameters())
    ref = dict(zip([n for n, _ in named], one.batch_grads(
        [p for _, p in named], imgs, lbls)[1]))
    del one, named
    torch.cuda.synchronize()
    held = {"whole_gib": sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 2**30}
    cfg = ViTTrainConfig(batch_size=TP_BATCH, compute_dtype="bfloat16",
                         pp_stages=PP_STAGES, pp_micro=PP_MICRO)
    tr = vit_loop.ViTTrainer(vit_cfg, cfg, model, dev, distributed=True)
    held["staged_gib"] = sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 2**30
    names = [n for n, _ in model.named_parameters()]
    shapes = set()
    kernel_op = vattn.flash_mha_packed_qkv

    def recording(qkv, **kw):
        shapes.add(tuple(qkv.shape))
        return kernel_op(qkv, **kw)

    def forward():
        vattn.reset_launch_counts()
        logits = tr.logits(imgs)
        torch.cuda.synchronize()
        return logits, {k: vattn.LAUNCHES[k]
                        for k in ("flash3_fwd", "flash3_bwd")}

    def grads():
        vattn.reset_launch_counts()
        _, g = tr._pp_grads(imgs, lbls, vit_loop.IMAGENET_NORM)
        torch.cuda.synchronize()
        return (torch.cat([x.reshape(-1) for x in g]),
                {k: vattn.LAUNCHES[k] for k in ("flash3_fwd", "flash3_bwd")})
    want = torch.cat([ref[n].reshape(-1) for n in names])
    vattn.flash_mha_packed_qkv = recording
    try:
        logits, fwd_launches = forward()
        g, step_launches = grads()
    finally:
        vattn.flash_mha_packed_qkv = kernel_op
    res = {"stage": tr.stages.index, "held": held,
           "qkv_shapes": sorted(list(x) for x in shapes),
           "forward": {"launches": fwd_launches,
                       "logits_rel": _norm_rel(logits, ref_logits)},
           "step": {"launches": step_launches, "grad_rel": _norm_rel(g, want),
                    "leaves": len(names)}}
    # the faults: the gradient hops back as zeros; the last stage pools its
    # microbatches in reverse order (each only for its measurement)
    send, fwd_schedule = vpp.dist.stage_send, vpp._forward

    def zeros_back(t, group, to, tag):
        return send(torch.zeros_like(t) if to < tr.stages.index else t,
                    group, to, tag)

    def reversed_micro(*a, **k):
        stem, ins, outs = fwd_schedule(*a, **k)
        return stem, ins, outs[::-1]
    vpp.dist.stage_send = zeros_back
    try:
        res["fault_zero_hop_grad_rel"] = _norm_rel(grads()[0], want)
    finally:
        vpp.dist.stage_send = send
    vpp._forward = reversed_micro
    try:
        res["fault_order_logits_rel"] = _norm_rel(forward()[0], ref_logits)
    finally:
        vpp._forward = fwd_schedule
    del ref, want, g, logits, ref_logits
    mom = tr.init_momentum()
    tr.step(mom, imgs, lbls, 0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(PP_TIMED_STEPS + 1)]
    ev[0].record()
    for i in range(PP_TIMED_STEPS):
        tr.step(mom, imgs, lbls, 0.01)
        ev[i + 1].record()
    torch.cuda.synchronize()
    res["step_ms"] = [ev[i].elapsed_time(ev[i + 1])
                      for i in range(PP_TIMED_STEPS)]
    res["step_peak_gib"] = (torch.cuda.max_memory_allocated()
                            - resident) / 2**30
    res["resident_gib"] = resident / 2**30
    return res


def _flat_adapters(tree: dict) -> dict:
    """{(tower, block, name): f64 array} of an adapter tree (the trainable
    layout: {tower: {block: {name: leaf}}}, tensors or arrays)."""
    import torch
    return {(t, int(i), k): (v.detach().double().cpu().numpy()
                             if torch.is_tensor(v) else np.asarray(
                                 v, np.float64))
            for t, blocks in tree.items() for i, leaves in blocks.items()
            for k, v in leaves.items()}


def _adapter_diffs(got: tuple, want: tuple, init: dict) -> dict:
    """Two CLIP-HBA runs' adapters and AdamW moments ((trainable, mu, nu)
    each) by tower: the adapters' largest difference over their largest
    move from `init` ("param"), the same in L2 norms ("param_l2"), and each
    moment's largest difference over its largest value ("mu", "nu"). AdamW
    steps by m / sqrt(v), which a gradient scaled by a constant leaves as
    it was, so the moments are what hold a leaf's gradient to its scale."""
    base = _flat_adapters(init)
    out = {}
    for what, g, w in zip(("param", "mu", "nu"), got, want):
        fg, fw = _flat_adapters(g), _flat_adapters(w)
        for tower in sorted({k[0] for k in fw}):
            keys = [k for k in fw if k[0] == tower]
            diff = [fg[k] - fw[k] for k in keys]
            ref = [fw[k] - base[k] if what == "param" else fw[k]
                   for k in keys]
            out.setdefault(what, {})[tower] = float(
                max(np.abs(d).max() for d in diff)
                / max(np.abs(r).max() for r in ref))
            if what == "param":
                out.setdefault("param_l2", {})[tower] = float(
                    np.sqrt(sum((d ** 2).sum() for d in diff)
                            / sum((r ** 2).sum() for r in ref)))
    return out


def _clip_sp_check(wpath: str) -> dict:
    """Under two gloo ranks sharing the card (one model group), CLIP-HBA
    on ViT-L/14 weights with its visual tower sequence-parallel, the
    gather and the ring form, beside the trainer alone on the same rank
    and a planted fault (the gather form with the text adapters' gradient
    counted twice, as if both model ranks seeded it): CLIP_SP_STEPS train
    steps each from the same adapters on the same CLIP_SP_BATCH images
    (each step's loss, the first step's launches, s a step), then each
    form's adapters and AdamW moments against the trainer alone's
    (``_adapter_diffs``)."""
    import torch
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.ckpt import clip_ckpt
    from vit_project_torch.core.prng import Key
    from vit_project_torch.data.spose66 import classnames66
    from vit_project_torch.models import convert as vconvert
    from vit_project_torch.models import tokenizer as vtok
    from vit_project_torch.ops import attention as vattn
    from vit_project_torch.parallel import dist
    from vit_project_torch.parallel import mesh as vmesh
    from vit_project_torch.train import clip_loop
    dev = dist.local_device("cuda:0")        # the card both ranks share
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
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    imgs = torch.randint(0, 256, (CLIP_SP_BATCH, 224, 224, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    tgts = torch.rand((CLIP_SP_BATCH, 66), generator=gen, device=dev) * 2
    mesh = vmesh.make_mesh(n_model=2)
    out, trees = {}, {}
    for form in ("one", "gather", "ring", "fault"):
        tr = clip_loop.ClipHBATrainer(
            cfg, model, acfg, static, prompts, lr=3e-4,
            compute_dtype=torch.bfloat16,
            mesh=None if form == "one" else mesh, sp=form != "one",
            sp_ring=form == "ring")
        if form == "fault":
            reduce_step = tr._all_reduce_step

            def doubled(trainable, loss, ok, reduce_step=reduce_step):
                res = reduce_step(trainable, loss, ok)
                for tower, _, _, leaf in adora.trainable_leaves(trainable):
                    if tower == "text":
                        leaf.grad.mul_(2)
                return res
            tr._all_reduce_step = doubled
        trainable = adora.make_trainable(init_tr, dev)
        opt = tr.init_optimizer(trainable)
        losses, launches = [], None
        t0 = time.time()
        for k in range(CLIP_SP_STEPS):
            vattn.reset_launch_counts()
            loss, ok = tr.train_step(trainable, opt, imgs, tgts,
                                     np.arange(CLIP_SP_BATCH),
                                     Key((SWEEP_SEED, 0, k)),
                                     batch_size=CLIP_SP_BATCH)
            if launches is None:
                torch.cuda.synchronize()
                launches = {n: vattn.LAUNCHES[n]
                            for n in ("flash3_fwd", "flash3_bwd")}
            losses.append(loss if ok else None)
        torch.cuda.synchronize()
        step_s = (time.time() - t0) / CLIP_SP_STEPS
        _, mu, nu = clip_ckpt.adamw_moments(opt, trainable)
        trees[form] = (trainable, mu, nu)
        out[form] = {"losses": losses, "launches": launches,
                     "step_s": step_s}
        if form != "one":
            out[form]["against_one"] = _adapter_diffs(
                trees[form], trees["one"], init_tr)
            del trees[form]
        del tr, opt
    return {"clip_sp": out}


# launches started by _dist_start and not yet collected: main() stops any
# that a failing phase left running
_BACKGROUND: list = []


def _dist_start(tmp: str, name: str, argv: list,
                nproc: int | None = 1) -> dict:
    """Start `argv` ([--gloo] MODULE ARGS) through _dist_worker: under
    ``torchrun --standalone --nproc_per_node nproc``, or alone (nproc
    None), in a session of its own, its output to a log. Returns the job
    for _dist_collect."""
    report = os.path.join(tmp, f"{name}.report")
    log = os.path.join(tmp, f"{name}.log")
    me = os.path.abspath(__file__)
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc)] if nproc else [sys.executable])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd + [me, "--dist_worker", report, *argv],
                                cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    job = {"name": name, "proc": proc, "report": report, "log": log,
           "nproc": nproc, "t0": time.time()}
    _BACKGROUND.append(job)
    return job


def _dist_stop(job: dict) -> None:
    """Kill a launch's whole session (torchrun and its ranks) and reap it."""
    import signal
    if job["proc"].poll() is None:
        try:
            os.killpg(job["proc"].pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    job["proc"].wait()
    if job in _BACKGROUND:
        _BACKGROUND.remove(job)


def _dist_collect(job: dict, timeout: int = 600) -> list:
    """Wait for a _dist_start launch, at most `timeout` s from its start.
    Returns the ranks' reports; on failure or timeout stops it, prints the
    output's tail and fails the phase."""
    try:
        rc = job["proc"].wait(
            timeout=max(1.0, job["t0"] + timeout - time.time()))
    except subprocess.TimeoutExpired:
        rc = f"nothing: still running after {timeout} s"
    _dist_stop(job)
    if rc != 0:
        with open(job["log"]) as f:
            print(f.read()[-6000:], flush=True)
        fail(f"[dist] {job['name']} exited {rc}")
    reports, paths = [], [f"{job['report']}.rank{r}.json"
                          for r in range(job["nproc"] or 1)]
    for path in paths:
        with open(path) as f:
            reports.append(json.load(f))
    # the launch's seconds: from its start to its last report
    job["s"] = max(os.path.getmtime(p) for p in paths) - job["t0"]
    return reports


def _dist_run(tmp: str, name: str, argv: list, nproc: int | None = 1,
              timeout: int = 600) -> list:
    """_dist_start, then _dist_collect: the ranks' reports."""
    return _dist_collect(_dist_start(tmp, name, argv, nproc), timeout)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _worst_leaves(a, b, k: int = 3) -> list:
    """The `k` leaves of two trees furthest apart: [(path, max |a - b| over
    max |b| of the whole tree)]."""
    def flat(tree, path=""):
        if isinstance(tree, dict):
            return [x for key in sorted(tree) for x in flat(
                tree[key], f"{path}.{key}" if path else str(key))]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree)
                    for x in flat(v, f"{path}.{i}")]
        return [] if tree is None else [(path, np.asarray(tree))]
    fa, fb = flat(a), flat(b)
    top = max(float(np.abs(y).max()) for _, y in fb)
    diffs = [(n, float(np.abs(x.astype(np.float64) - y).max()) / top)
             for (n, x), (_, y) in zip(fa, fb)]
    return sorted(diffs, key=lambda d: -d[1])[:k]


def _rel_tree_diff(a, b) -> float:
    """max |a - b| over max |b|, over two trees' leaves."""
    la, lb = _tree_leaves(a), _tree_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    diff = max(float(np.abs(x.astype(np.float64) - y).max())
               for x, y in zip(la, lb))
    return diff / max(float(np.abs(y).max()) for y in lb)


def _dist_prelude(tmp: str) -> dict:
    """Phase dist's first work, started before phase serve_vit: its
    fixture, and one process that runs cli.vit_train alone ("single") and
    cli.vit_rsa_eval on its checkpoint, the runs both of phase dist's
    launches read. Returns the paths, the arguments and the job."""
    t0 = time.time()
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
    print(f"[dist] fixture ready in {time.time() - t0:.1f} s (the "
          f"vit_train ImageFolder; 48 THINGS JPEGs and an RDM); ViT-B/16, "
          f"batch 256, bf16, SGD lr {DIST_LR}, {DIST_EPOCHS} epochs a run",
          flush=True)
    train_args = ["--data_path", data, "--batch_size", "256", "--epochs",
                  str(DIST_EPOCHS), "--num_workers", "8", "--lr", DIST_LR]
    single = os.path.join(root, "single")
    rsa_one = os.path.join(root, "rsa_one.csv")
    job = _dist_start(root, "single", [
        "vit_project_torch.cli.vit_train", *train_args, "--fused_dw",
        "--output_dir", single, "--then", "vit_project_torch.cli.vit_rsa_eval",
        "--checkpoint_dir", single, "--output_csv", rsa_one, *things_args],
        nproc=None)
    return {"root": root, "data": data, "single": single, "rsa_one": rsa_one,
            "things_args": things_args, "train_args": train_args, "job": job}


def phase_dist(tmp: str, pre: dict | None = None):
    """Data parallelism as users launch it: cli.vit_train at ViT-B/16's full
    width and depth (bf16, global batch 256, fused_dw) alone and under
    ``torchrun --standalone --nproc_per_node 1`` in dp, --zero1 and --fsdp
    (NCCL); cli.vit_rsa_eval and one cli.vit_measure cell under torchrun
    against the same CLIs alone; ms a step per mode in turns; and two ranks
    under gloo on this one card (dp, the gathered RSA, tp, ep, sp, mesh
    serving, pp). The torchrun runs share one launch (a chain of the
    worker's, each CLI counted from 0), and so do the gloo ones: a process
    costs ~20 s of start-up. Both launches start once the run alone has
    written the checkpoint they read, and run beside the rest of this
    phase and the later phases; the phase returns finish(), which collects
    and checks them (timed as "dist_gloo"). `pre`: _dist_prelude's, when
    main started it; made here otherwise."""
    import pandas as pd
    import torch
    from vit_project_torch.cli import vit_measure as measure_cli

    t_phase = time.time()
    pre = pre or _dist_prelude(tmp)
    root, data, single, rsa_one = (pre[k] for k in (
        "root", "data", "single", "rsa_one"))
    things_args, train_args = pre["things_args"], pre["train_args"]
    train_cli = "vit_project_torch.cli.vit_train"

    # --- the main path: cli.vit_train alone (the prelude's process, with
    # cli.vit_rsa_eval on its checkpoint), then in one torchrun launch dp,
    # zero1, fsdp, cli.vit_rsa_eval, one cli.vit_measure cell and the step
    # timing; each CLI's counts start at 0 and are read at its end ---
    want = {"dw_db": 49 * DIST_STEPS, "flash3_bwd": 12 * DIST_STEPS,
            "flash3_fwd": 12 * (DIST_STEPS + DIST_VAL_BATCHES)}
    by_mode = {"single": _dist_collect(pre["job"])[0]}
    by_mode["single"].pop("then")
    print(f"[dist] cli.vit_train and cli.vit_rsa_eval alone took "
          f"{pre['job']['s']:.1f} s beside the phases before this one; "
          f"{time.time() - t_phase:.1f} s waited for here", flush=True)
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
              "--then", "time_modes", "--then", train_cli,
              *_moe_args(data), "--epochs", "1", "--output_dir",
              os.path.join(root, "moe_dp"), "--then", "serve_mesh"]
    torch.cuda.empty_cache()
    nccl_job = _dist_start(root, "torchrun", chain)
    # --- two ranks on this card under gloo, started here and collected by
    # finish() below, after the script's later phases: dp, the gathered
    # RSA, tensor parallelism (its run and its block check), expert
    # parallelism (its run and its step), sequence parallelism (a run of
    # each form, their block checks and steps), mesh serving and the
    # pipeline (its run and its forward and step against the whole model).
    # Its round-trips through the host take minutes of the host's clock and
    # little of the card's, so the launch runs beside the rest of this
    # phase and phases clip_dist, sweep and forks, each rank and each of
    # those counting its own launches in its own process ---
    gloo_out = os.path.join(root, "gloo_dp")
    pp_out = os.path.join(root, "gloo_pp")
    tp_out = os.path.join(root, "gloo_tp")
    ep_out = os.path.join(root, "gloo_ep")
    sp_out = os.path.join(root, "gloo_sp")
    ring_out = os.path.join(root, "gloo_ring")
    sp_data = os.path.join(root, "imagenet_sp")
    _write_image_folder(sp_data, np.random.RandomState(SEED + 6),
                        train=SP_TRAIN, val=SP_VAL)
    ring_args = ["--data_path", sp_data, "--batch_size", str(TP_BATCH),
                 "--epochs", "1", "--num_workers", "8", "--lr", DIST_LR]
    tp_args = ["--data_path", data, "--batch_size", str(TP_BATCH),
               "--epochs", str(DIST_EPOCHS), "--num_workers", "8", "--lr",
               DIST_LR]
    torch.cuda.empty_cache()
    gloo_job = _dist_start(root, "gloo", [
        "--gloo", train_cli, *train_args, "--device", "cuda:0",
        "--epochs", str(GLOO_EPOCHS), "--output_dir", gloo_out, "--then",
        "vit_project_torch.cli.vit_rsa_eval", "--checkpoint_dir", single,
        "--output_csv", os.path.join(root, "rsa_gloo.csv"), *things_args,
        "--device", "cuda:0", "--then", train_cli, *tp_args, "--device",
        "cuda:0", "--tp_devices", "2", "--output_dir", tp_out, "--then",
        "tp_check", "--then", train_cli, *tp_args, "--device", "cuda:0",
        "--moe_experts", str(MOE_EXPERTS), "--ep_devices", "2",
        "--output_dir", ep_out, "--epochs", str(EP_EPOCHS), "--then",
        "ep_check", "--then", train_cli, *tp_args, "--epochs", "1",
        "--device", "cuda:0", "--sp_devices", "2", "--output_dir", sp_out,
        "--then", train_cli, *ring_args, "--device", "cuda:0",
        "--sp_devices", "2", "--sp_ring", "--output_dir", ring_out,
        "--then", "sp_check", "--then", "serve_mesh", "--then", train_cli,
        *ring_args, "--device", "cuda:0", "--pp_stages", str(PP_STAGES),
        "--pp_micro", str(PP_MICRO), "--output_dir", pp_out, "--then",
        "pp_check"], nproc=2)
    # --- while both launches run: the CLIs alone that the torchrun ones
    # are held to (one grid cell; the MoE run's epoch 0 when phase moe did
    # not run), and the one-process runs the gloo launch's runs are held
    # to, which need none of its outputs ---
    _cli(measure_cli.main, cell + ["--output_csv",
                                   os.path.join(root, "cell_one.csv")],
         os.path.join(root, "cell_one.log"))
    from vit_project_torch.cli import vit_train as train_main
    moe_alone = os.path.join(tmp, "moe", "moe_a")
    if not os.path.isdir(moe_alone):
        moe_alone = os.path.join(root, "moe_alone")
        _cli(train_main.main, _moe_args(data) + [
            "--epochs", "1", "--output_dir", moe_alone],
            os.path.join(root, "moe_alone.log"))
    for name, args in (("tp_one", tp_args), ("ep_one", tp_args + [
            "--moe_experts", str(MOE_EXPERTS), "--epochs", str(EP_EPOCHS)]),
            ("ring_one", ring_args)):
        _cli(train_main.main,
             args + ["--output_dir", os.path.join(root, name)],
             os.path.join(root, f"{name}.log"))
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    seconds = time.time() - t_phase
    print(f"[dist] phase {seconds:.1f} s, the torchrun and gloo launches "
          f"still running beside the later phases; the card's memory in "
          f"use {(total - free) / 2**30:.1f} of {total / 2**30:.1f} GiB",
          flush=True)

    def finish():
        """Collect both launches and check them (phase dist's second
        part)."""
        t_wait = time.time()
        first = _dist_collect(nccl_job, timeout=900)[0]
        g = _dist_collect(gloo_job, timeout=900)
        print(f"[dist] the torchrun launch took {nccl_job['s']:.1f} s and "
              f"the gloo one {gloo_job['s']:.1f} s beside the later phases; "
              f"{time.time() - t_wait:.1f} s waited for here", flush=True)
        # the one-process resumes _check_tp and _check_pp read (the tp and
        # pp runs' epoch 0, the ring run alone's), in a process of their
        # own beside the checks before those two
        resumes = []
        for src, name, args in (
                (tp_out, "tp_resumed", tp_args),
                (pp_out, "pp_resumed", ring_args + ["--epochs", "2"]),
                (os.path.join(root, "ring_one"), "ring_e2",
                 ring_args + ["--epochs", "2"])):
            _resume_from_epoch0(src, os.path.join(root, name), _read_rows(
                os.path.join(src, "training_metrics.csv")))
            resumes += [train_cli, *args, "--output_dir",
                        os.path.join(root, name), "--then"]
        resume_job = _dist_start(root, "resumes", resumes[:-1], nproc=None)
        steps = [first] + first.pop("then")
        by_mode.update(zip(DIST_MODES[1:], steps[:3]))
        rsa_rep, cell_rep, tm, moe_rep, mesh_rep = steps[3:]
        runs, trees, rows = {}, {}, {}
        for mode in DIST_MODES:
            out = os.path.join(root, mode)
            rep = by_mode[mode]
            if rep["launches"] != {**{k: 0 for k in rep["launches"]},
                                   **want}:
                fail(f"[dist] {mode}: launches {rep['launches']}, want "
                     f"{want}")
            if rep["backend"] != (None if mode == "single" else "nccl"):
                fail(f"[dist] {mode}: backend {rep['backend']}")
            runs[mode] = rep
            trees[mode] = _ckpt_trees(out)
            rows[mode] = _read_rows(os.path.join(out,
                                                 "training_metrics.csv"))
            print(f"[dist] {mode}: {rep['s']:.1f} s, peak "
                  f"{rep['peak_gib']:.3f} GiB ({rep['start_gib']:.3f} GiB "
                  f"held at its start), launches "
                  + ", ".join(f"{k} {v}" for k, v in sorted(
                      rep["launches"].items()) if v)
                  + "; rows "
                  + "; ".join(",".join(r) for r in rows[mode][1:]),
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
                _trees_equal(a, b)
                for a, b in zip(trees[mode], trees["single"]))
            got = np.array([[float(v) for v in r[1:]]
                            for r in rows[mode][1:]])
            ref = np.array([[float(v) for v in r[1:]]
                            for r in rows["single"][1:]])
            rel = [_rel_tree_diff(a, b) for a, b in zip(trees[mode],
                                                        trees["single"])]
            cmp[mode] = {
                "bit_equal": exact, "tree_rel_diff": rel,
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
                fail(f"[dist] {mode} at world size 1 differs from one "
                     f"process")
            if mode == "fsdp" and not (
                    cmp[mode]["loss_rel_diff"] <= DIST_LOSS_RTOL
                    and cmp[mode]["acc_diff"] <= DIST_ACC_ATOL
                    and max(rel) <= DIST_PARAM_RTOL):
                fail(f"[dist] fsdp outside the tolerance: {cmp[mode]}")
        del trees
        for mode in DIST_MODES[1:]:     # the disk: 1.4 GB a run
            shutil.rmtree(os.path.join(root, mode))
        main_launches = {k: sum(runs[m]["launches"][k]
                                for m in DIST_MODES if m != "single")
                         for k in want}

        # --- the per-epoch RSA and one grid cell: torchrun at world size 1
        # (above) against the same CLIs alone (in this process) ---
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
            fail(f"[dist] launches {rsa_rep['launches']} "
                 f"{cell_rep['launches']}")

        # --- ms a step per mode, in turns, in one process (the launch
        # above) ---
        per_step_want = {"dw_db": 49, "flash3_bwd": 12, "flash3_fwd": 12}
        for mode, got in tm["per_step"].items():
            if {k: got[k] for k in per_step_want} != per_step_want:
                fail(f"[dist] {mode}: a step launched {got}")
        step_ms = {m: statistics.mean(x for t in v for x in t)
                   for m, v in tm["turns"].items()}
        print("[dist] a step's launches, every mode: flash3_fwd 12, "
              "flash3_bwd 12, dw_db 49; ms a step in turns (single, dp, "
              "zero1, fsdp, and back; 10 steps a turn): " + "; ".join(
                  f"{m} {step_ms[m]:.2f} (turns "
                  + ", ".join(f"{statistics.mean(t):.2f}" for t in v)
                  + f"; +{step_ms[m] - step_ms['single']:.2f})"
                  for m, v in tm["turns"].items())
              + f"; peak in that process {tm['peak_gib']:.2f} GiB "
              f"(four models); {smi_line()}", flush=True)

        # --- the MoE ViT in dp at world size 1 (the chain's last CLI, one
        # epoch) against epoch 0 of phase moe's run alone, bit for bit
        # (that epoch alone here when phase moe did not run) ---
        from vit_project_torch.ckpt import serialization as ser
        moe_dp = os.path.join(root, "moe_dp")
        alone = ser.load(os.path.join(moe_alone,
                                      "checkpoint_epoch_000.pth"))
        moe_exact = _read_rows(os.path.join(
            moe_dp, "training_metrics.csv")) == _read_rows(os.path.join(
                moe_alone, "training_metrics.csv"))[:2] \
            and all(_trees_equal(a, b) for a, b in zip(
                _ckpt_trees(moe_dp), (alone["params"], alone["opt_state"])))
        del alone
        moe_want = {k: v * MOE_STEPS // MOE_EPOCHS
                    for k, v in MOE_PER_STEP.items()}
        moe_want["flash3_fwd"] += 12
        print(f"[dist] MoE (--moe_experts {MOE_EXPERTS} --fused_dw) under "
              f"torchrun, world size 1 (backend {moe_rep['backend']}): "
              f"{moe_rep['s']:.1f} s, launches "
              + ", ".join(f"{k} {moe_rep['launches'][k]}" for k in sorted(
                  moe_want))
              + "; against the run alone: "
              + ("bit-equal rows and checkpoints" if moe_exact
                 else "DIFFERS"), flush=True)
        if not moe_exact or moe_rep["backend"] != "nccl" or any(
                moe_rep["launches"][k] != v for k, v in moe_want.items()):
            fail(f"[dist] MoE dp at world size 1: bit-equal {moe_exact}, "
                 f"{moe_rep}")
        for d in (moe_dp, moe_alone):
            shutil.rmtree(d)

        g_rsa = [rep["then"][0] for rep in g]
        g_rows = _read_rows(os.path.join(gloo_out, "training_metrics.csv"))
        got = np.array([[float(v) for v in r[1:]] for r in g_rows[1:]])
        ref = np.array([[float(v) for v in r[1:]]
                        for r in rows["single"][1:1 + GLOO_EPOCHS]])
        g_loss = float(np.abs(got[:, :2] / ref[:, :2] - 1).max())
        g_acc = float(np.abs(got[:, 2] - ref[:, 2]).max())
        half = {"flash3_fwd": 12 * (4 + 1) * GLOO_EPOCHS,
                "flash3_bwd": 12 * 4 * GLOO_EPOCHS}
        for rep in g:
            if rep["backend"] != "gloo" or any(
                    rep["launches"][k] != v for k, v in half.items()):
                fail(f"[dist] gloo rank {rep['rank']}: {rep}")
        rho_g = pd.read_csv(os.path.join(root, "rsa_gloo.csv"))["rsa_score"]
        rho_1 = pd.read_csv(rsa_one)["rsa_score"]
        rho_diff = float(np.abs(rho_g.to_numpy() - rho_1.to_numpy()).max())
        print(f"[dist] 2 ranks, gloo, one card (128 images a rank, no "
              f"fused_dw): {g[0]['s']:.1f} s, peak "
              f"{max(r['peak_gib'] for r in g):.2f} GiB a rank; rows "
              + "; ".join(",".join(r) for r in g_rows[1:])
              + f"; against one process: losses {g_loss:.3e} relative, "
              f"accuracy {g_acc:.3f} points; RSA over 2 ranks "
              f"{g_rsa[0]['s']:.1f} s, rho within {rho_diff:.2e} of one "
              f"process's", flush=True)
        if not (g_loss <= DIST_LOSS_RTOL and g_acc <= DIST_ACC_ATOL
                and rho_diff <= DIST_RHO_ATOL):
            fail(f"[dist] gloo 2-rank run outside the tolerance: losses "
                 f"{g_loss}, accuracy {g_acc}, rho {rho_diff}")
        shutil.rmtree(gloo_out)
        ep = _check_ep(root, ep_out, [rep["then"][3] for rep in g],
                       [rep["then"][4] for rep in g])
        sp = _check_sp(root, sp_out, ring_out,
                       [[rep["then"][k] for rep in g] for k in (5, 6, 7)])
        serve_mesh = _check_serve_mesh(mesh_rep,
                                       [rep["then"][8] for rep in g])
        _dist_collect(resume_job)
        tp = _check_tp(root, tp_out, [rep["then"][1] for rep in g],
                       [rep["then"][2] for rep in g])
        pp = _check_pp(root, pp_out,
                       [[rep["then"][k] for rep in g] for k in (9, 10)])
        for d in ("single", "gloo_tp", "tp_one", "tp_resumed", "gloo_ep",
                  "ep_one", "gloo_sp", "gloo_ring", "ring_one",
                  "imagenet_sp", "gloo_pp", "pp_resumed", "ring_e2"):
            shutil.rmtree(os.path.join(root, d))
        RESULTS["dist"] = {
            "runs": runs, "compare": cmp, "rsa": rsa_rep, "cell": cell_rep,
            "time_modes": tm, "step_ms": step_ms, "moe_dp": moe_rep,
            "moe_dp_bit_equal": moe_exact, "gloo": g, "gloo_rsa": g_rsa,
            "gloo_rows": g_rows[1:], "gloo_loss_rel": g_loss,
            "gloo_acc_diff": g_acc, "gloo_rho_diff": rho_diff, "tp": tp,
            "ep": ep, "sp": sp, "serve_mesh": serve_mesh, "pp": pp,
            "seconds": seconds, "torchrun_s": nccl_job["s"],
            "gloo_s": gloo_job["s"], "finish_s": time.time() - t_wait}
        print(f"[dist] both launches checked, {time.time() - t_wait:.1f} s "
              f"after the wait for them began", flush=True)
        return {**main_launches, "tp": tp["launches"], "ep": ep["launches"],
                "sp": sp["launches"], "serve_mesh": serve_mesh["launches"],
                "pp": pp["launches"]}

    return finish


def _check_serve_mesh(nccl: dict, gloo: list) -> dict:
    """_serve_mesh's reports: at world size 1 under NCCL the dp engine
    bit-equal to the engine alone with 12 flash3_fwd a chunk; on each gloo
    rank the dp and tp engines within SERVE_MESH_GLOO_RTOL of the engine
    alone, 12 flash3_fwd a chunk, both planted tp faults outside it, and
    the ranks' outputs the same bits.
    Returns the numbers, with the flash3_fwd launches that the ranks
    counted in their meshed chunks summed (one chunk a rank an engine)."""
    per_chunk = 12
    dp = nccl["dp"]
    print(f"[dist] serve_mesh, NCCL world size 1, ViT-B/16 bf16 bucket "
          f"{nccl['bucket']}: dp engine "
          f"{'bit-equal to' if dp['bit_equal'] else 'DIFFERS from'} the "
          f"engine alone, flash3_fwd {dp['launches']} a chunk; images/s in "
          f"turns: alone {nccl['solo_images_per_s']:.1f}, dp "
          f"{dp['images_per_s']:.1f}", flush=True)
    if not (dp["bit_equal"] and dp["launches"] == per_chunk
            and nccl["launches_solo"] == per_chunk
            and nccl["backend"] == "nccl"):
        fail(f"[dist] serve_mesh under NCCL: {nccl}")
    for rep in gloo:
        print(f"[dist] serve_mesh, gloo rank {rep['rank']} of 2, bucket "
              f"{rep['bucket']}: " + "; ".join(
                  f"{k} {rep[k]['rel_err']:.3e} of the largest logit from "
                  f"the engine alone (bound {SERVE_MESH_GLOO_RTOL:.0e}), "
                  f"flash3_fwd {rep[k]['launches']} a chunk, qkv rows "
                  f"{rep[k]['qkv_rows']}, {rep[k]['call_s']:.3f} s a call"
                  for k in ("dp", "tp")), flush=True)
        for k in ("dp", "tp"):
            r = rep[k]
            if not (r["finite"] and r["launches"] == per_chunk
                    and r["rel_err"] <= SERVE_MESH_GLOO_RTOL
                    and r["shape"] == [rep["bucket"], 1000]):
                fail(f"[dist] serve_mesh gloo rank {rep['rank']} {k}: {r}")
        faults = {k: rep[k] for k in ("fault_unsummed", "fault_other_heads")}
        print(f"[dist] serve_mesh, gloo rank {rep['rank']}: planted tp "
              "faults " + ", ".join(f"{k[6:]} {v:.3e}"
                                    for k, v in faults.items())
              + f" of the largest logit (each must exceed "
              f"{SERVE_MESH_GLOO_RTOL:.0e})", flush=True)
        if not all(v > SERVE_MESH_GLOO_RTOL for v in faults.values()):
            fail(f"[dist] serve_mesh: a planted tp fault within the bound "
                 f"on gloo rank {rep['rank']}: {faults}")
    if any(gloo[0][k]["sha"] != gloo[1][k]["sha"] for k in ("dp", "tp")):
        fail("[dist] serve_mesh: the gloo ranks returned other outputs")
    if gloo[0]["tp"]["qkv_rows"] != 3 * 768 // 2:
        fail(f"[dist] serve_mesh: tp rank holds {gloo[0]['tp']} qkv rows")
    return {"nccl": nccl, "gloo": gloo,
            "launches": {"flash3_fwd": dp["launches"] + sum(
                rep[k]["launches"] for rep in gloo for k in ("dp", "tp"))}}


def _check_tp(root: str, tp_out: str, runs: list, checks: list) -> dict:
    """Phase dist's tensor-parallel checks on the gloo launch's reports
    (`runs`: each rank's cli.vit_train --tp_devices 2; `checks`: each
    rank's _tp_check) and two one-process runs on the same data: phase
    dist's "tp_one", the same invocation without --tp_devices (the rows
    within TP_LOSS_RTOL and DIST_ACC_ATOL, the checkpoint's parameters
    within DIST_PARAM_RTOL and its momentum within TP_MOMENTUM_RTOL), and
    "tp_resumed", the tp run's epoch 0 resumed (its epoch-1 row within the
    same bounds of the tp run's)."""
    want = {"flash3_fwd": 12 * (TP_STEPS + TP_VAL_BATCHES),
            "flash3_bwd": 12 * TP_STEPS}
    for rep in runs:
        got = {k: v for k, v in rep["launches"].items() if v}
        if rep["backend"] != "gloo" or got != want:
            fail(f"[dist] tp rank {rep['rank']}: backend {rep['backend']}, "
                 f"launches {got}, want {want}")
    one = os.path.join(root, "tp_one")
    resumed = os.path.join(root, "tp_resumed")
    tp_rows = _read_rows(os.path.join(tp_out, "training_metrics.csv"))

    def against(rows, ref):
        got = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
        want_ = np.array([[float(v) for v in r[1:]] for r in ref[1:]])
        if got.shape != want_.shape or not np.isfinite(got).all():
            fail(f"[dist] tp rows {rows} against {ref}")
        return (float(np.abs(got[:, :2] / want_[:, :2] - 1).max()),
                float(np.abs(got[:, 2] - want_[:, 2]).max()))
    one_rows = _read_rows(os.path.join(one, "training_metrics.csv"))
    loss_rel, acc_diff = against(tp_rows, one_rows)
    tree_rel = [_rel_tree_diff(a, b) for a, b in
                zip(_ckpt_trees(tp_out), _ckpt_trees(one))]
    res_loss, res_acc = against(
        _read_rows(os.path.join(resumed, "training_metrics.csv")), tp_rows)
    blocks = [c["block"] for c in checks]
    step_ms = [statistics.mean(x for t in c["turns"] for x in t)
               for c in checks]
    per_step = [{k: c["per_step"][k] for k in ("flash3_fwd", "flash3_bwd")}
                for c in checks]
    print(f"[dist] tp 2 ranks, gloo, one card (--tp_devices 2, batch "
          f"{TP_BATCH}, 6 heads a rank): {runs[0]['s']:.1f} s, peak "
          f"{max(r['peak_gib'] for r in runs):.2f} GiB a rank, launches "
          f"flash3_fwd {runs[0]['launches']['flash3_fwd']} flash3_bwd "
          f"{runs[0]['launches']['flash3_bwd']} a rank; a step's launches "
          f"{per_step}; ms a step "
          + ", ".join(f"rank {r} {ms:.2f} (turns "
                      + ", ".join(f"{statistics.mean(t):.2f}"
                                  for t in c["turns"]) + ")"
                      for r, (ms, c) in enumerate(zip(step_ms, checks)))
          + "; rows " + "; ".join(",".join(r) for r in tp_rows[1:])
          + f"; against one process: losses {loss_rel:.3e} relative, "
          f"accuracy {acc_diff:.3f} points, parameters {tree_rel[0]:.3e} / "
          f"momentum {tree_rel[1]:.3e} of their largest (bounds "
          f"{TP_LOSS_RTOL}, {DIST_ACC_ATOL:.3f}, {DIST_PARAM_RTOL}, "
          f"{TP_MOMENTUM_RTOL}); its epoch 0 resumed in one "
          f"process: losses {res_loss:.3e}, accuracy {res_acc:.3f}; block "
          f"against the whole plain block: "
          + "; ".join(f"rank {r} qkv {b['qkv_shape']}, y {b['y_rel_err']:.3e}"
                      f", dqkv {b['dqkv_rel_err']:.3e}"
                      for r, b in enumerate(blocks))
          + f" (tol {TP_BLOCK_RTOL}); {smi_line()}", flush=True)
    for b in blocks:
        if b["qkv_shape"] != [TP_BATCH, 197, 1152] or {
                k: b["launches"][k] for k in ("flash3_fwd", "flash3_bwd")} \
                != {"flash3_fwd": 1, "flash3_bwd": 1} \
                or not (b["y_rel_err"] <= TP_BLOCK_RTOL
                        and b["dqkv_rel_err"] <= TP_BLOCK_RTOL):
            fail(f"[dist] tp block: {b}")
    if per_step != [{"flash3_fwd": 12, "flash3_bwd": 12}] * 2:
        fail(f"[dist] a tp step launched {per_step}")
    if not (max(loss_rel, res_loss) <= TP_LOSS_RTOL
            and max(acc_diff, res_acc) <= DIST_ACC_ATOL
            and tree_rel[0] <= DIST_PARAM_RTOL
            and tree_rel[1] <= TP_MOMENTUM_RTOL):
        fail(f"[dist] tp outside the tolerance of one process: losses "
             f"{loss_rel} / {res_loss}, accuracy {acc_diff} / {res_acc}, "
             f"trees {tree_rel}")
    return {"runs": runs, "checks": checks, "rows": tp_rows[1:],
            "step_ms": step_ms, "loss_rel": loss_rel, "acc_diff": acc_diff,
            "tree_rel": tree_rel, "resumed_loss_rel": res_loss,
            "resumed_acc_diff": res_acc,
            "launches": {k: runs[0]["launches"][k] for k in want}}


def _check_ep(root: str, ep_out: str, runs: list, checks: list) -> dict:
    """Phase dist's expert-parallel checks on the gloo launch's reports
    (`runs`: each rank's cli.vit_train --moe_experts 8 --ep_devices 2 for
    EP_EPOCHS; `checks`: each rank's _ep_check) against phase dist's
    one-process run "ep_one" on the same data (the MoE run without
    --ep_devices, as long): the rows within TP_LOSS_RTOL and DIST_ACC_ATOL,
    the checkpoint's parameters within DIST_PARAM_RTOL and its momentum
    within TP_MOMENTUM_RTOL."""
    steps = 1024 // TP_BATCH * EP_EPOCHS
    want = {"flash3_fwd": 12 * (steps + 256 // TP_BATCH * EP_EPOCHS),
            "flash3_bwd": 12 * steps}
    for rep in runs:
        got = {k: v for k, v in rep["launches"].items() if v}
        if rep["backend"] != "gloo" or got != want:
            fail(f"[dist] ep rank {rep['rank']}: backend {rep['backend']}, "
                 f"launches {got}, want {want}")
    one = os.path.join(root, "ep_one")
    rows = _read_rows(os.path.join(ep_out, "training_metrics.csv"))
    one_rows = _read_rows(os.path.join(one, "training_metrics.csv"))
    got = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    ref = np.array([[float(v) for v in r[1:]] for r in one_rows[1:]])
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"[dist] ep rows {rows} against {one_rows}")
    loss_rel = float(np.abs(got[:, :2] / ref[:, :2] - 1).max())
    acc_diff = float(np.abs(got[:, 2] - ref[:, 2]).max())
    ta, tb = _ckpt_trees(ep_out), _ckpt_trees(one)
    tree_rel = [_rel_tree_diff(a, b) for a, b in zip(ta, tb)]
    exact = rows == one_rows and all(_trees_equal(a, b)
                                     for a, b in zip(ta, tb))
    del ta, tb
    step_ms = [statistics.mean(x for t in c["turns"] for x in t)
               for c in checks]
    per_step = [{k: c["per_step"][k] for k in ("flash3_fwd", "flash3_bwd")}
                for c in checks]
    print(f"[dist] ep 2 ranks, gloo, one card (--moe_experts {MOE_EXPERTS} "
          f"--ep_devices 2, batch {TP_BATCH}, "
          f"{checks[0]['experts_here']} experts a MoE block a rank): "
          f"{runs[0]['s']:.1f} s, peak "
          f"{max(r['peak_gib'] for r in runs):.2f} GiB a rank, launches "
          f"flash3_fwd {runs[0]['launches']['flash3_fwd']} flash3_bwd "
          f"{runs[0]['launches']['flash3_bwd']} a rank; a step's launches "
          f"{per_step}; ms a step "
          + ", ".join(f"rank {r} {ms:.2f}" for r, ms in enumerate(step_ms))
          + "; rows " + "; ".join(",".join(r) for r in rows[1:])
          + f"; against one process: "
          + ("bit-equal rows and checkpoints" if exact else
             f"losses {loss_rel:.3e} relative, accuracy {acc_diff:.3f} "
             f"points, parameters {tree_rel[0]:.3e} / momentum "
             f"{tree_rel[1]:.3e} of their largest")
          + f" (bounds {TP_LOSS_RTOL}, {DIST_ACC_ATOL:.3f}, "
          f"{DIST_PARAM_RTOL}, {TP_MOMENTUM_RTOL}); {smi_line()}",
          flush=True)
    if per_step != [{"flash3_fwd": 12, "flash3_bwd": 12}] * 2 or \
            [c["experts_here"] for c in checks] != [MOE_EXPERTS // 2] * 2:
        fail(f"[dist] an ep step launched {per_step}, experts "
             f"{[c['experts_here'] for c in checks]}")
    if not (loss_rel <= TP_LOSS_RTOL and acc_diff <= DIST_ACC_ATOL
            and tree_rel[0] <= DIST_PARAM_RTOL
            and tree_rel[1] <= TP_MOMENTUM_RTOL):
        fail(f"[dist] ep outside the tolerance of one process: losses "
             f"{loss_rel}, accuracy {acc_diff}, trees {tree_rel}")
    return {"runs": runs, "checks": checks, "rows": rows[1:],
            "step_ms": step_ms, "loss_rel": loss_rel, "acc_diff": acc_diff,
            "tree_rel": tree_rel, "bit_equal": exact,
            "launches": {k: runs[0]["launches"][k] for k in want}}


def _check_sp(root: str, sp_out: str, ring_out: str,
              reports: list) -> dict:
    """Phase dist's sequence-parallel checks on the gloo launch's reports
    (`reports`: each rank's cli.vit_train --sp_devices 2, one epoch of the
    tp run's data; each rank's --sp_devices 2 --sp_ring, one epoch of the
    small ImageFolder; each rank's _sp_check). Each run against one
    process: the gather run against the epoch-0 row and checkpoint of
    phase dist's one-process run "tp_one" (losses within TP_LOSS_RTOL,
    accuracy DIST_ACC_ATOL, parameters DIST_PARAM_RTOL, momentum
    SP_MOMENTUM_RTOL), the ring run against the same invocation in one
    process, "ring_one" (its
    rows within TP_LOSS_RTOL and SP_ACC_ATOL, its trees within
    DIST_PARAM_RTOL and TP_MOMENTUM_RTOL); the momentum leaves furthest
    apart printed. 12 / 12 flash3 launches a step in the gather form and
    none in the ring's; each form's block within SP_BLOCK_RTOL of the whole
    plain block; the gather's bf16 gradient sum equal to the f32 sum."""
    gather_runs, ring_runs, checks = reports
    want = {"gather": {"flash3_fwd": 12 * (SP_STEPS + SP_VAL_BATCHES),
                       "flash3_bwd": 12 * SP_STEPS},
            "ring": {}}
    step_want = {"gather": {"flash3_fwd": 12, "flash3_bwd": 12},
                 "ring": {"flash3_fwd": 0, "flash3_bwd": 0}}
    block_want = {"gather": {"flash3_fwd": 1, "flash3_bwd": 1},
                  "ring": {"flash3_fwd": 0, "flash3_bwd": 0}}
    one = os.path.join(root, "ring_one")
    refs = {"gather": (os.path.join(root, "tp_one"), "checkpoint_epoch_000.pth",
                       SP_MOMENTUM_RTOL, DIST_ACC_ATOL),
            "ring": (one, "checkpoint_latest.pth", TP_MOMENTUM_RTOL,
                     SP_ACC_ATOL)}
    problems, res = [], {"forms": {}}
    for form, out, runs in (("gather", sp_out, gather_runs),
                            ("ring", ring_out, ring_runs)):
        ref_dir, ref_ckpt, mom_rtol, acc_atol = refs[form]
        for rep in runs:
            got = {k: v for k, v in rep["launches"].items() if v}
            if rep["backend"] != "gloo" or got != want[form]:
                problems.append(f"sp {form} rank {rep['rank']}: backend "
                                f"{rep['backend']}, launches {got}, want "
                                f"{want[form]}")
        rows = _read_rows(os.path.join(out, "training_metrics.csv"))
        got = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
        ref = np.array([[float(v) for v in r[1:]] for r in _read_rows(
            os.path.join(ref_dir, "training_metrics.csv"))[1:2]])
        if got.shape != ref.shape or not np.isfinite(got).all():
            fail(f"[dist] sp {form} rows {rows} against {ref}")
        loss_rel = float(np.abs(got[:, :2] / ref[:, :2] - 1).max())
        acc_diff = float(np.abs(got[:, 2] - ref[:, 2]).max())
        trees, one_trees = _ckpt_trees(out), _ckpt_trees(ref_dir, ref_ckpt)
        tree_rel = [_rel_tree_diff(a, b) for a, b in zip(trees, one_trees)]
        worst = _worst_leaves(trees[1], one_trees[1])
        del trees, one_trees
        steps, val = ((SP_STEPS, SP_VAL_BATCHES) if form == "gather"
                      else (SP_RING_STEPS, SP_RING_VAL_BATCHES))
        print(f"[dist] sp {form} form, 2 ranks, gloo, one card "
              f"(cli.vit_train --sp_devices 2"
              f"{' --sp_ring' if form == 'ring' else ''}, batch {TP_BATCH}, "
              f"tokens " + " / ".join(f"[{c['bounds'][0]}, {c['bounds'][1]})"
                                      for c in checks)
              + f"): {runs[0]['s']:.1f} s for {steps} steps and {val} "
              f"validation batches, peak "
              + " / ".join(f"{r['peak_gib']:.2f}" for r in runs)
              + f" GiB a rank, launches a rank flash3_fwd "
              f"{runs[0]['launches']['flash3_fwd']} flash3_bwd "
              f"{runs[0]['launches']['flash3_bwd']}; rows "
              + "; ".join(",".join(r) for r in rows[1:])
              + f"; against one process: losses {loss_rel:.3e} relative, "
              f"accuracy {acc_diff:.3f} points, parameters {tree_rel[0]:.3e}"
              f" / momentum {tree_rel[1]:.3e} of their largest (bounds "
              f"{TP_LOSS_RTOL}, {acc_atol:.3f}, {DIST_PARAM_RTOL}, "
              f"{mom_rtol}; the momentum leaves furthest apart, over the "
              f"largest momentum: " + ", ".join(f"{n} {v:.3e}"
                                                for n, v in worst)
              + ")", flush=True)
        if not (loss_rel <= TP_LOSS_RTOL and acc_diff <= acc_atol
                and tree_rel[0] <= DIST_PARAM_RTOL
                and tree_rel[1] <= mom_rtol):
            problems.append(f"sp {form} run outside the tolerance of one "
                            f"process: losses {loss_rel}, accuracy "
                            f"{acc_diff}, trees {tree_rel}")
        step_ms = [statistics.mean(x for t in c["turns"][form] for x in t)
                   for c in checks]
        blocks = [c["blocks"][form] for c in checks]
        per_step = [c["per_step"][form] for c in checks]
        res["forms"][form] = {
            "runs": runs, "rows": rows[1:], "loss_rel": loss_rel,
            "acc_diff": acc_diff, "tree_rel": tree_rel,
            "worst_momentum": worst, "step_ms": step_ms, "blocks": blocks,
            "per_step": per_step,
            "step_peak_gib": [c["step_peak_gib"][form] for c in checks]}
        print(f"[dist] sp {form} form, trainer steps on one batch: a step's "
              f"launches {per_step}; ms a step in turns (gather, ring, "
              f"ring, gather; {SP_TIMED_STEPS} a turn) "
              + ", ".join(f"rank {r} {ms:.2f} (turns "
                          + ", ".join(f"{statistics.mean(t):.2f}"
                                      for t in c["turns"][form]) + ")"
                          for r, (ms, c) in enumerate(zip(step_ms, checks)))
              + "; a step's peak over the trainers' state "
              + " / ".join(f"{c['step_peak_gib'][form]:.2f}"
                           for c in checks)
              + " GiB; block against the whole plain block: "
              + "; ".join(f"rank {r} y {b['y_rel_err']:.3e}, dx "
                          f"{b['dx_rel_err']:.3e}, launches {b['launches']}"
                          for r, b in enumerate(blocks))
              + f" (tol {SP_BLOCK_RTOL}); {smi_line()}", flush=True)
        for b in blocks:
            if b["launches"] != block_want[form] or not (
                    b["y_rel_err"] <= SP_BLOCK_RTOL
                    and b["dx_rel_err"] <= SP_BLOCK_RTOL):
                problems.append(f"sp {form} block: {b}")
        if per_step != [step_want[form]] * 2:
            problems.append(f"an sp {form} step launched {per_step}")
    sums = [c["bf16_sum"] for c in checks]
    print(f"[dist] sp gather backward: gloo's bf16 all-reduce of a "
          f"[{TP_BATCH}, 197, 2304] gradient against the f32 sum rounded "
          f"to bf16 once: " + "; ".join(
              f"rank {r} {s_['differ']} of {s_['elements']} elements differ"
              for r, s_ in enumerate(sums)), flush=True)
    if any(s_["differ"] for s_ in sums):
        problems.append(f"the bf16 gradient sum differs from the f32 sum: "
                        f"{sums}")
    res["bf16_sum"] = sums
    if problems:
        fail("[dist] " + "; ".join(problems))
    res["launches"] = {k: gather_runs[0]["launches"][k]
                       for k in ("flash3_fwd", "flash3_bwd")}
    return res


def _check_pp(root: str, pp_out: str, reports: list) -> dict:
    """Phase dist's pipeline checks on the gloo launch's reports
    (`reports`: each rank's cli.vit_train --pp_stages 2 --pp_micro 4, one
    epoch of the sp ring run's ImageFolder; each rank's _pp_check). The
    run against the same invocation in one process (_check_sp's ring_one):
    its rows within TP_LOSS_RTOL and SP_ACC_ATOL, its flat checkpoint,
    read by the one-process loader, within DIST_PARAM_RTOL and
    TP_MOMENTUM_RTOL; its epoch 0 and ring_one's each resumed for a second
    epoch in one process ("pp_resumed", "ring_e2"), the epoch-1 rows
    within the same bounds of each other. 6 x 4 flash3_fwd and flash3_bwd a rank a step (the bubble
    skipped), at [16, 197, 2304]; pp_check's forward and gradients within
    PP_LOGITS_RTOL and PP_GRAD_RTOL of the whole model's, and each planted
    fault above its bound."""
    from vit_project_torch.ckpt import vit_ckpt
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.train import vit_loop
    runs, checks = reports
    per_step = {"flash3_fwd": 12 // PP_STAGES * PP_MICRO,
                "flash3_bwd": 12 // PP_STAGES * PP_MICRO}
    want = {"flash3_fwd": per_step["flash3_fwd"] * (SP_RING_STEPS
                                                    + SP_RING_VAL_BATCHES),
            "flash3_bwd": per_step["flash3_bwd"] * SP_RING_STEPS}
    problems = []
    for rep in runs:
        got = {k: v for k, v in rep["launches"].items() if v}
        if rep["backend"] != "gloo" or got != want:
            problems.append(f"pp rank {rep['rank']}: backend "
                            f"{rep['backend']}, launches {got}, want {want}")
    one = os.path.join(root, "ring_one")
    rows = _read_rows(os.path.join(pp_out, "training_metrics.csv"))
    one_rows = _read_rows(os.path.join(one, "training_metrics.csv"))

    def against(got_rows, ref_rows):
        got = np.array([[float(v) for v in r[1:]] for r in got_rows[1:]])
        ref = np.array([[float(v) for v in r[1:]] for r in ref_rows[1:]])
        if got.shape != ref.shape or not np.isfinite(got).all():
            fail(f"[dist] pp rows {got_rows} against {ref_rows}")
        return (float(np.abs(got[:, :2] / ref[:, :2] - 1).max()),
                float(np.abs(got[:, 2] - ref[:, 2]).max()))
    loss_rel, acc_diff = against(rows, one_rows)
    trees, one_trees = _ckpt_trees(pp_out), _ckpt_trees(one)
    tree_rel = [_rel_tree_diff(a, b) for a, b in zip(trees, one_trees)]
    worst = _worst_leaves(trees[1], one_trees[1])
    # the one-process loader takes the flat checkpoint whole (strict)
    vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
    ck = vit_ckpt.load_checkpoint(os.path.join(pp_out,
                                               "checkpoint_latest.pth"))
    vit_loop.load_trees(vvit.empty_vit(vit_cfg, "cpu"), ck["params"])
    del trees, one_trees, ck
    # a second epoch in one process from pp's epoch 0 and from ring_one's
    res_rows, e2_rows = (_read_rows(os.path.join(
        root, name, "training_metrics.csv"))
        for name in ("pp_resumed", "ring_e2"))
    res_loss, res_acc = against(res_rows[:1] + res_rows[2:],
                                e2_rows[:1] + e2_rows[2:])
    block_gib = checks[0]["held"]["whole_gib"] - checks[0]["held"][
        "staged_gib"]
    step_ms = [statistics.mean(c["step_ms"]) for c in checks]
    print(f"[dist] pp 2 stages x 1 data shard, gloo, one card "
          f"(cli.vit_train --pp_stages {PP_STAGES} --pp_micro {PP_MICRO}, "
          f"batch {TP_BATCH}, blocks 0-5 / 6-11): {runs[0]['s']:.1f} s for "
          f"{SP_RING_STEPS} steps and {SP_RING_VAL_BATCHES} validation "
          f"batch, peak " + " / ".join(f"{r['peak_gib']:.2f}" for r in runs)
          + f" GiB a rank, launches a rank flash3_fwd "
          f"{runs[0]['launches']['flash3_fwd']} flash3_bwd "
          f"{runs[0]['launches']['flash3_bwd']} (want {want}); rows "
          + "; ".join(",".join(r) for r in rows[1:])
          + f"; against one process: losses {loss_rel:.3e} relative, "
          f"accuracy {acc_diff:.3f} points, parameters {tree_rel[0]:.3e} / "
          f"momentum {tree_rel[1]:.3e} of their largest (bounds "
          f"{TP_LOSS_RTOL}, {SP_ACC_ATOL:.3f}, {DIST_PARAM_RTOL}, "
          f"{TP_MOMENTUM_RTOL}; the momentum leaves furthest apart: "
          + ", ".join(f"{n} {v:.3e}" for n, v in worst)
          + f"); the flat checkpoint loads whole in one process; epoch 0 "
          f"resumed in one process against one process's own epoch 1: "
          f"losses {res_loss:.3e}, accuracy {res_acc:.3f}", flush=True)
    print(f"[dist] pp_check (batch {TP_BATCH}, {PP_MICRO} microbatches): "
          + "; ".join(
              f"rank {r} (stage {c['stage']}) forward "
              f"{c['forward']['launches']}, logits "
              f"{c['forward']['logits_rel']:.3e}, step "
              f"{c['step']['launches']}, gradients of {c['step']['leaves']} "
              f"leaves {c['step']['grad_rel']:.3e}; faults: zeros hopped "
              f"back {c['fault_zero_hop_grad_rel']:.3e}, microbatches "
              f"reversed {c['fault_order_logits_rel']:.3e}; qkv "
              f"{c['qkv_shapes']}; ms a step "
              f"{statistics.mean(c['step_ms']):.2f}"
              f" ({', '.join(f'{t:.2f}' for t in c['step_ms'])}), a step's "
              f"peak over {c['resident_gib']:.2f} GiB resident "
              f"{c['step_peak_gib']:.2f} GiB"
              for r, c in enumerate(checks))
          + f" (bounds ||err||/||ref|| {PP_LOGITS_RTOL}, {PP_GRAD_RTOL}); "
          f"parameters held whole {checks[0]['held']['whole_gib']:.3f} GiB, "
          f"staged {checks[0]['held']['staged_gib']:.3f} GiB (the other "
          f"stage's blocks {block_gib:.3f} GiB, with their momentum "
          f"{2 * block_gib:.3f}); {smi_line()}", flush=True)
    if not (max(loss_rel, res_loss) <= TP_LOSS_RTOL
            and max(acc_diff, res_acc) <= SP_ACC_ATOL
            and tree_rel[0] <= DIST_PARAM_RTOL
            and tree_rel[1] <= TP_MOMENTUM_RTOL):
        problems.append(f"pp outside the tolerance of one process: losses "
                        f"{loss_rel} / {res_loss}, accuracy {acc_diff} / "
                        f"{res_acc}, trees {tree_rel}")
    for c in checks:
        if c["forward"]["launches"] != {"flash3_fwd": per_step["flash3_fwd"],
                                        "flash3_bwd": 0} \
                or c["step"]["launches"] != per_step \
                or c["qkv_shapes"] != [[TP_BATCH // PP_MICRO, 197, 2304]]:
            problems.append(f"pp_check launches or shapes: {c}")
        if not (c["forward"]["logits_rel"] <= PP_LOGITS_RTOL
                and c["step"]["grad_rel"] <= PP_GRAD_RTOL):
            problems.append(f"pp_check outside its bounds: {c}")
    if max(c["fault_zero_hop_grad_rel"] for c in checks) <= PP_GRAD_RTOL \
            or min(c["fault_order_logits_rel"]
                   for c in checks) <= PP_LOGITS_RTOL:
        problems.append("a planted pipeline fault reads within the bounds: "
                        + str([(c["fault_zero_hop_grad_rel"],
                                c["fault_order_logits_rel"])
                               for c in checks]))
    if problems:
        fail("[dist] " + "; ".join(problems))
    return {"runs": runs, "checks": checks, "rows": rows[1:],
            "loss_rel": loss_rel, "acc_diff": acc_diff, "tree_rel": tree_rel,
            "worst_momentum": worst, "resumed_loss_rel": res_loss,
            "resumed_acc_diff": res_acc, "step_ms": step_ms,
            "launches": {k: runs[0]["launches"][k] for k in want}}


CLIP_DIST_EPOCHS = 2
# 1,444 training images at batch 64: 22 full batches and one of 36
CLIP_DIST_STEPS = 23 * CLIP_DIST_EPOCHS
# CLIP_FULL_FWD flash3_fwd a full-tower forward (the fixture's image
# blocks, 12 text): each step, and the eval (the 362 test images as one
# batch) and the RSA before training and after each epoch; one flash3_bwd a
# step (the last image block)
CLIP_DIST_WANT = {"flash3_fwd": CLIP_FULL_FWD * (CLIP_DIST_STEPS
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
    """CLIP-HBA training across ranks as users launch it, at full width
    (the fixture's ViT-L/14, rank-32 DoRA, bf16, batch 64, 2 epochs, THINGS-sized
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
    targets = np.random.RandomState(SEED + 4).rand(len(fx["names"]), 66) * 2
    data = _write_things_csvs(root, fx["names"], targets)
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
    # the visual tower sequence-parallel through cli.baseline: one epoch
    # of a THINGS subset with the NOD inference set
    sub = os.path.join(root, "sp_things")
    os.makedirs(sub)
    keep = list(range(CLIP_SP_IMAGES)) + list(range(1806, 1854))
    sub_data = _write_things_csvs(sub, [fx["names"][i] for i in keep],
                                  targets[keep], n_train=CLIP_SP_IMAGES)
    # NOD-style names (category, then an index) linked to other images:
    # the run's category-RDM archive needs more than one category
    nod_dir, nod_names = os.path.join(sub, "nod"), []
    os.makedirs(nod_dir)
    for j in range(CLIP_SP_NOD):
        nod_names.append(f"nod{j % 4}_{j:02d}.jpg")
        os.link(os.path.join(fx["img_dir"], fx["names"][CLIP_SP_IMAGES + j]),
                os.path.join(nod_dir, nod_names[-1]))
    nod_csv = os.path.join(sub, "nod.csv")
    with open(nod_csv, "w") as f:
        f.write("\n".join(["image_name"] + nod_names) + "\n")

    def sp_argv(out):
        return ["--csv_file", sub_data["csv_file"], "--img_dir",
                fx["img_dir"], "--inference_csv_file",
                sub_data["inference_csv_file"], "--RDM48_triplet_dir",
                sub_data["RDM48_triplet_dir"], *fx["model_args"],
                "--batch_size", str(CLIP_SP_BATCH), "--epochs", "1",
                "--nod_csv_file", nod_csv,
                "--nod_img_dir", nod_dir, "--output_dir", out]
    sweep_cli_name = "vit_project_torch.cli.sweep"
    runs, files, rows, epoch_s = {}, {}, {}, {}
    forks, resumed = {}, {}
    def chain_of(name):
        argv = [*args, "--output_dir", os.path.join(root, name)]
        res_out = os.path.join(root, f"resumed_{name}")
        if name == "gloo2":
            return ["--gloo", base_cli, *argv, "--device", "cuda:0",
                    "--then", sweep_cli_name, *resumed_argv(res_out),
                    "--device", "cuda:0", "--then", base_cli,
                    *sp_argv(os.path.join(root, "sp_gather")),
                    "--device", "cuda:0", "--sp_devices", "2", "--then",
                    base_cli, *sp_argv(os.path.join(root, "sp_ring")),
                    "--device", "cuda:0", "--sp_devices", "2",
                    "--sp_ring", "--then", "clip_sp_check", fx["wpath"]]
        return [base_cli, *argv, "--then", sweep_cli_name,
                *forks_argv(os.path.join(root, "forks_dp1")), "--then",
                sweep_cli_name, *resumed_argv(res_out), "--then",
                "clip_step_ms", fx["wpath"]]
    jobs = {}
    for name, nproc in (("alone", 0), ("dp1", 1), ("gloo2", 2)):
        out = os.path.join(root, name)
        if nproc == 0:
            reps = [_alone(name, baseline_cli.main,
                           [*args, "--output_dir", out], root)]
            text = reps[0].pop("text")
            # both launches read the run alone's adapters: they start now
            # and run side by side (each counts its own launches)
            for other, n in (("dp1", 1), ("gloo2", 2)):
                jobs[other] = _dist_start(root, other, chain_of(other),
                                          nproc=n)
        else:
            reps = _dist_collect(jobs[name])
            if nproc == 1:
                forks["forks_dp1"], res, tm = reps[0].pop("then")
                resumed[name] = [res]
            else:
                thens = [rep.pop("then") for rep in reps]
                resumed[name] = [t[0] for t in thens]
                sp_runs = {"gather": [t[1] for t in thens],
                           "ring": [t[2] for t in thens]}
                clip_sp = [t[3] for t in thens]
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

    # --- the visual tower sequence-parallel over the two gloo ranks (the
    # gloo2 launch's last three modules): each form's cli.baseline run
    # against the same invocation alone (here), and its trainer steps
    # against the trainer alone ---
    sp_alone = os.path.join(root, "sp_alone")
    sp_ref = _alone("sp_alone", baseline_cli.main, sp_argv(sp_alone), root)
    sp_ref.pop("text")
    sp_res = {"trainer": _clip_sp_report(clip_sp),
              "runs": _check_clip_sp_runs(root, sp_runs, sp_ref, fx)}
    sp_res["launches"] = sp_res["runs"]["launches"]
    for d in ("sp_gather", "sp_ring", "sp_alone", "sp_things"):
        shutil.rmtree(os.path.join(root, d))

    # --- ms a step, alone and dp at world size 1, in turns (the dp1
    # launch) ---
    want_step = {"flash3_fwd": CLIP_FULL_FWD, "flash3_bwd": 1}
    if any(v != want_step for v in tm["per_step"].values()):
        fail(f"[clip_dist] a step launched {tm['per_step']}")
    # medians: a step is host-bound enough that a turn can catch a stall
    step_ms = {m: statistics.median(x for t in v for x in t)
               for m, v in tm["turns"].items()}
    print(f"[clip_dist] a step launches flash3_fwd {CLIP_FULL_FWD}, "
          f"flash3_bwd 1 alone "
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
        "sp": sp_res, "seconds": time.time() - t_phase}
    print(f"[clip_dist] phase {time.time() - t_phase:.1f} s", flush=True)
    return {**{k: sum(r["launches"][k] for name in ("dp1", "gloo2")
                      for r in runs[name] + resumed[name])
               + forks["forks_dp1"]["launches"][k]
               for k in ("flash3_fwd", "flash3_bwd")},
            "sp": sp_res["launches"]}


def _clip_sp_report(reps: list) -> dict:
    """clip_dist's sequence-parallel trainer check on each rank's
    _clip_sp_check: a step's launches (CLIP_FULL_FWD / 1 in the gather
    form, the whole image sequence through the kernels; 12 / 0 in the
    ring's, the
    text tower alone), each step's loss against the trainer alone's within
    CLIP_DIST_LOSS_RTOL (gather) and CLIP_RING_LOSS_RTOL (ring), both
    forms' adapters and moments within CLIP_SP_PARAM_RTOL and
    CLIP_SP_MOMENT_RTOL, and the planted fault's moments beyond it."""
    full = {"flash3_fwd": CLIP_FULL_FWD, "flash3_bwd": 1}
    want = {"one": full, "gather": full,
            "ring": {"flash3_fwd": 12, "flash3_bwd": 0}, "fault": full}
    loss_rtol = {"gather": CLIP_DIST_LOSS_RTOL, "ring": CLIP_RING_LOSS_RTOL,
                 "fault": CLIP_DIST_LOSS_RTOL}
    res = {"ranks": reps, "compare": {}}
    problems = []
    for rep in reps:
        got = rep["clip_sp"]
        for form in want:
            if got[form]["launches"] != want[form] or None in \
                    got[form]["losses"]:
                problems.append(f"{form} rank {rep['rank']}: {got[form]}")
        for form in ("gather", "ring", "fault"):
            d = got[form]["against_one"]
            c = {**d, "loss_rel": float(np.abs(
                     np.array(got[form]["losses"])
                     / np.array(got["one"]["losses"]) - 1).max()),
                 "param_l2_max": max(d["param_l2"].values()),
                 "moment": max(max(d["mu"].values()),
                               max(d["nu"].values()))}
            res["compare"].setdefault(form, []).append(c)
            within = (c["loss_rel"] <= loss_rtol[form]
                      and c["param_l2_max"] <= CLIP_SP_PARAM_RTOL
                      and c["moment"] <= CLIP_SP_MOMENT_RTOL)
            if within != (form != "fault"):
                problems.append(f"{form} rank {rep['rank']}: "
                                + ("outside" if form != "fault" else
                                   "the planted fault within")
                                + f" the tolerance of the trainer alone: "
                                f"{c}")
    r0 = reps[0]["clip_sp"]
    print(f"[clip_dist] CLIP-HBA visual sp trainer over 2 gloo ranks "
          f"(ViT-L/14 widths, {CLIP_FIXTURE_BLOCKS} image blocks, tokens 129 + "
          f"128, batch {CLIP_SP_BATCH}, "
          f"{CLIP_SP_STEPS} steps): "
          + "; ".join(
              f"{form} s a step {r0[form]['step_s']:.3f}, launches "
              f"{r0[form]['launches']}, losses "
              + ", ".join(f"{x:.6f}" for x in r0[form]["losses"])
              for form in want)
          + "; against alone, rank 0 / 1: "
          + "; ".join(f"{form} losses "
                      + " / ".join(f"{c['loss_rel']:.3e}" for c in cs)
                      + ", adapters (L2 over the move; largest over the "
                      "largest move) "
                      + " / ".join(
                          ", ".join(f"{t} {c['param_l2'][t]:.3e} "
                                    f"{c['param'][t]:.3e}"
                                    for t in sorted(c["param"]))
                          for c in cs)
                      + ", mu " + " / ".join(
                          ", ".join(f"{t} {v:.3e}"
                                    for t, v in sorted(c["mu"].items()))
                          for c in cs)
                      + ", nu " + " / ".join(
                          ", ".join(f"{t} {v:.3e}"
                                    for t, v in sorted(c["nu"].items()))
                          for c in cs)
                      for form, cs in res["compare"].items())
          + f" (bounds losses {CLIP_DIST_LOSS_RTOL} gather, "
          f"{CLIP_RING_LOSS_RTOL} ring; adapters {CLIP_SP_PARAM_RTOL}, "
          f"moments {CLIP_SP_MOMENT_RTOL}; the fault (text gradient "
          f"twice) must exceed them); {smi_line()}", flush=True)
    if problems:
        fail("[clip_dist] sp trainer: " + "; ".join(problems))
    return res


def _clip_run_trees(out: str, spec: dict) -> tuple:
    """(rows, (adapters, mu, nu), NOD embeddings, files) of a one-epoch
    cli.baseline run in `out`."""
    import pandas as pd
    from vit_project_torch.adapters import dora as adora
    from vit_project_torch.ckpt import serialization as ser

    def find(prefix):
        return next(os.path.join(d, n) for d, _, ns in os.walk(out)
                    for n in ns if n.startswith(prefix))
    state = ser.load(find("epoch1_random_states"))["optimizer_state"][0]
    adapters = adora.from_reference_names(
        ser.load_flat(find("epoch1_dora_params")), spec)
    emb = pd.read_csv(find("nod_embeddings_epoch1")).iloc[:, 1:].to_numpy()
    return (_read_rows(find("training_res_")),
            (adapters, state.mu, state.nu), emb,
            sorted(_run_files(out)))


def _check_clip_sp_runs(root: str, sp_runs: dict, ref_rep: dict,
                        fx: dict) -> dict:
    """clip_dist's sequence-parallel runs: each rank's cli.baseline
    --sp_devices 2 (gather) and --sp_ring report (`sp_runs`), and their
    trees, against the same invocation alone (`ref_rep`, its tree in
    root/sp_alone): the same files (rank 1 writes none), launches (the
    gather's those of the run alone, the ring's its text tower's, a third
    of the forwards' and no backward), rows (losses within
    CLIP_DIST_LOSS_RTOL / CLIP_RING_LOSS_RTOL, rho within
    CLIP_DIST_RHO_ATOL / CLIP_RING_RHO_ATOL), adapters and moments within
    CLIP_SP_PARAM_RTOL and CLIP_SP_MOMENT_RTOL (``_adapter_diffs``) and
    the NOD embeddings within CLIP_SP_EMB_RTOL / CLIP_RING_EMB_RTOL."""
    from vit_project_torch.adapters import dora as adora
    cfg = fx["cfg"]
    spec = adora.dora_spec(cfg.visual.layers, cfg.text.layers, 2, 1)
    ref_rows, ref_trees, ref_emb, ref_files = _clip_run_trees(
        os.path.join(root, "sp_alone"), spec)
    ref_l = {k: v for k, v in ref_rep["launches"].items() if v}
    want = {"gather": ref_l,      # the ring form: the 12 text blocks alone
            "ring": {"flash3_fwd": ref_l["flash3_fwd"] * 12 // CLIP_FULL_FWD}}
    bounds = {"gather": (CLIP_DIST_LOSS_RTOL, CLIP_DIST_RHO_ATOL,
                         CLIP_SP_EMB_RTOL),
              "ring": (CLIP_RING_LOSS_RTOL, CLIP_RING_RHO_ATOL,
                       CLIP_RING_EMB_RTOL)}
    problems, res = [], {"alone": ref_rep, "alone_rows": ref_rows[1:]}
    for form, reps in sp_runs.items():
        rows, trees, emb, files = _clip_run_trees(
            os.path.join(root, f"sp_{form}"), spec)
        for rep in reps:
            got = {k: v for k, v in rep["launches"].items() if v}
            if got != want[form] or rep["backend"] != "gloo" \
                    or rep["writes"] or rep["result"] is not None:
                problems.append(f"{form} rank {rep['rank']}: launches "
                                f"{got} (want {want[form]}), backend "
                                f"{rep['backend']}, writes "
                                f"{rep['writes']}")
        if files != ref_files:
            problems.append(f"{form}: files {files}, alone {ref_files}")
        g = np.array([[float(v) for v in r[1:5]] for r in rows[1:]])
        w = np.array([[float(v) for v in r[1:5]] for r in ref_rows[1:]])
        c = {"loss_rel": float(np.abs(g[:, :2] / w[:, :2] - 1).max()),
             "rho_diff": float(np.abs(g[:, 2] - w[:, 2]).max()),
             "emb_rel": float(np.abs(emb - ref_emb).max()
                              / np.abs(ref_emb).max()),
             **_adapter_diffs(trees, ref_trees, fx["init_tr"])}
        c["param_l2_max"] = max(c["param_l2"].values())
        c["moment"] = max(max(c["mu"].values()), max(c["nu"].values()))
        res[form] = {"reports": reps, "rows": rows[1:], **c}
        print(f"[clip_dist] cli.baseline --sp_devices 2"
              f"{' --sp_ring' if form == 'ring' else ''} over 2 gloo ranks, "
              f"one epoch of {CLIP_SP_IMAGES} THINGS images and "
              f"{CLIP_SP_NOD} NOD: {reps[0]['s']:.1f} s (alone "
              f"{ref_rep['s']:.1f}), peak "
              + " / ".join(f"{r['peak_gib']:.2f}" for r in reps)
              + f" GiB a rank, launches a rank {reps[0]['launches']['flash3_fwd']}"
              f" / {reps[0]['launches']['flash3_bwd']} (alone "
              f"{ref_l}); rows " + "; ".join(",".join(r) for r in rows[1:])
              + f"; against alone: losses {c['loss_rel']:.3e} relative, rho "
              f"{c['rho_diff']:.3e}, NOD embeddings {c['emb_rel']:.3e}, "
              f"adapters (L2 over the move; largest over the largest move) "
              + ", ".join(f"{t} {c['param_l2'][t]:.3e} {c['param'][t]:.3e}"
                          for t in sorted(c["param"]))
              + ", mu " + ", ".join(f"{t} {v:.3e}"
                                    for t, v in sorted(c["mu"].items()))
              + ", nu " + ", ".join(f"{t} {v:.3e}"
                                    for t, v in sorted(c["nu"].items()))
              + f" (bounds {bounds[form][0]}, {bounds[form][1]}, "
              f"{bounds[form][2]}, {CLIP_SP_PARAM_RTOL}, "
              f"{CLIP_SP_MOMENT_RTOL}); same files, rank 1 wrote none",
              flush=True)
        if not (c["loss_rel"] <= bounds[form][0]
                and c["rho_diff"] <= bounds[form][1]
                and c["emb_rel"] <= bounds[form][2]
                and c["param_l2_max"] <= CLIP_SP_PARAM_RTOL
                and c["moment"] <= CLIP_SP_MOMENT_RTOL):
            problems.append(f"{form} outside the tolerance of the run "
                            f"alone: {c}")
    if problems:
        fail("[clip_dist] sp runs: " + "; ".join(problems))
    res["launches"] = {k: sum(sp_runs[f][0]["launches"][k]
                              for f in ("gather", "ring"))
                       for k in ("flash3_fwd", "flash3_bwd")}
    return res


def _drift_runs(tmp: str, label: str, args: list, runs) -> dict:
    """Each of `runs` ((name, extra flags, nproc or None), the first the
    reference) as ``cli.vit_train ARGS EXTRA`` in its own process
    (``--dist_worker``; nproc: that many gloo ranks sharing the card).
    Prints each run's rows, then against the reference the largest
    relative loss difference, the accuracy difference and each checkpoint
    tree's largest difference over its largest value (parameters,
    momentum). Returns {name: those three numbers and the trees'}."""
    train = "vit_project_torch.cli.vit_train"
    rows, trees, out = {}, {}, {}
    for name, extra, nproc in runs:
        tag = f"{label}_{name}".replace(" ", "_")
        run_dir = os.path.join(tmp, tag)
        argv = (["--gloo"] if nproc else []) + [
            train, *args, *extra, "--output_dir", run_dir]
        _dist_run(tmp, tag, argv, nproc=nproc)
        rows[name] = np.array([[float(v) for v in r[1:]] for r in _read_rows(
            os.path.join(run_dir, "training_metrics.csv"))[1:]])
        trees[name] = _ckpt_trees(run_dir)
        shutil.rmtree(run_dir)
        print(f"[drift] {label} {name}: rows "
              + "; ".join(",".join(f"{v:.6f}" for v in r)
                          for r in rows[name]), flush=True)
    ref = runs[0][0]
    for name, _, _ in runs[1:]:
        got, want = rows[name], rows[ref]
        rel = [_rel_tree_diff(a, b) for a, b in zip(trees[name], trees[ref])]
        out[name] = {"loss_rel": float(np.abs(got[:, :2] / want[:, :2]
                                              - 1).max()),
                     "acc_diff": float(np.abs(got[:, 2] - want[:, 2]).max()),
                     "tree_rel": rel,
                     "worst_momentum": _worst_leaves(trees[name][1],
                                                     trees[ref][1])}
        print(f"[drift] {label} {name} against {ref}: losses "
              f"{out[name]['loss_rel']:.3e} relative, accuracy "
              f"{out[name]['acc_diff']:.4f} points, trees {rel[0]:.3e} "
              f"(parameters) / {rel[1]:.3e} (momentum) of their largest; "
              f"the momentum leaves furthest apart "
              + ", ".join(f"{n} {v:.3e}"
                          for n, v in out[name]["worst_momentum"]),
              flush=True)
    return out


def _drift_main(body) -> int:
    """Run `body(tmp, data)` alone on the card: the kernels built, phase
    vit_train's seeded ImageFolder written to `data`; then the card's name
    and power limit. No result line."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        body(tmp, data)
        print(smi_line(), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _dist_drift(lrs: list) -> int:
    """``--dist_drift [LRS]``, run alone: how far the distributed runs drift
    from one process, by learning rate (the measurement behind DIST_LR and
    the tolerances of phase dist). On phase vit_train's seeded
    ImageFolder, ViT-B/16 in bf16 for 2 epochs, at each learning rate: at
    batch 256 one process with ``--fused_dw`` (the reference), one with
    the plain dW+db (the same arithmetic summed in another order: the
    spread of a change that should not matter), and two dp ranks under
    gloo sharing the card (128 images a rank, the plain dW+db); at
    TP_BATCH one process with the plain dW+db (the reference, as phase
    dist's tp check), one with ``--fused_dw``, and ``--tp_devices 2`` over
    two gloo ranks (``_drift_runs``)."""
    gloo = ["--device", "cuda:0"]

    def body(tmp, data):
        for lr in lrs:
            for batch, runs in (
                    (256, (("fused", ["--fused_dw"], None),
                           ("plain", [], None), ("gloo", gloo, 2))),
                    (TP_BATCH, (("plain", [], None),
                                ("fused", ["--fused_dw"], None),
                                ("tp", gloo + ["--tp_devices", "2"], 2)))):
                _drift_runs(tmp, f"lr {lr} batch {batch}", [
                    "--data_path", data, "--batch_size", str(batch),
                    "--epochs", "2", "--num_workers", "8", "--lr", lr], runs)
    return _drift_main(body)


def _sp_drift(seeds: list, report_path: str | None) -> int:
    """``--sp_drift [SEEDS [REPORT]]``, run alone: the measurement behind
    SP_MOMENTUM_RTOL. At TP_BATCH and lr DIST_LR, one epoch (16 steps) of
    phase vit_train's ImageFolder from each ``--random_seed``: one process
    with the plain dW+db (the reference, as phase dist's sp check), one
    with ``--fused_dw`` (the control: the same arithmetic summed in
    another order), and ``--sp_devices 2`` over two gloo ranks sharing the
    card in the gather form and with ``--sp_ring`` (``_drift_runs``).
    REPORT gets every number as JSON."""
    gloo = ["--device", "cuda:0", "--sp_devices", "2"]
    found = {}

    def body(tmp, data):
        for seed in seeds:
            found[seed] = _drift_runs(tmp, f"seed {seed}", [
                "--data_path", data, "--batch_size", str(TP_BATCH),
                "--epochs", "1", "--num_workers", "8", "--lr", DIST_LR,
                "--random_seed", seed],
                (("plain", [], None), ("fused", ["--fused_dw"], None),
                 ("gather", gloo, 2), ("ring", gloo + ["--sp_ring"], 2)))
    rc = _drift_main(body)
    if report_path:
        with open(report_path, "w") as f:
            json.dump({"card": smi_line(), "seeds": found}, f)
    return rc


DWDB_DRIFT_BATCH = 64


def _dwdb_drift(steps: int, report_path: str | None = None) -> int:
    """``--dwdb_drift [STEPS [REPORT]]``, run alone: where the batch-64 drift of a
    ``--fused_dw`` run from a plain one comes from. ViT-B/16 in bf16 from
    the seeded weights of ``run_vit_training``, on the first `steps`
    batches of 64 of phase vit_train's ImageFolder (its training loader,
    seed 0), SGD at lr DIST_LR, trained three ways in one process, each
    from its own parameters and momentum:

    - "fused": every dense layer's dW and db from the dW+db kernel (f32);
    - "f32": the same backward with the kernel's plain version,
      ``fused_dw.dw_db_reference`` (x^T g and the row sum in f32), in its
      place, so at step 1 the two differ only by the kernel's order of
      summation;
    - "plain": the plain autograd backward (``--fused_dw`` off), whose dW
      and db come out of cuBLAS in bf16 and are then cast to f32.

    Prints, from step 1, each run's loss against "fused" and, leaf by leaf
    over every dense weight and bias (qkv, proj, fc1, fc2 of each block and
    the head), the largest |difference| of the gradients over the largest
    |gradient| of the "fused" run, with the worst leaf; step 1's against
    DWDB_TOLERANCE (the kernel phase's dW+db bound). Writes every number
    to REPORT (JSON) when given; no result line. Exits 1 when step 1's
    kernel gradients leave the bound."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.data.packed import make_loader
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.ops import fused_dw as vfdw
    from vit_project_torch.train import vit_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = os.path.join(ROOT, "vit_project_torch", "_build",
                       f"dwdb-{os.getpid()}")
    os.makedirs(tmp)
    report = {"card": smi_line(), "batch": DWDB_DRIFT_BATCH, "lr": DIST_LR,
              "tolerance": DWDB_TOLERANCE, "steps": []}
    try:
        phase_build()
        data = os.path.join(tmp, "imagenet")
        _write_image_folder(data, np.random.RandomState(SEED))
        vit_cfg = vvit.VIT_CONFIGS["vit_base_patch16_224"]
        loader = make_loader(os.path.join(data, "train"), DWDB_DRIFT_BATCH,
                             train=True, seed=SEED, size=224, workers=8,
                             drop_last=True)
        runs = {}
        for name in ("fused", "f32", "plain"):
            cfg = ViTTrainConfig(data_path=data, output_dir=tmp,
                                 batch_size=DWDB_DRIFT_BATCH,
                                 compute_dtype="bfloat16",
                                 fused_dw=name != "plain", random_seed=SEED)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            model = vvit.init_vit_params(vvit.empty_vit(vit_cfg, "cuda"), gen)
            trainer = vit_loop.ViTTrainer(vit_cfg, cfg, model, "cuda")
            runs[name] = (trainer, trainer.init_momentum())
        names = [n for n, _ in runs["fused"][0].model.named_parameters()]
        dense = [i for i, n in enumerate(names) if re.search(
            r"(qkv|proj|fc1|fc2)\.(weight|bias)$|^head\.", n)]
        kernel_dw_db = vfdw.dw_db
        lr = float(DIST_LR)
        for step, (images, labels) in enumerate(loader.epoch(0), start=1):
            if step > steps:
                break
            out = {}
            for name, (trainer, momentum) in runs.items():
                imgs, lbls = trainer.place(images, labels)
                params = [p for _, p in trainer.model.named_parameters()]
                if name == "f32":
                    vfdw.dw_db = vfdw.dw_db_reference
                try:
                    loss, grads = trainer.batch_grads(params, imgs, lbls)
                finally:
                    vfdw.dw_db = kernel_dw_db
                out[name] = (float(loss), grads)
                with torch.no_grad():      # the step's update, as step() does
                    bufs = [momentum[n] for n in names]
                    upd = torch._foreach_mul(params, trainer.cfg.weight_decay)
                    torch._foreach_add_(upd, grads)
                    torch._foreach_mul_(bufs, trainer.cfg.momentum)
                    torch._foreach_add_(bufs, upd)
                    torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))
            ref_loss, ref = out["fused"]
            line = {"step": step, "loss_fused": ref_loss}
            for name in ("f32", "plain"):
                loss, grads = out[name]
                rel = {names[i]: ((grads[i] - ref[i]).abs().max()
                                  / ref[i].abs().max().clamp_min(1e-30)).item()
                       for i in dense}
                worst = max(rel, key=rel.get)
                line[name] = {"loss_diff": loss - ref_loss,
                              "loss_rel": abs(loss / ref_loss - 1),
                              "grad_rel_max": rel[worst], "worst_leaf": worst,
                              "grad_rel_median": statistics.median(
                                  rel.values()),
                              "grad_rel": rel}
                print(f"[dwdb_drift] step {step} {name} vs fused: loss "
                      f"{loss:.6f} vs {ref_loss:.6f} (diff "
                      f"{loss - ref_loss:+.3e})"
                      f"; dense-leaf gradients max |diff| / max |fused| "
                      f"{rel[worst]:.3e} ({worst}), median "
                      f"{line[name]['grad_rel_median']:.3e} over {len(rel)} "
                      f"leaves", flush=True)
            report["steps"].append(line)
        first = report["steps"][0]
        verdict = ("agree" if first["f32"]["grad_rel_max"] <= DWDB_TOLERANCE
                   else "DISAGREE")
        report["step1_kernel_vs_f32"] = verdict
        print(f"[dwdb_drift] step 1: the kernel's gradients and its plain f32 "
              f"version's {verdict} within {DWDB_TOLERANCE} "
              f"({first['f32']['grad_rel_max']:.3e}); the plain autograd "
              f"backward's differ by {first['plain']['grad_rel_max']:.3e}",
              flush=True)
        print(smi_line(), flush=True)
        if report_path:
            os.makedirs(os.path.dirname(os.path.abspath(report_path)),
                        exist_ok=True)
            with open(report_path, "w") as f:
                json.dump(report, f, indent=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0 if report.get("step1_kernel_vs_f32") == "agree" else 1


DRYRUN_N = 4              # the gloo ranks of the dry run, sharing the card
DRYRUN_TIMEOUT = 600      # s the dry run's launches may take
CKPT_BATCH = 16           # the step that fills the momentum before the round
                          # trip (8 images a rank)


def _sharded_ckpt_check(root: str) -> dict:
    """Two gloo ranks sharing the card: ViT-B/16's FSDP2 parameters and
    momentum after one step (bf16 compute, batch CKPT_BATCH) through the
    sharded checkpoint (``vit_ckpt.save_checkpoint(sharded=True)``, every
    rank its own shards) and back into zeroed DTensors of the same
    placement (``load_checkpoint(template=)``), bit for bit; the bytes each
    rank wrote against its shards' bytes; and the save's seconds against
    the gather-then-primary `.pth` save of the same state (``full_state``,
    the JAX-layout conversion, ``save_checkpoint`` on the primary, as
    ``run_vit_training`` saves), in turns: sharded, gathered, gathered,
    sharded."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor
    from vit_project_torch.ckpt import vit_ckpt
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import convert as vconvert
    from vit_project_torch.models import vit as vvit
    from vit_project_torch.train.vit_loop import ViTTrainer
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank, world = tdist.get_rank(), tdist.get_world_size()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = vvit.init_vit_params(vvit.empty_vit(vvit.VIT_B16, dev), gen)
    trainer = ViTTrainer(vvit.VIT_B16, ViTTrainConfig(
        batch_size=CKPT_BATCH, fsdp=True), model, dev)
    momentum = trainer.init_momentum()
    rs = np.random.RandomState(SEED)
    images = rs.randint(0, 255, (CKPT_BATCH, 224, 224, 3), np.uint8)
    labels = rs.randint(0, 1000, CKPT_BATCH)
    trainer.step(momentum, *trainer.place(images[rank::world],
                                          labels[rank::world]), 0.01)
    params, mom = trainer.sharded_state(momentum)
    sched = {"last_epoch": 1, "base_lr": 0.01}
    dcp_dir, pth_dir = (os.path.join(root, d) for d in ("dcp", "pth"))

    def sharded():
        return vit_ckpt.save_checkpoint(0, params, mom, sched, 1.0, 0.0, 0.0,
                                        dcp_dir, sharded=True)

    def gathered():
        full_p, full_m = trainer.full_state(momentum)
        jax_p = jax_m = None
        if rank == 0:
            jax_p, jax_m = (vconvert.vit_jax_from_state_dict(
                {k: v.cpu() for k, v in t.items()}) for t in (full_p, full_m))
        del full_p, full_m
        return vit_ckpt.save_checkpoint(0, jax_p, jax_m, sched, 1.0, 0.0,
                                        0.0, pth_dir)

    seconds = {"sharded": [], "gathered": []}
    for name in ("sharded", "gathered", "gathered", "sharded"):
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.time()
        path = (sharded if name == "sharded" else gathered)()
        tdist.barrier()
        seconds[name].append(time.time() - t0)
        if name == "sharded":
            dcp_path = path
        else:
            pth_path = path
    files = {f: os.path.getsize(os.path.join(dcp_path, f))
             for f in sorted(os.listdir(dcp_path))}
    own = sum(t.to_local().numel() * t.element_size()
              for tree in (params, mom) for t in tree.values())
    template = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
                "opt_state": {k: torch.zeros_like(v) for k, v in mom.items()}}
    tdist.barrier()
    t0 = time.time()
    back = vit_ckpt.load_checkpoint(dcp_path, template=template)
    torch.cuda.synchronize()
    tdist.barrier()
    load_s = time.time() - t0
    unequal = [f"{tree}.{k}" for tree, src in (("params", params),
                                               ("opt_state", mom))
               for k, v in src.items()
               if not torch.equal(back[tree][k].to_local(), v.to_local())]
    sharded_leaves = sum(isinstance(v, DTensor) for tree in (params, mom)
                         for v in tree.values())
    out = {"seconds": seconds, "load_s": load_s, "files": files,
           "own_bytes": own, "pth_bytes": (os.path.getsize(pth_path)
                                           if rank == 0 else None),
           "leaves": len(params) + len(mom), "dtensor_leaves": sharded_leaves,
           "unequal": unequal[:8], "epoch": back["epoch"],
           "scheduler_state": back["scheduler_state"]}
    tdist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_dryrun(tmp: str):
    """The port's compile check and multi-rank dry run as a user calls them
    (cli/dryrun.py). Starts, in the background, the module's command line
    (``main([DRYRUN_N])`` in a worker process of this script: its ranks
    under gloo on the card, beside its one-process oracle) and the
    full-width sharded
    checkpoint round trip on two gloo ranks (_sharded_ckpt_check); then, in
    this process, ``entry()``: ViT-B/16's bf16 logits of 8 images with 12
    flash3_fwd launches, against the same call on the plain attention
    (SERVE_VIT_KERNEL_RTOL of the largest). Returns finish(), which
    collects and checks the two launches (timed as "dryrun_collect")."""
    import torch
    from vit_project_torch.cli import dryrun
    from vit_project_torch.ops import attention as vattn
    root = os.path.join(tmp, "dryrun")
    os.makedirs(root)
    dry_job = _dist_start(root, "dryrun", [
        "vit_project_torch.cli.dryrun", str(DRYRUN_N), "--timeout",
        str(DRYRUN_TIMEOUT)], nproc=None)
    ckpt_job = _dist_start(root, "sharded_ckpt", [
        "--gloo", "sharded_ckpt", os.path.join(root, "ckpt")], nproc=2)

    fn, args = dryrun.entry()
    blocks = args[0].cfg.layers
    vattn.reset_launch_counts()
    logits = fn(*args)
    torch.cuda.synchronize()
    entry_launches = vattn.LAUNCHES["flash3_fwd"]
    plain = _plain_attention(lambda: fn(*args))
    err = ((logits - plain).abs().max() / plain.abs().max()).item()
    ms = cuda_ms(lambda: fn(*args), 10)
    res = RESULTS["dryrun"] = {"entry": {
        "shape": list(logits.shape), "flash3_fwd": entry_launches,
        "err": err, "ms": ms}}
    print(f"[dryrun] entry(): ViT-B/16 bf16 logits {list(logits.shape)} of "
          f"8 images, {entry_launches} flash3_fwd launches, against the plain "
          f"attention {err:.3e} of the largest (bound "
          f"{SERVE_VIT_KERNEL_RTOL}), {ms:.3f} ms a call", flush=True)
    if tuple(logits.shape) != (8, 1000) or \
            not torch.isfinite(logits).all().item():
        fail(f"[dryrun] entry() logits {list(logits.shape)} not finite "
             f"[8, 1000]")
    if entry_launches != blocks:
        fail(f"[dryrun] entry() launched flash3_fwd {entry_launches} times "
             f"({blocks} blocks)")
    if not err <= SERVE_VIT_KERNEL_RTOL:
        fail(f"[dryrun] entry() against the plain attention: {err:.3e}")
    del fn, args, logits, plain

    def finish():
        """Collect the dry run and the round trip, and check them."""
        t_wait = time.time()
        # its main() in a worker of this script's (which makes no group)
        _dist_collect(dry_job, timeout=DRYRUN_TIMEOUT + 60)
        with open(dry_job["log"]) as f:
            lines = f.read().splitlines()
        out = json.loads(next(ln for ln in reversed(lines)
                              if ln.startswith('{"n": ')))
        for name, loss in out["losses"].items():
            print(f"[dryrun] {name}: loss {loss} ("
                  f"{out['seconds'].get(name, float('nan')):.2f} s)",
                  flush=True)
        for name, c in out["checks"].items():
            print(f"[dryrun] check {name}: {'ok' if c['ok'] else 'MISSED'} "
                  f"- {c['detail']}", flush=True)
        ranks = out["launches"] + out["oracle_launches"]
        print(f"[dryrun] launches a rank (flash3_fwd, flash3_bwd): "
              + ", ".join(f"({r['flash3_fwd']}, {r['flash3_bwd']})"
                          for r in out["launches"])
              + f"; oracle ({out['oracle_launches'][0]['flash3_fwd']}, "
              f"{out['oracle_launches'][0]['flash3_bwd']}); "
              f"{dry_job['s']:.1f} s from start to exit "
              f"({out['seconds']['total']:.1f} s in dryrun_multichip)",
              flush=True)
        res.update(out)
        res["s"] = dry_job["s"]
        if not all(c["ok"] for c in out["checks"].values()):
            fail("[dryrun] a check missed its bound")
        print("[dryrun] " + next(ln for ln in lines
                                 if ln.startswith("dryrun_multichip(")),
              flush=True)
        if not all(r["flash3_fwd"] > 0 and r["flash3_bwd"] > 0
                   for r in ranks):
            fail(f"[dryrun] a rank launched no flash3 kernel: {ranks}")

        ck = _dist_collect(ckpt_job, timeout=DRYRUN_TIMEOUT)
        for r in ck:
            print(f"[dryrun] sharded ckpt rank {r['rank']}: ViT-B/16 FSDP2 "
                  f"{r['leaves']} leaves ({r['dtensor_leaves']} DTensors), "
                  f"own shards {r['own_bytes']:,} bytes; sharded save "
                  + " / ".join(f"{s:.2f}" for s in r["seconds"]["sharded"])
                  + " s, gathered .pth save "
                  + " / ".join(f"{s:.2f}" for s in r["seconds"]["gathered"])
                  + f" s; load into the template {r['load_s']:.2f} s; "
                  f"unequal leaves {r['unequal']}; peak "
                  f"{r['peak_gib']:.2f} GiB", flush=True)
        files = ck[0]["files"]
        print(f"[dryrun] sharded ckpt files: "
              + ", ".join(f"{k} {v:,} bytes" for k, v in files.items())
              + f"; the .pth {ck[0]['pth_bytes']:,} bytes; "
              f"{time.time() - t_wait:.1f} s waited for here", flush=True)
        res["sharded_ckpt"] = ck
        for r in ck:
            mine = files.get(f"__{r['rank']}_0.distcp", 0)
            if r["unequal"] or r["dtensor_leaves"] != r["leaves"] or \
                    r["epoch"] != 0 or \
                    r["scheduler_state"] != {"last_epoch": 1,
                                             "base_lr": 0.01}:
                fail(f"[dryrun] sharded ckpt rank {r['rank']}: not "
                     f"bit-equal ({r['unequal']}, epoch {r['epoch']}, "
                     f"{r['scheduler_state']})")
            if not r["own_bytes"] <= mine <= r["own_bytes"] * 1.05 + 2**20:
                fail(f"[dryrun] rank {r['rank']} wrote {mine:,} bytes for "
                     f"its {r['own_bytes']:,} bytes of shards")
        return {k: sum(r[k] for r in ranks)
                for k in ("flash3_fwd", "flash3_bwd")} | {
                    "entry": entry_launches}
    return finish


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist_worker"]:      # a process of phase dist
        return _dist_worker(argv[1], argv[2:])
    if argv[:1] == ["--dist_drift"]:       # DIST_LR's measurement
        return _dist_drift((argv[1:] or ["0.1,0.01,0.001"])[0].split(","))
    if argv[:1] == ["--sp_drift"]:         # SP_MOMENTUM_RTOL's measurement
        return _sp_drift((argv[1:] or ["0,1"])[0].split(","),
                         (argv[2:] or [None])[0])
    if argv[:1] == ["--dwdb_drift"]:       # the fused dW+db's drift at 64
        return _dwdb_drift(int((argv[1:] or ["8"])[0]),
                           (argv[2:] or [None])[0])
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
    t_script = time.time()
    phase_s = RESULTS["phase_s"] = {}

    def timed(name, fn, *a):
        t0 = time.time()
        try:
            return fn(*a)
        finally:
            phase_s[name] = time.time() - t0
            print(f"[timing] {name} {phase_s[name]:.1f} s (script "
                  f"{time.time() - t_script:.1f} s)", flush=True)
    timed("build", phase_build)
    rows = timed("kernel", phase_kernel, peaks) if "kernel" in phases else (
        timed("kernel_ln", phase_kernel_ln, peaks) if "kernel_ln" in phases
        else [])
    ops_launches = timed("ops", phase_ops) if "ops" in phases else None
    serve_launches = train_launches = vit_launches = sweep_launches = None
    forks_launches = grid_launches = serve_vit_launches = None
    dist_launches = clip_dist_launches = moe_launches = None
    serve_rn_launches = profile_launches = dryrun_launches = None
    orbax_launches = None
    tmp = os.path.join(ROOT, "vit_project_torch", "_build",
                       f"smoke-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    try:
        if "serve" in phases:
            serve_launches = timed("serve", phase_serve, tmp)
        if "train" in phases:
            train_launches = timed("train", phase_train, tmp)
        if "vit_train" in phases:
            vit_launches = timed("vit_train", phase_vit_train, tmp,
                                 "orbax" in phases)
        if "orbax" in phases:
            orbax_launches = timed("orbax", phase_orbax, tmp)
        if "profile" in phases:
            profile_launches = timed("profile", phase_profile, tmp)
        # the dry run's launches run beside moe and vit_grid
        dryrun_finish = (timed("dryrun", phase_dryrun, tmp)
                         if "dryrun" in phases else None)
        if "moe" in phases:
            moe_launches = timed("moe", phase_moe, tmp)
        if "vit_grid" in phases:
            grid_launches = timed("vit_grid", phase_vit_grid, tmp)
        if dryrun_finish is not None:
            dryrun_launches = timed("dryrun_collect", dryrun_finish)
        # phase dist's first process runs beside serve_vit and serve_rn
        dist_pre = _dist_prelude(tmp) if "dist" in phases else None
        if "serve_vit" in phases:
            serve_vit_launches = timed("serve_vit", phase_serve_vit, tmp)
        if "serve_rn" in phases:
            serve_rn_launches = timed("serve_rn", phase_serve_rn, tmp)
        dist_finish = None
        if "dist" in phases:
            dist_finish = timed("dist", phase_dist, tmp, dist_pre)
        if "clip_dist" in phases:
            clip_dist_launches = timed("clip_dist", phase_clip_dist, tmp)
        if "sweep" in phases or "forks" in phases:
            sweep_launches, ctx = timed("sweep", phase_sweep, tmp)
            if "forks" in phases:
                forks_launches = timed("forks", phase_forks, ctx)
            del ctx
        if dist_finish is not None:
            dist_launches = timed("dist_gloo", dist_finish)
        _CLIP_FIXTURE.clear()
        torch.cuda.empty_cache()
    finally:
        for job in list(_BACKGROUND):
            _dist_stop(job)
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

    def dist_tp(name):
        return dist_launches and dist_launches["tp"][name]

    def dist_ep(name):
        return dist_launches and dist_launches["ep"][name]

    def dist_sp(name):
        return dist_launches and dist_launches["sp"][name]

    def dist_pp(name):
        return dist_launches and dist_launches["pp"][name]

    def clip_sp(name):
        return clip_dist_launches and clip_dist_launches["sp"][name]

    def moe(name):
        return moe_launches and moe_launches[name]

    def profile(name):
        return profile_launches and profile_launches[name]

    def dist_mesh(name):
        return dist_launches and dist_launches["serve_mesh"][name]

    def clip_dist(name):
        return clip_dist_launches and clip_dist_launches[name]

    def dry(name):
        return dryrun_launches and dryrun_launches[name]

    def orbax(name):
        return orbax_launches and orbax_launches[name]

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
               "serve_rn": serve_rn_launches,
               "train": train_launches and train_launches["flash3_fwd"],
               "vit_train": vit("flash3_fwd"), "orbax": orbax("flash3_fwd"),
               "vit_grid": grid("flash3_fwd"), "sweep": sweep("flash3_fwd"),
               "forks": forks("flash3_fwd"), "dist": dist("flash3_fwd"),
               "dist_tp": dist_tp("flash3_fwd"), "moe": moe("flash3_fwd"),
               "dist_ep": dist_ep("flash3_fwd"),
               "dist_sp": dist_sp("flash3_fwd"),
               "dist_pp": dist_pp("flash3_fwd"),
               "clip_dist": clip_dist("flash3_fwd"),
               "clip_dist_sp": clip_sp("flash3_fwd"),
               "profile": profile("flash3_fwd"),
               "dist_serve_mesh": dist_mesh("flash3_fwd"),
               "entry": dry("entry"), "dryrun": dry("flash3_fwd")},
              [r["max_abs_err_o"] for r in rows
               if r["kernel"] == "flash3_fwd"],
              row_of("flash3_fwd", "image_b256"),
              "image tower, bucket 256, bfloat16, qkv [256, 257, 3072], "
              "H=16; launches: the serving run"),
        entry("flash3_bwd", "vit_project_torch/csrc/flash3_bwd.cu",
              "vit_project_tpu/ops/attention.py:480",
              train_launches and train_launches["flash3_bwd"],
              {"train": train_launches and train_launches["flash3_bwd"],
               "vit_train": vit("flash3_bwd"), "orbax": orbax("flash3_bwd"),
               "vit_grid": grid("flash3_bwd"), "sweep": sweep("flash3_bwd"),
               "forks": forks("flash3_bwd"), "dist": dist("flash3_bwd"),
               "dist_tp": dist_tp("flash3_bwd"), "moe": moe("flash3_bwd"),
               "dist_ep": dist_ep("flash3_bwd"),
               "dist_sp": dist_sp("flash3_bwd"),
               "dist_pp": dist_pp("flash3_bwd"),
               "clip_dist": clip_dist("flash3_bwd"),
               "clip_dist_sp": clip_sp("flash3_bwd"),
               "profile": profile("flash3_bwd"),
               "dryrun": dry("flash3_bwd")},
              [r["max_abs_err"] for r in rows
               if r["kernel"] == "flash3_bwd"],
              row_of("flash3_bwd", "image_b64"),
              "image tower, training batch 64, bfloat16, qkv "
              "[64, 257, 3072], H=16; launches: the training run"),
        entry("dw_db", "vit_project_torch/csrc/dw_db.cu",
              "vit_project_tpu/ops/fused_dw.py:41", vit("dw_db"),
              {"vit_train": vit("dw_db"), "orbax": orbax("dw_db"),
               "dist": dist("dw_db"),
               "moe": moe("dw_db"), "profile": profile("dw_db")},
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
    # the RN towers' text shapes of row 1 (phase serve_rn's text blocks)
    kernels[0]["rn_text_rows"] = [
        {k: r.get(k) for k in ("case", "dtype", "shape", "heads", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err_o")}
        for r in rows if r["kernel"] == "flash3_fwd"
        and r["case"].startswith("text_rn")]
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
