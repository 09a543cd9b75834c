#!/usr/bin/env python3
"""Drive the PyTorch port (vit_project_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from csrc/ with nvcc (one process
   per source, all started together) and prints the build time;
3. phase `kernel`: runs each kernel against its plain PyTorch version on
   the card at the shapes its main path gives it (the attention forward at
   the serving buckets, the backward at the training step's image and text
   shapes), in float32 and bfloat16, checks the largest errors against
   stated tolerances, and times the kernel, the plain version and one
   PyTorch library call for the same function beside the card's bound for
   that work;
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
6. prints one JSON line of kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result. ``--json PATH`` also writes every number to PATH.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 (NVIDIA data sheets, dense, at a 700 W limit on
# the SXM part): bytes/s of device memory and operations/s by type. A PCIe
# card has its own sheet.
PEAKS = {
    "SXM": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
    "PCIe": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12},
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
TOLERANCE = {"float32": {"o": 1e-5, "lse": 1e-5},
             "bfloat16": {"o": 2e-2, "lse": 1e-4}}

# backward kernel-vs-plain tolerances: max abs error of each of dq, dk, dv
# over the largest |value| of that gradient in the plain version, per dtype:
#   float32: exact f32 arithmetic in another order of summation; the row
#     sums c and the products run over up to 257 keys (measured on an H100
#     SXM: 1.0e-6 relative at most).
#   bfloat16: both versions round p and ds to bf16 before the products and
#     the gradients to bf16 at the end; f32 sums in another order move a
#     value across a bf16 rounding boundary at most once, one bf16 spacing,
#     which is at most 2^-7 of the largest |value| (measured: 2.4e-3).
BWD_TOLERANCE = {"float32": 1e-5, "bfloat16": 2 ** -7}

SEED = 0
RESULTS: dict = {}


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
            if "ptxas info" in line:
                print(f"[build] {name}: {line.strip()}")
    RESULTS["build_s"] = dt


def attention_cases():
    """(label, B, S, H, causal) at the serving path's shapes: the image
    tower at buckets 8, 32 and 256, and the 66 causal text prompts."""
    return [("image_b8", 8, 257, 16, False), ("image_b32", 32, 257, 16, False),
            ("image_b256", 256, 257, 16, False), ("text_66", 66, 77, 12, True)]


def bwd_cases():
    """(label, B, S, H, causal) of the attention backward on the training
    path: the image tower at the training batch of 64, and the 66 causal
    text prompts (reached when a text block below the last is adapted)."""
    return [("image_b64", 64, 257, 16, False), ("text_66", 66, 77, 12, True)]


def _random_qkv(B, S, H, dtype, seed=SEED):
    import torch
    D = H * 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * D, generator=g, device="cuda")
    qkv[..., :D] *= 0.125           # q prescaled by 1/sqrt(64)
    return qkv.to(dtype).contiguous(), g


def phase_kernel(peaks):
    return phase_kernel_fwd(peaks) + phase_kernel_bwd(peaks)


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
            nbytes = (qkv.numel() * qkv.element_size()       # read qkv
                      + do.numel() * do.element_size()       # read do
                      + lse.numel() * 4                      # read lse
                      + qkv.numel() * qkv.element_size())    # write dqkv
            pairs = S * (S + 1) // 2 if causal else S * S
            flops = 10 * B * H * pairs * 64                  # 5 products
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = flops / peaks[dname] * 1e3
            row = {"kernel": "flash3_bwd", "case": label, "dtype": dname,
                   "shape": [B, S, 3 * D], "heads": H, "causal": causal,
                   "max_abs_err": max(errs.values()), "errors": errs,
                   "relative_errors": rel, "tolerance_relative": tol,
                   "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "mbytes": nbytes / 1e6, "gflop": flops / 1e9}
            rows.append(row)
            print(f"[kernel] flash3_bwd {label:10s} {dname:8s} err "
                  + " ".join(f"{n} {errs[n]:.2e} ({rel[n]:.1e} rel)"
                             for n in errs)
                  + f" | kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
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
                   "shape": [B, S, 3 * D],
                   "heads": H, "causal": causal, "max_abs_err_o": err_o,
                   "max_abs_err_lse": err_l, "ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "mbytes": nbytes / 1e6, "gflop": flops / 1e9}
            rows.append(row)
            print(f"[kernel] flash3_fwd {label:10s} {dname:8s} "
                  f"err o {err_o:.2e} lse {err_l:.2e} | kernel_ms "
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
        eng(x)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng(x)
            times.append(time.perf_counter() - t0)
        ips[b] = b / statistics.median(times)
        print(f"[serve] bucket {b}: median {statistics.median(times) * 1e3:.2f}"
              f" ms per call, {ips[b]:.1f} images/s", flush=True)
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
    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    breakdown = {}
    with torch.inference_mode():
        for b, reps in ((8, 20), (256, 5)):
            x = eng._place(pre(rs.randint(0, 256, (b, size, size, 3))
                               .astype(np.uint8)))
            breakdown[b] = wall_ms(lambda: eng._fn(eng.model, x), reps)
        text_ms = wall_ms(lambda: vclip.encode_text(
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernel,serve,train",
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
    serve_launches = train_launches = None
    tmp = os.path.join(ROOT, "vit_project_torch", "_build",
                       f"smoke-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    try:
        if "serve" in phases:
            serve_launches = phase_serve(tmp)
        if "train" in phases:
            train_launches = phase_train(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def row_of(kernel, case):
        return next((r for r in rows if r["kernel"] == kernel
                     and r["case"] == case and r["dtype"] == "bfloat16"), {})

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
              {"serve": serve_launches,
               "train": train_launches and train_launches["flash3_fwd"]},
              [r["max_abs_err_o"] for r in rows
               if r["kernel"] == "flash3_fwd"],
              row_of("flash3_fwd", "image_b256"),
              "image tower, bucket 256, bfloat16, qkv [256, 257, 3072], "
              "H=16; launches: the serving run"),
        entry("flash3_bwd", "vit_project_torch/csrc/flash3_bwd.cu",
              "vit_project_tpu/ops/attention.py:480",
              train_launches and train_launches["flash3_bwd"],
              {"train": train_launches and train_launches["flash3_bwd"]},
              [r["max_abs_err"] for r in rows
               if r["kernel"] == "flash3_bwd"],
              row_of("flash3_bwd", "image_b64"),
              "image tower, training batch 64, bfloat16, qkv "
              "[64, 257, 3072], H=16; launches: the training run"),
    ]
    RESULTS["kernels"] = kernels
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)), exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if phases != {"kernel", "serve", "train"}:
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
