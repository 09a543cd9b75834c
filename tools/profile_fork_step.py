#!/usr/bin/env python3
"""Where the time of a batched-fork lock-step goes, on one NVIDIA GPU.

    python3 tools/profile_fork_step.py        # from the repository root

On seeded random CLIP ViT-L/14 weights with rank-32 DoRA (bf16 compute,
1,024 random images at 224^2, 64 rows a fork):

1. the solo ``train_step`` against ``train_step_forks`` at R = 1, from the
   frozen-prefix cache and on the full tower, in turns (solo, fork, fork,
   solo; 10 steps each), with their medians and ranges;
2. torch.profiler over 3 lock-steps at R = 8 from the cache: the summed
   time of the device's kernels a lock-step against the wall time of an
   unprofiled one, and the largest kernels;
3. the adapted out_proj of R = 8 forks, forward and backward at
   [8 x 64*257, 1024] bf16: one product a fork on chunk views (the port's
   formulation) against one bmm over the stacked weights, in turns.

Prints lines starting with ``[fork-step]`` and the card's name and power
limit. Needs a CUDA device.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vit_project_torch.adapters import dora as adora  # noqa: E402
from vit_project_torch.core.prng import Key  # noqa: E402
from vit_project_torch.data.spose66 import classnames66  # noqa: E402
from vit_project_torch.models import clip as vclip  # noqa: E402
from vit_project_torch.models import tokenizer as vtok  # noqa: E402
from vit_project_torch.train import clip_loop  # noqa: E402


def wall_ms(fn, n=10):
    out = []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(k)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def in_turns(fns: dict, order, n=10) -> dict:
    times = {k: [] for k in fns}
    for name in order:
        times[name] += wall_ms(fns[name], n)
    return times


def summary(times: dict) -> str:
    return "; ".join(f"{k} {statistics.median(v):.2f} ms "
                     f"({min(v):.2f}-{max(v):.2f})" for k, v in times.items())


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fork_step: no CUDA device is visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[fork-step] {smi}", flush=True)
    cfg = vclip.CLIP_VIT_L14
    model = vclip.init_clip_weights_(
        vclip.empty_clip(cfg, "cuda"),
        torch.Generator(device="cuda").manual_seed(0))
    init, static, acfg = adora.apply_dora(
        model, adora.dora_spec(24, 12, 2, 1), r=32, alpha=16, dropout=0.1,
        generator=torch.Generator(device="cuda").manual_seed(1))
    prompts = np.minimum(vtok.tokenize(classnames66, context_length=77,
                                       truncate=True), 49407)
    tr = clip_loop.ClipHBATrainer(cfg, model, acfg, static, prompts,
                                  lr=3e-4, compute_dtype=torch.bfloat16)
    rs = np.random.RandomState(0)
    imgs, tgts = tr.upload_dataset(
        rs.randint(0, 255, (1024, 224, 224, 3)).astype(np.uint8),
        rs.rand(1024, 66).astype(np.float32))
    src = {"full": imgs, "cached": tr.build_prefix_cache(imgs)}
    tr.text_prefix_cache  # noqa: B018  (built once, before any timing)

    def state(R):
        trs = [adora.make_trainable(init, "cuda") for _ in range(R)]
        return trs, [tr.init_optimizer(t) for t in trs]
    forks = {R: state(R) for R in (1, 8)}
    (solo_tr,), (solo_opt,) = state(1)

    def solo(label):
        return lambda k: tr.train_step(
            solo_tr, solo_opt, src[label], tgts,
            np.arange(64) + 64 * (k % 16), Key((1, 0, k)),
            cached=label == "cached")

    def fork(label, R):
        trs, opts = forks[R]
        return lambda k: tr.train_step_forks(
            trs, opts, src[label], tgts,
            [np.arange(64) + 64 * ((k + f) % 16) for f in range(R)],
            [Key((1, 0, k, f)) for f in range(R)], cached=label == "cached")

    for label in ("cached", "full"):
        fns = {"solo": solo(label), "fork R=1": fork(label, 1)}
        for fn in fns.values():
            fn(0)
        times = in_turns(fns, ("solo", "fork R=1", "fork R=1", "solo"))
        print(f"[fork-step] {label}, in turns: {summary(times)}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = fork("cached", 8)
    wall = statistics.median(wall_ms(step))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(3):
            step(k)
        torch.cuda.synchronize()
    # kernels only: an aten op's device time is its kernels' time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kernels) / 3e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[fork-step] cached R=8 lock-step: kernels {dev:.2f} ms of a "
          f"{wall:.2f} ms step (median of 10, unprofiled); largest: "
          + ", ".join(f"{e.key[:60]} {e.self_device_time_total / 3e3:.2f}"
                      for e in top), flush=True)

    R, M, D = 8, 64 * 257, 1024
    o = torch.randn(R * M, D, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    ws = [torch.randn(D, D, device="cuda", requires_grad=True)
          for _ in range(R)]
    b = torch.randn(D, device="cuda")
    dy = torch.randn(R * M, D, device="cuda", dtype=torch.bfloat16)

    def per_fork(rows):
        y = torch.cat([F.linear(x, w.t().to(o.dtype), b.to(o.dtype))
                       for x, w in zip(rows, ws)])
        y.backward(dy)

    def bmm():
        y = torch.baddbmm(b.to(o.dtype).expand(R, M, D),
                          o.unflatten(0, (R, -1)),
                          torch.stack(ws).to(o.dtype))
        y.reshape(R * M, D).backward(dy)
    fns = {"per fork (chunk views)": lambda k: per_fork(o.chunk(R)),
           "bmm": lambda k: bmm()}
    for fn in fns.values():
        fn(0)
    names = list(fns)
    times = in_turns(fns, names + names[::-1])
    print(f"[fork-step] out_proj of 8 forks, forward + backward at "
          f"[8 x {M}, {D}] bf16, in turns: {summary(times)}", flush=True)
    print(f"[fork-step] {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
