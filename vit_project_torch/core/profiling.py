"""Tracing and per-epoch timing (counterpart of the JAX package's
core/profiling.py). The reference has only coarse per-epoch time.time()
prints (train_vit_sgd.py:130,159-163). Here:

- ``trace(logdir)``: a ``torch.profiler`` trace of the host and the card
  (CUDA kernels, the hand-written ones launched through ctypes included)
  around any region, written to `logdir` as a Chrome / TensorBoard trace
  (``*.pt.trace.json``); nothing when `logdir` is falsy. It yields the
  profiler, whose ``key_averages()`` the step profiler (cli/profile.py)
  reads once the region has ended;
- ``EpochTimer``: per-epoch wall time and images/s for the run logs.
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler trace (CPU and, with a visible GPU, CUDA activity)
    of the wrapped region into `logdir`, else nothing. Yields the profiler
    (None without `logdir`)."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class EpochTimer:
    """Wall-clock + throughput per epoch.

    Usage:
        t = EpochTimer()
        ... epoch work ...
        line = t.finish(images=n)   # "epoch_time=42.1s images_per_sec=3041.2"
    """

    def __init__(self):
        self.t0 = time.perf_counter()

    def finish(self, images: int | None = None) -> str:
        dt = time.perf_counter() - self.t0
        parts = [f"epoch_time={dt:.1f}s"]
        if images:
            parts.append(f"images_per_sec={images / dt:.1f}")
        return " ".join(parts)

    def seconds(self) -> float:
        return time.perf_counter() - self.t0
