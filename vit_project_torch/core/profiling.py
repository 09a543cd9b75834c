"""Per-epoch wall time and throughput (copy of ``EpochTimer`` from the JAX
package's core/profiling.py). The reference has only coarse per-epoch
time.time() prints (train_vit_sgd.py:130,159-163)."""
from __future__ import annotations

import time


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
