"""Preemption-safe training: catch SIGTERM, stop at a checkpoint, exit
resumable (copy of the JAX package's core/preempt.py ``PreemptionGuard``).

The CLIP-HBA loop polls the guard at epoch boundaries, right after the
epoch's checkpoints are written, so a stop is exactly resumable in place;
the batched sweep and lengths poll ``should_stop_collective`` at each lock-step
and group boundary, and the ViT loop at each epoch boundary.

Mid-epoch stops are a one-process feature: signals reach the ranks of a
``torch.distributed`` group at different times, and a rank that stops at
batch k while another goes on to k+1 would hang the next collective. So
over more than one process ``should_stop()`` answers False, and a stop
happens at the next ``should_stop_collective()``, which every rank calls at
the same loop point: one rank's flag stops them all.
"""
from __future__ import annotations

import signal
import sys
import threading


def exit_if_undispatched(guard) -> None:
    """Shared epilogue of the batched sweep and lengths CLIs: exit 143 when a
    preemption left runs or conditions undispatched, so orchestration
    re-queues them. The caller must not have reported those items as failed
    first (a worker dispatcher reads a written report as authoritative)."""
    if getattr(guard, "undispatched", None):
        sys.exit(143)


class PreemptionGuard:
    """Signal-flag holder with scoped handler installation.

    Use as a context manager around the training loop; `request()` triggers
    programmatically (tests, or callers that learn of preemption
    out-of-band)."""

    #: SIGTERM is what spot/queued preemption delivers. SIGINT is
    #: deliberately NOT claimed (Ctrl-C keeps its KeyboardInterrupt meaning).
    DEFAULT_SIGNALS = (signal.SIGTERM,)

    def __init__(self, signals=DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self.signaled_by: int | None = None

    def request(self) -> None:
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def should_stop(self) -> bool:
        """True when a stop was requested (by a signal or `request()`) and
        this is the only process (module docstring)."""
        from ..parallel import dist
        return self._event.is_set() and dist.world_size() == 1

    def should_stop_collective(self) -> bool:
        """The poll every process makes at the same loop point: True when
        any rank's flag is set (the flags are all-gathered; one process, or
        no process group: the local flag)."""
        from ..parallel import dist
        if dist.world_size() == 1:
            return self._event.is_set()
        import torch
        flag = torch.tensor([1.0 if self._event.is_set() else 0.0],
                            device=dist.collective_device())
        return bool(dist.all_gather_rows(flag).sum().item() > 0)

    def _handler(self, signum, frame):
        self.signaled_by = signum
        self._event.set()

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                # signal.signal works on the main thread only; a guard built
                # on a worker thread still supports request()/should_stop()
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False
