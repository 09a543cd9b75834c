"""Preemption-safe training: catch SIGTERM, stop at a checkpoint, exit
resumable (copy of the JAX package's core/preempt.py ``PreemptionGuard``).

The CLIP-HBA loop polls the guard at epoch boundaries, right after the
epoch's checkpoints are written, so a stop is exactly resumable in place.
The port trains in one process (``torch.distributed`` is not initialised);
the JAX package's collective poll comes with the parallel modes.
"""
from __future__ import annotations

import signal
import threading


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
        """True when a stop was requested (by a signal or `request()`)."""
        return self._event.is_set()

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
