"""Bounded background-thread feeder: run a producer generator on its own
thread and deliver its items through a depth-bounded queue (a copy of the
JAX package's core/feeder.py).

The one home for the overlap-stage discipline shared by the input pipeline
(decode overlap, data/imagenet.ImageFolderLoader.epoch) and the device
feeder (pinned copies to the card, train/vit_loop._device_prefetch):

- puts keep watching a stop event, so an abandoned consumer (generator
  closed mid-epoch) can never leave the thread blocked on a full queue;
- any producer exception is DELIVERED to the consumer (re-raised from the
  feeder) instead of dying silently in the thread — a dead producer with no
  sentinel would leave the consumer blocked in q.get() forever;
- the consumer's finally sets stop and joins the thread;
- a producer wedged inside one long work unit (e.g. a native decode of a
  whole batch) can outlive the 10 s abandonment join. Such threads are
  TRACKED in a module registry instead of silently leaked: every feed()
  call (and reap_leaked()) prunes the registry of threads that have since
  drained, so a long-lived process embedding the loader holds at most the
  currently-wedged threads, not an unbounded accumulation.
"""
from __future__ import annotations

import logging
import queue as _queue
import threading

# threads that outlived their consumer's abandonment join, pruned by
# reap_leaked(); guarded by _leaked_lock
_leaked: list[threading.Thread] = []
_leaked_lock = threading.Lock()


def reap_leaked() -> int:
    """Drop finished threads from the leak registry; returns how many are
    STILL alive (wedged in a long producer work unit). Called by every
    feed(); servers embedding the loader can also call it on their own
    housekeeping cadence."""
    with _leaked_lock:
        _leaked[:] = [t for t in _leaked if t.is_alive()]
        return len(_leaked)


def leaked_count() -> int:
    """Currently-tracked abandoned feeder threads (alive or not yet reaped)."""
    with _leaked_lock:
        return len(_leaked)


def feed(producer, depth: int, abandon_join_timeout: float = 10.0):
    """Yield `producer`'s items, produced on a feeder thread, through a
    queue of the given depth (depth items may be in flight ahead of the
    consumer). depth <= 0 means NO lookahead: consume synchronously on the
    caller's thread (Queue(maxsize=0) would be UNBOUNDED — the producer
    would race a whole epoch into memory, the opposite of what a caller
    passing 0 asked for).

    `abandon_join_timeout` bounds how long an abandoning consumer waits for
    the thread; a thread still alive after it goes to the leak registry
    (see module docstring)."""
    if depth <= 0:
        yield from producer
        return
    reap_leaked()
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def run():
        try:
            for item in producer:
                if stop.is_set():
                    return
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - forwarded, not dropped
            put(e)
            return
        put(None)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=abandon_join_timeout)
        if t.is_alive():
            # wedged inside one long producer work unit; it will see `stop`
            # when that unit returns and exit without blocking (puts watch
            # stop). Track it so long-lived processes can observe/reap it
            # instead of accumulating invisible daemon threads.
            logging.getLogger("vit_project_torch").warning(
                "feeder thread outlived its %.1f s abandonment join "
                "(producer wedged in a long work unit); tracking for reap",
                abandon_join_timeout)
            with _leaked_lock:
                _leaked.append(t)
