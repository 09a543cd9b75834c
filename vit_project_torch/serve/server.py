"""Online serving: a micro-batching request queue + a stdlib HTTP front.

A copy of the JAX package's serve/server.py (standard library and numpy
only), kept here so the port imports nothing of that package.

The batch engine (serve/engine.py) answers "run THIS array"; an online
deployment instead sees many small concurrent requests. The answer is
MICRO-BATCHING: requests queue, a dispatcher thread coalesces whatever
arrived within a small window (bounded by the engine's largest bucket) into
ONE fixed-shape dispatch, and each caller gets back exactly its rows. One
GPU then serves many clients at batch throughput while a lone request still
completes in about a small-bucket latency.

Stack is stdlib-only (http.server / threading / json), so the daemon runs
in any image the package runs in.

Wire protocol (all under one port):
- POST /v1/predict       body = .npy bytes (np.save of a [H,W,C] image or
                         [B,H,W,C] batch, uint8 or float32). Response:
                         .npy bytes of the outputs ([B, num_outputs]), or
                         JSON top-k when `?topk=K` is given.
- GET  /v1/healthz       {"status": "ok", ...engine/bucket info}
- GET  /v1/stats         request/image counters + latency quantiles.

Dtype-dependent input conversion (uint8 -> scaled float, normalization)
must happen PER REQUEST via the `preprocess=` hook — never inside the
engine below the MicroBatcher, where np.concatenate's dtype promotion
across a mixed uint8/float window would silently change a uint8 client's
pixel scale. cli/serve.py wires the right preprocess per engine family.
"""
from __future__ import annotations

import io
import json
import queue
import signal
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class MicroBatcher:
    """Coalesce concurrent predict() calls into fixed-shape engine dispatches.

    A dispatcher thread blocks on the queue, then keeps absorbing requests
    until either `max_batch` images are in hand (the engine's largest bucket
    by default — one dispatch, zero padding waste) or `max_delay_ms` has
    passed since the FIRST queued request (latency bound; the bucket ladder
    pads whatever was gathered). Each request's rows are scattered back to
    its Future, so callers never see each other's data.
    """

    def __init__(self, engine, max_batch: int | None = None,
                 max_delay_ms: float = 5.0):
        self.engine = engine
        self.max_batch = int(max_batch or max(engine.buckets))
        self.max_delay = max_delay_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.dispatches = 0          # engine calls made
        self.images = 0              # images served
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    # -- client side -----------------------------------------------------------

    def submit(self, images: np.ndarray) -> Future:
        """images: [B, ...] batch (B >= 1). Returns a Future of [B, out]."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((np.asarray(images), fut))
        return fut

    def predict(self, images: np.ndarray, timeout: float | None = None):
        return self.submit(images).result(timeout)

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=10)

    # -- dispatcher ------------------------------------------------------------

    def _gather(self):
        """One coalescing window: [(array, future), ...] or None on stop."""
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        n = len(item[0])
        deadline = time.monotonic() + self.max_delay
        while n < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                # stop sentinel mid-window: serve what we have first, but
                # RE-ENQUEUE it so _run still sees it (otherwise the
                # dispatcher would block forever on the next get() and the
                # post-close drain would never run)
                self._q.put(None)
                break
            batch.append(nxt)
            n += len(nxt[0])
        return batch

    def _run(self):
        while True:
            batch = self._gather()
            if batch is None:
                break
            arrays, futs = zip(*batch)
            try:
                out = self.engine(np.concatenate(arrays)) if len(arrays) > 1 \
                    else self.engine(arrays[0])
                self.dispatches += 1
                s = 0
                for a, f in zip(arrays, futs):
                    f.set_result(out[s:s + len(a)])
                    s += len(a)
                self.images += s
            except BaseException as e:  # deliver, don't kill the dispatcher
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
        # drain anything queued after close()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("MicroBatcher closed"))


class _Stats:
    """Thread-safe counters + latency quantiles over the last 1024 requests."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.images = 0
        self.errors = 0
        self._lat = deque(maxlen=1024)
        self.t0 = time.time()

    def record(self, n_images: int, latency_s: float):
        with self._lock:
            self.requests += 1
            self.images += n_images
            self._lat.append(latency_s)

    def error(self):
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            q = (lambda p: round(lat[min(len(lat) - 1,
                                         int(p * len(lat)))] * 1000, 3)) \
                if lat else (lambda p: None)
            return {"requests": self.requests, "images": self.images,
                    "errors": self.errors,
                    "uptime_s": round(time.time() - self.t0, 1),
                    "latency_ms": {"p50": q(0.50), "p90": q(0.90),
                                   "p99": q(0.99)}}


def _expected_rank(image_shape):
    return len(image_shape) + 1  # + batch axis


def make_handler(batcher: MicroBatcher, image_shape: tuple,
                 stats: _Stats, request_timeout: float = 60.0,
                 preprocess=None, max_body_mb: float = 256.0):
    """BaseHTTPRequestHandler subclass bound to one batcher instance.

    `preprocess(arr) -> arr` runs PER REQUEST (before micro-batch
    coalescing), so dtype-dependent conversions — e.g. uint8 -> normalized
    float for the CLIP engine — can never be confused by np.concatenate's
    dtype promotion across a mixed uint8/float window. `max_body_mb` bounds
    the request body BEFORE it is read into memory (413 past it)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- plumbing ---------------------------------------------------------

        def log_message(self, *a):  # quiet by default; stats has the counters
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode())

        def _drain_body(self):
            """Consume the request body so a keep-alive connection is not
            poisoned by unread bytes being parsed as the next request."""
            n = int(self.headers.get("Content-Length", 0) or 0)
            while n > 0:
                chunk = self.rfile.read(min(n, 1 << 20))
                if not chunk:
                    break
                n -= len(chunk)

        # -- routes -----------------------------------------------------------

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/v1/healthz":
                self._send_json(200, {
                    "status": "ok",
                    "image_shape": list(image_shape),
                    "buckets": list(batcher.engine.buckets),
                    "max_batch": batcher.max_batch,
                    "max_delay_ms": batcher.max_delay * 1000})
            elif path == "/v1/stats":
                snap = stats.snapshot()
                snap["dispatches"] = batcher.dispatches
                self._send_json(200, snap)
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/v1/predict":
                self._drain_body()
                self._send_json(404, {"error": f"no route {path}"})
                return
            # parse + validate the query BEFORE any inference is spent on a
            # request whose response could not be rendered anyway
            topk = None
            for kv in query.split("&"):
                if kv.startswith("topk="):
                    try:
                        topk = max(1, int(kv[5:]))
                    except ValueError:
                        self._drain_body()
                        stats.error()
                        self._send_json(400, {"error": f"topk must be a "
                                                       f"positive int, got "
                                                       f"{kv[5:]!r}"})
                        return
            t0 = time.monotonic()
            n = int(self.headers.get("Content-Length", 0) or 0)
            if n > max_body_mb * (1 << 20):
                # reject by the declared size BEFORE buffering it: a
                # ThreadingHTTPServer reads one body per connection thread,
                # so unbounded reads are an easy OOM on an exposed host
                stats.error()
                self.send_response(413)
                self.send_header("Content-Length", "0")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                return
            try:
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
            except Exception as e:
                stats.error()
                self._send_json(400, {"error": f"body must be .npy bytes "
                                               f"(np.save): {e}"})
                return
            if arr.ndim == _expected_rank(image_shape) - 1:
                arr = arr[None]  # single image -> batch of one
            if arr.ndim != _expected_rank(image_shape) or \
                    tuple(arr.shape[1:]) != tuple(image_shape):
                stats.error()
                self._send_json(400, {
                    "error": f"expected [B, {', '.join(map(str, image_shape))}]"
                             f" (or one unbatched image), got {list(arr.shape)}"})
                return
            if preprocess is not None:
                arr = preprocess(arr)
            try:
                out = np.asarray(batcher.submit(arr).result(request_timeout))
            except Exception as e:
                stats.error()
                self._send_json(500, {"error": str(e)})
                return
            stats.record(len(arr), time.monotonic() - t0)
            if topk is not None:
                topk = min(topk, out.shape[-1])
                idx = np.argsort(-out, axis=-1)[:, :topk]
                body = [[{"index": int(i), "score": float(row[i])}
                         for i in r] for row, r in zip(out, idx)]
                self._send_json(200, {"predictions": body})
            else:
                buf = io.BytesIO()
                np.save(buf, out)
                self._send(200, buf.getvalue(), "application/x-npy")

    return Handler


class ServingDaemon:
    """Engine + MicroBatcher + ThreadingHTTPServer, lifecycle in one object.

    >>> d = ServingDaemon(engine, image_shape=(224, 224, 3), port=0)
    >>> d.start();  print(d.port)   # 0 -> ephemeral, resolved after start
    >>> ...
    >>> d.shutdown()
    """

    def __init__(self, engine, image_shape: tuple, port: int = 8000,
                 host: str = "127.0.0.1", max_batch: int | None = None,
                 max_delay_ms: float = 5.0, request_timeout: float = 60.0,
                 preprocess=None, max_body_mb: float = 256.0):
        self.batcher = MicroBatcher(engine, max_batch=max_batch,
                                    max_delay_ms=max_delay_ms)
        self.stats = _Stats()
        handler = make_handler(self.batcher, tuple(image_shape), self.stats,
                               request_timeout, preprocess=preprocess,
                               max_body_mb=max_body_mb)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="serving-http")
        self._down = False
        self._down_lock = threading.Lock()
        self._down_done = threading.Event()

    def start(self):
        self._thread.start()
        return self

    def serve_forever(self, install_sigterm: bool = True):
        """Foreground mode (the CLI path). Ctrl-C and SIGTERM both shut
        down GRACEFULLY: in-flight requests finish, the listener closes,
        the dispatcher drains (the same contract the training loops honor
        for preemption notices). The SIGTERM handler must not call
        shutdown() synchronously — it would interrupt serve_forever's own
        polling loop and deadlock on its is-shut-down event — so it hands
        the call to a helper thread."""
        prev = None
        if install_sigterm:
            try:
                prev = signal.signal(
                    signal.SIGTERM,
                    lambda s, f: threading.Thread(
                        target=self.shutdown, daemon=True).start())
            except ValueError:
                prev = None  # not the main thread; Ctrl-C still works
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
            self.shutdown()

    def shutdown(self):
        """Idempotent AND race-safe: the loser of a concurrent shutdown
        (e.g. serve_forever's finally racing the SIGTERM helper thread)
        BLOCKS until the winner finishes the drain — returning early would
        let the process exit while the daemon helper is still mid-drain,
        resetting in-flight clients."""
        with self._down_lock:
            first = not self._down
            self._down = True
        if not first:
            self._down_done.wait(timeout=30)
            return
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.batcher.close()
            if self._thread.is_alive():
                self._thread.join(timeout=10)
        finally:
            self._down_done.set()
