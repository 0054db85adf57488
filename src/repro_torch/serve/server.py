"""Continuous-batching serving over a ladder of batch shapes (copy of
``repro/serve/server.py``, so the port needs nothing of ``repro``).

:class:`ContinuousBatchingServer`: a worker thread drains a bounded request
queue into the smallest compiled bucket that fits (e.g. 8/32/128), waiting
at most ``max_wait_ms`` past the oldest request before flushing partial.
``submit`` returns a handle; ``result()`` blocks on completion.  The worker
reuses the poisoned-queue idiom of the reference's ``ThreadedIterator``: a
scorer exception POISONS the server — every pending and future request
fails promptly with the original error instead of hanging, and the server
goes sticky-dead.  Per-request latency lands in bounded-memory
:class:`repro_torch.telemetry.LatencyHistogram` buckets; every scored batch
is a ``serve/batch`` tracer span.  :class:`BatchingServer` is the
reference's synchronous pad-and-drain loop over one batch shape, its
``max_wait_ms`` deadline real: a partial batch waits up to the deadline of
its oldest request for stragglers before it is padded and flushed.

The per-bucket score fns are typically those of
:func:`repro_torch.serve.snapshot.make_bucket_scorers`, reading the newest
published :class:`~repro_torch.serve.snapshot.ServingSnapshot` per batch.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import telemetry


class ServerClosed(RuntimeError):
    """Raised by submit/result when the server is closed or poisoned."""


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets sorted ascending; n must fit)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} requests exceed the largest bucket {buckets[-1]}")


class _Request:
    """Submit handle: a tiny future resolved by the worker thread."""

    __slots__ = ("payload", "t_submit", "t_done", "_done", "score", "error")

    def __init__(self, payload: Any):
        self.payload = payload
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self._done = threading.Event()
        self.score = None
        self.error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("request not scored within timeout")
        if self.error is not None:
            if isinstance(self.error, ServerClosed):
                raise self.error
            raise ServerClosed("serving worker died") from self.error
        return self.score

    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, score=None, error: Optional[BaseException] = None) -> None:
        self.score = score
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()


class ContinuousBatchingServer:
    """Worker-thread continuous batching over bucketed compiled shapes.

    ``score_fns``: ``{bucket_size: fn(batch) -> [bucket] scores}`` — one
    compiled step per bucket.  ``pad_batch(payloads, bucket)``: stack +
    zero-pad ``len(payloads) <= bucket`` request payloads into that
    bucket's batch.  ``max_wait_ms``: how long past the OLDEST queued
    request a partial batch may wait for more arrivals; a full largest
    bucket never waits.  ``queue_depth`` bounds the submit queue
    (backpressure: ``submit`` blocks when the server is that far behind).
    """

    def __init__(
        self,
        score_fns: dict[int, Callable[[dict], Any]],
        pad_batch: Callable[[list, int], dict],
        *,
        max_wait_ms: float = 2.0,
        queue_depth: int = 4096,
        name: str = "serve_worker",
    ):
        if not score_fns:
            raise ValueError("need at least one bucket score fn")
        self.buckets = tuple(sorted(score_fns))
        self.score_fns = dict(score_fns)
        self.pad_batch = pad_batch
        self.max_wait_ms = max_wait_ms
        # per-bucket latency: 1us..100s in ms units, 2% relative error
        self.hist = {
            b: telemetry.LatencyHistogram(lo=1e-3, hi=1e5, growth=1.02) for b in self.buckets
        }
        self.batches = {b: 0 for b in self.buckets}
        self.requests = 0
        self.padded = 0  # dummy rows executed (bucket - n summed)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._dead: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._work, daemon=True, name=name)
        self._started = False
        self._lock = threading.Lock()

    # ---------------------------------------------------------- submit --
    def submit(self, payload: Any) -> _Request:
        """Enqueue one request; returns a handle whose ``result()`` blocks
        until the worker scores it.  Raises :class:`ServerClosed` once the
        server is closed or poisoned (sticky-dead, like a poisoned
        ThreadedIterator)."""
        if self._dead is not None:
            raise ServerClosed("serving worker died") from self._dead
        if self._stop.is_set():
            raise ServerClosed("server is closed")
        with self._lock:
            if not self._started:
                self._thread.start()
                self._started = True
        req = _Request(payload)
        self._q.put(req)
        return req

    def score(self, payload: Any, timeout: Optional[float] = None):
        """Blocking convenience: submit + result."""
        return self.submit(payload).result(timeout)

    # ---------------------------------------------------------- worker --
    def _collect(self, first: _Request) -> list[_Request]:
        """One batch: the first request plus everything that arrives before
        its ``max_wait_ms`` deadline, capped at the largest bucket.  Queued
        backlog is taken without waiting — the deadline only ever delays a
        PARTIAL batch."""
        reqs = [first]
        deadline = first.t_submit + self.max_wait_ms * 1e-3
        while len(reqs) < self.buckets[-1]:
            try:
                reqs.append(self._q.get_nowait())
                continue
            except queue.Empty:
                pass
            remaining = deadline - time.perf_counter()
            if remaining <= 0 or self._stop.is_set():
                break
            try:
                reqs.append(self._q.get(timeout=min(remaining, 0.05)))
            except queue.Empty:
                continue
        return reqs

    def _run_batch(self, reqs: list[_Request]) -> None:
        n = len(reqs)
        bucket = bucket_for(n, self.buckets)
        with telemetry.span(
            "serve/batch", cat="serve", bucket=bucket, n=n, queue_depth=self._q.qsize()
        ):
            batch = self.pad_batch([r.payload for r in reqs], bucket)
            scores = np.asarray(self.score_fns[bucket](batch))[:n]
        t_done = time.perf_counter()
        hist = self.hist[bucket]
        for r, s in zip(reqs, scores):
            r._resolve(score=s)
            hist.record((t_done - r.t_submit) * 1e3)
        self.batches[bucket] += 1
        self.requests += n
        self.padded += bucket - n

    def _work(self) -> None:
        reqs: list[_Request] = []
        try:
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
                reqs = self._collect(first)
                self._run_batch(reqs)
                reqs = []
        except BaseException as e:  # noqa: BLE001 — poison, don't hang
            # the ThreadedIterator poison idiom, future-shaped: mark the
            # server sticky-dead and deliver the error to every request in
            # hand, queued, or submitted later — callers FAIL, never hang
            self._dead = e
            for r in reqs:
                r._resolve(error=e)
            self._fail_queued(e)

    def _fail_queued(self, exc: Optional[BaseException]) -> None:
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if exc is not None:
                r._resolve(error=exc)
            else:
                r._resolve(error=ServerClosed("server closed before scoring"))

    # ----------------------------------------------------------- stats --
    def percentiles(self) -> dict:
        """Per-bucket ``{p50_ms, p99_ms, mean_ms, n}`` (buckets with no
        traffic are omitted, matching the histogram's empty contract)."""
        out = {}
        for b, h in self.hist.items():
            s = h.summary()
            if s:
                out[b] = {"p50_ms": s["p50"], "p99_ms": s["p99"], "mean_ms": s["mean"], "n": s["n"]}
        return out

    def stats(self) -> dict:
        """Heartbeat-shaped summary: queue depth, totals, per-bucket
        batch counts and latency percentiles."""
        return {
            "queue_depth": self._q.qsize(),
            "requests": self.requests,
            "padded": self.padded,
            "batches": dict(self.batches),
            "buckets": self.percentiles(),
        }

    # ----------------------------------------------------------- close --
    def close(self) -> None:
        """Stop the worker, fail anything still queued (ServerClosed), and
        join.  Idempotent."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)
        self._fail_queued(self._dead)

    def __enter__(self) -> "ContinuousBatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()



class BatchingServer:
    """Synchronous pad-and-drain serving loop over one batch shape.

    ``drain()`` processes the queue in ``batch_size`` chunks and yields
    ``(requests, scores)`` for each.  Partial batches honor ``max_wait_ms``:
    they wait until the oldest queued request has aged that long before
    padding and flushing, so requests submitted meanwhile (from another
    thread) can still join the chunk.  ``pad_batch(requests)`` builds one
    batch of ``batch_size`` rows; ``score_fn(batch)`` returns its scores.
    """

    def __init__(self, score_fn: Callable[[dict], Any], batch_size: int,
                 pad_batch: Callable[[list], dict], max_wait_ms: float = 2.0):
        self.score_fn = score_fn
        self.batch_size = batch_size
        self.pad_batch = pad_batch
        self.max_wait_ms = max_wait_ms
        self.queue: deque = deque()
        # 1us..100s in ms units, 2% relative quantile error
        self.latency = telemetry.LatencyHistogram(lo=1e-3, hi=1e5, growth=1.02)

    def submit(self, request: Any) -> None:
        self.queue.append((time.perf_counter(), request))

    def _await_deadline(self) -> None:
        """Block until the queue fills a whole batch or the OLDEST queued
        request reaches its ``max_wait_ms`` deadline."""
        deadline = self.queue[0][0] + self.max_wait_ms * 1e-3
        while len(self.queue) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.0005))

    def drain(self):
        """Process the queue in ``batch_size`` chunks, yielding
        ``(requests, scores)`` for each."""
        while self.queue:
            if len(self.queue) < self.batch_size:
                self._await_deadline()
            n = min(self.batch_size, len(self.queue))
            items = [self.queue.popleft() for _ in range(n)]
            t_in = [t for t, _ in items]
            reqs = [r for _, r in items]
            with telemetry.span("serve/batch", cat="serve", n=n):
                batch = self.pad_batch(reqs)
                scores = np.asarray(self.score_fn(batch))[:n]
            t_done = time.perf_counter()
            for t in t_in:
                self.latency.record((t_done - t) * 1e3)
            yield reqs, scores

    def percentiles(self) -> dict:
        """``{p50_ms, p99_ms, mean_ms, n}`` (empty before any request)."""
        s = self.latency.summary()
        if not s:
            return {}
        return {"p50_ms": s["p50"], "p99_ms": s["p99"], "mean_ms": s["mean"], "n": s["n"]}
