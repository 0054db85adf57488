"""The host side of the ingestion pipeline (twin of
``repro/data/pipeline.py``): the threaded iterator and the per-batch
pre-sort of the sparse update's stream.

1. **Overlap**: a worker thread pulls batches from the source, runs the host
   prep, and parks the result in a bounded queue, so the prep of batch
   ``n + 1`` runs while the card executes step ``n``
   (:class:`ThreadedIterator`; :func:`repro_torch.train.loop.prefetch_to_device`
   is a thin wrapper over it for the host-to-device leg, :class:`HostPipeline`
   for the host prep).  Worker failures are delivered to the consumer as a
   poisoned queue entry and re-raised promptly: the loop never hangs on a
   dead loader.
2. **Pre-sort**: the row kernels read the update's lookups sorted by row.
   Without host prep the step sorts them on the card
   (``core.sharded_embedding._row_sorted_streams``).  :func:`presort_batch`
   builds, for each embedding shard, the same four arrays on the host, with
   the same function on CPU tensors, so the two are equal bit for bit at any
   shard count, and ships them as batch fields (``psort_*``); a config with
   ``host_presort=True`` feeds them to the row kernel and sorts nothing.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from repro_torch import telemetry

PSORT_KEYS = ("psort_rows", "psort_bags", "psort_msk", "psort_wgt")


def presort_batch(layout, idx, weights=None) -> dict:
    """Each embedding shard's sorted update stream of one global batch, in
    row and table mode.

    ``layout``: a ``core.sharded_embedding.ShardedEmbeddingLayout``; ``idx``
    [B, S, P] int original-slot ids (numpy or a CPU tensor), the stream the
    step's update reads in the batch's order; ``weights`` [B, S, P] the bag
    weights or None.  Row mode sorts each shard's stream of ``B * S * P``
    lookups; table mode first puts the slots in padded-slot order (dummy
    slots read id 0 with weight 0, as the step's exchange does) and sorts
    each shard's ``B * slots_per_shard * P`` lookups.

    Returns ``{psort_rows, psort_bags, psort_msk, psort_wgt}``, numpy
    ``[num_shards, L]`` int32 / int32 / int32 / fp32, row ``k`` the stream of
    embedding shard ``k``: the arrays ``_row_sorted_streams`` gives on the
    card for that shard, computed by it on the CPU (``torch.sort(stable=
    True)``, whose permutation, being stable, is the only one).  At one
    shard they are the reference's ``presort_batch``'s bit for bit; at more,
    a lookup of another shard's rows has ``msk = 0`` in both, and the port
    keys it by its flat index modulo the shard's rows where the reference
    keys it past the last row (``_row_sorted_streams`` says why)."""
    import torch
    from repro_torch.core import sharded_embedding as se

    ids = torch.as_tensor(np.asarray(idx, np.int32))
    wgt = None if weights is None else torch.as_tensor(np.asarray(weights, np.float32))
    P = ids.shape[-1]
    ns = layout.num_shards
    if layout.mode == "table":
        maps = se.slot_maps(layout, "cpu")
        ids = se.permute_indices(layout, ids, maps)
        wgt = None if wgt is None else se.permute_indices(layout, wgt, maps)
    K = layout.slots_per_shard
    out = None
    for s in range(ns):
        mine, w = ids, wgt
        if layout.mode == "table":
            mine = ids[:, s * K:(s + 1) * K]
            w = None if wgt is None else wgt[:, s * K:(s + 1) * K]
        off = torch.as_tensor(se.local_offsets(layout, s), dtype=torch.int32)
        local = (mine + off[None, :, None]).reshape(-1)
        streams = se._row_sorted_streams(layout, local, P,
                                         None if w is None else w.reshape(-1), s)
        if out is None:
            out = {k: np.empty((ns, local.numel()), t.numpy().dtype)
                   for k, t in zip(PSORT_KEYS, streams)}
        for k, t in zip(PSORT_KEYS, streams):
            out[k][s] = t.numpy()
    return out

_DONE = object()


class _Poison:
    """Queue sentinel carrying a worker exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Stopped(Exception):
    """Internal: close() was requested while the worker held an item."""


class ThreadedIterator:
    """Worker thread + bounded queue + poison sentinel, once.

    Pulls from ``source`` on a daemon thread, applies ``transform`` (the
    host prep: shard decode, pre-sort, the copy to the card, ...) and parks results
    in a ``depth``-bounded queue — backpressure keeps the worker at most
    ``depth`` items (+1 in hand) ahead of the consumer.  Order is
    preserved exactly.  A worker exception poisons the queue and
    re-raises at the consumer's next pull: a dead producer FAILS the
    consumer, it never hangs it.

    ``close()`` stops the worker promptly even when it is blocked on a
    full queue (the put loop watches the stop flag), drains the queue
    and joins — abandoning a partially-consumed stream does not leak a
    blocked thread or its queued items.  ``stats`` counts ``prep_s``
    (worker: source pull + transform), ``wait_s`` (consumer blocked on
    the queue), ``batches`` and ``retries``.

    Resilience knobs: ``retries`` bounds a retry-with-backoff on
    TRANSIENT worker exceptions (a flaky shard read whose ``__next__``
    can be called again; generators that die stay dead and simply end
    the stream) — beyond the budget the queue is poisoned as before.
    ``faults`` is an optional :class:`repro_torch.faults.FaultPlan`; the
    worker fires the ``loader.next`` site once per pull (step-indexed by
    pull count), which is where drills inject loader deaths and stalls.
    After a poison is delivered the stream goes STICKY-DEAD: the
    exception is raised once and later pulls see ``StopIteration`` —
    a consumer that absorbs the error (skip-batch budget) must never
    hang on the dead worker's empty queue.
    """

    def __init__(self, source: Iterable, *,
                 transform: Optional[Callable] = None, depth: int = 2,
                 name: str = "ThreadedIterator", retries: int = 0,
                 retry_backoff_s: float = 0.05, faults=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._retries = retries
        self._retry_backoff_s = retry_backoff_s
        self._faults = faults
        self.stats = {"prep_s": 0.0, "wait_s": 0.0, "batches": 0,
                      "retries": 0}
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name=name)
        self._started = False

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue
        raise _Stopped

    def _work(self) -> None:
        try:
            it = iter(self._source)
            failures = 0
            pulls = 0
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    if self._faults is not None:
                        self._faults.fire("loader.next", step=pulls)
                    # span lands on this worker's own trace track (the
                    # thread name, e.g. prefetch_to_device)
                    with telemetry.span("ingest/prep", cat="ingest",
                                        pull=pulls):
                        item = next(it)
                        if self._transform is not None:
                            item = self._transform(item)
                except StopIteration:
                    self._put(_DONE)
                    return
                except _Stopped:
                    raise
                except Exception as e:  # noqa: BLE001 — bounded retry
                    # transient worker failure: retry the pull (sources
                    # whose __next__ is re-callable survive; a dead
                    # generator raises StopIteration on the retry and the
                    # stream ends); past the budget, poison as usual.
                    # InjectedCrash is a BaseException: never retried.
                    if failures < self._retries:
                        failures += 1
                        self.stats["retries"] += 1
                        time.sleep(self._retry_backoff_s
                                   * (2 ** (failures - 1)))
                        continue
                    raise
                pulls += 1
                self.stats["prep_s"] += time.perf_counter() - t0
                self._put(item)
        except _Stopped:
            pass
        except BaseException as e:  # noqa: BLE001 — poison, don't hang
            try:
                self._put(_Poison(e))
            except _Stopped:
                pass

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        t0 = time.perf_counter()
        item = self._q.get()
        self.stats["wait_s"] += time.perf_counter() - t0
        if item is _DONE:
            # sticky: repeated next() calls and CHAINED consumers (e.g.
            # a prefetch_to_device worker reading a closed ThreadedIterator)
            # must also observe end-of-stream instead of blocking forever
            try:
                self._q.put_nowait(_DONE)
            except queue.Full:
                pass
            raise StopIteration
        if isinstance(item, _Poison):
            # sticky-dead: the worker exited after poisoning, so a consumer
            # that catches this exception (TrainLoop's skip-batch budget)
            # and pulls again must observe end-of-stream, not block forever
            # on an empty queue nothing refills
            try:
                self._q.put_nowait(_DONE)
            except queue.Full:
                pass
            raise item.exc
        self.stats["batches"] += 1
        return item

    def close(self) -> None:
        """Stop the worker (promptly, even when blocked on a full queue),
        drain its items, join, and leave a sticky end-of-stream sentinel
        so any consumer currently blocked in ``__next__`` — or pulling
        later — gets StopIteration instead of hanging.  Idempotent."""
        self._stop.set()
        if self._started:
            deadline = time.monotonic() + 5.0
            while (self._thread.is_alive()
                   and time.monotonic() < deadline):
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    time.sleep(0.005)
            self._thread.join(timeout=1.0)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:
            self._q.put_nowait(_DONE)
        except queue.Full:
            pass


class HostPipeline(ThreadedIterator):
    """Background-thread batch prep with bounded lookahead (one worker, as
    the reference's).  ``batches``: any iterable of batch dicts of numpy
    arrays.  ``presort=True`` adds the ``psort_*`` fields of
    :func:`presort_batch` (needs ``layout``), which a config with
    ``host_presort=True`` reads.  Worker exceptions re-raise at the
    consumer's next pull; ``close()`` releases the worker of an abandoned
    stream; ``stats`` counts the prep's and the consumer's wait's seconds."""

    def __init__(self, batches: Iterable[dict], *, layout=None, presort: bool = False,
                 depth: int = 2, retries: int = 0, faults=None):
        if presort and layout is None:
            raise ValueError("presort=True requires the embedding layout")
        self._layout = layout
        self._presort = presort
        super().__init__(batches, transform=self._prep, depth=depth, name="HostPipeline",
                         retries=retries, faults=faults)

    def _prep(self, b: dict) -> dict:
        out = dict(b)
        if self._presort:
            out.update(presort_batch(self._layout, out["idx"], out.get("weights")))
        return out
