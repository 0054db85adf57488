"""N ranks of one function on this host, each its own process.

:func:`run_ranks` starts ``world_size`` processes (``spawn``), joins them in
one ``torch.distributed`` process group through a file store, runs
``fn(rank, world_size, *args)`` in each and returns their results in rank
order; each rank's intra-op threads get an equal share of the host's cores.
Every wait is bounded: the group's ``timeout`` bounds a collective that
waits on a rank that died or hangs, and the parent stops every child
when the run exceeds ``timeout_s`` or any child fails, and then raises;
the resource tracker that the first ``spawn`` starts is stopped with them.  It
is how the tests run the hybrid step at N gloo ranks on the CPU, and how
``chip_smoke.py`` runs two ranks on one card (gloo, the payloads staged
through host memory).

It is a :class:`RankPool` that serves one call.  A pool keeps its ranks up
between calls: one start and one process group for many ``fn`` in turn (a
rank's start, its imports, its group and its card's context, is most of a
short call's time), with the same bounds: a call past its ``timeout_s`` or a
rank that fails closes the pool.
"""

from __future__ import annotations

import datetime
import gc
import multiprocessing
import os
import tempfile
import time
import traceback
from multiprocessing import connection, resource_tracker


def _rank(rank: int, world_size: int, backend: str, store: str, timeout_s: float,
          conn) -> None:
    """A rank of a :class:`RankPool`: takes its share of the host's cores,
    joins the group, reports ready, then runs each ``(fn, args)`` it
    receives until ``None``; after each, its garbage and its card's cached
    blocks go, so an idle rank holds no more than its context.  A failure
    is reported and ends the rank."""
    import torch
    import torch.distributed as dist
    # the host's cores shared out among the ranks: each rank's default of one
    # thread a core made N ranks on the CPU ten times slower
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    torch.set_num_threads(max(1, (cores or 1) // world_size))
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "gloo":
            # every rank's connections up before any rank may end and close its own: a
            # rank that finished first and tore its group down broke a peer still
            # connecting ("Connection closed by peer" in connectFullMesh)
            dist.barrier()
    except BaseException:
        conn.send((False, traceback.format_exc()))
        conn.close()
        raise
    try:
        conn.send((True, None))
        while (task := conn.recv()) is not None:
            fn, args = task
            try:
                out = fn(rank, world_size, *args)
            except BaseException:
                conn.send((False, traceback.format_exc()))
                raise
            conn.send((True, out))
            del task, fn, args, out
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        conn.close()


#: seconds the other ranks get to report after one fails
FAILURE_GRACE_S = 5.0


def _collect(readers: dict, procs: list, timeout_s: float) -> dict:
    """One message from each rank's connection (``readers``: connection ->
    rank): ``{rank: result}``.  A rank whose connection ends reads as a
    failure; after the first failure the others get FAILURE_GRACE_S to
    report.  Raises ``RuntimeError`` with every failed rank's report, and
    ``TimeoutError`` past ``timeout_s``."""
    readers = dict(readers)
    world_size = len(procs)
    got: dict = {}
    failed: dict = {}
    deadline = time.monotonic() + timeout_s
    while readers:
        left = deadline - time.monotonic()
        if left <= 0:
            if failed:
                break
            raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s "
                               f"(done: {sorted(got)})")
        for conn in connection.wait(list(readers), timeout=min(left, 1.0)):
            rank = readers.pop(conn)
            try:
                ok, out = conn.recv()
            except EOFError:
                procs[rank].join(timeout=5)
                ok, out = False, f"exited with code {procs[rank].exitcode} and no result"
            if ok:
                got[rank] = out
                continue
            if not failed:
                # a rank that fails tears its process group down, and a peer
                # still connecting or in a collective then fails too ("connection
                # closed by peer"): wait a little for the others' reports, so that
                # the error holds the first cause and not only its echo
                deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
            failed[rank] = out
    if failed:
        raise RuntimeError("\n".join(f"rank {r} failed:\n{out}"
                                     for r, out in sorted(failed.items())))
    return got


def _stop(procs: list) -> None:
    """Join every rank, killing those still alive after 5 s."""
    for p in procs:
        p.join(timeout=5)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=5)


class RankPool:
    """``world_size`` rank processes in one process group of ``backend``,
    kept up between calls, each :meth:`run` one ``fn`` on every rank.  The
    ranks start at once and join their group in the background; the first
    :meth:`run` waits for them (within its ``timeout_s``).  ``timeout_s``
    here bounds the group's collectives.  A failed or timed-out call closes
    the pool (no rank outlives it), as does :meth:`close` and leaving a
    ``with`` block; multiprocessing's resource tracker goes with it where
    the pool started it."""

    def __init__(self, world_size: int, *, backend: str = "gloo", timeout_s: float = 900.0,
                 store_dir: str | None = None):
        tracker = resource_tracker._resource_tracker
        self._own_tracker = tracker._pid is None  # the first spawn below starts it
        self.world_size, self._ready, self.closed = world_size, False, False
        self._tmp = tempfile.TemporaryDirectory(dir=store_dir)
        store = os.path.join(self._tmp.name, "store")
        ctx = multiprocessing.get_context("spawn")
        pipes = [ctx.Pipe() for _ in range(world_size)]
        self._conns = [a for a, _ in pipes]
        self._procs = [ctx.Process(target=_rank, args=(r, world_size, backend, store,
                                                       timeout_s, pipes[r][1]), daemon=True)
                       for r in range(world_size)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise
        finally:
            for _, b in pipes:
                b.close()  # so that a rank that dies reads as the end of its pipe

    def run(self, fn, args: tuple = (), *, timeout_s: float = 300.0) -> list:
        """``[fn(r, world_size, *args) for r in ranks]`` on the pool's ranks;
        fails as :func:`run_ranks` does."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        readers = {c: r for r, c in enumerate(self._conns)}
        try:
            deadline = time.monotonic() + timeout_s
            if not self._ready:
                _collect(readers, self._procs, timeout_s)
                self._ready = True
            for c in self._conns:
                c.send((fn, args))
            got = _collect(readers, self._procs, max(deadline - time.monotonic(), 1e-3))
        except BaseException:
            self.close()
            raise
        return [got[r] for r in range(self.world_size)]

    def close(self) -> None:
        """End every rank (each leaves its group first, unless it is stuck or
        dead) and free the store."""
        if self.closed:
            return
        self.closed = True
        for c in self._conns:
            try:
                c.send(None)
            except OSError:  # that rank ended already
                pass
        _stop([p for p in self._procs if p.pid is not None])
        for c in self._conns:
            c.close()
        self._tmp.cleanup()
        if self._own_tracker:  # it would outlive the pool, a child of this process
            resource_tracker._resource_tracker._stop()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def run_ranks(fn, world_size: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 300.0, store_dir: str | None = None) -> list:
    """``[fn(r, world_size, *args) for r in ranks]``, each in its own process
    inside one process group of ``backend``: a :class:`RankPool` that serves
    one call.  ``fn`` must be importable by name (a module-level function)
    and its arguments and result picklable.  ``store_dir``: where the file
    store goes (a fresh temporary directory when None).  Raises
    ``RuntimeError`` with the traceback of every rank that failed (those that
    report within :data:`FAILURE_GRACE_S` of the first failure), and
    ``TimeoutError`` past ``timeout_s``; no child outlives the call,
    multiprocessing's resource tracker included where the call started it."""
    with RankPool(world_size, backend=backend, timeout_s=timeout_s,
                  store_dir=store_dir) as pool:
        return pool.run(fn, args, timeout_s=timeout_s)


def rank_device(device: str, rank: int):
    """Rank ``rank``'s device for ``device`` ("cpu" or "cuda"): the CPU, or
    the rank's own card where there is one a rank, else the card the ranks
    share round robin."""
    import torch
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    from repro_torch import resolve_device
    resolve_device(device)  # raises where there is no card
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device: str, world_size: int) -> str:
    """NCCL for ranks with a card each; gloo on the CPU and for ranks that
    share a card (NCCL refuses two ranks on one device), whose collectives
    then stage their payloads through pinned host memory."""
    import torch
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"
