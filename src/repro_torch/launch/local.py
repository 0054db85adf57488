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
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
from multiprocessing import connection, resource_tracker


def _child(fn, rank: int, world_size: int, args: tuple, backend: str, store: str,
           timeout_s: float, conn) -> None:
    import torch
    import torch.distributed as dist
    # the host's cores shared out among the ranks: each rank's default of one
    # thread a core made N ranks on the CPU ten times slower
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    torch.set_num_threads(max(1, (cores or 1) // world_size))
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        conn.send((True, out))
    except BaseException:  # reported to the parent, which raises
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_ranks(fn, world_size: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 300.0, store_dir: str | None = None) -> list:
    """``[fn(r, world_size, *args) for r in ranks]``, each in its own process
    inside one process group of ``backend``.  ``fn`` must be importable by
    name (a module-level function) and its arguments and result picklable.
    ``store_dir``: where the file store goes (a fresh temporary directory
    when None).  Raises ``RuntimeError`` with the child's traceback if any
    rank fails, and ``TimeoutError`` past ``timeout_s``; no child outlives
    the call, multiprocessing's resource tracker included where the call
    started it."""
    tracker = resource_tracker._resource_tracker
    own_tracker = tracker._pid is None  # the first spawn below starts it
    ctx = multiprocessing.get_context("spawn")
    # a pipe a rank, not a Queue: a Queue's semaphores stay registered with
    # the resource tracker, which a later unregister would start anew
    pipes = [ctx.Pipe(duplex=False) for _ in range(world_size)]
    procs = []
    try:
        with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
            store = os.path.join(tmp, "store")
            procs = [ctx.Process(target=_child, args=(fn, r, world_size, args, backend, store,
                                                      timeout_s, pipes[r][1]), daemon=True)
                     for r in range(world_size)]
            for p in procs:
                p.start()
            for _, w in pipes:
                w.close()  # so that a rank that dies reads as the end of its pipe
            readers = {pipes[r][0]: r for r in range(world_size)}
            got: dict = {}
            deadline = time.monotonic() + timeout_s
            while readers:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s "
                                       f"(done: {sorted(got)})")
                for conn in connection.wait(list(readers), timeout=min(left, 1.0)):
                    rank = readers.pop(conn)
                    try:
                        ok, out = conn.recv()
                    except EOFError:
                        procs[rank].join(timeout=5)
                        raise RuntimeError(f"rank {rank} exited with code "
                                           f"{procs[rank].exitcode} and no result") from None
                    if not ok:
                        raise RuntimeError(f"rank {rank} failed:\n{out}")
                    got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for rd, wr in pipes:
            rd.close()
            wr.close()
        if own_tracker:  # it would outlive the call, a child of this process
            tracker._stop()
    return [got[r] for r in range(world_size)]


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
