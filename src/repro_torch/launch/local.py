"""N ranks of one function on this host, each its own process.

:func:`run_ranks` starts ``world_size`` processes (``spawn``), joins them in
one ``torch.distributed`` process group through a file store, runs
``fn(rank, world_size, *args)`` in each and returns their results in rank
order; each rank's intra-op threads get an equal share of the host's cores.
Every wait is bounded: the group's ``timeout`` bounds a collective that
waits on a rank that died or hangs, and the parent stops every child
when the run exceeds ``timeout_s`` or any child fails, and then raises.  It
is how the tests run the hybrid step at N gloo ranks on the CPU, and how
``chip_smoke.py`` runs two ranks on one card (gloo, the payloads staged
through host memory).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback


def _child(fn, rank: int, world_size: int, args: tuple, backend: str, store: str,
           timeout_s: float, results) -> None:
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
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 300.0, store_dir: str | None = None) -> list:
    """``[fn(r, world_size, *args) for r in ranks]``, each in its own process
    inside one process group of ``backend``.  ``fn`` must be importable by
    name (a module-level function) and its arguments and result picklable.
    ``store_dir``: where the file store goes (a fresh temporary directory
    when None).  Raises ``RuntimeError`` with the child's traceback if any
    rank fails, and ``TimeoutError`` past ``timeout_s``; no child outlives
    the call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(fn, r, world_size, args, backend, store,
                                                  timeout_s, results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s "
                                       f"(done: {sorted(got)})")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive() and p.exitcode != 0]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
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
