"""Fault-tolerant training loop (twin of ``repro/train/loop.py``).

* checkpoint/restart: periodic async checkpoints (atomic commit, verified on
  restore: ``repro_torch/checkpoint/manager.py``), restore on startup from
  the newest VALID checkpoint, a final checkpoint on SIGTERM,
  KeyboardInterrupt or any in-loop failure (the save lives in a
  ``finally``), except after a simulated process death
  (:class:`repro_torch.faults.InjectedCrash`), which dies checkpoint-less
  like a real ``kill -9``;
* straggler detection: a ring buffer of step times flags steps slower than
  ``threshold x`` the running median (:class:`StragglerMonitor`);
  :class:`DataRebalancer` shifts batch shares away from a slow host;
* loader fault containment: a counted skip-batch budget
  (``TrainLoopConfig.skip_batch_budget``) absorbs transient loader
  exceptions; a source that ends (``StopIteration``) ends the run cleanly at
  the last completed step;
* host-side prefetch: :func:`prefetch_to_device` keeps ``size`` batches
  copied to the card ahead of the step, from pinned memory on a side
  stream, so the loader's host work and the copy of batch ``n + 1`` overlap
  step ``n``;
* a JSONL heartbeat every ``heartbeat_every`` steps, ``step_hook`` after
  every step, ``serve_stats`` folded into the heartbeat.

The loop reads each step's loss with ``float(loss)``, one host sync a step,
so the step time ``dt`` is the step's real time.  SIGTERM handling degrades
off the main thread to the ``_stop`` flag.  Fault-injection hook point:
``train.step``, inside the timed window.

On a mesh of N ranks (``mesh=``, the twin of the reference's
``state_shardings=`` / ``batch_shardings=``) every rank runs a loop on its
shard of the state.  Every rank reads the same global stream; the loop cuts
each batch to the rank's block (``core.hybrid.local_batch``) before the
prefetch copy, so only that block crosses to the card.  The loss is the
step's global loss, the same on every rank.  A checkpoint holds the
reference's global arrays: every rank gathers them
(``weights.state_to_global``, a collective, on the loop's thread at the
same step on every rank) and rank 0 alone hands them to its
:class:`CheckpointManager`, so the files are the ones the reference's loop
writes on that mesh.  After the final save a barrier waits for rank 0's
commit.  On restore rank 0 resolves :meth:`CheckpointManager.latest_valid_step`
(verifying, falling back past a corrupt step) and broadcasts it, and every
rank loads the global arrays and cuts its shard (``weights.state_from_global``).
A rank whose loop unwinds from an exception writes no final checkpoint:
the gather is a collective, and the other ranks, blocked in the failed
step's collectives, cannot join it; they fail when the process group's
timeout ends that wait, and skip it too.  So stopping (preemption, a stream
that ends) must come at one step on every rank, as it does when every rank
reads the same stream and a scheduler signals every process.  Restoring
onto another shard count is ``checkpoint.reshard_store`` and
``reshard_dense`` (``examples/elastic_restart_torch.py``).

An LM on a mesh (``model_cfg`` a ``models.transformer.TransformerConfig``)
runs the same way: its batches cut by ``models.lm_steps.local_batch``, its
checkpoint the whole state gathered by ``weights.lm_state_to_global`` (the
files a one-rank LM loop writes), and a restore cut again by
``weights.lm_state_from_global``, onto a mesh of any shape.

A state that carries the in-graph step metrics (``metrics``, the model's
``step_metrics``) is drained every ``metrics_every`` steps and at the end:
one device -> host copy, a ``repro.metrics`` counter on the trace, and the
window since the last drain in the next heartbeat with its
``cache_hit_rate``.  On a mesh each rank drains its replicated copy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time
import warnings
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import ThreadedIterator
from repro_torch.faults.plan import NO_FAULTS, InjectedCrash
from repro_torch.optim.data_parallel import tree_map

_EXHAUSTED = object()


class PrefetchIterator:
    """The iterator :func:`prefetch_to_device` returns: forwards one
    :class:`ThreadedIterator`, makes the consumer's stream wait for each
    batch's copy, and exposes the worker's ``stats``/``close`` (the
    heartbeat reads ``stats``).  Dropping it closes the worker."""

    def __init__(self, tit: ThreadedIterator, device: torch.device):
        self._tit = tit
        self._device = device

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        batch, copied = next(self._tit)
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)

            def hand_over(t):
                # the batch was allocated on the copy stream: tell the
                # allocator the consumer's stream uses it too
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
                return t
            tree_map(hand_over, batch)
        return batch

    @property
    def stats(self) -> dict:
        return self._tit.stats

    def close(self) -> None:
        self._tit.close()

    def __del__(self):
        try:
            self._tit.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def prefetch_to_device(batches: Iterator[Any], size: int = 2, device="cuda",
                       faults=None) -> PrefetchIterator:
    """Wrap a host batch iterator so the next ``size`` batches are already
    on ``device`` while the current step runs.

    A :class:`repro_torch.data.pipeline.ThreadedIterator` worker pulls from
    ``batches``, turns each numpy array of a batch (a dict, list or tuple of
    them, or one) into a tensor and, on a CUDA device, pins it and copies it
    on a side stream of its own, recording an event after the copy.  The
    consumer's stream waits on that event before it uses the batch, and each
    tensor is ``record_stream``-ed onto it, so the allocator does not hand
    its memory out while the step may still read it.  On the CPU the arrays
    become tensors sharing their memory, but for a read-only array (the
    packed reader's mmap views), which is copied.  Other leaves pass
    through.

    The worker stays at most ``size`` batches ahead of the consumer
    (bounded-queue backpressure); order is preserved exactly.  A source that
    raises poisons the queue and the exception is re-raised to the consumer
    promptly.  Dropping or closing the iterator stops the worker.
    ``faults``: an optional :class:`repro_torch.faults.FaultPlan`; the worker
    fires ``loader.next`` once a pull."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def to_tensor(a):
        if isinstance(a, np.ndarray):
            if side is not None:  # one copy, straight into pinned memory
                t = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                                pin_memory=True)
                t.numpy()[...] = a
                return t.to(dev, non_blocking=True)
            # a read-only array (the packed reader's mmap views) is copied:
            # a tensor must not alias memory that may not be written
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
        if not isinstance(a, torch.Tensor) or side is None:
            return a
        return a.pin_memory().to(dev, non_blocking=True)

    def put(batch):
        if side is None:
            return tree_map(to_tensor, batch), None
        with torch.cuda.stream(side):
            out = tree_map(to_tensor, batch)
            copied = torch.cuda.Event()
            copied.record(side)
        return out, copied

    tit = ThreadedIterator(batches, transform=put, depth=size, name="prefetch_to_device",
                           faults=faults)
    return PrefetchIterator(tit, dev)


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_threshold: float = 2.0  # step > thr x median -> straggler
    straggler_window: int = 50
    prefetch: int = 0  # >0: copy-ahead window of prefetch_to_device
    skip_batch_budget: int = 0  # transient loader errors absorbed per run
    # heartbeat: one JSONL record per ``heartbeat_every``-step window
    # (step-time percentiles, straggler snapshot, ingest stats, the drained
    # metrics and cache hit rate, checkpoint save durations); None = off
    heartbeat_path: Optional[str] = None
    heartbeat_every: int = 10
    # how often the state's in-graph step metrics (the model's step_metrics)
    # are copied to the host, emitted as a trace counter and windowed
    metrics_every: int = 10


class StragglerMonitor:
    """Ring-buffer step timer; flags outliers vs the running median."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.events: list[tuple[int, float, float]] = []
        self.on_straggler = on_straggler

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 10:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                is_straggler = True
                self.events.append((step, dt, med))
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler

    def snapshot(self) -> dict:
        """Summary over the current ring-buffer window: {n, median_ms,
        p99_ms, max_ms, outliers} (outliers = flagged stragglers over the
        whole run, not just the window)."""
        if not self.times:
            return {"n": 0, "outliers": len(self.events)}
        a = np.asarray(self.times, np.float64) * 1e3
        return {"n": int(a.size), "median_ms": float(np.median(a)),
                "p99_ms": float(np.percentile(a, 99)),
                "max_ms": float(a.max()), "outliers": len(self.events)}


class DataRebalancer:
    """Elastic per-host batch shares.  Synchronous SPMD keeps the global
    batch fixed; when host h straggles we shift a fraction of its rows to
    the other hosts (the sampler consults ``shares`` when building the next
    global batch).  ``min_share`` floors every host's share (as a fraction
    of the uniform 1/n share) so repeated penalties never starve a host."""

    def __init__(self, n_hosts: int, min_share: float = 0.5):
        self.shares = np.ones(n_hosts) / n_hosts
        self.min_share = min_share / n_hosts

    def penalize(self, host: int, factor: float = 0.9):
        moved = self.shares[host] * (1 - factor)
        floor = self.min_share
        if self.shares[host] - moved < floor:
            moved = max(0.0, self.shares[host] - floor)
        self.shares[host] -= moved
        others = [i for i in range(len(self.shares)) if i != host]
        self.shares[others] += moved / len(others)

    def rows_per_host(self, global_batch: int) -> np.ndarray:
        raw = np.floor(self.shares * global_batch).astype(int)
        raw[0] += global_batch - raw.sum()
        return raw


def _is_lm(cfg) -> bool:
    from repro_torch.models.transformer import TransformerConfig
    return isinstance(cfg, TransformerConfig)


class LocalBatches:
    """The iterator a loop on a mesh reads: each global batch of ``batches``
    (a dict of numpy arrays or tensors) cut to this rank's block
    (``core.hybrid.local_batch``) and, where ``device`` is given, copied
    there.  An exception of the source passes through and the iterator
    stays usable, so the loop's skip-batch budget works as on one rank."""

    def __init__(self, batches: Iterable[dict], cfg, mesh, device=None):
        self._src = iter(batches)
        self._cfg = cfg
        self._mesh = mesh
        self._device = device

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> dict:
        from repro_torch.core import hybrid
        from repro_torch.weights import to_torch
        batch = {k: to_torch(v) if isinstance(v, np.ndarray) else v
                 for k, v in next(self._src).items()}
        if _is_lm(self._cfg):
            from repro_torch.models import lm_steps
            batch = lm_steps.local_batch(self._cfg, self._mesh, batch)
        else:
            batch = hybrid.local_batch(self._cfg, self._mesh, batch)
        if self._device is not None:
            batch = {k: v.to(self._device) for k, v in batch.items()}
        return batch

    @property
    def stats(self) -> Optional[dict]:
        return getattr(self._src, "stats", None)


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable, state: Any,
                 batches: Iterator[Any], device="cuda", faults=None, event_log=None,
                 step_hook: Optional[Callable[[int, Any], Any]] = None,
                 serve_stats: Optional[Callable[[], dict]] = None,
                 mesh=None, model_cfg=None):
        # step_hook(completed_step, state) runs after every completed step;
        # serve_stats() is folded into each heartbeat record as rec["serve"].
        # device: where prefetched batches and a restored state go (the mesh's
        # device when ``mesh`` is given).  mesh: this rank's ``launch.mesh.Mesh``,
        # ``batches`` then yielding global batches; with it the model's
        # ``model_cfg`` (a ``core.hybrid.HybridDef``, a ``core.dlrm.DLRMConfig`` or an LM's
        # ``models.transformer.TransformerConfig``), by which the loop cuts the
        # batches and gathers and cuts the state
        from repro_torch.launch.mesh import refuse_shape_only
        refuse_shape_only(mesh, "the run loop")
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.model_cfg = model_cfg
        self.step_hook = step_hook
        self.serve_stats = serve_stats
        self.faults = faults if faults is not None else NO_FAULTS
        self.events = event_log
        if mesh is not None:
            if model_cfg is None:
                raise ValueError("a loop on a mesh needs the model's config (model_cfg) to cut "
                                 "the batches and gather the state")
            batches = LocalBatches(batches, model_cfg, mesh,
                                   None if cfg.prefetch > 0 else self.device)
        if cfg.prefetch > 0:
            batches = prefetch_to_device(batches, size=cfg.prefetch, device=self.device,
                                         faults=faults)
        self.batches = batches
        self.monitor = StragglerMonitor(cfg.straggler_window, cfg.straggler_threshold)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, cfg.keep, faults=self.faults,
                                       event_log=event_log)
                     if cfg.ckpt_dir else None)
        self.start_step = 0
        self.losses: list[float] = []
        self.skipped_batches = 0
        #: wall seconds of each save's gather of a sharded state (a mesh's loop)
        self.gather_durations: list[float] = []
        self._stop = False
        self._owns_batches = cfg.prefetch > 0
        self._metrics_prev: Optional[dict] = None
        self._metrics_window: Optional[dict] = None
        if self.ckpt and self.mesh is None:
            try:  # the newest valid checkpoint, verified on the arrays it restores
                self.start_step, self.state = self.ckpt.restore(self.state, device=self.device)
            except FileNotFoundError:  # none: a fresh start
                pass
            else:
                print(f"[train] restored checkpoint at step {self.start_step}")
        elif self.ckpt:
            step = self._from_rank0(self.ckpt.latest_valid_step() if self.mesh.rank == 0
                                    else None)
            if step is not None:
                from repro_torch import weights
                if _is_lm(model_cfg):
                    like = weights.lm_global_like(model_cfg, momentum="mom" in self.state)
                    _, glob = self.ckpt.restore(like, step=step, device="cpu")
                    self.state = weights.lm_state_from_global(glob, model_cfg, self.mesh)
                else:
                    _, glob = self.ckpt.restore(weights.global_like(model_cfg, self.mesh),
                                                step=step, device="cpu")
                    self.state = weights.state_from_global(glob, model_cfg, self.mesh)
                self.start_step = step
                print(f"[train] rank {self.mesh.rank}: restored checkpoint at step {step}")

    def _pg(self):
        return self.mesh.group(self.mesh.axis_names).pg

    def _from_rank0(self, obj):
        """``obj`` of the mesh's rank 0, on every rank."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, group=self._pg(), group_src=0)
        return box[0]

    def _save(self, step: int, blocking: bool = False) -> None:
        """Checkpoint ``step``: the state itself at one rank; on a mesh the
        global arrays, which every rank gathers and rank 0 writes."""
        if self.mesh is None:
            self.ckpt.save(step, self.state, blocking=blocking)
            return
        from repro_torch import weights
        t0 = time.perf_counter()
        glob = (weights.lm_state_to_global if _is_lm(self.model_cfg) else
                weights.state_to_global)(self.state, self.mesh, self.model_cfg)
        self.gather_durations.append(time.perf_counter() - t0)
        if self.mesh.rank == 0:
            self.ckpt.save(step, glob, blocking=blocking)

    def _record(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.record(kind, **fields)

    def _sigterm(self, *_):
        self._stop = True

    def _next_batch(self):
        """Pull the next batch; transient loader exceptions consume the
        skip-batch budget (each one logged) before propagating.  A source
        that ends (including a loader that died and went sticky-dead)
        returns the exhaustion sentinel so the loop can finish cleanly."""
        while True:
            try:
                return next(self.batches)
            except StopIteration:
                return _EXHAUSTED
            except InjectedCrash:
                raise  # simulated process death: never absorbed
            except Exception as e:  # noqa: BLE001 — budgeted containment
                if self.skipped_batches < self.cfg.skip_batch_budget:
                    self.skipped_batches += 1
                    self._record("batch_skipped", error=repr(e),
                                 skipped=self.skipped_batches,
                                 budget=self.cfg.skip_batch_budget)
                    print(f"[train] skipping failed batch "
                          f"({self.skipped_batches}/{self.cfg.skip_batch_budget}): {e!r}")
                    continue
                raise

    def _drain_metrics(self) -> Optional[dict]:
        """Copy the state's cumulative step metrics to the host (one small
        device -> host copy; on a mesh the rank's replicated vector, no
        collective), emit them as a trace counter and keep the window since
        the last drain for the next heartbeat.  None when the state carries
        no metrics."""
        from repro_torch.telemetry import metrics as step_mx

        cur = step_mx.drain(self.state)
        if cur is None:
            return None
        self._metrics_window = step_mx.window(cur, self._metrics_prev)
        self._metrics_prev = cur
        step_mx.emit(telemetry.get_tracer(), cur)
        return self._metrics_window

    def _heartbeat(self, step: int, window: list[float]) -> dict:
        """One JSONL record summarizing the window since the last
        heartbeat: step-time percentiles, straggler snapshot, ingest stats,
        the drained metrics' window and its cache hit rate, checkpoint save
        durations.  Appended + flushed per record so a dying process leaves
        the tail on disk."""
        from repro_torch.telemetry import metrics as step_mx

        rec: dict = {"step": step, "t": time.time(),
                     "skipped_batches": self.skipped_batches}
        if window:
            a = np.asarray(window, np.float64) * 1e3
            rec["window_steps"] = int(a.size)
            rec["step_ms_p50"] = float(np.percentile(a, 50))
            rec["step_ms_p99"] = float(np.percentile(a, 99))
            rec["step_ms_mean"] = float(a.mean())
        rec["straggler"] = self.monitor.snapshot()
        ingest = getattr(self.batches, "stats", None)
        if ingest is not None:
            rec["ingest"] = dict(ingest)
        if self._metrics_window is not None:
            rec["metrics_window"] = self._metrics_window
            rec["cache_hit_rate"] = step_mx.hit_rate(self._metrics_window)
        if self.ckpt is not None and self.ckpt.save_durations:
            rec["ckpt_save_s"] = [round(d, 6) for d in self.ckpt.save_durations[-8:]]
        if self.serve_stats is not None:
            try:
                rec["serve"] = self.serve_stats()
            except Exception as e:  # noqa: BLE001 — telemetry must not kill the run
                rec["serve"] = {"error": repr(e)}
        path = Path(self.cfg.heartbeat_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        telemetry.instant("train/heartbeat", cat="train", step=step)
        return rec

    def run(self) -> Any:
        """Run to ``cfg.steps``, checkpointing every ``cfg.ckpt_every``
        completed steps.  The FINAL checkpoint is written in a ``finally``:
        SIGTERM preemption, KeyboardInterrupt, a dead loader or a failing
        step all leave the last completed state on disk (only a simulated
        hard crash skips it; on a mesh, an exception too: see the module's
        docstring).  Off the main thread, SIGTERM installation is skipped
        with a warning and preemption degrades to the ``_stop`` flag."""
        on_main = threading.current_thread() is threading.main_thread()
        old = None
        if on_main:
            old = signal.signal(signal.SIGTERM, self._sigterm)
        else:
            warnings.warn(
                "TrainLoop.run outside the main thread: SIGTERM handler not "
                "installed (Python restricts signal handling to the main "
                "thread); preemption degrades to the _stop flag",
                RuntimeWarning, stacklevel=2)
        tr = telemetry.get_tracer()
        tr.set_track("train_loop")
        hb_on = self.cfg.heartbeat_path is not None
        window: list[float] = []
        completed = self.start_step
        crashed = False
        try:
            for step in range(self.start_step, self.cfg.steps):
                if self._stop:
                    print(f"[train] preemption at step {step}; checkpointing")
                    self._record("preempted", step=step)
                    break
                batch = self._next_batch()
                if batch is _EXHAUSTED:
                    print(f"[train] batch stream ended at step {step}")
                    self._record("stream_exhausted", step=step)
                    break
                t0 = time.perf_counter()
                fault = self.faults.fire("train.step", step=step)
                if fault is not None and fault.action in ("preempt", "sigterm"):
                    if fault.action == "sigterm" and on_main:
                        os.kill(os.getpid(), signal.SIGTERM)  # handler sets _stop
                    else:
                        self._stop = True
                with tr.span("train/step", cat="train", step=step):
                    self.state, loss = self.step_fn(self.state, batch)
                    loss = float(loss)
                dt = time.perf_counter() - t0
                self.losses.append(loss)
                window.append(dt)
                completed = step + 1
                if self.monitor.record(step, dt):
                    print(f"[train] straggler step {step}: {dt * 1e3:.1f} ms")
                if self.step_hook is not None:
                    self.step_hook(completed, self.state)
                if step % self.cfg.log_every == 0:
                    print(f"[train] step {step} loss {loss:.4f} {dt * 1e3:.1f} ms")
                if self.ckpt and completed % self.cfg.ckpt_every == 0:
                    self._save(completed)
                if completed % self.cfg.metrics_every == 0:
                    self._drain_metrics()
                if hb_on and completed % self.cfg.heartbeat_every == 0:
                    self._heartbeat(completed, window)
                    window.clear()
        except InjectedCrash:
            crashed = True  # simulated kill -9: no final checkpoint
            raise
        finally:
            unwinding = sys.exc_info()[1] is not None
            try:
                if self.ckpt and not crashed and self.mesh is not None and unwinding:
                    # the gather is a collective that the other ranks cannot join
                    self._record("final_checkpoint_skipped", step=completed,
                                 error=repr(sys.exc_info()[1]))
                elif self.ckpt and not crashed:
                    self._save(completed, blocking=True)
                    if self.mesh is not None:
                        import torch.distributed as dist
                        dist.barrier(group=self._pg())  # rank 0 has committed
            except Exception as e:  # noqa: BLE001 — don't mask the in-flight error
                self._record("final_checkpoint_failed", step=completed, error=repr(e))
                if not unwinding:
                    raise
            finally:
                try:
                    if not crashed:
                        self._drain_metrics()
                        if hb_on:
                            self._heartbeat(completed, window)
                except Exception:  # noqa: BLE001 — telemetry must not mask the run
                    pass
                if self._owns_batches:
                    try:
                        self.batches.close()
                    except Exception:  # noqa: BLE001 — worker already dead is fine
                        pass
                if old is not None:
                    signal.signal(signal.SIGTERM, old)
        return self.state
