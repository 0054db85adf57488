"""The port's train loop, fault plan, failure log and threaded iterator
against the JAX package's, on the CPU.

The reference's loop cases (``tests/test_train_loop.py``) and its drills
(``tests/test_faults.py``: the kill matrix, the corrupt-checkpoint
fallback, preemption, the skip-batch budget, the loader's retries and
sticky death) run on ``repro.train`` and ``repro_torch.train`` alike, the
port's loop with ``device="cpu"``.  Then the quickstart's contract at its own
size: both packages' loops train the same carried DLRM state on the same
batches for 6 steps with a checkpoint every 3, restore at step 6 and take 3
more, their losses held to each other.
"""

import itertools
import json
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro import faults as j_faults
from repro import telemetry as j_telemetry
from repro import train as j_train
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.data import pipeline as j_pipeline
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.train import loop as j_loop
from repro_torch import checkpoint as t_ckpt
from repro_torch import faults as t_faults
from repro_torch import telemetry as t_telemetry
from repro_torch import train as t_train
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.data import pipeline as t_pipeline
from repro_torch.data import synthetic as t_syn
from repro_torch.launch.mesh import make_mesh as t_make_mesh
from repro_torch.testing import to_torch


class _Pkg:
    """One package's loop, checkpoint, fault and iterator API; the port's
    loop and prefetch run with ``device="cpu"``."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.train = j_train if jax_side else t_train
        self.loop_mod = j_loop if jax_side else t_train
        self.ckpt = j_ckpt if jax_side else t_ckpt
        self.faults = j_faults if jax_side else t_faults
        self.telemetry = j_telemetry if jax_side else t_telemetry
        self.ThreadedIterator = (j_pipeline if jax_side else t_pipeline).ThreadedIterator
        self.device_kw = {} if jax_side else {"device": "cpu"}

    def TrainLoop(self, cfg, step, state, batches, **kw):
        return self.train.TrainLoop(cfg, step, state, batches, **self.device_kw, **kw)

    def prefetch(self, batches, size=2, **kw):
        return self.train.prefetch_to_device(batches, size=size, **self.device_kw, **kw)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Pkg(request.param)


def _x(batch) -> int:
    return int(np.asarray(batch["x"]).reshape(-1)[0])


# ---------------------------------------------------------------------------
# tests/test_train_loop.py, on both packages
# ---------------------------------------------------------------------------


def test_straggler_detection(pkg):
    mon = pkg.train.StragglerMonitor(window=20, threshold=2.0)
    for i in range(20):
        assert not mon.record(i, 0.1)
    assert mon.record(20, 0.5)
    assert not mon.record(21, 0.12)
    assert len(mon.events) == 1
    snap = mon.snapshot()
    assert snap["n"] == 20 and snap["outliers"] == 1


def test_straggler_callback(pkg):
    hits = []
    mon = pkg.train.StragglerMonitor(window=10, threshold=1.5,
                                     on_straggler=lambda s, dt, med: hits.append(s))
    for i in range(12):
        mon.record(i, 0.1)
    mon.record(99, 1.0)
    assert hits == [99]


def test_rebalancer_conserves_batch_and_floors(pkg):
    rb = pkg.loop_mod.DataRebalancer(n_hosts=4)
    rb.penalize(2)
    rb.penalize(2)
    rows = rb.rows_per_host(1024)
    assert rows.sum() == 1024 and rows[2] < rows[0]
    for _ in range(200):
        rb.penalize(2, factor=0.5)
    assert rb.shares[2] == pytest.approx(0.5 / 4)
    assert rb.shares.sum() == pytest.approx(1.0)


class _RecordingIter:
    """Source iterator that records how far the consumer has pulled."""

    def __init__(self, n):
        self.n = n
        self.pulled = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pulled >= self.n:
            raise StopIteration
        self.pulled += 1
        return {"x": np.full((2,), self.pulled - 1, np.int32)}


def test_prefetch_preserves_order_and_pulls_ahead(pkg):
    src = _RecordingIter(10)
    it = pkg.prefetch(src, size=3)
    first = next(it)
    deadline = time.monotonic() + 5.0
    while src.pulled < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert 4 <= src.pulled <= 1 + 3 + 1      # ahead, within the window
    got = [_x(first)] + [_x(b) for b in it]
    assert got == list(range(10))
    assert src.pulled == 10


class _FailingIter:
    """Yields ``good`` batches, then dies like a broken loader."""

    def __init__(self, good):
        self.good = good
        self.pulled = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pulled >= self.good:
            raise RuntimeError("shard decode failed")
        self.pulled += 1
        return {"x": np.full((2,), self.pulled - 1, np.int32)}


def test_prefetch_propagates_worker_exception(pkg):
    it = pkg.prefetch(_FailingIter(2), size=4)
    assert _x(next(it)) == 0 and _x(next(it)) == 1
    with pytest.raises(RuntimeError, match="shard decode failed"):
        next(it)


def test_prefetch_early_exit_releases_worker(pkg):
    src = _RecordingIter(10_000)
    it = pkg.prefetch(src, size=2)
    next(it), next(it)
    it.close()
    deadline = time.monotonic() + 5.0
    while (any(t.name == "prefetch_to_device" and t.is_alive() for t in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())
    pulled = src.pulled
    time.sleep(0.05)
    assert src.pulled == pulled


def test_prefetch_short_stream_and_validation(pkg):
    assert [_x(b) for b in pkg.prefetch(_RecordingIter(2), 5)] == [0, 1]
    with pytest.raises(ValueError, match="size"):
        list(pkg.prefetch(iter([]), size=0))


def test_loop_surfaces_loader_failure(pkg):
    def step(state, batch):
        return state + 1, float(state)

    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=10, log_every=100, prefetch=2),
                         step, 0, _FailingIter(3))
    with pytest.raises(RuntimeError, match="shard decode failed"):
        loop.run()
    assert len(loop.losses) == 3


def test_loop_uses_prefetch(pkg):
    seen = []

    def step(state, batch):
        seen.append(_x(batch))
        return state + 1, float(state)

    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=6, log_every=100, prefetch=2),
                         step, 0, _RecordingIter(100))
    loop.run()
    assert seen == list(range(6))
    assert not loop.batches._tit._thread.is_alive()     # the loop closed its worker


def test_loop_checkpoint_restore(pkg, tmp_path):
    def step(state, batch):
        return state + 1, float(state)

    batches = iter(range(10_000))
    cfg = pkg.train.TrainLoopConfig
    loop = pkg.TrainLoop(cfg(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=100),
                         step, 0, batches)
    loop.run()
    loop2 = pkg.TrainLoop(cfg(steps=15, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=100),
                          step, 0, batches)
    assert loop2.start_step == 10
    assert int(loop2.state) == 10
    loop2.run()
    assert int(loop2.state) == 15


def test_keyboard_interrupt_writes_final_checkpoint(pkg, tmp_path):
    def step(state, batch):
        if state == 7:
            raise KeyboardInterrupt
        return state + 1, float(state)

    cfg = pkg.train.TrainLoopConfig(steps=100, ckpt_dir=str(tmp_path), ckpt_every=50,
                                    log_every=1000)
    loop = pkg.TrainLoop(cfg, step, 0, iter(range(10_000)))
    with pytest.raises(KeyboardInterrupt):
        loop.run()
    assert pkg.ckpt.CheckpointManager(tmp_path).latest_valid_step() == 7
    loop2 = pkg.TrainLoop(cfg, step, 0, iter(range(10_000)))
    assert loop2.start_step == 7 and int(loop2.state) == 7


def test_injected_crash_leaves_no_final_checkpoint(pkg, tmp_path):
    """A simulated process death in a step: the periodic checkpoint at 3
    stays, no final one is written at 4, and the crash propagates."""
    plan = pkg.faults.FaultPlan([pkg.faults.Fault("train.step", action="crash", step=4)])

    def step(state, batch):
        return state + 1, float(state)

    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path),
                                                   ckpt_every=3, log_every=1000),
                         step, 0, iter(range(100)), faults=plan)
    with pytest.raises(pkg.faults.InjectedCrash):
        loop.run()
    loop.ckpt.wait()
    assert len(loop.losses) == 4
    assert pkg.ckpt.CheckpointManager(tmp_path).steps() == [3]


def test_trainloop_step_hook_and_heartbeat(pkg, tmp_path):
    hooks = []

    def step(state, batch):
        time.sleep(0.001)
        return state + batch, float(batch)

    hb = tmp_path / "hb.jsonl"
    stream = pkg.ThreadedIterator(iter(range(100)), depth=2)
    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=7, heartbeat_path=str(hb),
                                                   heartbeat_every=3, log_every=100),
                         step, 0, stream, step_hook=lambda s, st: hooks.append(s),
                         serve_stats=lambda: {"snapshot": {"version": 7}})
    loop.run()
    stream.close()
    assert hooks == list(range(1, 8))
    recs = [json.loads(line) for line in hb.read_text().splitlines()]
    assert [r["step"] for r in recs] == [3, 6, 7]
    for r in recs[:2]:
        assert r["window_steps"] == 3
        assert 0 < r["step_ms_p50"] <= r["step_ms_p99"]
        assert r["ingest"]["batches"] >= 3
        assert r["skipped_batches"] == 0
        assert r["serve"] == {"snapshot": {"version": 7}}
    assert recs[-1]["window_steps"] == 1


def test_trainloop_emits_step_spans_on_its_track(pkg):
    tr = pkg.telemetry.configure(enabled=True)
    n0 = len(tr.events())
    try:
        loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=4, prefetch=2, log_every=100),
                             lambda state, batch: (state, 0.5), 0, iter(np.arange(50.0)))
        loop.run()
        events = tr.events()[n0:]
        spans = [e for e in events if e.get("ph") == "X" and e["name"] == "train/step"]
        assert len(spans) == 4
        tracks = {e["tid"]: e["args"]["name"] for e in tr.events() if e.get("ph") == "M"}
        assert {tracks[s["tid"]] for s in spans} == {"train_loop"}
    finally:
        pkg.telemetry.configure(enabled=False)


# ---------------------------------------------------------------------------
# tests/test_faults.py, on both packages
# ---------------------------------------------------------------------------


def test_fault_plan_step_indexed_counted_and_seeded(pkg):
    F = pkg.faults
    plan = F.FaultPlan([F.Fault("train.step", step=3, times=2)])
    for s in (0, 1, 2):
        assert plan.fire("train.step", step=s) is None
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected fault"):
            plan.fire("train.step", step=3)
    assert plan.fire("train.step", step=3) is None
    assert plan.count("train.step") == 2
    with pytest.raises(ValueError, match="unknown fault action"):
        F.Fault("x", action="explode")
    a = F.FaultPlan.random(7, ["train.step", "loader.next"], steps=50, rate=0.2)
    b = j_faults.FaultPlan.random(7, ["train.step", "loader.next"], steps=50, rate=0.2)
    assert [(f.site, f.step) for f in a._faults] == [(f.site, f.step) for f in b._faults]
    assert not issubclass(F.InjectedCrash, Exception)


def test_failure_log_records_jsonl_and_trace_instants(pkg, tmp_path):
    tr = pkg.telemetry.configure(enabled=True)
    n0 = len(tr.events())
    try:
        log = pkg.faults.FailureLog(tmp_path / "events.jsonl")
        log.record("ckpt_write_retry", step=3, attempt=0)
        log.record("preempted", step=9)
        assert log.counts() == {"ckpt_write_retry": 1, "preempted": 1}
        lines = [json.loads(ln) for ln in (tmp_path / "events.jsonl").read_text().splitlines()]
        assert [ln["kind"] for ln in lines] == ["ckpt_write_retry", "preempted"]
        inst = [e for e in tr.events()[n0:] if e.get("ph") == "i"]
        assert [e["name"] for e in inst] == ["fault/ckpt_write_retry", "fault/preempted"]
        assert inst[0]["args"] == {"step": "3", "attempt": "0"}
        assert "faults" in {e["args"]["name"] for e in tr.events() if e.get("ph") == "M"}
    finally:
        pkg.telemetry.configure(enabled=False)


class _RetryableSource:
    """Pull index ``i`` in ``fail_pulls`` fails once, then succeeds."""

    def __init__(self, n, fail_pulls=()):
        self.n = n
        self.i = 0
        self.fail_pulls = set(fail_pulls)

    def __iter__(self):
        return self

    def __next__(self):
        if self.i in self.fail_pulls:
            self.fail_pulls.discard(self.i)
            raise RuntimeError("shard read failed")
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return {"x": np.full((8,), self.i - 1, np.float32)}


def test_threaded_iterator_retries_transient_faults(pkg):
    it = pkg.ThreadedIterator(_RetryableSource(6, fail_pulls=(1, 3)), retries=2,
                              retry_backoff_s=0.001)
    assert [int(b["x"][0]) for b in it] == list(range(6))
    st = it.stats
    assert set(st) == {"prep_s", "wait_s", "batches", "retries"}
    assert st["batches"] == 6 and st["retries"] == 2


def test_threaded_iterator_sticky_dead_after_poison(pkg):
    def dies():
        yield 1
        yield 2
        raise RuntimeError("loader died")

    it = pkg.ThreadedIterator(dies())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_loader_fault_hook_injects_death_and_stall(pkg):
    F = pkg.faults
    plan = F.FaultPlan([F.Fault("loader.next", step=2)])
    it = pkg.ThreadedIterator(({"x": i} for i in range(10)), faults=plan)
    assert next(it)["x"] == 0 and next(it)["x"] == 1
    with pytest.raises(RuntimeError, match="injected fault"):
        next(it)
    plan = F.FaultPlan([F.Fault("loader.next", step=1, action="stall", delay_s=0.05)])
    it = pkg.ThreadedIterator(({"x": i} for i in range(4)), faults=plan)
    assert [b["x"] for b in it] == [0, 1, 2, 3]
    assert plan.count("loader.next") == 1


def test_prefetch_forwards_faults(pkg):
    plan = pkg.faults.FaultPlan([pkg.faults.Fault("loader.next", step=1)])
    it = pkg.prefetch(({"x": np.int32(i)} for i in range(8)), size=2, faults=plan)
    assert int(np.asarray(next(it)["x"])) == 0
    with pytest.raises(RuntimeError, match="injected fault"):
        for _ in range(8):
            next(it)


def _toy_step(state, batch):
    new = {"w": state["w"] * np.float32(0.999) + np.asarray(batch["x"]),
           "sr": state["sr"] + np.int32(1)}
    return new, float(np.sum(new["w"]))


def _toy_init():
    return {"w": np.arange(8, dtype=np.float32), "sr": np.int32(0)}


def _toy_stream(start=0):
    def batch(i):
        rng = np.random.default_rng(1000 + i)
        return {"x": rng.standard_normal(8).astype(np.float32)}

    return (batch(i) for i in itertools.count(start))


def _toy_reference(steps=12):
    state, stream = _toy_init(), _toy_stream()
    for _ in range(steps):
        state, _ = _toy_step(state, next(stream))
    return state


def _resume_and_finish(pkg, ckpt_dir, steps=12, **loop_kw):
    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                                                   ckpt_every=3, log_every=1000),
                         _toy_step, _toy_init(), iter(()), **loop_kw)
    loop.batches = _toy_stream(loop.start_step)
    return loop.run(), loop


KILL_MATRIX = {
    "arrays_crash": lambda F: [F.Fault("ckpt.write.arrays", action="crash")],
    "arrays_torn_commit": lambda F: [F.Fault("ckpt.write.arrays", action="partial")],
    "meta_crash": lambda F: [F.Fault("ckpt.write.meta", action="crash")],
    "commit_crash": lambda F: [F.Fault("ckpt.commit", action="crash")],
    "enospc_exhausted": lambda F: [F.Fault("ckpt.write.arrays", times=10,
                                           exc=lambda: OSError(28, "No space left"))],
    "loader_death": lambda F: [F.Fault("loader.next", step=7)],
    "sigterm_mid_run": lambda F: [F.Fault("train.step", action="sigterm", step=7)],
    "preempt_flag": lambda F: [F.Fault("train.step", action="preempt", step=5)],
}


@pytest.mark.parametrize("name", list(KILL_MATRIX))
def test_kill_matrix_resumes_bitwise(pkg, tmp_path, name):
    """Inject the fault, let the run die or stop, restart from disk: the
    final state is bit for bit an uninterrupted run's."""
    want = _toy_reference(12)
    log = pkg.faults.FailureLog()
    plan = pkg.faults.FaultPlan(KILL_MATRIX[name](pkg.faults), log=log)
    batches = (pkg.ThreadedIterator(_toy_stream(), faults=plan) if name == "loader_death"
               else _toy_stream())
    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=12, ckpt_dir=str(tmp_path),
                                                   ckpt_every=3, log_every=1000),
                         _toy_step, _toy_init(), batches, faults=plan, event_log=log)
    died = None
    try:
        loop.run()
    except BaseException as e:  # noqa: BLE001 — drills die in many ways
        died = e
    assert plan.count() >= 1
    if name in ("sigterm_mid_run", "preempt_flag"):
        assert died is None
    got, loop2 = _resume_and_finish(pkg, tmp_path, event_log=log)
    assert 0 <= loop2.start_step <= 12
    np.testing.assert_array_equal(got["w"], want["w"])
    assert got["sr"] == want["sr"]
    if loop2.start_step:
        pkg.ckpt.CheckpointManager(tmp_path).verify(loop2.start_step)


def test_corrupt_latest_checkpoint_drill(pkg, tmp_path):
    want = _toy_reference(12)
    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=9, ckpt_dir=str(tmp_path),
                                                   ckpt_every=3, log_every=1000),
                         _toy_step, _toy_init(), _toy_stream())
    loop.run()
    assert pkg.ckpt.CheckpointManager(tmp_path).latest_step() == 9
    pkg.faults.corrupt_checkpoint(tmp_path, 9, "flip")
    log = pkg.faults.FailureLog()
    got, loop2 = _resume_and_finish(pkg, tmp_path, event_log=log)
    assert loop2.start_step == 6
    assert log.counts()["ckpt_corrupt_skipped"] >= 1
    np.testing.assert_array_equal(got["w"], want["w"])
    assert got["sr"] == want["sr"]


def test_run_off_main_thread_degrades_gracefully(pkg, tmp_path):
    result = {}

    def target():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plan = pkg.faults.FaultPlan([pkg.faults.Fault("train.step", action="preempt",
                                                          step=2)])
            loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path),
                                                           ckpt_every=100, log_every=1000),
                                 _toy_step, _toy_init(), _toy_stream(), faults=plan)
            loop.run()
            result["warned"] = any("main thread" in str(w.message) for w in caught)
            result["losses"] = len(loop.losses)

    t = threading.Thread(target=target)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert result["warned"] and result["losses"] == 3
    assert pkg.ckpt.CheckpointManager(tmp_path).latest_valid_step() == 3


def test_skip_batch_budget_counts_and_bounds(pkg):
    log = pkg.faults.FailureLog()
    cfg = pkg.train.TrainLoopConfig(steps=8, log_every=1000, skip_batch_budget=2)
    loop = pkg.TrainLoop(cfg, _toy_step, _toy_init(), _RetryableSource(50, fail_pulls=(2, 5)),
                         event_log=log)
    loop.run()
    assert loop.skipped_batches == 2 and len(loop.losses) == 8
    assert log.counts()["batch_skipped"] == 2
    loop = pkg.TrainLoop(cfg, _toy_step, _toy_init(),
                         _RetryableSource(50, fail_pulls=(1, 2, 3)))
    with pytest.raises(RuntimeError, match="shard read failed"):
        loop.run()
    assert loop.skipped_batches == 2


def test_dead_prefetch_loader_within_budget_ends_cleanly(pkg, tmp_path):
    def dies_at(n):
        for _ in range(n):
            yield {"x": np.full((8,), 0.01, np.float32)}
        raise RuntimeError("loader died for good")

    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=50, ckpt_dir=str(tmp_path),
                                                   ckpt_every=100, log_every=1000, prefetch=2,
                                                   skip_batch_budget=1),
                         _toy_step, _toy_init(), dies_at(5))
    loop.run()
    assert len(loop.losses) == 5 and loop.skipped_batches == 1
    assert pkg.ckpt.CheckpointManager(tmp_path).latest_valid_step() == 5


def test_injected_stall_registers_as_straggler(pkg):
    plan = pkg.faults.FaultPlan([pkg.faults.Fault("train.step", action="stall", step=12,
                                                  delay_s=0.05)])
    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=15, log_every=1000),
                         _toy_step, _toy_init(), _toy_stream(), faults=plan)
    loop.run()
    assert 12 in [e[0] for e in loop.monitor.events]


# ---------------------------------------------------------------------------
# The mesh, and the quickstart's contract at its own size
# ---------------------------------------------------------------------------


def test_mesh_is_one_rank():
    mesh = t_make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == dict(j_make_mesh((1, 1), ("data", "model")).shape)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="one rank"):
        t_make_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="length"):
        t_make_mesh((1,), ("data", "model"), device="cpu")


QUICKSTART = dict(name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
                  table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100), emb_dim=32,
                  pooling=8, batch=512, lr=0.05)


def test_quickstart_contract_matches_the_reference_loop(tmp_path):
    """Both packages' loops from the same carried state (the reference's
    draw) over the same ``dlrm_stream(0, cfg, alpha=0.6)`` batches: 6 steps
    with a checkpoint every 3, a fresh loop that restores at step 6 (the
    port's into a state drawn from another seed) and 3 more.  The port's 9
    losses equal, bit for bit, those of 9 steps of its own without a loop or
    a restore.  Against the reference: the first three steps within 1e-6
    relative (``tests/test_torch_train.py``'s tolerance for three steps);
    all nine within 1e-4, since the two sum the dense network in other
    orders and the states drift apart step by step (9.1e-6 at step 8,
    measured; the same without the loop).  The eval step of the final state
    scores the next batch as the reference's ``make_eval_step`` does on that
    state, their logits as :func:`_assert_logits_close` holds them."""
    j_cfg = j_dlrm.DLRMConfig(**QUICKSTART, fused_update=False)
    t_cfg = t_dlrm.DLRMConfig(**QUICKSTART)
    mesh = j_make_mesh((1, 1), ("data", "model"))
    state, _ = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    t_state = weights.state_from_numpy(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    j_step, shardings, _, _ = j_dlrm.make_train_step(j_cfg, mesh)
    t_step = t_dlrm.make_train_step(t_cfg, device="cpu")
    pool = []
    for b, _ in zip(t_syn.dlrm_stream(0, t_cfg, alpha=0.6), range(10)):
        b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
        pool.append(b)
    t_pool = [{k: to_torch(v) for k, v in b.items()} for b in pool]
    direct, plain = weights.state_to(t_state, "cpu"), []
    for b in t_pool[:9]:
        direct, loss = t_step(direct, b)
        plain.append(float(loss))

    j_stream = (jax.tree.map(jnp.asarray, b) for b in pool)
    t_stream = iter(t_pool)

    def loop_cfg(mod, steps, sub):
        return mod.TrainLoopConfig(steps=steps, ckpt_dir=str(tmp_path / sub), ckpt_every=3,
                                   log_every=100)

    j1 = j_train.TrainLoop(loop_cfg(j_train, 6, "jax"), j_step, state, j_stream,
                           state_shardings=shardings)
    state = j1.run()
    j2 = j_train.TrainLoop(loop_cfg(j_train, 9, "jax"), j_step, state, j_stream,
                           state_shardings=shardings)
    state = j2.run()
    t1 = t_train.TrainLoop(loop_cfg(t_train, 6, "torch"), t_step, t_state, t_stream, device="cpu")
    t1.run()
    other = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(3), device="cpu")
    t2 = t_train.TrainLoop(loop_cfg(t_train, 9, "torch"), t_step, other, t_stream, device="cpu")
    assert j2.start_step == t2.start_step == 6
    t_state = t2.run()
    losses, want = t1.losses + t2.losses, j1.losses + j2.losses
    assert losses == plain
    np.testing.assert_allclose(losses[:3], want[:3], rtol=1e-6, atol=0)
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=0)

    j_ev, _, _, _ = j_dlrm.make_eval_step(j_cfg, mesh)
    t_ev = t_dlrm.make_eval_step(t_cfg, device="cpu")
    got = t_ev(t_state, t_pool[9])
    want = np.asarray(j_ev(jax.tree.map(jnp.asarray, weights.state_to_numpy(t_state)),
                           jax.tree.map(jnp.asarray, pool[9])))
    assert got.shape == (t_cfg.batch,) and bool(((got > 0) & (got < 1)).all())
    _assert_logits_close(got, want)


# The eval step's scores of these random models sit near 0.5 (logits of a
# few tenths), so they are compared as logits.  Both packages run the same
# bf16 layers but sum in other orders, so now and then an activation rounds
# to the neighbouring bf16 value and moves its sample's logit by a few 1e-5
# (measured: 1 sample of the quickstart's 512 at 3.9e-5; every other gap at
# most 2.4e-7, an fp32 ulp of the score).  So at least 99 % of the logits lie
# within ``EVAL_ATOL`` and every one within ``EVAL_FLIP_ATOL``, both far under
# what a wrong eval step moves them by (the faulted cases below).
EVAL_ATOL = 1e-5
EVAL_FLIP_ATOL = 1e-3


def _assert_logits_close(got: torch.Tensor, want: np.ndarray) -> None:
    got_l = torch.logit(got.double()).numpy()
    want_l = torch.logit(torch.from_numpy(np.asarray(want, np.float64))).numpy()
    gap = np.abs(got_l - want_l)
    share = float((gap > EVAL_ATOL).mean())
    assert share <= 0.01, f"{share:.2%} of the logits off by more than {EVAL_ATOL}"
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=EVAL_FLIP_ATOL)


SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=32, lr=0.1)


@pytest.mark.parametrize("impl,weighted,opt", [("xla", False, "split_sgd"),
                                               ("pallas", False, "split_sgd"),
                                               ("xla", True, "split_sgd"),
                                               ("pallas", True, "momentum_bf16"),
                                               ("xla", False, "adagrad_rowwise")])
def test_eval_step_matches_reference(impl, weighted, opt):
    """``make_eval_step`` against the reference's on a (1, 1) mesh, from the
    same carried state: the logits as :func:`_assert_logits_close` holds
    them, the scores in (0, 1); with ``mlp_impl="pallas"`` the reference runs
    its fused_mlp kernel in interpret mode and the port its kernel's plain
    version."""
    kw = {**SMALL, "mlp_impl": impl, "weighted": weighted, "sparse_optimizer": opt}
    j_cfg, t_cfg = j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)
    mesh = j_make_mesh((1, 1), ("data", "model"))
    state, _ = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    t_state = weights.state_from_numpy(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    b = next(t_syn.dlrm_stream(4, t_cfg, 1.05))
    b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
    if weighted:
        b["weights"] = np.random.default_rng(4).uniform(0.5, 1.5, b["idx"].shape).astype(
            np.float32)
    j_ev, _, _, _ = j_dlrm.make_eval_step(j_cfg, mesh)
    want = np.asarray(j_ev(state, jax.tree.map(jnp.asarray, b)))
    got = t_dlrm.make_eval_step(t_cfg, device="cpu")(t_state, {k: to_torch(v) for k, v in b.items()})
    assert got.shape == want.shape == (t_cfg.batch,) and got.dtype == torch.float32
    assert bool(((got > 0) & (got < 1)).all())
    _assert_logits_close(got, want)


@pytest.mark.parametrize("fault", ["zeroed_table_slab", "constant_scores"])
def test_eval_tolerance_rejects_a_broken_eval_step(fault):
    """The comparison of :func:`test_eval_step_matches_reference` fails an eval
    step that scores without the embedding tables (their forward slab zeroed)
    or returns sigmoid(0) for every sample."""
    kw = {**SMALL, "mlp_impl": "xla", "weighted": False, "sparse_optimizer": "split_sgd"}
    j_cfg, t_cfg = j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)
    mesh = j_make_mesh((1, 1), ("data", "model"))
    state, _ = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    t_state = weights.state_from_numpy(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    b = next(t_syn.dlrm_stream(4, t_cfg, 1.05))
    b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
    j_ev, _, _, _ = j_dlrm.make_eval_step(j_cfg, mesh)
    want = np.asarray(j_ev(state, jax.tree.map(jnp.asarray, b)))
    if fault == "zeroed_table_slab":
        t_state["emb"]["hi"].zero_()
        got = t_dlrm.make_eval_step(t_cfg, device="cpu")(
            t_state, {k: to_torch(v) for k, v in b.items()})
    else:
        got = torch.full((t_cfg.batch,), 0.5)
    with pytest.raises(AssertionError):
        _assert_logits_close(got, want)
