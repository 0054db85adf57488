"""The in-graph step metrics (``repro_torch.telemetry.metrics``), the stage
profiler (``telemetry.stages``) and the trace summary
(``telemetry.summarize``) against the reference's, on the CPU.

``pack`` / ``window`` / ``hit_rate`` / ``drain`` and the counting helpers
equal the reference's; the metrics vector is bit for bit invisible to
training and its counts exact; ``BENCH_telemetry.json`` ``metrics`` (the
hit rate and the window of one step) is reproduced exactly at (1, 1) (the
hot set is a function of counts, gids and seed, not of the mesh); the
``TrainLoop`` heartbeat's ``metrics_window`` and ``cache_hit_rate`` equal
the reference loop's; ``profile_stages`` times six stages whose modelled
bytes and flops are the reference's; either package's summary of either
package's trace is the same, and so is the CLI's.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as j_dlrm
from repro.core import sharded_embedding as j_se
from repro.core.embedding import EmbeddingSpec as JSpec
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.telemetry import Tracer as JTracer
from repro.telemetry import metrics as j_mx
from repro.telemetry import stages as j_stages
from repro.telemetry import summarize as j_sum
from repro_torch import weights
from repro_torch.core import cache as t_cache
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.data.synthetic import zipf_indices
from repro_torch.telemetry import Tracer
from repro_torch.telemetry import metrics as t_mx
from repro_torch.telemetry import stages as t_stages
from repro_torch.telemetry import summarize as t_sum
from repro_torch.testing import to_torch
from repro_torch.train import TrainLoop, TrainLoopConfig

ROOT = Path(__file__).resolve().parents[1]
TABLES = (50, 30, 20, 10)
BASE = dict(name="t", num_dense=4, bottom=(8, 8), top=(8,), table_rows=TABLES, emb_dim=8,
            pooling=3, batch=16, emb_mode="table", idx_input="sharded", lr=0.05)
# the configuration of benchmarks/bench_telemetry.py's metrics section
BENCH = dict(name="bench", num_dense=32, bottom=(64, 16), top=(64,), table_rows=(2000,) * 8,
             emb_dim=16, pooling=5, batch=64, emb_mode="table", idx_input="sharded",
             hot_rows=64, promote_every=2, step_metrics=True)


def _zipf_batch(i, batch=16) -> dict:
    r = np.random.default_rng(500 + i)
    hi = np.array([m - 1 for m in TABLES])[None, :, None]
    idx = np.minimum(r.zipf(1.5, size=(batch, len(TABLES), 3)) - 1, hi).astype(np.int32)
    idx[0, 0, 0] = -1      # an invalid id: read by no row
    idx[1, 1, 2] = 30      # past table 1's rows
    return {"idx": idx, "dense_x": np.asarray(jnp.asarray(r.normal(size=(batch, 4)), jnp.bfloat16)),
            "labels": r.integers(0, 2, batch).astype(np.float32)}


def _port_batch(b: dict) -> dict:
    return {k: to_torch(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [{}, {"steps": 1.0, "bags": 512.0, "skipped_bags": 463.0},
                                   {"hit_lookups": 2508, "rows_touched": 2560,
                                    "exchange_payload_bytes": 3136.5}])
def test_pack_matches_reference(slots):
    got = t_mx.pack("cpu", **slots).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_mx.pack(**slots)))
    assert t_mx.METRIC_NAMES == j_mx.METRIC_NAMES and got.dtype == np.float32
    with pytest.raises(ValueError, match="unknown metric"):
        t_mx.pack(bogus=1.0)


@pytest.mark.parametrize("bags,skipped", [(512.0, 463.0), (0.0, 0.0), (3.0, 1.0),
                                          (65536.0, 34567.0), (1e7 + 1, 12345.0)])
def test_window_hit_rate_and_drain_match_reference(bags, skipped):
    cur = dict(zip(j_mx.METRIC_NAMES, (7.0, 2508.0, skipped, bags, 2560.0, 3136.0)))
    prev = dict(zip(j_mx.METRIC_NAMES, (6.0, 100.0, 0.0, 1.0, 0.5, 0.0)))
    for p in (None, prev):
        assert t_mx.window(cur, p) == j_mx.window(cur, p)
    assert t_mx.hit_rate(cur) == j_mx.hit_rate(cur)
    vec = np.asarray(list(cur.values()), np.float32)
    assert t_mx.drain({"metrics": torch.from_numpy(vec)}) == j_mx.drain({"metrics": jnp.asarray(vec)})
    assert t_mx.drain({"emb": {}}) is None and j_mx.drain({"emb": {}}) is None


def test_counting_helpers_match_reference():
    """``valid_lookups`` and ``cache_hit_counts`` against the reference's on
    the same block; ``valid_lookups_padded`` against a numpy count."""
    spec, jspec = EmbeddingSpec(TABLES, 8), JSpec(TABLES, 8)
    rng = np.random.default_rng(5)
    idx = rng.integers(-3, 60, (16, 4, 3)).astype(np.int32)
    layout, jl = t_se.make_layout(spec, 3, "table"), j_se.make_layout(jspec, 3, "table")
    assert float(t_mx.valid_lookups(layout, torch.from_numpy(idx))) == float(
        j_mx.valid_lookups(jl, jnp.asarray(idx)))
    ids = np.array([0, 1, 2, -1, 56, 57, 100, 3], np.int32)
    hot_pos = t_cache.hot_positions(spec.total_rows, torch.from_numpy(ids))
    got = t_mx.cache_hit_counts(layout, hot_pos, torch.from_numpy(idx))
    want = j_mx.cache_hit_counts(jl, jnp.asarray(hot_pos.numpy()), jnp.asarray(idx))
    assert [float(g) for g in got] == [float(w) for w in want] and float(got[0]) > 0
    padded = t_se.permute_indices(layout, torch.from_numpy(idx)).numpy()
    caps = t_mx.padded_caps(layout)
    K = layout.slots_per_shard
    for m in range(3):
        block = padded[:, m * K:(m + 1) * K]
        want_m = ((block >= 0) & (block < caps[m * K:(m + 1) * K][None, :, None])).sum()
        assert float(t_mx.valid_lookups_padded(layout, torch.from_numpy(block), m)) == want_m


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _steps(cfg, n: int, start=None):
    state = (weights.state_to(start, "cpu") if start is not None
             else t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu"))
    step = t_dlrm.make_train_step(cfg, device="cpu")
    losses = []
    for i in range(n):
        state, loss = step(state, _port_batch(_zipf_batch(i)))
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("mode,idx_input", [("table", "sharded"), ("table", "replicated"),
                                            ("row", "replicated"), ("row", "sharded")])
def test_metrics_are_invisible_to_training_and_count_exactly(mode, idx_input):
    """``step_metrics=True`` against ``False``, 4 steps with the cache
    (``hot_rows`` 8): the losses and every other leaf bit for bit; the
    vector's ``steps``, ``bags``, ``rows_touched`` equal to counts of the
    batches, and the hit slots equal to the reference's test of the hot set
    each step read (zero without the bypass)."""
    kw = {**BASE, "emb_mode": mode, "idx_input": idx_input, "hot_rows": 8, "promote_every": 2}
    cfg = t_dlrm.DLRMConfig(**kw)
    on_cfg = dataclasses.replace(cfg, step_metrics=True)
    if idx_input == "replicated" and mode == "table":
        layout = t_se.make_layout(cfg.spec, 1, "table")

        def batch(i):
            b = _zipf_batch(i)
            b["idx"] = t_se.permute_indices(layout, torch.from_numpy(b["idx"])).numpy()
            return b
    else:
        batch = _zipf_batch
    states, hits = {}, [0.0, 0.0]
    for name, c in (("off", cfg), ("on", on_cfg)):
        state = t_dlrm.init_state(c, torch.Generator().manual_seed(0), device="cpu")
        step = t_dlrm.make_train_step(c, device="cpu")
        losses = []
        for i in range(4):
            if name == "on" and mode == "table" and idx_input == "sharded":
                lk, bg = t_mx.cache_hit_counts(t_se.make_layout(c.spec, 1, "table"),
                                               state["cache"]["hot_pos"],
                                               to_torch(batch(i)["idx"]))
                hits[0] += float(lk)
                hits[1] += float(bg)
            state, loss = step(state, _port_batch(batch(i)))
            losses.append(float(loss))
        states[name] = (state, losses)
    (off, l_off), (on, l_on) = states["off"], states["on"]
    assert l_on == l_off
    a = weights.state_to_numpy(off)
    b = weights.state_to_numpy(on)
    vec = b.pop("metrics")
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                                      np.asarray(y).reshape(-1).view(np.uint8))
    m = dict(zip(t_mx.METRIC_NAMES, vec.tolist()))
    rows = sum(int(((_zipf_batch(i)["idx"] >= 0)
                    & (_zipf_batch(i)["idx"] < np.array(TABLES)[None, :, None])).sum())
               for i in range(4))
    assert m["steps"] == 4 and m["bags"] == 4 * 16 * 4 and m["rows_touched"] == rows
    assert m["hit_lookups"] == hits[0] and m["skipped_bags"] == hits[1]
    assert m["exchange_payload_bytes"] == (m["bags"] - m["skipped_bags"]) * 8 * 4
    if mode == "table" and idx_input == "sharded":
        assert m["skipped_bags"] > 0


def test_bench_telemetry_metrics_reproduced_exactly(tmp_path):
    """``BENCH_telemetry.json`` ``metrics``: 6 steps of the bench's
    configuration (8 x 2000 x 16, pooling 5, batch 64, hot_rows 64,
    promote_every 2) on ``zipf_indices`` from ``default_rng(0)``, then the
    all-hot fraction of a held-out batch, and one more step on it drained
    before and after: the hit rate 0.904296875 and the window's counts,
    exactly, at (1, 1) (the bench ran 8 ranks)."""
    want = json.loads((ROOT / "BENCH_telemetry.json").read_text())["metrics"]
    cfg = t_dlrm.DLRMConfig(**BENCH)
    state = t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = t_dlrm.make_train_step(cfg, device="cpu")
    rng = np.random.default_rng(0)

    def batch():
        idx = np.stack([zipf_indices(rng, m, (64, 5), 1.05) for m in cfg.table_rows],
                       1).astype(np.int32)
        return {"idx": torch.from_numpy(idx),
                "dense_x": torch.from_numpy(rng.standard_normal((64, 32))).to(torch.bfloat16),
                "labels": torch.from_numpy(rng.integers(0, 2, 64).astype(np.float32))}

    for _ in range(want["trained_steps"]):
        state, _ = step(state, batch())
    mb = batch()
    layout = t_se.make_layout(cfg.spec, 1, "table")
    hit, _ = t_cache.hot_bag_local(layout, state["cache"]["hot_w"], state["cache"]["hot_pos"],
                                   mb["idx"])
    bench_hit_rate = float(hit.float().mean())
    tr = Tracer(enabled=True)
    before = t_mx.drain(state)
    t_mx.emit(tr, before)
    state, _ = step(state, mb)
    after = t_mx.drain(state)
    t_mx.emit(tr, after)
    win = t_mx.window(after, before)
    assert bench_hit_rate == want["bench_hit_rate"] == 0.904296875
    assert t_mx.hit_rate(win) == want["window_hit_rate"]
    assert {k: win[k] for k in want["window"]} == want["window"]
    assert after["steps"] == want["cumulative_steps"]
    path = tr.export(tmp_path / "bench.json")
    assert t_sum.summarize(path)["metrics"]["last_window_hit_rate"] == want["summarize_hit_rate"]


def test_train_loop_heartbeat_matches_reference(tmp_path):
    """The port's ``TrainLoop`` and the reference's over the same cached
    configuration with the metrics, from one numpy state, ``metrics_every``
    3 and a heartbeat every 3 of 7 steps: each record's ``metrics_window``
    and ``cache_hit_rate`` equal, the drains on the trace too."""
    from repro.train.loop import TrainLoop as JLoop
    from repro.train.loop import TrainLoopConfig as JLoopConfig
    from repro.telemetry import tracer as j_tracer
    from repro_torch.telemetry import tracer as t_tracer

    kw = {**BASE, "hot_rows": 8, "promote_every": 2, "step_metrics": True}
    cfg = t_dlrm.DLRMConfig(**kw)
    start = weights.state_to_numpy(t_dlrm.init_state(cfg, torch.Generator().manual_seed(2),
                                                     device="cpu"))
    mesh = j_make_mesh((1, 1), ("data", "model"))
    j_step, shardings, _, _ = j_dlrm.make_train_step(j_dlrm.DLRMConfig(**kw, fused_update=False),
                                                     mesh)
    recs = {}
    for name in ("port", "ref"):
        hb = tmp_path / f"{name}.jsonl"
        batches = [_zipf_batch(i) for i in range(7)]
        if name == "port":
            t_tracer.configure(True)
            loop = TrainLoop(TrainLoopConfig(steps=7, metrics_every=3, heartbeat_every=3,
                                             heartbeat_path=str(hb), log_every=100),
                             t_dlrm.make_train_step(cfg, device="cpu"),
                             # a copy: the step updates in place, and on the CPU
                             # state_from_numpy shares the arrays' memory
                             weights.state_to(weights.state_from_numpy(start, cfg, device="cpu"),
                                              "cpu"),
                             iter([_port_batch(b) for b in batches]), device="cpu")
            try:
                loop.run()
                drains = [e for e in t_tracer.get_tracer().events() if e.get("ph") == "C"]
            finally:
                t_tracer.configure(False)
        else:
            j_tracer.configure(enabled=True)
            try:
                loop = JLoop(JLoopConfig(steps=7, metrics_every=3, heartbeat_every=3,
                                         heartbeat_path=str(hb), log_every=100), j_step,
                             jax.device_put(jax.tree.map(jnp.asarray, start), shardings),
                             iter([jax.tree.map(jnp.asarray, b) for b in batches]))
                loop.run()
                j_drains = [e for e in j_tracer.get_tracer().events() if e.get("ph") == "C"]
            finally:
                j_tracer.configure(enabled=False)
        recs[name] = [json.loads(line) for line in hb.read_text().splitlines()]
    assert len(recs["port"]) == len(recs["ref"]) == 3
    for a, b in zip(recs["port"], recs["ref"]):
        assert a["step"] == b["step"]
        assert a["metrics_window"] == b["metrics_window"]
        assert a["cache_hit_rate"] == b["cache_hit_rate"]
    assert recs["port"][0]["cache_hit_rate"] > 0
    assert [d["args"] for d in drains[-3:]] == [d["args"] for d in j_drains[-3:]]


# ---------------------------------------------------------------------------
# The stage profile and the summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("ranks", [1, 8, 64])
def test_modeled_stage_costs_match_reference(mode, ranks):
    kw = dict(BENCH, emb_mode=mode)
    cfg = t_dlrm.DLRMConfig(**kw)
    j_cfg = j_dlrm.DLRMConfig(**kw)
    got = t_stages.modeled_stage_costs(cfg, t_se.make_layout(cfg.spec, 1, mode), ranks=ranks)
    want = j_stages.modeled_stage_costs(j_dlrm.as_hybrid_def(j_cfg),
                                        j_se.make_layout(j_cfg.spec, 1, mode), ranks=ranks)
    assert list(got) == list(want)
    for name in want:
        for k in ("bytes", "flops", "comm"):
            assert got[name][k] == want[name][k], (name, k)
        assert got[name]["modeled_us"] >= 0


def test_profile_stages_times_six_stages_on_their_track(tmp_path):
    """One rank on the CPU: six stages, each with ms and its modelled
    bytes, flops and µs, a span per timed run on ``pipeline_stages``; the
    exported trace's summary lists them."""
    cfg = t_dlrm.DLRMConfig(**dict(BASE, emb_mode="row", idx_input="replicated"))
    tr = Tracer(enabled=True)
    out = t_stages.profile_stages(cfg, steps=2, tracer=tr, device="cpu")
    assert list(out["stages"]) == ["index_exchange", "embedding_fwd", "dense_fwd_bwd",
                                   "dY_exchange", "sparse_update", "dense_update"]
    want = t_stages.modeled_stage_costs(cfg, t_se.make_layout(cfg.spec, 1, "row"))
    for name, r in out["stages"].items():
        assert r["ms"] > 0 and r["bytes"] == want[name]["bytes"]
        assert r["flops"] == want[name]["flops"] and r["modeled_us"] == want[name]["modeled_us"]
    assert out["chip"] == "h100-sxm" and out["dense_params"] > 0
    track = t_sum.summarize(tr.export(tmp_path / "stages.json"))["tracks"]["pipeline_stages"]
    assert sorted(track) == sorted(f"stage/{n}" for n in out["stages"])
    assert all(r["count"] == 2 and "modeled_bytes" in r for r in track.values())


def _fill(tr, counter) -> None:
    """Spans on the thread's and on virtual tracks, serve spans with and
    without a bucket, instants, and three metric drains."""
    tr.set_track("train_loop")
    for i in range(3):
        with tr.span("train/step", cat="train", step=i):
            pass
    with tr.span("stage/embedding_fwd", track="pipeline_stages", modeled_bytes=1e6,
                 modeled_flops=2e6, modeled_us=3.5):
        pass
    for b, n in ((8, 5), (32, 20), (8, 7)):
        with tr.span("serve/batch", track="server", bucket=b, n=n):
            pass
    with tr.span("serve/publish", track="server"):
        pass
    tr.instant("fault/loader", cat="faults")
    tr.instant("train/heartbeat")
    for k in range(1, 4):
        counter("repro.metrics", dict(zip(j_mx.METRIC_NAMES,
                                          (k, 100.0 * k, 45.0 * k, 64.0 * k, 320.0 * k, 9.0))))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_summaries_agree_both_ways_and_cli(writer, tmp_path):
    tr = Tracer(enabled=True) if writer == "port" else JTracer(enabled=True)
    _fill(tr, tr.counter)
    path = tr.export(str(tmp_path / "trace.json"))
    got, want = t_sum.summarize(path), j_sum.summarize(path)
    assert got == want and got["metrics"]["drains"] == 3 and got["serve"]
    assert t_sum.format_summary(got) == j_sum.format_summary(want)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for extra in ([], ["--json"]):
        res = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", "summarize",
                              str(path), *extra], env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr
        if extra:
            assert json.loads(res.stdout) == json.loads(json.dumps(want))
        else:
            assert res.stdout.strip() == j_sum.format_summary(want).strip()
