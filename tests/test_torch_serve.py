"""The port's serving slice against the JAX package, on the CPU.

Both sides score the same weights: the JAX side draws a train state with
``init_state``, and ``repro_torch.weights`` carries it across bit for bit.
The batch is made with numpy from a fixed seed.  The JAX side runs as its
own tests run it (Pallas in interpret mode on the CPU); the port runs the
kernels' plain versions, which is what its wrappers do with CPU tensors.
The second half ports the server-behaviour cases of tests/test_serve.py to
the port's copy of the server.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.core import sharded_embedding as j_se
from repro.launch.mesh import make_mesh
from repro.optim import split_sgd as j_split
from repro.serve import snapshot as j_snapshot
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.optim import split_sgd as t_split
from repro_torch.serve import (ContinuousBatchingServer, ServerClosed,
                               SnapshotRegistry, bucket_for, make_bucket_scorers,
                               make_snapshot_score_step, snapshot_from_state, snapshot_state)
from repro_torch.testing import assert_close, bf16_ulps, to_numpy, to_torch

# table sizes that are not multiples of row_pad = 8, so the row offsets matter
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=8, mlp_impl="pallas")


def _configs(**over):
    kw = {**SMALL, **over}
    return j_dlrm.DLRMConfig(**kw), t_dlrm.DLRMConfig(**kw)


def _batch(seed: int, B: int) -> dict:
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, m, (B, SMALL["pooling"])) for m in SMALL["table_rows"]],
                   axis=1).astype(np.int32)
    dense_x = np.asarray(jnp.asarray(rng.standard_normal((B, SMALL["num_dense"])), jnp.bfloat16))
    return {"idx": idx, "dense_x": dense_x, "labels": np.zeros(B, np.float32)}


def _jax_world(j_cfg):
    mesh = make_mesh((1, 1), ("data", "model"))
    mdef = j_dlrm.as_hybrid_def(j_cfg)
    state, layout = j_hybrid.init_state(jax.random.PRNGKey(0), mdef, mesh)
    return mesh, mdef, state, layout


def _torch_batch(batch: dict) -> dict:
    return {"idx": torch.from_numpy(batch["idx"]), "dense_x": to_torch(batch["dense_x"])}


@pytest.mark.parametrize("impl,opt", [("pallas", None), ("xla", None), ("pallas", "sgd")])
def test_snapshot_scores_match_reference(impl, opt):
    """Scores within atol = rtol = 2e-2, the bf16 tolerance of
    tests/test_kernels.py: both sides run the same bf16 layers, but sum in
    other orders, so a bf16 rounding between layers can fall either way."""
    j_cfg, t_cfg = _configs(mlp_impl=impl, sparse_optimizer=opt)
    mesh, mdef, state, _ = _jax_world(j_cfg)
    batch = _batch(1, j_cfg.batch)
    fn, _, _, _ = j_snapshot.make_snapshot_score_step(mdef, mesh, donate_batch=False)
    want = np.asarray(fn(j_snapshot.snapshot_state(mdef, state),
                         {k: jnp.asarray(v) for k, v in batch.items()}))

    snap = weights.state_to_snapshot(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    t_fn, bstructs = make_snapshot_score_step(t_cfg, device="cpu")
    got = t_fn(snap, _torch_batch(batch))
    assert got.shape == want.shape == (j_cfg.batch,) and got.dtype == torch.float32
    assert bstructs["idx"] == ((8, 4, 3), torch.int32)
    assert np.isfinite(to_numpy(got)).all()
    assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_bag_output_within_one_bf16_ulp():
    """row_sharded_bag_fwd: the same rows summed in fp32 in other orders,
    then rounded to bf16 as the reference's reduce-scatter wire does, so the
    two sides differ by at most one bf16 ulp."""
    j_cfg, t_cfg = _configs()
    mesh, mdef, state, layout = _jax_world(j_cfg)
    batch = _batch(2, 64)
    axes = ("data", "model")
    bag = compat.shard_map(lambda W, idx: j_se.row_sharded_bag_fwd(layout, W, idx, axes),
                           mesh=mesh, in_specs=(P(axes, None), P()), out_specs=P(axes),
                           check_vma=False)
    want = np.asarray(bag(state["emb"]["hi"], jnp.asarray(batch["idx"])))
    t_layout = t_se.make_layout(t_cfg.spec, 1)
    assert t_layout.rows_per_shard == layout.rows_per_shard
    np.testing.assert_array_equal(t_layout.row_offsets, layout.row_offsets)
    got = t_se.row_sharded_bag_fwd(t_layout, to_torch(np.asarray(state["emb"]["hi"])),
                                   torch.from_numpy(batch["idx"]))
    assert got.dtype == torch.float32 and got.shape == want.shape == (64, 4, 16)
    assert bf16_ulps(to_numpy(got), want).max() <= 1


def test_weights_cross_bit_for_bit():
    """Both hand-offs (the snapshot pytree and the full train state) carry
    the JAX bf16 slabs across bit for bit, and the port's split halves are
    the reference's, bit for bit, on ordinary and special values."""
    j_cfg, t_cfg = _configs()
    _, mdef, state, _ = _jax_world(j_cfg)
    state_np = jax.tree.map(np.asarray, state)
    a = weights.state_to_snapshot(state_np, t_cfg, device="cpu")
    b = weights.snapshot_from_numpy(jax.tree.map(np.asarray, j_snapshot.snapshot_state(mdef, state)),
                                    t_cfg, device="cpu")
    assert a["emb_w"].dtype == torch.bfloat16
    assert torch.equal(a["emb_w"].view(torch.int16), b["emb_w"].view(torch.int16))
    np.testing.assert_array_equal(a["emb_w"].view(torch.int16).numpy(),
                                  state_np["emb"]["hi"].view(np.int16))
    for part in ("bot", "top"):
        for key in ("w", "b"):
            for x, y in zip(a["dense_hi"][part][key], state_np["dense"]["hi"][part][key]):
                np.testing.assert_array_equal(x.view(torch.int16).numpy(), y.view(np.int16))
    with pytest.raises(ValueError):
        weights.state_to_snapshot(state_np, dataclasses.replace(t_cfg, emb_dim=8), device="cpu")

    w = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    w[:6] = [0.0, -0.0, np.inf, -np.inf, np.float32(1e-42), np.finfo(np.float32).max]
    jh, jl = j_split.split_fp32(jnp.asarray(w))
    th, tl = t_split.split_fp32(torch.from_numpy(w))
    np.testing.assert_array_equal(th.view(torch.int16).numpy(), np.asarray(jh).view(np.int16))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).view(np.int16))
    np.testing.assert_array_equal(t_split.combine_split(th, tl).numpy().view(np.int32),
                                  w.view(np.int32))
    np.testing.assert_array_equal(t_split.combine_split(to_torch(np.asarray(jh)),
                                                        to_torch(np.asarray(jl))).numpy(),
                                  np.asarray(j_split.combine_split(jh, jl)))


def test_snapshot_holds_forward_slabs_only():
    t_cfg = t_dlrm.DLRMConfig(**SMALL)
    hi, lo = t_split.split_fp32(torch.randn(t_se.make_layout(t_cfg.spec, 1).total_rows, 16))
    dense = t_dlrm.init_dense_params(t_cfg, torch.Generator().manual_seed(0), device="cpu")
    dense_hi = {p: {k: [t_split.split_fp32(t)[0] for t in v] for k, v in d.items()}
                for p, d in dense.items()}
    state = {"emb": {"hi": hi, "lo": lo}, "dense": {"hi": dense_hi}}
    snap = snapshot_state(t_cfg, state)
    assert set(snap) == {"emb_w", "dense_hi"} and snap["emb_w"] is hi
    owned = snapshot_state(t_cfg, state, copy=True)
    assert owned["emb_w"] is not hi and torch.equal(owned["emb_w"], hi)
    s = snapshot_from_state(t_cfg, state, step=3)
    assert s.emb_bytes * 2 == s.fp32_emb_bytes and s.step == 3
    assert s.total_bytes > s.emb_bytes


def test_server_spans_reach_the_tracer_copy():
    """The serve/batch span of the server copy lands in the port's tracer
    copy when it is enabled, and costs nothing when it is not."""
    from repro_torch import telemetry
    tracer = telemetry.get_tracer()
    assert telemetry.span("x") is telemetry.span("y")        # the shared no-op
    telemetry.configure(True)
    try:
        with _echo_server(max_wait_ms=1.0) as srv:
            assert srv.score(3, timeout=10.0) == 6
        spans = [e for e in tracer.events() if e.get("name") == "serve/batch"]
    finally:
        telemetry.configure(False)
    assert spans and spans[-1]["args"]["bucket"] == 4 and spans[-1]["dur"] >= 0


def test_registry_publish_retire_versions():
    reg = SnapshotRegistry(keep=2)
    assert reg.current() is None
    for step in (0, 5, 10):
        reg.publish({"emb_w": torch.zeros(1)}, step=step)
    assert reg.versions() == [2, 3]
    assert reg.current().version == 3 and reg.current().step == 10
    assert reg.get(1) is None and reg.get(2).step == 5
    assert reg.retire(2) and not reg.retire(2)
    assert reg.versions() == [3]
    with pytest.raises(ValueError):
        SnapshotRegistry(keep=0)


def test_server_over_snapshots_matches_step_and_picks_up_publish():
    """End to end on the CPU: requests padded into bucket 8 score what the
    score step scores for the same rows, and a publish between batches
    serves the new tables with no restart."""
    t_cfg = t_dlrm.DLRMConfig(**SMALL)
    reg = SnapshotRegistry()
    reg.publish(weights.init_snapshot(t_cfg, torch.Generator().manual_seed(0), device="cpu"))
    fns, pad = make_bucket_scorers(t_cfg, (4, 8), lambda: reg.current().state, device="cpu")
    batch = _batch(4, 5)
    payloads = [{"idx": batch["idx"][i], "dense_x": batch["dense_x"].astype(np.float32)[i]}
                for i in range(5)]
    step, _ = make_snapshot_score_step(t_cfg, batch=8, device="cpu")
    want = to_numpy(step(reg.current().state, pad(payloads, 8)))[:5]
    with ContinuousBatchingServer(fns, pad, max_wait_ms=50.0) as srv:
        r1 = np.array([h.result(60.0) for h in [srv.submit(p) for p in payloads]])
        reg.publish(weights.init_snapshot(t_cfg, torch.Generator().manual_seed(1), device="cpu"))
        r2 = np.array([h.result(60.0) for h in [srv.submit(p) for p in payloads]])
        assert srv.requests == 10
    assert np.isfinite(r1).all() and ((r1 > 0) & (r1 < 1)).all()
    np.testing.assert_array_equal(r1, want)
    assert not np.array_equal(r1, r2)


# ------------------------------------------- server (tests/test_serve.py) --

def test_bucket_for_picks_smallest_fit():
    assert bucket_for(1, (4, 16)) == 4
    assert bucket_for(4, (4, 16)) == 4
    assert bucket_for(5, (4, 16)) == 16
    with pytest.raises(ValueError):
        bucket_for(17, (4, 16))


def _echo_server(**kw):
    """Buckets 4/16; scores payload*2 via a padded 'vals' batch."""
    fns = {b: (lambda batch: batch["vals"] * 2) for b in (4, 16)}
    pad = lambda ps, b: {"vals": np.array(ps + [0] * (b - len(ps)))}  # noqa: E731
    return ContinuousBatchingServer(fns, pad, **kw)


def test_continuous_server_scores_and_batches():
    with _echo_server(max_wait_ms=20.0) as srv:
        handles = [srv.submit(i) for i in range(10)]
        assert [h.result(timeout=10.0) for h in handles] == [2 * i for i in range(10)]
        stats = srv.stats()
    assert stats["requests"] == 10 and stats["queue_depth"] == 0
    assert sum(stats["batches"].values()) <= 2
    for p in stats["buckets"].values():
        assert p["n"] > 0 and p["p50_ms"] <= p["p99_ms"]


def test_continuous_server_partial_batch_waits_for_deadline():
    with _echo_server(max_wait_ms=300.0) as srv:
        h1 = srv.submit(1)
        t = threading.Timer(0.03, lambda: srv.submit(2))
        t.start()
        assert h1.result(timeout=10.0) == 2
        t.join()
        deadline = time.perf_counter() + 5.0
        while srv.requests < 2 and time.perf_counter() < deadline:
            time.sleep(0.005)
        assert sum(srv.batches.values()) == 1
        assert srv.requests == 2


def test_continuous_server_poisoned_by_scorer_error():
    fns = {4: lambda batch: (_ for _ in ()).throw(RuntimeError("boom"))}
    pad = lambda ps, b: {}  # noqa: E731
    srv = ContinuousBatchingServer(fns, pad, max_wait_ms=1.0)
    h = srv.submit(0)
    with pytest.raises(ServerClosed) as ei:
        h.result(timeout=10.0)
    assert isinstance(ei.value.__cause__, RuntimeError)
    with pytest.raises(ServerClosed):
        srv.submit(1)
    srv.close()


def test_continuous_server_close_fails_queued():
    srv = _echo_server(max_wait_ms=1.0)
    srv.close()
    with pytest.raises(ServerClosed):
        srv.submit(0)


def test_continuous_server_flushes_partial_at_deadline():
    """A lone request waits out max_wait_ms for company, then is scored in a
    partial batch of its own."""
    with _echo_server(max_wait_ms=60.0) as srv:
        t0 = time.perf_counter()
        assert srv.score(5, timeout=10.0) == 10
        dt = time.perf_counter() - t0
        assert srv.batches == {4: 1, 16: 0} and srv.padded == 3
    assert dt >= 0.055
