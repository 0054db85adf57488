"""The hot-row cache (``repro_torch.core.cache``) and its touch counts against
the reference's (``repro.core.cache``), on the CPU.

Held bit for bit against the reference on the same numpy inputs:
``parse_hot_sync``, ``hash32``, ``layout_gid_maps`` / ``spec_gid_to_table``,
``hot_positions``, ``select_hot`` under drawn count ties (a 4-shard row and
a 3-shard table layout, which must agree), ``hot_bag_local``'s hit mask, and
the cache subtree and ``cnt`` after port steps against
``repro.core.dlrm.make_train_step(fused_update=False)`` at (1, 1).  Held bit
for bit against the port's own ``hot_rows=0`` steps under ``allreduce``:
every slab and ``sr``, for {sgd, split_sgd, momentum_bf16} x M in {1, 2} x
the host pre-sort on and off, while bags do hit.  ``deferred:8`` drifts from
the cold run, within the reference's pinned bound.  The counts equal the
bincount of the lookups on every update path, a declared ``cnt``
(``adagrad_freq``) is bumped once, and a save in the middle of a run
resumes bit for bit, either package restoring the other's checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import cache as j_cache
from repro.core import dlrm as j_dlrm
from repro.core import sharded_embedding as j_se
from repro.core.embedding import EmbeddingSpec as JSpec
from repro.launch.mesh import make_mesh as j_make_mesh
from repro_torch import weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import cache as t_cache
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.data.pipeline import presort_batch
from repro_torch.optim import row as t_row
from repro_torch.optim.data_parallel import tree_leaves
from repro_torch.testing import to_torch

TABLES = (50, 30, 20, 10)
BASE = dict(name="t", num_dense=4, bottom=(8, 8), top=(8,), table_rows=TABLES, emb_dim=8,
            pooling=3, batch=16, emb_mode="table", idx_input="sharded", lr=0.05)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _zipf_batch(i, batch=16, tables=TABLES) -> dict:
    """``tests/test_cache.py``'s stream: heavy repeats on each table's head."""
    r = np.random.default_rng(500 + i)
    hi = np.array([m - 1 for m in tables])[None, :, None]
    idx = np.minimum(r.zipf(1.5, size=(batch, len(tables), 3)) - 1, hi).astype(np.int32)
    return {"idx": idx, "dense_x": np.asarray(jnp.asarray(r.normal(size=(batch, 4)), jnp.bfloat16)),
            "labels": r.integers(0, 2, batch).astype(np.float32)}


def _np(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the reference's numpy array (bf16 as ``ml_dtypes``,
    int16 bits as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().view(np.uint16) if t.dtype == torch.int16 else t.numpy()


def _port_batch(b: dict) -> dict:
    return {k: to_torch(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["allreduce", "deferred:1", "deferred:8", "deferred:0",
                                  "deferred:x", "deferred:-2", "psum", ""])
def test_parse_hot_sync_matches_reference(mode):
    try:
        want = j_cache.parse_hot_sync(mode)
    except ValueError:
        with pytest.raises(ValueError, match="hot_sync"):
            t_cache.parse_hot_sync(mode)
        return
    assert t_cache.parse_hot_sync(mode) == want


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1, -3, 0xFFFFFFFF])
def test_hash32_bitwise(seed):
    """Over int32 values with the high bit set (the empty -1 included)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4096), [-1, -2 ** 31, 0, 2 ** 31 - 1]])
    x = x.astype(np.int32)
    want = np.asarray(j_cache.hash32(jnp.asarray(x), seed)).astype(np.int64)
    got = t_cache.hash32(torch.from_numpy(x), seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 2 ** 31).any()


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_layout_gid_maps_and_gid_table_match_reference(mode, shards):
    spec, jspec = EmbeddingSpec(TABLES, 4), JSpec(TABLES, 4)
    got = t_se.layout_gid_maps(t_se.make_layout(spec, shards, mode))
    want = j_se.layout_gid_maps(j_se.make_layout(jspec, shards, mode))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(t_cache.spec_gid_to_table(spec), j_cache.spec_gid_to_table(jspec))


def test_hot_positions_matches_reference_and_drops_empties():
    ids = np.array([7, -1, 0, 12, -1, 15], np.int32)
    got = t_cache.hot_positions(16, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_cache.hot_positions(16, jnp.asarray(ids))))
    assert int((got >= 0).sum()) == 4 and got[15] == 5 and got[14] == -1


@pytest.mark.parametrize("every,sync,tick", [(1, "allreduce", 0), (2, "allreduce", 0),
                                             (2, "allreduce", 1), (3, "deferred:2", 2),
                                             (4, "deferred:2", 4), (5, "deferred:3", 6)])
def test_step_cache_cadence_matches_reference(every, sync, tick):
    """One ``step_cache`` from a cache at ``tick`` with a stale mirror: the
    promotion and the refresh happen on the reference's ticks, and the new
    cache equals the reference's ``step_cache`` (run in ``shard_map`` at
    (1, 1)) bit for bit."""
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.optim import row as j_row
    kw = {**BASE, "hot_rows": 4, "promote_every": every, "hot_sync": sync, "sr_seed": 7}
    cfg = t_dlrm.DLRMConfig(**kw)
    spec = EmbeddingSpec(TABLES, 8)
    layout = t_se.make_layout(spec, 1, "table")
    rng = np.random.default_rng(tick + 10 * every)
    l2g, _ = t_se.layout_gid_maps(layout)
    emb = {"hi": to_torch(rng.standard_normal((layout.total_rows, 8)).astype(np.float32)
                          ).to(torch.bfloat16),
           "lo": torch.zeros(layout.total_rows, 8, dtype=torch.int16),
           "cnt": torch.from_numpy((_tie_counts(tick, spec)[l2g.clip(0)] * (l2g >= 0))[:, None]
                                   .astype(np.int32))}
    cache = t_cache.init_cache(cfg, layout, "split_sgd", "cpu")
    cache["tick"].fill_(tick)
    cache["hot_ids"][:3] = torch.tensor([1, 52, 90], dtype=torch.int32)
    cache["hot_pos"] = t_cache.hot_positions(spec.total_rows, cache["hot_ids"])
    cache["hot_w"].normal_()
    got = t_cache.step_cache(cfg, layout, "split_sgd", cache, emb)
    j_cfg = j_dlrm.DLRMConfig(**kw)
    jl = j_se.make_layout(JSpec(TABLES, 8), 1, "table")
    mesh = j_make_mesh((1, 1), ("data", "model"))
    j_emb = {k: jnp.asarray(_np(v)) for k, v in emb.items()}
    j_cache_in = {k: jnp.asarray(_np(v)) for k, v in cache.items()}
    f = jax.jit(compat.shard_map(
        lambda c, e: j_cache.step_cache(j_cfg, jl, j_row.resolve(j_cfg), c, e, "model"),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False))
    want = jax.tree.map(np.asarray, f(j_cache_in, j_emb))
    mine = {k: _np(v) for k, v in got.items()}
    for k in want:
        np.testing.assert_array_equal(_bits(mine[k]), _bits(want[k]))
    promoted = (tick + 1) % every == 0
    assert (int((mine["hot_ids"] >= 0).sum()) > 3) == promoted


def _tie_counts(seed: int, spec) -> np.ndarray:
    """Counts a gid with few distinct values: many ties."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(spec.total_rows, np.int32)
    for t, rows_t in enumerate(spec.table_rows):
        base = int(spec.row_offsets[t])
        counts[base:base + rows_t] = rng.integers(0, 4, rows_t)
    return counts


@pytest.mark.parametrize("seed", [5, 6, 2 ** 31 - 1])
@pytest.mark.parametrize("hot_rows", [1, 6, 40])
def test_select_hot_bitwise_under_ties_on_two_layouts(seed, hot_rows):
    """The same counts a gid select the same hot set, in the same order, as
    the reference's stable-sort form, on a 4-shard row layout and a 3-shard
    table layout; ``hot_rows`` 40 exceeds two tables' rows, so their slots
    end in -1."""
    spec, jspec = EmbeddingSpec(TABLES, 4), JSpec(TABLES, 4)
    counts = _tie_counts(7, spec)
    got = {}
    for name, shards, mode in (("row4", 4, "row"), ("tab3", 3, "table")):
        layout = t_se.make_layout(spec, shards, mode)
        l2g, _ = t_se.layout_gid_maps(layout)
        cnt_full = np.where(l2g >= 0, counts[np.clip(l2g, 0, None)], 0).astype(np.int32)
        got[name] = t_cache.select_hot(layout, torch.from_numpy(cnt_full), hot_rows, seed).numpy()
        want = np.asarray(j_cache.select_hot(j_se.make_layout(jspec, shards, mode),
                                             jnp.asarray(cnt_full), hot_rows, seed))
        np.testing.assert_array_equal(got[name], want)
    np.testing.assert_array_equal(got["row4"], got["tab3"])
    if hot_rows == 40:
        assert (got["row4"] == -1).sum() > 0


def test_select_hot_seed_reorders_ties():
    spec = EmbeddingSpec(TABLES, 4)
    layout = t_se.make_layout(spec, 1, "row")
    cnt = torch.from_numpy(_tie_counts(7, spec))
    assert not torch.equal(t_cache.select_hot(layout, cnt, 6, 5), t_cache.select_hot(layout, cnt, 6, 6))


def test_hot_bag_local_hit_mask_matches_reference_and_bags_are_the_owners():
    """The hit mask equals the reference's; a hit bag equals the owner's bag
    (the plain bag of the store rows) bit for bit, weighted too."""
    spec = EmbeddingSpec(TABLES, 8)
    layout = t_se.make_layout(spec, 1, "table")
    rng = np.random.default_rng(3)
    W = torch.from_numpy(rng.standard_normal((layout.total_rows, 8)).astype(np.float32))
    l2g, g2l = t_se.layout_gid_maps(layout)
    cnt = torch.from_numpy(_tie_counts(2, spec)[l2g.clip(0)] * (l2g >= 0)).to(torch.int32)
    ids = t_cache.select_hot(layout, cnt, 8, 0)
    hot_w = t_cache.refresh_hot_slab(layout, W, ids, torch.from_numpy(g2l),
                                     t_cache.comm.local_group())
    hot_pos = t_cache.hot_positions(spec.total_rows, ids)
    idx = np.stack([rng.integers(0, 6, (32, 3)) for _ in TABLES], 1).astype(np.int32)
    wgt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    jl = j_se.make_layout(JSpec(TABLES, 8), 1, "table")
    want, _ = j_cache.hot_bag_local(jl, jnp.asarray(hot_w.numpy()), jnp.asarray(hot_pos.numpy()),
                                    jnp.asarray(idx))
    maps = t_se.slot_maps(layout, "cpu")
    for weights in (None, torch.from_numpy(wgt)):
        hit, bag = t_cache.hot_bag_local(layout, hot_w, hot_pos, torch.from_numpy(idx), weights)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(want))
        assert 0.0 < float(hit.float().mean()) < 1.0
        owner = t_se.table_sharded_bag_fwd(layout, W, t_se.permute_indices(
            layout, torch.from_numpy(idx), maps), None,
            None if weights is None else t_se.permute_indices(layout, weights, maps), maps=maps)
        np.testing.assert_array_equal(_tbits(bag[hit]), _tbits(owner[hit]))


@pytest.mark.parametrize("kw,match", [(dict(hot_rows=-1), "hot_rows"),
                                      (dict(hot_rows=8, promote_every=0), "promote_every"),
                                      (dict(hot_rows=8, hot_sync="bogus"), "hot_sync"),
                                      (dict(hot_sync="deferred:0"), "hot_sync"),
                                      (dict(hot_rows=10 ** 6), "row space")])
def test_validate_rejects_bad_cache_config_as_reference(kw, match):
    cfg = t_dlrm.DLRMConfig(**{**BASE, **kw})
    with pytest.raises(ValueError, match=match):
        t_dlrm.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        j_dlrm.make_train_step(j_dlrm.DLRMConfig(**{**BASE, **kw}),
                               j_make_mesh((1, 1), ("data", "model")))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _run(cfg, steps: int, presort: bool = False, start=None, batch_fn=_zipf_batch):
    """``steps`` port steps at one rank from ``init_state`` seed 0 (or a copy
    of ``start``); returns (state, losses)."""
    state = (weights.state_to(start, "cpu") if start is not None
             else t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu"))
    step = t_dlrm.make_train_step(cfg, device="cpu")
    layout = t_se.make_layout(cfg.spec, 1, cfg.emb_mode)
    losses = []
    for i in range(steps):
        b = batch_fn(i)
        if presort:
            b.update(presort_batch(layout, b["idx"]))
        state, loss = step(state, _port_batch(b))
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("optimizer", ["sgd", "split_sgd", "momentum_bf16"])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("presort", [False, True])
def test_allreduce_cache_is_bitwise_invisible(optimizer, M, presort):
    """``hot_rows=8`` under ``allreduce`` against ``hot_rows=0``: the losses,
    every slab and ``sr`` bit for bit, while the hot set serves more than
    0.3 of the bags."""
    base = t_dlrm.DLRMConfig(**BASE, sparse_optimizer=optimizer, microbatches=M,
                             host_presort=presort, sr_seed=3)
    off, l_off = _run(base, 4, presort)
    cached = dataclasses.replace(base, hot_rows=8, promote_every=2)
    on, l_on = _run(cached, 4, presort)
    assert l_on == l_off
    assert set(on["emb"]) == set(off["emb"]) | {"cnt"}
    for k in off["emb"]:
        np.testing.assert_array_equal(_tbits(on["emb"][k]), _tbits(off["emb"][k]))
    for a, b in zip(tree_leaves(off["dense"]), tree_leaves(on["dense"])):
        np.testing.assert_array_equal(_tbits(a), _tbits(b))
    if "sr" in off:
        assert int(off["sr"]) == int(on["sr"]) == 3 + 4
    layout = t_se.make_layout(cached.spec, 1, cached.emb_mode)
    hit, _ = t_cache.hot_bag_local(layout, on["cache"]["hot_w"], on["cache"]["hot_pos"],
                                   to_torch(_zipf_batch(3)["idx"]))
    assert float(hit.float().mean()) > 0.3


def _j_state(j_cfg, start):
    """The reference's step at (1, 1) and ``start`` (numpy) placed for it."""
    mesh = j_make_mesh((1, 1), ("data", "model"))
    step, shardings, _, _ = j_dlrm.make_train_step(j_cfg, mesh)
    return step, jax.device_put(jax.tree.map(jnp.asarray, start), shardings), shardings


@pytest.mark.parametrize("mode", ["row", "table"])
def test_cached_steps_match_reference(mode):
    """Four steps with the cache and the metrics from one numpy state, the
    port against the reference's jitted step: ``cnt``, ``hot_ids``,
    ``hot_pos``, ``tick`` and the metrics vector bit for bit; ``hot_w`` bit
    for bit the port's own store rows, and in row mode (whose Split-SGD
    store the port holds bit for bit) the reference's."""
    kw = {**BASE, "emb_mode": mode, "hot_rows": 6, "promote_every": 2, "step_metrics": True,
          "sr_seed": 11}
    t_cfg = t_dlrm.DLRMConfig(**kw)
    start = weights.state_to_numpy(t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(1),
                                                     device="cpu"))
    j_step, j_state, _ = _j_state(j_dlrm.DLRMConfig(**kw, fused_update=False), start)
    state = weights.state_from_numpy(start, t_cfg, device="cpu")
    t_step = t_dlrm.make_train_step(t_cfg, device="cpu")
    for i in range(4):
        b = _zipf_batch(i)
        j_state, j_loss = j_step(j_state, jax.tree.map(jnp.asarray, b))
        state, loss = t_step(state, _port_batch(b))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    want = jax.tree.map(np.asarray, j_state)
    got = weights.state_to_numpy(state)
    np.testing.assert_array_equal(got["emb"]["cnt"], want["emb"]["cnt"])
    for k in ("hot_ids", "hot_pos", "tick"):
        np.testing.assert_array_equal(got["cache"][k], want["cache"][k])
    assert int(got["cache"]["tick"]) == 4 and (got["cache"]["hot_ids"] >= 0).sum() > 10
    np.testing.assert_array_equal(_bits(got["metrics"]), _bits(want["metrics"]))
    layout = t_se.make_layout(t_cfg.spec, 1, t_cfg.emb_mode)
    _, g2l = t_se.layout_gid_maps(layout)
    ids = got["cache"]["hot_ids"]
    rows = _bits(got["emb"]["hi"])[g2l[ids.clip(0)]]
    np.testing.assert_array_equal(_bits(got["cache"]["hot_w"])[ids >= 0], rows[ids >= 0])
    if mode == "row":
        np.testing.assert_array_equal(_bits(got["cache"]["hot_w"]), _bits(want["cache"]["hot_w"]))


def test_deferred_sync_drift_is_real_and_bounded():
    """``deferred:8`` over ``tests/test_cache.py``'s 50-step stream, both
    runs from the reference's ``init_state(PRNGKey(0))`` arrays, as its
    test starts: the store drifts from the cold run (stale rows served) by
    less than the reference's pinned 5e-3."""
    from repro.core import hybrid as j_hybrid

    def run(**kw):
        cfg = t_dlrm.DLRMConfig(**BASE, sparse_optimizer="sgd", **kw)
        j_cfg = j_dlrm.DLRMConfig(**BASE, sparse_optimizer="sgd", split_sgd=False, **kw)
        start, _ = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg),
                                       j_make_mesh((1, 1), ("data", "model")))
        return _run(cfg, 50, start=weights.state_from_numpy(jax.tree.map(np.asarray, start), cfg,
                                                            device="cpu"))[0]
    off = run()
    on = run(hot_rows=8, promote_every=5, hot_sync="deferred:8")
    drift = float((off["emb"]["w"] - on["emb"]["w"]).abs().max())
    assert 0.0 < drift < 5e-3


# ---------------------------------------------------------------------------
# The touch counts
# ---------------------------------------------------------------------------

def _oracle(g: np.ndarray, rows: int) -> np.ndarray:
    g = g.reshape(-1)
    g = g[(g >= 0) & (g < rows)]
    return np.bincount(g, minlength=rows).astype(np.int32)[:, None]


@pytest.mark.parametrize("path", ["row", "row-2-shards", "table", "table-presort", "row-presort",
                                  "weighted"])
def test_counter_bump_equals_bincount_on_every_path(path):
    """The auxiliary ``cnt`` advances by the bincount of the valid lookups,
    before the row kernel, on the device-sorted stream (row mode at one and
    two shards, table mode, weighted bags) and on the host's pre-sorted
    stream; the weights slab steps as without the counts."""
    spec = EmbeddingSpec((40, 24, 9), 8)
    mode = "table" if path.startswith("table") else "row"
    shards = 2 if path == "row-2-shards" else 1
    layout = t_se.make_layout(spec, shards, mode)
    rng = np.random.default_rng(4)
    idx = np.stack([rng.integers(0, m, (8, 5)) for m in spec.table_rows], 1).astype(np.int32)
    dY = torch.from_numpy(rng.standard_normal((8, 3, 8)).astype(np.float32))
    wgt = (torch.from_numpy(rng.uniform(0.5, 1.5, idx.shape).astype(np.float32))
           if path == "weighted" else None)
    W = torch.from_numpy(rng.standard_normal((layout.total_rows, 8)).astype(np.float32))
    R = layout.rows_per_shard
    if mode == "table":
        maps = t_se.slot_maps(layout, "cpu")
        ids = t_se.permute_indices(layout, torch.from_numpy(idx), maps)
        g = (ids.numpy() + layout.slot_local_offsets[None, :, None])
        dY = t_se.permute_indices(layout, dY, maps)
    else:
        ids = torch.from_numpy(idx)
        g = idx + layout.row_offsets[None, :, None]
    want = _oracle(g, layout.total_rows)
    start = torch.from_numpy(rng.integers(0, 5, (layout.total_rows, 1)).astype(np.int32))
    for s in range(shards):
        plain = {"w": W[s * R:(s + 1) * R].clone()}
        store = {"w": W[s * R:(s + 1) * R].clone(), "cnt": start[s * R:(s + 1) * R].clone()}
        group = t_cache.comm.Group(("model",), shards, s, None, t_cache.comm.CollectiveStats())
        presort = None
        if path.endswith("presort"):
            presort = tuple(torch.from_numpy(v[s]) for v in presort_batch(layout, idx).values())
        for st in (plain, store):
            t_se.apply_update(layout, st, "sgd", ids, dY, 0.1, weights=wgt, group=group,
                              presort=presort)
        np.testing.assert_array_equal(store["cnt"].numpy(), (start + torch.from_numpy(want))
                                      [s * R:(s + 1) * R].numpy())
        np.testing.assert_array_equal(_tbits(store["w"]), _tbits(plain["w"]))


@pytest.mark.parametrize("L,rows", [(1, 5), (37, 4), (5000, 3), (5000, 900)])
def test_counter_bump_runs_equal_index_add(L, rows):
    """The bump from the sorted stream's runs (one write a run's count) is
    ``index_add_`` of the masks, bit for bit: runs of one row, very long runs,
    masked lookups inside runs, a run of masked lookups alone."""
    rng = np.random.default_rng(L + rows)
    srows = torch.from_numpy(np.sort(rng.integers(0, rows, L)).astype(np.int32))
    smsk = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32))
    start = torch.from_numpy(rng.integers(0, 100, (rows, 1)).astype(np.int32))
    got = t_row.bump_counters(start.clone(), srows, smsk)
    assert torch.equal(got, start.clone().index_add_(0, srows, smsk[:, None]))


def test_adagrad_freq_declared_cnt_is_bumped_once():
    """A declared ``cnt`` is the cache's too: the store has one, bumped once
    a lookup, and the weights step as without the cache."""
    opt = t_row.get("adagrad_freq")
    assert set(opt.store_struct(10, 4, counters=True)) == {"w", "cnt"}
    W = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 4)).astype(np.float32))
    store = t_row.init_store(opt, W, counters=True)
    assert set(store) == {"w", "cnt"}
    layout = t_se.make_layout(EmbeddingSpec((16,), 4), 1, "row")
    idx = torch.tensor([[[1, 1, 3]], [[3, 5, 1]]], dtype=torch.int32)
    dY = torch.ones(2, 1, 4)
    t_se.apply_update(layout, store, opt, idx, dY, 0.1)
    assert store["cnt"][:, 0].tolist() == [0, 3, 0, 2, 0, 1] + [0] * 10


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)])
def test_elastic_reshard_keeps_the_hot_set(shape):
    """A cached one-rank state laid out for another mesh
    (``weights.reshard_global``): the cache goes across unchanged, the
    counts move with their rows, and ranking the moved counts on the new
    layout gives the same hot set (members are gids, not positions)."""
    from repro_torch.launch.mesh import Mesh
    cfg = t_dlrm.DLRMConfig(**{**BASE, "hot_rows": 6, "promote_every": 1})
    state, _ = _run(cfg, 3)
    glob = weights.state_to_global(state)
    new = Mesh(shape=dict(zip(("data", "model"), shape)), device=torch.device("cpu"))
    old = Mesh(shape={"data": 1, "model": 1}, device=torch.device("cpu"))
    out = weights.reshard_global(glob, cfg, old, new)
    for k, v in glob["cache"].items():
        assert torch.equal(out["cache"][k], v)
    layout = t_dlrm.make_layout(cfg, new)
    assert out["emb"]["cnt"].shape[0] == layout.total_rows
    ids = t_cache.select_hot(layout, out["emb"]["cnt"][:, 0], 6, cfg.sr_seed)
    assert torch.equal(ids, glob["cache"]["hot_ids"]) and int((ids >= 0).sum()) > 10


def test_cache_save_restore_resumes_bitwise_and_crosses_packages(tmp_path):
    """A save after 3 of 6 cached steps (momentum_bf16, ``sr``, the metrics):
    the restored run is the uninterrupted one bit for bit, the cache and the
    counts included; the reference restores the port's checkpoint and the
    port the reference's (of the same numpy state), bit for bit."""
    kw = {**BASE, "sparse_optimizer": "momentum_bf16", "sr_seed": 3, "hot_rows": 8,
          "promote_every": 2, "step_metrics": True}
    cfg = t_dlrm.DLRMConfig(**kw)
    want, _ = _run(cfg, 6)
    mid, _ = _run(cfg, 3)
    CheckpointManager(tmp_path / "port").save(3, mid, blocking=True)
    at, got = CheckpointManager(tmp_path / "port").restore(
        weights.state_to(t_dlrm.init_state(cfg, torch.Generator().manual_seed(9), device="cpu"),
                         "cpu"), device="cpu")
    assert at == 3 and int(got["cache"]["tick"]) == 3
    step = t_dlrm.make_train_step(cfg, device="cpu")
    for i in range(3, 6):
        got, _ = step(got, _port_batch(_zipf_batch(i)))
    a, b = weights.state_to_numpy(got), weights.state_to_numpy(want)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(_bits(x), _bits(y))

    # across the packages, from the port's step-3 state
    mid_np = weights.state_to_numpy(mid)
    j_cfg = j_dlrm.DLRMConfig(**kw, fused_update=False)
    _, j_state, shardings = _j_state(j_cfg, mid_np)
    JManager(tmp_path / "ref").save(3, j_state, blocking=True)
    _, from_ref = CheckpointManager(tmp_path / "ref").restore(weights.state_to(mid, "cpu"),
                                                              device="cpu")
    structs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), j_state)
    _, from_port = JManager(tmp_path / "port").restore(structs, shardings=shardings)
    for tree in (weights.state_to_numpy(from_ref), jax.tree.map(np.asarray, from_port)):
        assert jax.tree.structure(tree) == jax.tree.structure(mid_np)
        for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(mid_np)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(_bits(x), _bits(y))
