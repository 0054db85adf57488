"""The port's hybrid-parallel train and eval steps at 4 and 8 gloo ranks,
against the reference's on as many forced XLA CPU devices.

The same numpy start state (the reference's global arrays) and the same
global batches go through ``repro.core.dlrm.make_train_step``
(``fused_update=False``, the jitted reference row math) in one subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it, and through the port in one process
group of 4 ranks and one of 8 (``_torch_ranks.hybrid_cases_rank``):
each rank gets its shard of the state (``weights.state_from_numpy``) and
its block of each batch (``core.hybrid.local_batch``), and rank 0 gathers
the state back (``weights.state_to_numpy``).  The three run at once.

Tolerances are those of the one-rank three-step test
(``tests/test_torch_train.py``): the loss within 1e-6 relative (every small
case came out equal; the quickstart-size case is held within 1e-5, see
``test_losses_match_reference``), rows no step touched bit for bit, touched
rows, their state slabs and the fp32 master of the dense weights within
1e-3 relative plus 1e-5.  Row mode
with Split-SGD is held bit for bit on the store and the dense state (its
reduce-scatters are summed in XLA's order, its cotangent is bf16); table
mode's fp32 cotangent sums a row's duplicates in the order of the sorted
stream, which is not XLA's scatter order, so a few low halves differ by
one ulp.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.launch.local import run_ranks
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import row as t_row
from repro_torch.optim.split_sgd import combine_split
from _torch_ranks import hybrid_cases_rank

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13, 60, 21), emb_dim=16, pooling=3, batch=32, lr=0.1)
QUICKSTART = dict(name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
                  table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100), emb_dim=32,
                  pooling=8, batch=512, lr=0.05)
# benchmarks/bench_comm_model.py's measured leg, whose collective bytes BENCH_pipeline.json keeps
BENCH = dict(name="bench", num_dense=32, bottom=(64, 16), top=(64,), table_rows=(2000,) * 8,
             emb_dim=16, pooling=5, batch=64, emb_mode="table")

CASES4 = [
    ("1x4-row-replicated", (1, 4), {}),
    ("1x4-row-sharded", (1, 4), {"idx_input": "sharded"}),
    ("1x4-table-replicated", (1, 4), {"emb_mode": "table"}),
    ("1x4-table-sharded", (1, 4), {"emb_mode": "table", "idx_input": "sharded"}),
    ("1x4-table-adagrad", (1, 4), {"emb_mode": "table", "sparse_optimizer": "adagrad",
                                   "lr": 0.01}),
    ("2x2-row-replicated", (2, 2), {}),
    ("2x2-row-sharded", (2, 2), {"idx_input": "sharded"}),
    ("2x2-table-replicated", (2, 2), {"emb_mode": "table"}),
    ("2x2-table-sharded", (2, 2), {"emb_mode": "table", "idx_input": "sharded"}),
    ("2x2-row-weighted", (2, 2), {"weighted": True}),
    # the stateful kinds in row mode at N shards (ROADMAP queue 3: the port's
    # update stream spreads other shards' lookups where the reference clips them)
    ("2x2-row-momentum", (2, 2), {"sparse_optimizer": "momentum"}),
    ("2x2-row-adagrad", (2, 2), {"sparse_optimizer": "adagrad", "lr": 0.01}),
    ("2x2-row-adagrad_rowwise", (2, 2), {"sparse_optimizer": "adagrad_rowwise", "lr": 0.01}),
    ("2x2-row-adagrad_freq", (2, 2), {"sparse_optimizer": "adagrad_freq"}),
    ("2x2-row-momentum_bf16", (2, 2), {"sparse_optimizer": "momentum_bf16",
                                       "sr_seed": 2 ** 31 - 2}),
    ("2x2-row-adagrad_bf16", (2, 2), {"sparse_optimizer": "adagrad_bf16", "lr": 0.01,
                                      "sr_seed": 2 ** 31 - 2}),
]
ROW_STATEFUL = [n for n, _, o in CASES4 if "sparse_optimizer" in o and "emb_mode" not in o]
CASES8 = [("2x4-quickstart-row-replicated", (2, 4), QUICKSTART)]
# the reference's tests/test_cache.py::test_cache_multirank_bitwise_and_hotset_identity:
# table mode, the sharded stream, Split-SGD, 4 steps of its zipf(1.5) batches,
# the hot-row cache on (hot_rows 8, promote_every 2) and off
CACHE = dict(name="cache", num_dense=8, bottom=(16, 8), top=(16,), table_rows=(100, 60, 40, 30),
             emb_dim=8, pooling=3, batch=16, emb_mode="table", idx_input="sharded",
             sparse_optimizer="split_sgd", lr=0.05)
CACHE_CASES = [("2x4-cache-cold", (2, 4), CACHE),
               ("2x4-cache-hot8", (2, 4), {**CACHE, "hot_rows": 8, "promote_every": 2})]

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core import dlrm
from repro.launch.mesh import make_mesh
out = []
for c in pickle.load(open(sys.argv[1], "rb")):
    mesh = make_mesh(c["mesh"], ("data", "model"))
    cfg = dlrm.DLRMConfig(**c["cfg"], fused_update=False)
    step, shardings, _, _ = dlrm.make_train_step(cfg, mesh)
    state = jax.device_put(jax.tree.map(jnp.asarray, c["start"]), shardings)
    ev, _, _, _ = dlrm.make_eval_step(cfg, mesh)
    scores = np.asarray(ev(state, jax.tree.map(jnp.asarray, c["eval"])))
    losses = []
    for b in c["batches"]:
        state, loss = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
    out.append({"losses": losses, "scores": scores, "state": jax.tree.map(np.asarray, state)})
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _emb_shards(cfg, mesh) -> int:
    return mesh[1] if cfg.emb_mode == "table" else mesh[0] * mesh[1]


def _start(cfg, mesh, seed: int) -> dict:
    """A global start state of ``cfg`` on ``mesh`` as the reference's numpy
    arrays: table rows ~ U(-a, a) from numpy, the optimizer's state slabs
    drawn too (``mom`` ~ U(-a, a), ``acc`` ~ U(0, a), ``cnt`` in 1..3), dense
    weights drawn by the port."""
    layout = t_se.make_layout(cfg.spec, _emb_shards(cfg, mesh), cfg.emb_mode)
    a = 1.0 / np.sqrt(np.mean(cfg.table_rows))
    W = np.random.default_rng(seed).uniform(-a, a, (layout.total_rows, cfg.emb_dim))
    opt = t_row.resolve(cfg)
    emb = t_row.init_store(opt, torch.from_numpy(W.astype(np.float32)), counters=cfg.hot_rows > 0)
    rng = np.random.default_rng(seed + 1)
    for key, _, dtype in opt.state:  # state from earlier steps: a step of a row that
        slab = emb[key]              # should not step shows
        vals = (rng.integers(1, 4, slab.shape) if dtype == torch.int32
                else rng.uniform(0 if key == "acc" else -a, a, slab.shape))
        slab.copy_(torch.from_numpy(vals).to(dtype))
    state = {"emb": emb,
             "dense": t_dp.dp_global_arrays(
                 t_dlrm.init_dense_params(cfg, torch.Generator().manual_seed(seed), "cpu"),
                 mesh[0] * mesh[1])}
    if opt.stochastic_round:
        state["sr"] = torch.tensor(cfg.sr_seed, dtype=torch.int32)
    if cfg.hot_rows > 0:
        from repro_torch.core.cache import init_cache
        state["cache"] = init_cache(cfg, layout, opt, "cpu")
    return weights.state_to_numpy(state)


def _batches(cfg, mesh, n: int, seed: int) -> list[dict]:
    """n zipf batches; table mode with the replicated stream takes them in
    padded-slot order, as the reference's loader gives them."""
    rng = np.random.default_rng(seed)
    layout = t_se.make_layout(cfg.spec, _emb_shards(cfg, mesh), cfg.emb_mode)
    out = []
    for _ in range(n):
        B = cfg.batch
        idx = np.stack([rng.zipf(1.3, (B, cfg.pooling)) % m for m in cfg.table_rows], 1)
        b = {"idx": idx.astype(np.int32),
             "dense_x": rng.standard_normal((B, cfg.num_dense)).astype(ml_dtypes.bfloat16),
             "labels": rng.integers(0, 2, B).astype(np.float32)}
        if cfg.weighted:
            b["weights"] = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
        if cfg.emb_mode == "table" and cfg.idx_input == "replicated":
            for k in ("idx", "weights"):
                if k in b:
                    b[k] = t_se.permute_indices(layout, torch.from_numpy(b[k])).numpy()
        out.append(b)
    return out


def _cache_batches(n: int) -> list[dict]:
    """The reference's multi-rank cache test's batches: zipf(1.5) on each
    table's head, from ``default_rng(300 + i)``."""
    out = []
    for i in range(n):
        r = np.random.default_rng(300 + i)
        hi = np.array([m - 1 for m in CACHE["table_rows"]])[None, :, None]
        idx = np.minimum(r.zipf(1.5, size=(16, 4, 3)) - 1, hi).astype(np.int32)
        out.append({"idx": idx, "dense_x": r.normal(size=(16, 8)).astype(ml_dtypes.bfloat16),
                    "labels": r.integers(0, 2, 16).astype(np.float32)})
    return out


def _cache_case(name, mesh, over):
    cfg = t_dlrm.DLRMConfig(**over)
    bs = _cache_batches(5)
    return {"name": name, "cfg": over, "mesh": mesh, "start": _start(cfg, mesh, 300),
            "batches": bs[:4], "eval": bs[4]}


def _case(name, mesh, over, seed):
    kw = {**SMALL, **over}
    cfg = t_dlrm.DLRMConfig(**kw)
    bs = _batches(cfg, mesh, STEPS + 1, seed)
    return {"name": name, "cfg": kw, "mesh": mesh, "start": _start(cfg, mesh, seed),
            "batches": bs[:STEPS], "eval": bs[STEPS]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid")
    c4 = [_case(n, m, o, i) for i, (n, m, o) in enumerate(CASES4)]
    c8 = ([_case(n, m, o, 100 + i) for i, (n, m, o) in enumerate(CASES8)]
          + [_cache_case(n, m, o) for n, m, o in CACHE_CASES])
    # the measured leg, then its cache leg (the sharded stream) without and with
    # 64 hot rows a table: the bytes BENCH_pipeline.json's "cache" keeps
    bench = [{"name": "bench", "cfg": cfg, "mesh": (1, 8), "start": None,
              "batches": _batches(t_dlrm.DLRMConfig(**cfg), (1, 8), 1, 7), "eval": None}
             for cfg in (BENCH, {**BENCH, "exchange_dtype": "bf16"},
                         {**BENCH, "idx_input": "sharded"},
                         {**BENCH, "idx_input": "sharded", "hot_rows": 64, "promote_every": 2})]
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(c4 + c8, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(tmp / "cases.pkl"),
                            str(tmp / "ref.pkl")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port4 = run_ranks(hybrid_cases_rank, 4, (c4,), timeout_s=240, store_dir=str(tmp))
        port8 = run_ranks(hybrid_cases_rank, 8, (c8 + bench,), timeout_s=240,
                          store_dir=str(tmp))
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = {}
    for cases, port in ((c4, port4), (c8, port8)):
        for i, c in enumerate(cases):
            got[c["name"]] = (c, [port[r][i] for r in range(len(port))])
    return got, dict(zip([c["name"] for c in c4 + c8], want)), port8[0][len(c8):]


def _touched(case) -> np.ndarray:
    """The rows of the reference's global store that the steps touch (table
    mode: also every shard's spare row, which the dummy slots read)."""
    cfg = t_dlrm.DLRMConfig(**case["cfg"])
    layout = t_se.make_layout(cfg.spec, _emb_shards(cfg, case["mesh"]), cfg.emb_mode)
    out = np.zeros(layout.total_rows, bool)
    R = layout.rows_per_shard
    for b in case["batches"]:
        idx = b["idx"]
        if cfg.emb_mode == "row":
            out[(idx + layout.row_offsets[None, :, None]).reshape(-1)] = True
            continue
        if cfg.idx_input == "sharded":
            idx = t_se.permute_indices(layout, torch.from_numpy(idx)).numpy()
        pos = np.arange(layout.num_padded_slots)
        base = (pos // layout.slots_per_shard) * R + layout.slot_local_offsets
        out[(idx + base[None, :, None]).reshape(-1)] = True
    if cfg.emb_mode == "table":
        out[np.arange(layout.num_shards) * R + R - 1] = True
    return out


def _master(emb: dict) -> np.ndarray:
    """The fp32 master rows of a store (Split-SGD's ``hi`` and ``lo`` joined)."""
    if "hi" in emb:
        return np.asarray(combine_split(weights.to_torch(emb["hi"]), weights.to_torch(emb["lo"])))
    return np.asarray(emb["w"], np.float32)


def _dense_master(state: dict, ns: int, nb: int = 4) -> np.ndarray:
    """The fp32 master of the dense weights: the ``hi`` leaves raveled in
    pytree order, joined with the global bucketed ``lo`` put back in
    natural order."""
    hi = np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree.leaves(state["dense"]["hi"])])
    lo = np.asarray(state["dense"]["lo"])
    lo = lo.reshape(ns, nb, -1).transpose(1, 0, 2).reshape(-1)[:hi.size]
    return _master({"hi": hi, "lo": lo})


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


NAMES = [n for n, _, _ in CASES4 + CASES8 + CACHE_CASES]
# row-wise Adagrad's touched weights after three steps: jitted XLA sums a row's
# squares in an order of its own (tests/test_torch_row_optim.py: within 6e-8 at one rank)
ROWWISE_W_ATOL = 6e-8


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_reference(runs, name):
    """Within 1e-6 relative (the small cases came out equal).  At the
    quickstart's widths the dense network's sums alone, taken in other
    orders by the two frameworks, move the loss by more: the one-rank steps
    of both packages on these batches differ by 1.08e-6 at the first step
    and 2.28e-6 at the second, so that case is held within 1e-5."""
    got, want, _ = runs
    case, ranks = got[name]
    for r in ranks:  # every rank returns the same loss
        assert r["losses"] == ranks[0]["losses"]
    rtol = 1e-5 if case["cfg"]["name"] == "quickstart" else 1e-6
    np.testing.assert_allclose(ranks[0]["losses"], want[name]["losses"], rtol=rtol, atol=0)
    assert np.isfinite(ranks[0]["losses"]).all()


@pytest.mark.parametrize("name", NAMES)
def test_store_and_dense_state_match_reference(runs, name):
    got, want, _ = runs
    case, ranks = got[name]
    cfg = t_dlrm.DLRMConfig(**case["cfg"])
    mine, ref, start = ranks[0]["state"], want[name]["state"], case["start"]
    touched = _touched(case)
    for k in mine["emb"]:
        assert mine["emb"][k].shape == ref["emb"][k].shape
        np.testing.assert_array_equal(_bits(mine["emb"][k])[~touched],
                                      _bits(ref["emb"][k])[~touched])
        np.testing.assert_array_equal(_bits(mine["emb"][k])[~touched],
                                      _bits(start["emb"][k])[~touched])
        if k not in ("hi", "lo"):  # Split-SGD's halves are held as the fp32 master below
            np.testing.assert_allclose(np.asarray(mine["emb"][k], np.float32)[touched],
                                       np.asarray(ref["emb"][k], np.float32)[touched],
                                       rtol=1e-3, atol=1e-5)
    w_mine, w_ref, w_start = _master(mine["emb"]), _master(ref["emb"]), _master(start["emb"])
    assert (w_ref[touched] != w_start[touched]).any()
    np.testing.assert_allclose(w_mine[touched], w_ref[touched], rtol=1e-3, atol=1e-5)
    ranks_n = case["mesh"][0] * case["mesh"][1]
    np.testing.assert_allclose(_dense_master(mine, ranks_n), _dense_master(ref, ranks_n),
                               rtol=1e-3, atol=1e-5)
    if cfg.emb_mode == "row" and name in [n for n, _, _ in CASES4]:
        # bit for bit, as at one rank (tests/test_torch_row_optim.py,
        # tests/test_torch_stochastic.py), but for row-wise Adagrad's touched rows,
        # held below to that kind's one-rank tolerances
        rowwise = cfg.sparse_optimizer == "adagrad_rowwise"
        for k in mine["emb"]:
            keep = ~touched if rowwise else np.ones_like(touched)
            np.testing.assert_array_equal(_bits(mine["emb"][k])[keep], _bits(ref["emb"][k])[keep])
        if rowwise:
            np.testing.assert_allclose(mine["emb"]["w"][touched], ref["emb"]["w"][touched],
                                       rtol=0, atol=ROWWISE_W_ATOL)
            np.testing.assert_allclose(mine["emb"]["acc"][touched], ref["emb"]["acc"][touched],
                                       rtol=2 ** -21, atol=0)
        for a, b in zip(jax.tree.leaves({k: v for k, v in mine.items() if k != "emb"}),
                        jax.tree.leaves({k: v for k, v in ref.items() if k != "emb"})):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def _masked_only(case) -> tuple[np.ndarray, np.ndarray]:
    """Rows of the global store that only masked lookups reach (no step
    touches them): (the reference's, rows 0 and R - 1 of each shard, where
    its stream clips other shards' lookups; the port's, where its stream keys
    another shard's lookup by its flat index modulo R)."""
    cfg = t_dlrm.DLRMConfig(**case["cfg"])
    layout = t_se.make_layout(cfg.spec, _emb_shards(cfg, case["mesh"]), cfg.emb_mode)
    R, touched = layout.rows_per_shard, _touched(case)
    clip = np.zeros(layout.total_rows, bool)
    clip[np.arange(layout.num_shards) * R] = True
    clip[np.arange(layout.num_shards) * R + R - 1] = True
    spread = np.zeros(layout.total_rows, bool)
    for b in case["batches"]:
        g = (b["idx"] + layout.row_offsets[None, :, None]).reshape(-1)
        key = np.arange(g.size) % R
        for s in range(layout.num_shards):
            spread[s * R + key[g // R != s]] = True
    return clip & ~touched, spread & ~touched


@pytest.mark.parametrize("name", ROW_STATEFUL)
def test_rows_only_masked_lookups_reach_keep_weights_and_state(runs, name):
    """State is touched only for rows that receive a valid lookup (the
    contract of both packages).  At N shards each shard's update stream also
    carries the other shards' lookups with ``msk = 0``: the reference clips
    them to rows 0 and R - 1 of the shard, the port spreads them over its
    rows.  Rows that only such lookups reach keep every slab (weights,
    ``mom``, ``acc``, ``cnt``) bit for bit, in both packages."""
    got, want, _ = runs
    case, ranks = got[name]
    clip, spread = _masked_only(case)
    assert spread.sum() > 100 and clip.any()
    start, mine, ref = case["start"], ranks[0]["state"], want[name]["state"]
    for k in start["emb"]:
        for rows in (clip, spread):
            np.testing.assert_array_equal(_bits(mine["emb"][k])[rows], _bits(start["emb"][k])[rows])
            np.testing.assert_array_equal(_bits(ref["emb"][k])[rows], _bits(start["emb"][k])[rows])


@pytest.mark.parametrize("name", NAMES)
def test_eval_step_matches_reference(runs, name):
    """The multi-rank eval step from the start state: each rank scores its
    B / ranks samples, in the reference's device-major order; compared as
    logits (a random model's scores sit near 0.5)."""
    got, want, _ = runs
    case, ranks = got[name]
    mine = np.concatenate([r["scores"] for r in ranks])
    ref = want[name]["scores"]
    assert mine.shape == ref.shape == (case["cfg"]["batch"],)

    def logit(s):
        s = s.astype(np.float64)
        return np.log(s / (1 - s))
    np.testing.assert_allclose(logit(mine), logit(ref), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("name", NAMES)
def test_state_hand_off_round_trips(runs, name):
    """``state_from_numpy`` cuts the global arrays into each rank's shard
    and ``state_to_numpy`` gathers them back, bit for bit."""
    got, _, _ = runs
    case, ranks = got[name]
    back, start = ranks[0]["back"], case["start"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(start)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_collective_bytes_match_bench_pipeline(runs):
    """One step of the configuration of ``benchmarks/bench_comm_model.py``'s
    measured leg (8 ranks, mesh (1, 8), table mode, replicated stream, batch
    64, fp32 wire) moves, per rank, the result bytes that
    ``BENCH_pipeline.json`` ``points[0].collective_bytes`` counts in the
    reference's compiled HLO: all-to-all, reduce-scatter and all-reduce
    exactly; the all-gathers less 4 x 1656 x 2 bytes, because XLA's CPU
    pipeline widens the bucketed bf16 ``hi`` all-gather to fp32 before the
    collective (``f32[1656]`` in its HLO), where the port moves bf16."""
    import json
    _, _, bench = runs
    want = json.loads((ROOT / "BENCH_pipeline.json").read_text())["points"][0]["collective_bytes"]
    got = bench[0]["bytes_out"]
    assert got["all-to-all"] == want["all-to-all"] == 8192
    assert got["reduce-scatter"] == want["reduce-scatter"] == 3312
    assert got["all-reduce"] == want["all-reduce"] == 4
    assert got["all-gather"] == want["all-gather"] - 4 * 1656 * 2 == 18624


def test_bf16_wire_collective_bytes_match_bench_pipeline(runs):
    """The same step on the ``bf16`` wires against ``BENCH_pipeline.json``
    ``wire.bf16.collective_bytes``: the all-to-alls exactly (the forward's
    fp32 payload and the cotangent's halved); the all-gathers less the
    bucketed ``hi`` all-gather's widening (as on the fp32 wire); the dense
    reduce-scatter half of the reference's count, because XLA's CPU
    pipeline carries the bf16 payload as fp32 (``repro/dist/exchange.py``)
    where the port moves bf16."""
    import json
    _, _, bench = runs
    want = json.loads((ROOT / "BENCH_pipeline.json").read_text())["wire"]["bf16"]
    got = bench[1]["bytes_out"]
    assert got["all-to-all"] == want["collective_bytes"]["all-to-all"] == 6144
    assert got["all-gather"] == want["collective_bytes"]["all-gather"] - 4 * 1656 * 2 == 16576
    assert got["reduce-scatter"] == want["collective_bytes"]["reduce-scatter"] // 2 == 1656
    assert got["all-reduce"] == want["collective_bytes"]["all-reduce"] == 4
    fp32 = bench[0]["bytes_out"]
    assert fp32["all-to-all"] - got["all-to-all"] == 2048 and want["wire_reduction_x"] == 2.0


def test_cache_multirank_bitwise_and_hotset_identity(runs):
    """The reference's multi-rank cache case on (2, 4), 8 gloo ranks: with
    the cache the losses and every slab of the store (the counts aside) bit
    for bit the cold run's; every rank holds the same ``hot_ids``,
    ``hot_w`` and ``hot_pos``, which has members; the cache subtree and the
    counts bit for bit the reference's."""
    got, want, _ = runs
    (_, cold), (_, hot) = got["2x4-cache-cold"], got["2x4-cache-hot8"]
    assert hot[0]["losses"] == cold[0]["losses"]
    for k, v in cold[0]["state"]["emb"].items():
        np.testing.assert_array_equal(_bits(hot[0]["state"]["emb"][k]), _bits(v))
    for k in ("hot_ids", "hot_w", "hot_pos", "tick"):
        for r in hot[1:]:
            np.testing.assert_array_equal(r["cache"][k], hot[0]["cache"][k])
    assert (hot[0]["cache"]["hot_ids"] >= 0).sum() > 0 and int(hot[0]["cache"]["tick"]) == 4
    ref = want["2x4-cache-hot8"]["state"]
    for k in ("hot_ids", "hot_pos", "tick"):
        np.testing.assert_array_equal(hot[0]["state"]["cache"][k], ref["cache"][k])
    np.testing.assert_array_equal(hot[0]["state"]["emb"]["cnt"], ref["emb"]["cnt"])


def test_cache_collective_bytes_match_bench_pipeline(runs):
    """The cache's extra collective bytes a rank, one step of the cache leg
    of ``benchmarks/bench_comm_model.py`` (8 ranks on (1, 8), the sharded
    stream, batch 64): the promotion's all-gather of the counts (16,064
    rows of int32) and the refresh's int32 all-reduce of the mirror (512 x
    16), as ``BENCH_pipeline.json`` ``cache.hot64`` less ``hot0`` counts
    them in the reference's compiled HLO: +64,256 and +32,768 bytes, and
    nothing else."""
    import json
    _, _, bench = runs
    cache = json.loads((ROOT / "BENCH_pipeline.json").read_text())["cache"]
    cold, hot = bench[2]["bytes_out"], bench[3]["bytes_out"]
    want = {k: cache["hot64"]["collective_bytes"].get(k, 0)
            - cache["hot0"]["collective_bytes"].get(k, 0) for k in cold}
    got = {k: hot[k] - cold[k] for k in cold}
    assert got == want == {"all-gather": 64256, "all-to-all": 0, "reduce-scatter": 0,
                           "all-reduce": 32768, "collective-permute": 0}
