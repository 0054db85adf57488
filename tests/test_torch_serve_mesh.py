"""Serving on a mesh, the synchronous server and dlrm-mlperf's widths: the
port against the JAX package on the CPU.

Snapshot scoring in row and table mode on (1, 2) and (2, 2) meshes: four
gloo ranks (``launch.local.run_ranks``; the (1, 2) cases on each pair of
ranks at once) beside one reference process with 4 forced XLA devices,
from one numpy start state (``tests/_torch_cases.py``).  On every rank the
snapshot step's scores are ``make_score_step``'s bit for bit; rank 0's
``BatchingServer`` over ``make_bucket_scorers``, its mesh's other ranks
following, serves the gathered scores bit for bit, and those are the
reference's ``make_snapshot_score_step`` within the multi-rank eval
tolerance of ``tests/test_torch_hybrid.py`` (logits rtol 1e-4, atol 2e-5).
Processes spawned: 4 ranks and 1 reference, once for the module.

Then the twins of the reference's ``BatchingServer`` tests, and a
dlrm-mlperf of the published widths (E 128, 26 tables, 13 dense features,
the same MLPs, the fused_mlp path) with its tables cut to at most 3,000
rows, served on one rank against the reference's snapshot step.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_paper as j_paper
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.launch.mesh import make_mesh
from repro.serve import snapshot as j_snapshot
from repro_torch import weights
from repro_torch.configs import dlrm_paper as t_paper
from repro_torch.launch.local import run_ranks
from repro_torch.serve import BatchingServer, make_bucket_scorers, snapshot_specs
from repro_torch.serve.snapshot import SlabShard
from repro_torch.testing import to_torch
from _torch_cases import SMALL, case, cfg_of, layout_of, reference_results, run_reference, \
    zipf_batches
from _torch_ranks import serve_mesh_rank

MESH_CASES = [(mesh, mode) for mesh in ((1, 2), (2, 2)) for mode in ("row", "table")]
BUCKET = 32

SCORE_REF = """
from repro.serve import snapshot as S
for c, o in zip(todo["cases"], out["cases"]):
    mesh = make_mesh(c["mesh"], ("data", "model"))
    cfg = ref_cfg(c["cfg"])
    mdef = dlrm.as_hybrid_def(cfg)
    _, shardings, _, _ = dlrm.make_train_step(cfg, mesh)
    state = jax.device_put(jax.tree.map(jnp.asarray, c["start"]), shardings)
    fn, snap_sh, bstructs, _ = S.make_snapshot_score_step(mdef, mesh, donate_batch=False)
    snap = jax.device_put(S.snapshot_state(mdef, state), snap_sh)
    o["scores"] = np.asarray(fn(snap, {k: jnp.asarray(c["score_batch"][k]) for k in bstructs}))
"""


def _mesh_case(mesh, mode: str, seed: int) -> dict:
    over = dict(emb_mode=mode, mlp_impl="pallas")
    c = case(f"{mode}-{mesh}", mesh, over, seed, steps=0)
    cfg = cfg_of(c["cfg"])
    b = zipf_batches(cfg, mesh, 1, seed + 100)[0]
    c["score_batch"] = {k: v for k, v in b.items() if k != "orig"}
    c["payloads"] = [{"idx": b["orig"]["idx"][i], "dense_x": b["dense_x"][i]}
                     for i in range(cfg.batch)]
    c["bucket"] = BUCKET
    return c


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    cases = [_mesh_case(m, mode, 40 + i) for i, (m, mode) in enumerate(MESH_CASES)]
    proc = run_reference(tmp, cases, SCORE_REF)
    try:
        port = run_ranks(serve_mesh_rank, 4, (cases,), timeout_s=300, store_dir=str(tmp))
    finally:
        ref = reference_results(tmp, proc)
    return cases, port, ref["cases"]


def _logit(s) -> np.ndarray:
    s = np.asarray(s, np.float64)
    return np.log(s) - np.log1p(-s)


@pytest.mark.parametrize("k", range(len(MESH_CASES)),
                         ids=[f"{m[0]}x{m[1]}-{mode}" for m, mode in MESH_CASES])
def test_mesh_snapshot_serving(mesh_runs, k):
    cases, port, ref = mesh_runs
    c = cases[k]
    assert all(r[k]["bitwise"] for r in port)  # the snapshot step is make_score_step's
    n = c["mesh"][0] * c["mesh"][1]
    leads = [r[k] for r in port if "served" in r[k]]
    assert len(leads) == 4 // n  # one serving rank a mesh
    assert all(r[k]["followed"] == 1 for r in port if "followed" in r[k])
    for lead in leads:
        np.testing.assert_array_equal(lead["served"], lead["gathered"])
        assert lead["served"].shape == (BUCKET,)
        np.testing.assert_allclose(_logit(lead["served"]), _logit(ref[k]["scores"]), rtol=1e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("mode", ["row", "table"])
def test_snapshot_specs_and_carried_shards(mode):
    """``snapshot_specs`` names this rank's rows of ``emb_w`` (the store's
    sharding) and nothing else as sharded; ``SlabShard.cut`` takes those
    rows of a global slab, which ``weights.snapshot_from_numpy`` does on a
    mesh (the (1, 1) mesh here: the whole slab)."""
    cfg = dataclasses.replace(cfg_of(SMALL), emb_mode=mode)
    specs = snapshot_specs(cfg)
    layout = layout_of(cfg, (1, 1))
    axes = ("data", "model") if mode == "row" else ("model",)
    assert specs == {"emb_w": SlabShard(axes, 0, 1, layout.rows_per_shard), "dense_hi": None}
    two = layout_of(cfg, (1, 2))
    glob = np.arange(two.total_rows * 2, dtype=np.float32).reshape(-1, 2)
    R = two.rows_per_shard
    np.testing.assert_array_equal(SlabShard(axes, 1, 2, R).cut(glob), glob[R:])
    snap = weights.snapshot_from_numpy(
        {"emb_w": np.ones((layout.total_rows, cfg.emb_dim), np.float32),
         "dense_hi": _dense_hi(cfg)}, cfg, device="cpu")
    assert tuple(snap["emb_w"].shape) == (layout.total_rows, cfg.emb_dim)


def _dense_hi(cfg) -> dict:
    from repro_torch.core.dlrm import init_dense_params
    from repro_torch.optim.data_parallel import tree_map
    return tree_map(lambda t: t.numpy(), init_dense_params(cfg, torch.Generator(), "cpu"))


# ------------------------------------------------- BatchingServer (sync) --

def test_batching_server_max_wait_is_not_dead():
    """The reference's regression for a dead parameter: a queue short of a
    batch waits for ``max_wait_ms``, so a straggler submitted from another
    thread 30 ms in still joins the chunk."""
    srv = BatchingServer(lambda b: np.zeros(4), batch_size=4,
                         pad_batch=lambda reqs: {"n": len(reqs)}, max_wait_ms=500.0)
    srv.submit("a")
    srv.submit("b")
    joined = threading.Timer(0.03, lambda: (srv.submit("c"), srv.submit("d")))
    joined.start()
    t0 = time.perf_counter()
    chunks = [len(reqs) for reqs, _ in srv.drain()]
    dt = time.perf_counter() - t0
    joined.join()
    assert chunks == [4]                    # one full chunk, no early flush
    assert dt < 0.45                        # returned at fill, not deadline
    assert srv.percentiles()["n"] == 4


def test_batching_server_flushes_partial_at_deadline():
    srv = BatchingServer(lambda b: np.zeros(4), batch_size=4,
                         pad_batch=lambda reqs: {"n": len(reqs)}, max_wait_ms=60.0)
    assert srv.percentiles() == {}
    srv.submit("only")
    t0 = time.perf_counter()
    chunks = [len(reqs) for reqs, _ in srv.drain()]
    dt = time.perf_counter() - t0
    assert chunks == [1]
    assert dt >= 0.055                      # held the partial to deadline


# ------------------------------------------------ dlrm-mlperf's widths --

MLPERF_ROWS = 3000
# the rows of the reference's initial state (U(-a, a), a = 1 / sqrt(mean rows), up to
# 0.023 here) times 16, exact in bf16: the bags then move a logit by up to 0.38, where
# at the init scale they move it by 6.8e-3, under what the bf16 layers allow
MLPERF_ROW_SCALE = 16.0
MLPERF_ATOL = 2e-3


def test_dlrm_mlperf_widths_served_against_reference():
    """dlrm-mlperf at its published widths, each table cut to at most
    3,000 rows, ``mlp_impl="pallas"`` (the reference's fused_mlp in
    interpret mode, the port's plain version), served on one rank through
    ``make_bucket_scorers`` over buckets 8 and 32 from the reference's
    initial state carried across, its rows scaled by ``MLPERF_ROW_SCALE``:
    the logits of 40 requests within 2e-3 of the reference's snapshot step,
    the scores in (0, 1).  What takes 2e-3: the top MLP's bf16 layers, 512
    wide, summed in fp32 in another order than XLA's, so that an output's
    bf16 rounding falls the other way now and then (6.1e-4 measured here).
    The control, every lookup moved to the next row of its table through
    the same scorers, is beyond 2e-3 on every request."""
    rows = tuple(min(r, MLPERF_ROWS) for r in t_paper.CRITEO_TB)
    t_cfg = dataclasses.replace(t_paper.dlrm_mlperf(batch=32), table_rows=rows, mlp_impl="pallas")
    j_cfg = dataclasses.replace(j_paper.dlrm_mlperf(batch=32), table_rows=rows, mlp_impl="pallas")
    assert (t_cfg.emb_dim, len(t_cfg.table_rows), t_cfg.num_dense, t_cfg.bottom, t_cfg.top) == (
        128, 26, 13, (512, 256, 128), (512, 512, 256))
    assert t_cfg.top_sizes == [479, 512, 512, 256, 1]
    mesh = make_mesh((1, 1), ("data", "model"))
    mdef = j_dlrm.as_hybrid_def(j_cfg)
    state, _ = j_hybrid.init_state(jax.random.PRNGKey(3), mdef, mesh)
    state_np = jax.tree.map(np.asarray, state)
    hi = state_np["emb"]["hi"]
    state_np["emb"]["hi"] = (hi.astype(np.float32) * MLPERF_ROW_SCALE).astype(hi.dtype)
    state = jax.tree.map(jnp.asarray, state_np)
    rng = np.random.default_rng(11)
    n = 40
    idx = np.stack([rng.integers(0, m, (n, 1)) for m in rows], axis=1).astype(np.int32)
    dense_x = np.asarray(jnp.asarray(rng.standard_normal((n, 13)), jnp.bfloat16))
    fn, _, _, _ = j_snapshot.make_snapshot_score_step(mdef, mesh, batch=n, donate_batch=False)
    want = np.asarray(fn(j_snapshot.snapshot_state(mdef, state),
                         {"idx": jnp.asarray(idx), "dense_x": jnp.asarray(dense_x),
                          "labels": jnp.zeros(n)}))
    snap = weights.state_to_snapshot(state_np, t_cfg, device="cpu")
    assert tuple(snap["emb_w"].shape) == (sum(-(-r // 8) * 8 for r in rows), 128)
    fns, pad = make_bucket_scorers(t_cfg, (8, 32), lambda: snap, device="cpu")

    def served(ids):
        payloads = [{"idx": ids[i], "dense_x": to_torch(dense_x[i]).float().numpy()}
                    for i in range(n)]
        return np.concatenate([fns[32](pad(payloads[:32], 32)), fns[8](pad(payloads[32:], 8))])
    got = served(idx)
    assert got.shape == (n,) and bool(((got > 0) & (got < 1)).all())
    np.testing.assert_allclose(_logit(got), _logit(want), rtol=0, atol=MLPERF_ATOL)
    moved = served((idx + 1) % np.asarray(rows)[None, :, None])
    assert bool((np.abs(_logit(moved) - _logit(want)) > MLPERF_ATOL).all())


def test_serve_recsys_twin_at_two_ranks(monkeypatch):
    """``examples/serve_recsys_torch.py --ranks 2 --device cpu`` (two gloo
    processes) to its end: 400 requests scored by rank 0's server with rank
    1 following every batch, and one top-16 of 16 distinct candidates that
    both ranks merged alike (the example's own assertions)."""
    import importlib
    from pathlib import Path
    # on the path, so that the spawned ranks import the example by name too
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "examples"))
    out = importlib.import_module("serve_recsys_torch").main(["--ranks", "2", "--device", "cpu"])
    assert out["percentiles"]["n"] == 400 and out["batches"] >= 400 // 64
