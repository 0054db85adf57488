"""The port's microbatched train step (M > 1) and its ring index exchange,
against the reference's, on the CPU.

The same numpy start state and global batches go through
``repro.core.dlrm.make_train_step`` (``microbatches=M``,
``fused_update=False``) in one subprocess with 4 forced XLA devices, and
through the port in one process group of 4 gloo ranks
(``_torch_ranks.option_cases_rank``), the two at once.  M in {2, 4}, row
and table mode, the replicated and the sharded index stream, at (2, 2),
and M = 4 at (1, 1).

Tolerances are those of the M = 1 cases of ``tests/test_torch_hybrid.py``
(``_torch_cases.hold_state``): row mode with Split-SGD bit for bit after
every step, table mode's fp32 cotangent within 1e-3 relative plus 1e-5
(it sums a row's duplicates in the sorted stream's order); the loss within
1e-6 relative.  The dense gradients accumulate as the reference's jitted
sum comes out (``core/pipeline.py``).  The ring exchange is held bit for bit
to the fused all-gather, at 2 and 4 ranks: as a collective, and as the
index exchange of whole train steps.
"""

import numpy as np
import pytest

from repro_torch.launch.local import run_ranks
from _torch_cases import case, hold_state, reference_results, run_reference, same_bits
from _torch_ranks import option_cases_rank

M_CASES = [(f"{m}x{n}-{mode}-{inp}-M{M}", (m, n), {"emb_mode": mode, "idx_input": inp,
                                                  "microbatches": M})
           for (m, n) in [(2, 2)] for mode in ("row", "table")
           for inp in ("replicated", "sharded") for M in (2, 4)]
M_CASES.append(("1x1-row-replicated-M4", (1, 1), {"microbatches": 4}))
# the ring exchange against the fused one: (name, mesh, options), each run both ways
RING_CASES = [("2x2-row-sharded-M2", (2, 2), {"idx_input": "sharded", "microbatches": 2}),
              ("2x2-table-sharded", (2, 2), {"emb_mode": "table", "idx_input": "sharded"}),
              ("2x2-table-replicated-weighted", (2, 2), {"emb_mode": "table", "weighted": True}),
              ("1x4-row-sharded", (1, 4), {"idx_input": "sharded"}),
              ("1x2-table-sharded-M2", (1, 2), {"emb_mode": "table", "idx_input": "sharded",
                                                "microbatches": 2})]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("microbatch")
    mcases = [case(n, m, o, 10 + i) for i, (n, m, o) in enumerate(M_CASES)]
    rcases = []
    for i, (n, m, o) in enumerate(RING_CASES):
        for impl in ("fused", "ring"):
            c = case(f"{n}-{impl}", m, {**o, "exchange": {"impl": impl}}, 50 + i)
            rcases.append(c)
    ref = run_reference(tmp, mcases)
    try:
        port = run_ranks(option_cases_rank, 4, ((mcases + rcases, RING_UNITS),
                                                   "ring_units_rank"), timeout_s=240,
                         store_dir=str(tmp))
    finally:
        want = reference_results(tmp, ref)
    got = port[0]["cases"]
    return (mcases, got[:len(mcases)], want["cases"], rcases, got[len(mcases):],
            [p["units"] for p in port])


# the ring as a collective: (mesh, axes, payload shape, dtype) on every rank
RING_UNITS = [((2, 2), ("data", "model"), (3, 2, 5), "int32"),
              ((2, 2), ("model",), (4, 3), "bfloat16"),
              ((2, 2), ("data",), (2, 7), "float32"),
              ((1, 4), ("data", "model"), (2, 3), "bfloat16"),
              ((1, 2), ("model",), (5,), "int32")]

NAMES = [n for n, _, _ in M_CASES]


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_reference(runs, name):
    mcases, got, want, *_ = runs
    i = NAMES.index(name)
    np.testing.assert_allclose(got[i]["losses"], want[i]["losses"], rtol=1e-6, atol=0)
    assert np.isfinite(got[i]["losses"]).all()


@pytest.mark.parametrize("name", NAMES)
def test_state_matches_reference(runs, name):
    """After each step; row mode with Split-SGD bit for bit."""
    mcases, got, want, *_ = runs
    i = NAMES.index(name)
    c = mcases[i]
    for s, (mine, ref) in enumerate(zip(got[i]["states"], want[i]["states"])):
        hold_state({**c, "batches": c["batches"][:s + 1]}, mine, ref,
                   bitwise=c["cfg"].get("emb_mode", "row") == "row")


@pytest.mark.parametrize("name", NAMES)
def test_m_layout_switches_and_one_dense_update_a_step(runs, name):
    """Each step switches the layout M times each way (row mode: the bag
    reduce-scatter and the cotangent all-gather; table mode: the two
    all-to-alls) and runs one dense update (the reduce-scatter once a
    bucket, 4 buckets) on the accumulated gradient."""
    mcases, got, *_ = runs
    i = NAMES.index(name)
    c = mcases[i]
    M, ranks = c["cfg"]["microbatches"], c["mesh"][0] * c["mesh"][1]
    for st in got[i]["stats"]:
        calls = st["calls"]
        if ranks == 1:  # one rank: the bags need no sum, the dense update is one flat pass
            assert calls["all-gather"] == M + 1 and calls["reduce-scatter"] == 1
            continue
        if c["cfg"].get("emb_mode", "row") == "row":
            assert calls["reduce-scatter"] == M + 4
        else:
            assert calls["all-to-all"] == 2 * M and calls["reduce-scatter"] == 4


@pytest.mark.parametrize("name", [n for n, _, _ in RING_CASES])
def test_ring_step_is_the_fused_step_bit_for_bit(runs, name):
    """The train step with the ring exchange: every loss and the state after
    every step bit for bit the fused exchange's; the ring moves the same
    bytes as shifts (``collective-permute``) where the fused step
    all-gathers them."""
    *_, rcases, rgot, _ = runs
    j = [n for n, _, _ in RING_CASES].index(name)
    fused, ring = rgot[2 * j], rgot[2 * j + 1]
    assert fused["losses"] == ring["losses"]
    for a, b in zip(fused["states"], ring["states"]):
        assert same_bits(a, b)
    f, r = fused["stats"][0], ring["stats"][0]
    assert f["calls"]["collective-permute"] == 0 and r["calls"]["collective-permute"] > 0
    moved = f["bytes_out"]["all-gather"] - r["bytes_out"]["all-gather"]
    assert moved > 0


@pytest.mark.parametrize("unit", range(len(RING_UNITS)))
def test_ring_all_gather_is_the_fused_all_gather(runs, unit):
    """``ring_all_gather`` over one axis or two, at 2 and 4 ranks, bit for
    bit ``comm.all_gather`` on every rank."""
    *_, units = runs
    for r, u in enumerate(units):
        ring, fused = u[unit]
        np.testing.assert_array_equal(ring, fused)
        assert ring.shape[0] > 0
