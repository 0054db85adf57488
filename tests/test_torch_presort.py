"""The host pre-sort of the sparse update's stream (``host_presort``)
against the reference's, on the CPU.

``data.pipeline.presort_batch`` is held to the reference's
``repro.data.pipeline.presort_batch`` (bit for bit at one shard; at more,
on the lookups each shard owns, in order: the port keys another shard's
lookups by flat index modulo the shard's rows where the reference keys them
past the last row) and to the port's own device sort, bit for bit.  The
presorted train step is held to the reference's presorted step (one
subprocess with 4 forced XLA devices, its row kernel the interpret-mode
Pallas kernel) with the tolerances of ``tests/test_torch_hybrid.py``
(``_torch_cases.hold_state``: row mode with Split-SGD bit for bit), and to
the port's device-sorted step bit for bit, in one process group of 4 gloo
ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import sharded_embedding as j_se
from repro.data.pipeline import PSORT_KEYS as J_KEYS
from repro.data.pipeline import presort_batch as j_presort
from repro_torch.core import hybrid as t_hybrid
from repro_torch.core import sharded_embedding as t_se
from repro_torch.data.pipeline import PSORT_KEYS, HostPipeline, presort_batch
from repro_torch.dist import comm
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import Mesh, group_axes
from _torch_cases import (SMALL, case, cfg_of, hold_state, layout_of, reference_results,
                          run_reference, same_bits, zipf_batches)
from _torch_ranks import option_cases_rank

# (name, mesh, options): each run with host_presort by both packages, and by the
# port with its device sort too
CASES = [("1x1-row-split_sgd", (1, 1), {}),
         ("1x1-table-momentum_bf16-weighted", (1, 1),
          {"emb_mode": "table", "sparse_optimizer": "momentum_bf16", "weighted": True}),
         ("2x2-row-split_sgd", (2, 2), {}),
         ("2x2-row-sharded-split_sgd", (2, 2), {"idx_input": "sharded"}),
         ("2x2-table-split_sgd", (2, 2), {"emb_mode": "table"}),
         ("2x2-table-sharded-split_sgd", (2, 2), {"emb_mode": "table", "idx_input": "sharded"}),
         ("2x2-row-momentum_bf16-weighted", (2, 2),
          {"sparse_optimizer": "momentum_bf16", "weighted": True, "sr_seed": 2 ** 31 - 2}),
         ("2x2-table-weighted-M2", (2, 2), {"emb_mode": "table", "weighted": True,
                                            "microbatches": 2})]
NAMES = [n for n, _, _ in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("presort")
    pre = [case(n, m, {**o, "host_presort": True}, 20 + i) for i, (n, m, o) in enumerate(CASES)]
    dev = [dict(c, cfg={**c["cfg"], "host_presort": False},
                batches=[{k: v for k, v in b.items() if k not in PSORT_KEYS}
                         for b in c["batches"]]) for c in pre]
    for c in dev:
        c.pop("ref_batches")
    ref = run_reference(tmp, pre)
    try:
        port = run_ranks(option_cases_rank, 4, ((pre + dev, None), ""), timeout_s=240,
                         store_dir=str(tmp))
    finally:
        want = reference_results(tmp, ref)
    got = port[0]["cases"]
    return pre, got[:len(pre)], got[len(pre):], want["cases"]


def _streams(name_mode, shards, weighted, seed=3):
    kw = {**SMALL, "emb_mode": name_mode, "weighted": weighted}
    cfg = cfg_of(kw)
    mesh = (1, shards)  # row mode shards over the mesh, table mode over its model axis
    b = zipf_batches(cfg, mesh, 1, seed)[0]["orig"]
    t_layout = layout_of(cfg, mesh)
    j_layout = j_se.make_layout(cfg.spec, shards, name_mode)
    return (presort_batch(t_layout, b["idx"], b.get("weights")),
            j_presort(j_layout, b["idx"], b.get("weights")), t_layout, b)


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("weighted", [False, True])
def test_presort_batch_is_the_reference_at_one_shard(mode, weighted):
    mine, ref, layout, _ = _streams(mode, 1, weighted)
    assert PSORT_KEYS == J_KEYS
    for k in PSORT_KEYS:
        assert mine[k].dtype == ref[k].dtype and mine[k].shape == ref[k].shape
        np.testing.assert_array_equal(mine[k], ref[k])
    L = mine["psort_rows"].shape[1]
    assert L == 32 * (6 if mode == "row" else layout.slots_per_shard) * 3


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_presort_batch_owned_lookups_are_the_reference_in_order(mode, mesh):
    """At N shards each shard's ``msk = 1`` entries, in order, are the
    reference's bit for bit (rows, bags, weights); the masked ones differ
    only in where they sit."""
    ns = mesh[1] if mode == "table" else mesh[0] * mesh[1]
    mine, ref, layout, _ = _streams(mode, ns, True, seed=ns)
    assert mine["psort_rows"].shape == ref["psort_rows"].shape == (ns, mine["psort_rows"].shape[1])
    for s in range(ns):
        a, b = mine["psort_msk"][s] == 1, ref["psort_msk"][s] == 1
        assert a.sum() == b.sum() > 0
        for k in ("psort_rows", "psort_bags", "psort_wgt"):
            np.testing.assert_array_equal(mine[k][s][a], ref[k][s][b])
        assert (mine["psort_rows"][s] < layout.rows_per_shard).all()
        assert (mine["psort_rows"][s] >= 0).all()


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_presort_batch_is_the_device_sort(mode, shards):
    """Each shard's presorted stream bit for bit the stream the step sorts
    from the update side of its index exchange (row mode: the batch's ids
    at the shard's offsets; table mode: padded-slot order, dummy slots id 0
    and weight 0, the shard's slots), weights in."""
    mine, _, layout, b = _streams(mode, shards, True, seed=10 + shards)
    idx, wgt = torch.from_numpy(b["idx"]), torch.from_numpy(b["weights"])
    K = layout.slots_per_shard
    if mode == "table":
        idx, wgt = (t_se.permute_indices(layout, t) for t in (idx, wgt))
    for s in range(shards):
        ids, w = (idx, wgt) if mode == "row" else (idx[:, s * K:(s + 1) * K],
                                                   wgt[:, s * K:(s + 1) * K])
        local = ids + torch.as_tensor(t_se.local_offsets(layout, s),
                                      dtype=torch.int32)[None, :, None]
        want = t_se._row_sorted_streams(layout, local.reshape(-1), 3, w.reshape(-1), s)
        for k, t in zip(PSORT_KEYS, want):
            np.testing.assert_array_equal(mine[k][s], t.numpy())


def _fake_mesh(shape, rank):
    """A mesh of ``shape`` at ``rank`` whose groups know their sizes and
    indices and have no process group (enough for ``local_batch``)."""
    axes = ("data", "model")
    named = dict(zip(axes, shape))
    coords = dict(zip(axes, np.unravel_index(rank, shape)))
    stats = comm.CollectiveStats()
    groups = {t: comm.Group(t, int(np.prod([named[a] for a in t])),
                            comm.combined_axis_index(coords, t, named), None, stats)
              for t in group_axes(axes)}
    return Mesh(shape=named, device=torch.device("cpu"), rank=rank, groups=groups, stats=stats)


@pytest.mark.parametrize("mode", ["row", "table"])
def test_local_batch_cuts_the_presort_to_the_rank_s_shard(mode):
    """At (2, 2) a rank takes row k of each ``psort_*`` field, k its index
    on the embedding axes: in table mode its model coordinate, the two
    replicas of a shard the same row; in row mode its rank."""
    cfg = dataclasses.replace(cfg_of({**SMALL, "emb_mode": mode}), host_presort=True)
    layout = layout_of(cfg, (2, 2))
    b = zipf_batches(cfg, (2, 2), 1, 5)[0]
    fields = presort_batch(layout, b["orig"]["idx"])
    batch = {k: torch.from_numpy(v) for k, v in {**fields, "idx": b["idx"],
                                                 "labels": b["labels"]}.items()}
    for r in range(4):
        mesh = _fake_mesh((2, 2), r)
        got = t_hybrid.local_batch(cfg, mesh, batch)
        k = r % 2 if mode == "table" else r
        for key in PSORT_KEYS:
            assert tuple(got[key].shape) == (1, fields[key].shape[1])
            np.testing.assert_array_equal(got[key].numpy(), fields[key][k:k + 1])
        assert got["labels"].shape[0] == 8


def test_host_pipeline_attaches_the_presort():
    cfg = cfg_of({**SMALL, "emb_mode": "table", "weighted": True})
    layout = layout_of(cfg, (1, 2))
    src = [{k: v for k, v in b.items() if k != "orig"} | {"idx": b["orig"]["idx"]}
           for b in zipf_batches(cfg, (1, 2), 3, 9)]
    pipe = HostPipeline(iter(src), layout=layout, presort=True)
    got = list(pipe)
    assert len(got) == 3 and pipe.stats["batches"] == 3
    for g, b in zip(got, src):
        want = presort_batch(layout, b["idx"], b["weights"])
        for k in PSORT_KEYS:
            np.testing.assert_array_equal(g[k], want[k])
        np.testing.assert_array_equal(g["idx"], b["idx"])
    with pytest.raises(ValueError, match="layout"):
        HostPipeline(iter(src), presort=True)
    plain = list(HostPipeline(iter(src)))
    assert not any(k in plain[0] for k in PSORT_KEYS)


@pytest.mark.parametrize("name", NAMES)
def test_presorted_step_matches_reference(runs, name):
    pre, got, _, want = runs
    i = NAMES.index(name)
    np.testing.assert_allclose(got[i]["losses"], want[i]["losses"], rtol=1e-6, atol=0)
    c = pre[i]
    bitwise = c["cfg"].get("emb_mode", "row") == "row" and \
        c["cfg"].get("sparse_optimizer") is None
    for s, (mine, ref) in enumerate(zip(got[i]["states"], want[i]["states"])):
        hold_state({**c, "batches": c["batches"][:s + 1]}, mine, ref, bitwise=bitwise)


@pytest.mark.parametrize("name", NAMES)
def test_presorted_step_is_the_device_sorted_step(runs, name):
    """Losses and the state after each step bit for bit the port's
    device-sorted step's; the presorted step's collectives move the same
    bytes less the update side of the index exchange, which it skips (table
    mode with the replicated stream: the replicas' all-gather of the ids,
    and of the weights)."""
    pre, got, dev, _ = runs
    i = NAMES.index(name)
    assert got[i]["losses"] == dev[i]["losses"]
    for a, b in zip(got[i]["states"], dev[i]["states"]):
        assert same_bits(a, b)
    c = pre[i]
    cfg = cfg_of(c["cfg"])
    skipped = 0
    if cfg.emb_mode == "table" and cfg.idx_input == "replicated":
        # int32 ids (and fp32 weights) [B, K, P] gathered over the replicas
        # (at one rank too: its collectives are counted)
        K = layout_of(cfg, c["mesh"]).slots_per_shard
        skipped = cfg.batch * K * cfg.pooling * 4 * (2 if cfg.weighted else 1)
    for p, d in zip(got[i]["stats"], dev[i]["stats"]):
        assert d["bytes_out"]["all-gather"] - p["bytes_out"]["all-gather"] == skipped
        for kind in ("all-to-all", "reduce-scatter", "all-reduce"):
            assert p["bytes_out"][kind] == d["bytes_out"][kind]
