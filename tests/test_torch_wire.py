"""The ``bf16`` and ``bf16_sr`` wires of the hybrid step's collectives and
the dense error feedback, against the reference's, on the CPU.

The dither (``optim.stochastic.wire_noise``) is held to
``repro.optim.stochastic`` bit for bit; the wire payloads of the cotangent
exchange and the dense Split-SGD step at (2, 2) to the reference's
``gather_dY`` and ``rs_ag_split_sgd`` under ``shard_map`` bit for bit; the
train step with each wire, row and table mode, at (1, 1) and (2, 2), to the
reference's step with the tolerances of ``tests/test_torch_hybrid.py``
(``_torch_cases.hold_state``: row mode with Split-SGD bit for bit after the
first step), the ``err`` slab included.  The reference runs in one
subprocess with 4 forced XLA devices, the port in one process group of 4
gloo ranks, the two at once.  The checkpoint cases run at one rank in this
process: either package restores the other's checkpoint of a ``bf16`` run
with error feedback, ``err`` included, bit for bit, and a run resumed from a
``bf16_sr`` checkpoint replays the wire's dither.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.dist import exchange as j_ex
from repro.launch.mesh import make_mesh
from repro.optim import stochastic as j_sto
from repro_torch import checkpoint as t_ckpt
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.dist import exchange as t_ex
from repro_torch.launch.local import run_ranks
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import stochastic as t_sto
from _torch_cases import (SMALL, bits, case, cfg_of, hold_state, reference_results,
                          run_reference, same_bits, zipf_batches)
from _torch_ranks import option_cases_rank

WIRES = ("fp32", "bf16", "bf16_sr")
# (name, mesh, options): one step each (and a second, held to the tolerances);
# the error feedback's slab starts nonzero (a fresh run's is zero and stays so
# at M = 1: the dense gradients are bf16 values, which the wire keeps)
CASES = [(f"{m}x{n}-{mode}-{wire}", (m, n), {"emb_mode": mode, "exchange_dtype": wire})
         for (m, n) in [(1, 1), (2, 2)] for mode in ("row", "table")
         for wire in ("bf16", "bf16_sr")]
CASES += [("2x2-row-bf16-M2", (2, 2), {"exchange_dtype": "bf16", "microbatches": 2}),
          ("2x2-table-sharded-bf16_sr-M2", (2, 2), {"emb_mode": "table", "idx_input": "sharded",
                                                    "exchange_dtype": "bf16_sr",
                                                    "microbatches": 2, "sr_seed": -5})]
NAMES = [n for n, _, _ in CASES]

DENSE = {"n": 203, "nb": 2, "lr": 0.25, "seed": 77}
DY = {"B": 16, "seed": 9, "tag": 1}

UNITS_REF = """
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import sharded_embedding as se
from repro.core.embedding import EmbeddingSpec
from repro.optim import data_parallel as dp

inp = todo["inputs"]
mesh = make_mesh((2, 2), ("data", "model"))
allax = ("data", "model")
d = inp["dense"]
dense = {}
for wire, with_err in (("bf16", True), ("bf16_sr", False)):
    def one(hi, lo, err, g, wire=wire, with_err=with_err):
        st = dp.DPState(hi=hi, lo_shard=lo, mom_shard=None, err_shard=err if with_err else None)
        st2 = dp.rs_ag_split_sgd(st, {"w": g[0]}, d["lr"], allax, num_buckets=d["nb"],
                                 mean=False, wire_dtype=wire, error_feedback=True,
                                 seed=jnp.int32(d["seed"]))
        return st2.hi, st2.lo_shard, st2.err_shard if with_err else err
    f = jax.jit(compat.shard_map(one, mesh=mesh,
                                 in_specs=({"w": P()}, P(allax), P(allax), P(allax, None)),
                                 out_specs=({"w": P()}, P(allax), P(allax)), check_vma=False))
    hi, lo, err = f({"w": jnp.asarray(d["hi"]).view(jnp.bfloat16)}, jnp.asarray(d["lo"]),
                    jnp.asarray(d["err"]), jnp.asarray(d["g"]))
    dense[wire] = (np.asarray(hi["w"]).view(np.int16), np.asarray(lo), np.asarray(err))
out["dense"] = dense
g = inp["dY"]
dy = {}
for mode in ("row", "table"):
    layout = se.make_layout(EmbeddingSpec(tuple(g["rows"]), g["E"]), 4 if mode == "row" else 2,
                            mode)
    emb_ax, rep = (allax, None) if mode == "row" else ("model", ("data",))
    for wire in ("fp32", "bf16", "bf16_sr"):
        def gd(v, wire=wire, layout=layout, emb_ax=emb_ax, rep=rep):
            return se.gather_dY(layout, v, emb_ax, rep, wire_dtype=wire,
                                seed=jnp.int32(g["seed"]), tag=g["tag"])
        f = jax.jit(compat.shard_map(gd, mesh=mesh, in_specs=P(allax, None, None),
                                     out_specs=(P(None, None, None) if mode == "row"
                                                else P(None, "model", None)),
                                     check_vma=False))
        for what in ("values", "zeros", "exact"):
            dy[mode, wire, what] = np.asarray(f(jnp.asarray(g[what])), np.float32)
out["dY"] = dy
"""


def _unit_inputs() -> dict:
    rng = np.random.default_rng(4)
    n, nb = DENSE["n"], DENSE["nb"]
    params = {"w": torch.from_numpy(rng.standard_normal(n).astype(np.float32))}
    arrays = t_dp.dp_global_arrays(params, 4, nb, error_feedback=True)
    padded = arrays["lo"].numel()
    hi = t_dp.flat_hi(arrays["hi"], padded)[:n]
    S, E = len(SMALL["table_rows"]), SMALL["emb_dim"]
    shape = (DY["B"], S, E)
    return {"dense": {**DENSE, "hi": hi.view(torch.int16).numpy(),
                      "lo": arrays["lo"].numpy().view(np.uint16),
                      "err": (rng.standard_normal(padded) * 1e-2).astype(np.float32),
                      "g": rng.standard_normal((4, n)).astype(np.float32)},
            "dY": {**DY, "rows": SMALL["table_rows"], "E": E,
                   "values": rng.standard_normal(shape).astype(np.float32),
                   "zeros": np.zeros(shape, np.float32),
                   "exact": rng.integers(-8, 9, shape).astype(np.float32)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wire")
    cases = [case(n, m, o, 30 + i, err_scale=1e-2) for i, (n, m, o) in enumerate(CASES)]
    inputs = _unit_inputs()
    ref = run_reference(tmp, cases, UNITS_REF, inputs)
    try:
        port = run_ranks(option_cases_rank, 4, ((cases, inputs), "wire_units_rank"),
                         timeout_s=240, store_dir=str(tmp))
    finally:
        want = reference_results(tmp, ref)
    return cases, port[0]["cases"], want, [p["units"] for p in port]


@pytest.mark.parametrize("seed,tag,shape", [(0, 0, (7,)), (5, 0xDE100001, (3, 4, 5)),
                                            (-3, 2 ** 32 - 1, (2, 33)),
                                            (2 ** 31 - 1, 12345, (4, 2, 8))])
def test_wire_dither_is_the_reference_s(seed, tag, shape):
    """``wire_noise`` and ``sr_round_bf16_wire`` bit for bit
    ``repro.optim.stochastic``'s, and ``wire_encode`` / ``wire_decode``
    ``repro.dist.exchange``'s on every wire."""
    want = np.asarray(j_sto.wire_noise(jnp.int32(seed), jnp.uint32(tag), shape)).astype(np.int64)
    np.testing.assert_array_equal(t_sto.wire_noise(torch.tensor(seed, dtype=torch.int32), tag,
                                                    shape).numpy(), want)
    x = np.random.default_rng(seed % 7).standard_normal(shape).astype(np.float32) * 3
    for wire in WIRES:
        j = j_ex.wire_decode(j_ex.wire_encode(jnp.asarray(x), wire, jnp.int32(seed),
                                              jnp.uint32(tag)))
        t = t_ex.wire_decode(t_ex.wire_encode(torch.from_numpy(x), wire, seed, tag))
        np.testing.assert_array_equal(bits(t.numpy()), bits(np.asarray(j)))
    sr = t_sto.sr_round_bf16_wire(torch.from_numpy(x), seed, tag)
    assert sr.dtype == torch.bfloat16
    assert (sr.float().numpy() != x.astype(jnp.bfloat16).astype(np.float32)).any()


def test_exact_values_survive_every_wire():
    """The degeneration contract (the reference's
    ``test_wire_degenerations_bitwise``) at one rank: values bf16 holds
    (zeros, small integers) pass every wire's cotangent exchange bit for bit,
    and zero gradients leave the dense state (``hi``, ``lo``, ``err``)
    unchanged under every wire."""
    rng = np.random.default_rng(3)
    cfg = cfg_of(SMALL)
    for mode in ("row", "table"):
        layout = t_se.make_layout(cfg.spec, 1, mode)
        for x in (torch.zeros(8, 6, 16),
                  torch.from_numpy(rng.integers(-8, 9, (8, 6, 16)).astype(np.float32))):
            want = t_se.gather_dY(layout, x, wire_dtype="fp32").float()
            for wire in WIRES:
                got = t_se.gather_dY(layout, x, wire_dtype=wire, seed=5, tag=1).float()
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (mode, wire)
    params = {"w": torch.arange(64, dtype=torch.float32) / 7.0,
              "b": torch.ones(16) / 3.0}
    for wire, with_err in (("fp32", False), ("bf16", True), ("bf16", False), ("bf16_sr", False)):
        st = t_dp.init_dp_state(params, 1, 0, 2, with_err)
        hi0 = [t.clone() for t in t_dp.tree_leaves(st["hi"])]
        lo0 = st["lo"].clone()
        new = t_dp.rs_ag_split_sgd(st, t_dp.tree_map(torch.zeros_like, params), 0.1, 2,
                                   wire_dtype=wire, seed=3)
        for a, b in zip(t_dp.tree_leaves(new["hi"]), hi0):
            assert torch.equal(a, b)
        assert torch.equal(new["lo"], lo0)
        assert (new["err"] is None) == (not with_err)
        if with_err:
            assert bool((new["err"] == 0).all())


@pytest.mark.parametrize("wire", ["bf16", "bf16_sr"])
def test_dense_wire_is_the_reference_s_at_2x2(runs, wire):
    """``rs_ag_split_sgd`` at (2, 2), 2 buckets, fp32 gradients that bf16
    does not hold: ``bf16`` with the error feedback's slab (nonzero at the
    start), ``bf16_sr`` with its dither; every rank's ``hi``, ``lo`` and
    ``err`` bit for bit the reference's."""
    *_, want, units = runs
    hi, lo, err = want["dense"][wire]
    n = lo.size // 4
    for r, u in enumerate(units):
        mine = u["dense"][wire]
        np.testing.assert_array_equal(mine["hi"], hi)
        np.testing.assert_array_equal(mine["lo"].view(np.uint16), lo[r * n:(r + 1) * n])
        np.testing.assert_array_equal(bits(mine["err"]), bits(err[r * n:(r + 1) * n]))
    assert not (want["dense"]["bf16"][2] == 0).all()


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("wire", WIRES)
def test_cotangent_wire_is_the_reference_s_at_2x2(runs, mode, wire):
    """``gather_dY`` at (2, 2): every rank's cotangent in the update's
    layout bit for bit the reference's (row mode: the whole batch; table
    mode: its model shard's slots), the ``bf16_sr`` dither tagged by the
    microbatch and the sender's index over the replica axes, then the
    embedding axes; zeros and small integers the ``fp32`` wire's."""
    *_, want, units = runs
    K = None
    for r, u in enumerate(units):
        for what in ("values", "zeros", "exact"):
            ref = want["dY"][mode, wire, what]
            mine = u["dY"][mode, wire, what]
            if mode == "table":
                K = mine.shape[1]
                m = r % 2
                ref = ref[:, m * K:(m + 1) * K]
            np.testing.assert_array_equal(bits(mine), bits(ref))
            if what != "values":
                np.testing.assert_array_equal(bits(mine), bits(u["dY"][mode, "fp32", what]))
        narrow = mode == "table" and wire != "fp32"
        assert u["dtype"][mode, wire] == ("bfloat16" if narrow or mode == "row" else "float32")


@pytest.mark.parametrize("name", NAMES)
def test_step_matches_reference(runs, name):
    """Each wire's train step, the ``err`` slab included: the loss within
    1e-6 relative, the state as ``hold_state`` holds it (row mode bit for
    bit after the first step; the second starts from dense weights that the
    injected ``err`` moved, where the two frameworks' dense sums round apart
    in a last bit); the table-mode ``bf16`` wires move half the cotangent's
    bytes of the ``fp32`` one (checked against the sizes)."""
    cases, got, want, _ = runs
    i = NAMES.index(name)
    c = cases[i]
    np.testing.assert_allclose(got[i]["losses"], want["cases"][i]["losses"], rtol=1e-6, atol=0)
    row = c["cfg"].get("emb_mode", "row") == "row"
    for s, (mine, ref) in enumerate(zip(got[i]["states"], want["cases"][i]["states"])):
        hold_state({**c, "batches": c["batches"][:s + 1]}, mine, ref, bitwise=row and s == 0)
        assert int(mine.get("sr", 0)) == int(ref.get("sr", 0))
    cfg = cfg_of(c["cfg"])
    if not row and c["mesh"] == (2, 2) and cfg.idx_input == "replicated":
        # the cotangent's all-to-all: [B / 4, n_pad, E] at 2 bytes a value
        layout = t_se.make_layout(cfg.spec, 2, "table")
        a2a = got[i]["stats"][0]["bytes_in"]["all-to-all"]
        fwd = cfg.batch // 2 * layout.slots_per_shard * cfg.emb_dim * 4
        assert a2a - fwd == cfg.batch // 4 * layout.num_padded_slots * cfg.emb_dim * 2


def test_error_feedback_slab_is_live():
    """At M = 2 the dense gradient is a sum of microbatches that bf16 does
    not hold, so the ``bf16`` wire's residual is nonzero (held to the
    reference's in ``test_step_matches_reference[2x2-row-bf16-M2]``); the
    one-rank step keeps it in the state's ``err``."""
    cfg = cfg_of({**SMALL, "exchange_dtype": "bf16", "microbatches": 2})
    state = t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert state["dense"]["err"].dtype == torch.float32 and bool((state["dense"]["err"] == 0).all())
    step = t_dlrm.make_train_step(cfg, device="cpu")
    b = zipf_batches(cfg, (1, 1), 1, 2)[0]
    state, _ = step(state, {k: weights.to_torch(v) for k, v in b.items() if k != "orig"})
    assert bool((state["dense"]["err"] != 0).any())


def _ckpt_cfg(**over):
    kw = {**SMALL, **over}
    return j_dlrm.DLRMConfig(**{k: v for k, v in kw.items() if k != "exchange"},
                             exchange=j_ex.ExchangeConfig(**over["exchange"])
                             if "exchange" in over else None, fused_update=False), cfg_of(kw)


def _batch(cfg, seed):
    b = zipf_batches(cfg, (1, 1), 1, seed)[0]
    return {k: weights.to_torch(v) for k, v in b.items() if k != "orig"}


def test_err_slab_checkpoint_crosses_packages(tmp_path):
    """A ``bf16`` run with error feedback: the reference's checkpoint,
    ``err`` filled with seeded values, restores into the port bit for bit,
    and the port's into the reference (verification on)."""
    j_cfg, t_cfg = _ckpt_cfg(exchange={"dense_dtype": "bf16"})
    mesh = make_mesh((1, 1), ("data", "model"))
    state, _ = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    state_np = jax.tree.map(np.asarray, state)
    state_np["dense"]["err"] = (np.random.default_rng(7).standard_normal(
        state_np["dense"]["err"].shape) * 1e-2).astype(np.float32)
    j_state = jax.tree.map(jnp.asarray, state_np)
    j_ckpt.CheckpointManager(tmp_path / "jax").save(4, j_state, blocking=True)
    other = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(1), device="cpu")
    step, got = t_ckpt.CheckpointManager(tmp_path / "jax").restore(other, device="cpu")
    assert step == 4
    assert same_bits(weights.state_to_numpy(got), state_np)
    t_state = weights.state_from_numpy(state_np, t_cfg, device="cpu")
    t_ckpt.CheckpointManager(tmp_path / "torch").save(5, t_state, blocking=True)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j_state)
    step, back = j_ckpt.CheckpointManager(tmp_path / "torch").restore(like, verify=True)
    assert step == 5 and same_bits(jax.tree.map(np.asarray, back), state_np)


def test_err_slab_checkpoint_roundtrip(tmp_path):
    """Twin of the reference's test of that name: save -> restore -> three
    steps bit for bit three uninterrupted steps, the injected ``err``
    included, and the slab is live (a zeroed one gives another state)."""
    _, cfg = _ckpt_cfg(emb_mode="table", exchange={"dense_dtype": "bf16"})
    state = t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    inj = torch.from_numpy((np.random.default_rng(7).standard_normal(
        state["dense"]["err"].shape) * 1e-2).astype(np.float32))
    clean = weights.state_to(state, "cpu")
    state["dense"]["err"].copy_(inj)
    mgr = t_ckpt.CheckpointManager(tmp_path)
    mgr.save(0, state, blocking=True)
    step = t_dlrm.make_train_step(cfg, device="cpu")
    b = _batch(cfg, 3)
    straight = weights.state_to(state, "cpu")
    for _ in range(3):
        straight, loss_s = step(straight, b)
    _, resumed = mgr.restore(t_dlrm.init_state(cfg, torch.Generator().manual_seed(1),
                                               device="cpu"), device="cpu")
    assert torch.equal(resumed["dense"]["err"], inj)
    for _ in range(3):
        resumed, loss_r = step(resumed, b)
    assert float(loss_s) == float(loss_r)
    assert same_bits(weights.state_to_numpy(straight), weights.state_to_numpy(resumed))
    for _ in range(3):
        clean, _ = step(clean, b)
    assert not same_bits(weights.state_to_numpy(clean), weights.state_to_numpy(straight))


def test_bf16_sr_checkpoint_resume_replays_wire_dither(tmp_path):
    """Twin of the reference's test of that name: table mode, the sharded
    stream, ``bf16_sr``, M = 2; two steps, a checkpoint (``sr`` = 2), a
    restore and two more are bit for bit four uninterrupted steps, and
    another ``sr_seed`` gives another state (the dither is live)."""
    kw = {"emb_mode": "table", "idx_input": "sharded", "exchange_dtype": "bf16_sr",
          "microbatches": 2}
    _, cfg = _ckpt_cfg(**kw)
    b = _batch(cfg, 4)
    step = t_dlrm.make_train_step(cfg, device="cpu")
    start = t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    straight = weights.state_to(start, "cpu")
    for _ in range(4):
        straight, loss_s = step(straight, b)
    state = weights.state_to(start, "cpu")
    for _ in range(2):
        state, _ = step(state, b)
    assert int(state["sr"]) == 2
    mgr = t_ckpt.CheckpointManager(tmp_path)
    mgr.save(2, state, blocking=True)
    got_step, resumed = mgr.restore(t_dlrm.init_state(cfg, torch.Generator().manual_seed(1),
                                                      device="cpu"), device="cpu")
    assert got_step == 2 and int(resumed["sr"]) == 2
    for _ in range(2):
        resumed, loss_r = step(resumed, b)
    assert float(loss_s) == float(loss_r)
    assert int(resumed["sr"]) == int(straight["sr"]) == 4
    assert same_bits(weights.state_to_numpy(straight), weights.state_to_numpy(resumed))
    other_cfg = dataclasses.replace(cfg, sr_seed=11)
    other = weights.state_to(start, "cpu")
    other["sr"].fill_(11)
    other_step = t_dlrm.make_train_step(other_cfg, device="cpu")
    for _ in range(4):
        other, _ = other_step(other, b)
    assert not same_bits(weights.state_to_numpy(other)["emb"],
                         weights.state_to_numpy(straight)["emb"])
