"""The port's collectives (``repro_torch.dist.comm``) at 4 gloo ranks,
against ``jax.lax``'s tiled collectives and a numpy model of them.

One process group of 4 ranks on a ``(2, 2)`` mesh over ``("data",
"model")`` runs every collective on seeded numpy operands
(``_torch_ranks.comm_cases_rank``); one subprocess with 4 forced XLA
CPU devices runs ``jax.lax.all_gather`` / ``all_to_all`` / ``psum_scatter``
/ ``psum`` and the reference's ``rs_ag_split_sgd`` in a jitted
``shard_map`` on the same operands.  Held bit for bit: data movement, the
bf16 and fp32 reduce-scatters (XLA's CPU reduce-scatter adds rank 0's block
first and each next rank's in fp32, rounding once), the loss psum, and the
bucketed dense Split-SGD step.  bf16 payloads cross gloo as uint8 views
(gloo refuses int16 and uint16).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.dist import comm
from repro_torch.launch.local import run_ranks
from repro_torch.optim.split_sgd import split_fp32
from _torch_ranks import comm_cases_rank

ROOT = Path(__file__).resolve().parents[1]
N = 4
LR = 0.1
NB = 4

XLA = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.optim import data_parallel as dp
inp = pickle.load(open(sys.argv[1], "rb"))
mesh = compat.make_mesh((2, 2), ("data", "model"))
ALL = ("data", "model")

def per_rank(fn, x):
    f = jax.jit(compat.shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=P(ALL),
                                 out_specs=P(ALL), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))

def bf(name):
    return jnp.asarray(inp[name]).view(jnp.bfloat16)

out = {
    "all_gather_model": per_rank(lambda v: jax.lax.all_gather(v, "model", axis=0, tiled=True),
                                 inp["ag_i32"]),
    "all_gather_all_bf16": per_rank(lambda v: jax.lax.all_gather(v, ALL, axis=0, tiled=True),
                                    bf("ag_bf16")),
    "all_gather_data": per_rank(lambda v: jax.lax.all_gather(v, "data", axis=0, tiled=True),
                                inp["ag_i32"]),
    "all_to_all_0_1": per_rank(lambda v: jax.lax.all_to_all(v, ALL, 0, 1, tiled=True),
                               inp["a2a_f32"]),
    "all_to_all_1_0_bf16": per_rank(lambda v: jax.lax.all_to_all(v, "model", 1, 0, tiled=True),
                                    bf("a2a_bf16")),
    "psum_scatter_all_bf16": per_rank(
        lambda v: jax.lax.psum_scatter(v, ALL, scatter_dimension=0, tiled=True), bf("rs_bf16")),
    "psum_scatter_all_f32": per_rank(
        lambda v: jax.lax.psum_scatter(v, ALL, scatter_dimension=0, tiled=True), inp["rs_f32"]),
    "psum_scatter_model_f32": per_rank(
        lambda v: jax.lax.psum_scatter(v, "model", scatter_dimension=0, tiled=True),
        inp["rs_f32"]),
    "psum_all": per_rank(lambda v: jax.lax.psum(v, ALL), inp["psum_f32"]),
    "psum_all_i32": per_rank(lambda v: jax.lax.psum(v, ALL), inp["psum_i32"]),
}
out = {k: (v.view(np.int16) if v.dtype.name == "bfloat16" else v) for k, v in out.items()}
d = inp["dense"]

def dense(hi, lo, g):
    st = dp.DPState(hi={"w": hi}, lo_shard=lo, mom_shard=None, err_shard=None)
    st2 = dp.rs_ag_split_sgd(st, {"w": g[0]}, d["lr"], ALL, num_buckets=d["num_buckets"],
                             mean=False)
    return st2.hi["w"], st2.lo_shard

f = jax.jit(compat.shard_map(dense, mesh=mesh, in_specs=(P(), P(ALL), P(ALL)),
                             out_specs=(P(), P(ALL)), check_vma=False))
hi, lo = f(jnp.asarray(d["hi"]).view(jnp.bfloat16), jnp.asarray(d["lo"]), jnp.asarray(d["g"]))
out["dense_hi"] = np.asarray(hi).view(np.int16)
out["dense_lo"] = np.asarray(lo)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).view(np.int16)


def _inputs() -> dict:
    rng = np.random.default_rng(0)

    def wide(shape):  # values over 16 binades, so a sum's order shows in its bits
        return (rng.standard_normal(shape) * np.exp(rng.uniform(-8, 8, shape))).astype(np.float32)

    n_real = 1001  # padded to 1008 = 4 ranks x 4 buckets x 63
    w = rng.standard_normal(n_real).astype(np.float32)
    hi, lo = split_fp32(torch.from_numpy(w))
    padded = -(-n_real // (N * NB)) * (N * NB)
    lo_flat = np.zeros(padded, np.int16)
    lo_flat[:n_real] = lo.numpy()
    bchunk = padded // (N * NB)
    lo_bucketed = lo_flat.reshape(NB, N, bchunk).transpose(1, 0, 2).reshape(-1)
    return {
        "ag_i32": rng.integers(-1000, 1000, (N, 2, 3)).astype(np.int32),
        "ag_bf16": _bf16_bits(rng.standard_normal((N, 2, 5))),
        "a2a_f32": wide((N, 4, 2, 3)),
        "a2a_bf16": _bf16_bits(rng.standard_normal((N, 2, 4, 3))),
        "rs_bf16": _bf16_bits(wide((N, 8, 64))),
        "rs_f32": wide((N, 8, 64)),
        "psum_f32": wide((N, 3)),
        # int32 past 2^24 (fp32's exact range), negatives and float bit patterns
        # with a single nonzero term (the hot-row cache's refresh) included
        "psum_i32": np.concatenate([
            rng.integers(-2 ** 28, 2 ** 28, (N, 6)),
            np.array([[0x3F800001, -0x40800001, 2 ** 24 + 1, 0]] + [[0, 0, 1, 0]] * (N - 1))],
            axis=1).astype(np.int32),
        "dense": {"hi": hi.view(torch.int16).numpy(), "lo": lo_bucketed.view(np.uint16),
                  "g": wide((N, n_real)) * 1e-3, "lr": LR, "num_buckets": NB},
        # table mode, 2 shards of 2 slots x 3 lookups: ids [2 rows] a rank in
        # its shard's padded slots, the cotangent of its data group's 4 rows
        "update": {"idx": rng.integers(0, 5, (N, 2, 2, 3)).astype(np.int32),
                   "wgt": rng.uniform(0.5, 1.5, (N, 2, 2, 3)).astype(np.float32),
                   "W": rng.standard_normal((2, 32, 4)).astype(np.float32),
                   "dY": rng.standard_normal((2, 4, 2, 4)).astype(np.float32)},
    }


def _numpy_model(inp: dict) -> dict:
    """jax.lax's tiled collectives over the (2, 2) mesh, in numpy: rank r
    sits at (r // 2, r % 2); a sum adds the group's blocks in group order in
    fp32 and rounds once."""
    def as_f32(name):
        v = inp[name]
        return v.view(ml_dtypes.bfloat16).astype(np.float32) if name.endswith("_bf16") else v

    groups = {"all": [[0, 1, 2, 3]] * 4, "model": [[0, 1], [0, 1], [2, 3], [2, 3]],
              "data": [[0, 2], [1, 3], [0, 2], [1, 3]]}

    def gather(x, g):
        return [np.concatenate([x[j] for j in groups[g][r]]) for r in range(N)]

    def a2a(x, g, split, concat):
        out = []
        for r in range(N):
            members = groups[g][r]
            pos = members.index(r)
            out.append(np.concatenate([np.split(x[j], len(members), axis=split)[pos]
                                       for j in members], axis=concat))
        return out

    def rs(x, g):
        out = []
        for r in range(N):
            members = groups[g][r]
            blocks = [np.split(x[j], len(members), axis=0)[members.index(r)] for j in members]
            acc = blocks[0].astype(np.float32)
            for b in blocks[1:]:
                acc = (acc + b).astype(np.float32)
            out.append(acc)
        return out

    def bits(v):
        return _bf16_bits(v)

    return {
        "all_gather_model": np.stack(gather(inp["ag_i32"], "model")),
        "all_gather_all_bf16": np.stack(gather(inp["ag_bf16"], "all")),
        "all_gather_data": np.stack(gather(inp["ag_i32"], "data")),
        "all_to_all_0_1": np.stack(a2a(inp["a2a_f32"], "all", 0, 1)),
        "all_to_all_1_0_bf16": np.stack(a2a(inp["a2a_bf16"], "model", 1, 0)),
        "psum_scatter_all_bf16": bits(np.stack(rs(as_f32("rs_bf16"), "all"))),
        "psum_scatter_all_f32": np.stack(rs(inp["rs_f32"], "all")),
        "psum_scatter_model_f32": np.stack(rs(inp["rs_f32"], "model")),
        "psum_all": np.stack([sum(inp["psum_f32"][1:], inp["psum_f32"][0].copy())] * N),
        "psum_all_i32": np.stack([inp["psum_i32"].astype(np.int64).sum(0).astype(np.int32)] * N),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    inp = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    xla = subprocess.Popen([sys.executable, "-c", textwrap.dedent(XLA), str(tmp / "in.pkl"),
                            str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = run_ranks(comm_cases_rank, N, (inp,), timeout_s=120, store_dir=str(tmp))
        _, err = xla.communicate(timeout=240)
    finally:
        if xla.poll() is None:
            xla.kill()
    assert xla.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    return inp, port, want


NAMES = ["all_gather_model", "all_gather_all_bf16", "all_gather_data", "all_to_all_0_1",
         "all_to_all_1_0_bf16", "psum_scatter_all_bf16", "psum_scatter_all_f32",
         "psum_scatter_model_f32", "psum_all", "psum_all_i32"]


@pytest.mark.parametrize("name", NAMES)
def test_collective_bitwise_to_jax_lax_and_its_numpy_model(runs, name):
    """Each rank's result equals ``jax.lax``'s on the same operands, and the
    numpy model's, bit for bit."""
    inp, port, want = runs
    got = np.stack([port[r][name] for r in range(N)])
    model = _numpy_model(inp)[name]
    assert got.shape == want[name].shape == model.shape
    np.testing.assert_array_equal(got.view(np.int32) if got.dtype == np.float32 else got,
                                  want[name].view(np.int32) if want[name].dtype == np.float32
                                  else want[name])
    np.testing.assert_array_equal(model.view(np.int32) if model.dtype == np.float32 else model,
                                  want[name].view(np.int32) if want[name].dtype == np.float32
                                  else want[name])


def test_integer_psum_is_exact_where_fp32_is_not(runs):
    """The int32 sum is exact: the same operands summed in fp32 would lose
    bits (so the bitwise check above tests the integer path); at one rank
    with no process group the psum is the operand."""
    inp, port, _ = runs
    x = inp["psum_i32"]
    f32 = x.astype(np.float32).sum(0, dtype=np.float32).astype(np.int64)
    assert (f32 != x.astype(np.int64).sum(0)).any()
    assert port[0]["psum_all_i32"][6] == 0x3F800001 and port[0]["psum_all_i32"][8] == 2 ** 24 + 4
    t = torch.from_numpy(x[0].copy())
    assert comm.psum(t, comm.local_group()) is t


def test_reduce_scatter_order_shows_in_the_bits(runs):
    """The operands are wide enough that another summation order (the
    reverse) gives other bits: the bitwise checks above do test the order."""
    inp, _, want = runs
    x = inp["rs_f32"]
    rev = [np.split(x[j], N, axis=0)[0] for j in reversed(range(N))]
    acc = rev[0].copy()
    for b in rev[1:]:
        acc = (acc + b).astype(np.float32)
    assert (acc.view(np.int32) != want["psum_scatter_all_f32"][0].view(np.int32)).any()


def test_dense_split_sgd_step_bitwise_to_reference(runs):
    """``rs_ag_split_sgd`` over 4 ranks (the fp32 bucketed reduce-scatter,
    the Split-SGD step on each rank's chunk, the bf16 all-gather into the
    flat ``hi``) equals the reference's jitted ``rs_ag_split_sgd`` in
    ``shard_map``, ``mean=False``: every rank's ``hi`` and its ``lo``
    shard, bit for bit."""
    inp, port, want = runs
    for r in range(N):
        np.testing.assert_array_equal(port[r]["dense_hi"], want["dense_hi"])
    np.testing.assert_array_equal(np.concatenate([port[r]["dense_lo"] for r in range(N)]),
                                  want["dense_lo"].view(np.int16))
    assert (want["dense_hi"] != inp["dense"]["hi"]).any()


def test_table_update_gathers_replica_ids_and_weights(runs):
    """``apply_update`` in table mode with ``replica_group`` all-gathers the
    replicas' ids and weights, as the reference's does: the same store bit
    for bit as the update on ids and weights gathered beforehand."""
    _, port, _ = runs
    for r in range(N):
        np.testing.assert_array_equal(port[r]["replica_update"].view(np.int32),
                                      port[r]["replica_update_want"].view(np.int32))


def test_exchange_config_and_wire_tag_match_reference():
    """``resolve_exchange`` reads a config's ``exchange`` and
    ``exchange_dtype`` as the reference's does, and ``wire_tag`` mixes the
    same bits."""
    import dataclasses
    import warnings

    from repro.dist import exchange as j_ex
    from repro_torch.dist import exchange as t_ex

    @dataclasses.dataclass
    class Cfg:
        exchange: object = None
        exchange_dtype: object = None

    typed = {"num_buckets": 2, "dense_dtype": "bf16", "error_feedback": False}
    for kw in ({}, {"exchange_dtype": "fp32"}, {"exchange_dtype": "bf16"},
               {"exchange_dtype": "bf16_sr"}, {"exchange": typed}, {"exchange": {"impl": "ring"}}):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = t_ex.resolve_exchange(Cfg(**{k: t_ex.ExchangeConfig(**v) if k == "exchange"
                                             else v for k, v in kw.items()}))
            j = j_ex.resolve_exchange(Cfg(**{k: j_ex.ExchangeConfig(**v) if k == "exchange"
                                             else v for k, v in kw.items()}))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.needs_sr, t.needs_err) == (j.needs_sr, j.needs_err)
    with pytest.raises(ValueError, match="not both"):
        t_ex.resolve_exchange(Cfg(exchange=t_ex.ExchangeConfig(), exchange_dtype="fp32"))
    with pytest.raises(TypeError, match="ExchangeConfig"):
        t_ex.resolve_exchange(Cfg(exchange={"dY_dtype": "fp32"}))
    assert t_ex.WIRE_ITEMSIZE == j_ex.WIRE_ITEMSIZE
    for base in (t_ex.TAG_DY, t_ex.TAG_DENSE):
        for site in range(4):
            for rank in (0, 1, 7, 255):
                assert t_ex.wire_tag(base, site, rank) == int(j_ex.wire_tag(base, site, rank))


def test_byte_counters(runs):
    """Each kind counts its operands' bytes in and its results' bytes out:
    a tiled all-gather returns the group's blocks, a reduce-scatter one of
    them, an all-to-all as many bytes as it takes."""
    inp, port, _ = runs
    nbytes = {k: v[0].nbytes for k, v in inp.items() if k not in ("dense", "update")}
    stats = port[0]["stats"]
    assert stats["calls"] == {"all-gather": 3, "all-to-all": 2, "reduce-scatter": 3,
                              "all-reduce": 1, "collective-permute": 0}
    assert stats["bytes_in"]["all-gather"] == 2 * nbytes["ag_i32"] + nbytes["ag_bf16"]
    assert stats["bytes_out"]["all-gather"] == 2 * 2 * nbytes["ag_i32"] + 4 * nbytes["ag_bf16"]
    assert stats["bytes_in"]["all-to-all"] == stats["bytes_out"]["all-to-all"] \
        == nbytes["a2a_f32"] + nbytes["a2a_bf16"]
    assert stats["bytes_in"]["reduce-scatter"] == nbytes["rs_bf16"] + 2 * nbytes["rs_f32"]
    assert stats["bytes_out"]["reduce-scatter"] == \
        nbytes["rs_bf16"] // 4 + nbytes["rs_f32"] // 4 + nbytes["rs_f32"] // 2
    assert stats["bytes_in"]["all-reduce"] == stats["bytes_out"]["all-reduce"] == 12
    assert stats["staging_s"] == stats["wire_s"] == 0.0  # CPU tensors: nothing staged


def test_16_bit_payloads_cross_as_uint8():
    """bf16 and int16 payloads are handed to the backend as uint8 views of
    their bytes (gloo refuses int16 and uint16); 32-bit ones as they are."""
    for dt in (torch.bfloat16, torch.int16):
        t = torch.arange(6, dtype=torch.float32).to(dt).reshape(2, 3)
        b = comm._bytes(t)
        assert b.dtype == torch.uint8 and b.numel() == 12 and b.data_ptr() == t.data_ptr()
    t = torch.zeros(2, 3, dtype=torch.int32)
    assert comm._bytes(t).dtype == torch.int32


def test_one_rank_group_is_the_identity_and_counts():
    """A group of one rank with no process group returns its operand (no
    copy) from every collective, and counts it."""
    stats = comm.CollectiveStats()
    g = comm.Group(("model",), 1, 0, None, stats)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    for fn in (lambda: comm.all_gather(x, g), lambda: comm.all_to_all(x, g, 0, 1),
               lambda: comm.psum_scatter(x, g), lambda: comm.psum(x, g),
               lambda: comm.ppermute(x, g)):
        assert fn() is x
    assert stats.calls == dict.fromkeys(comm.KINDS, 1)
    assert stats.bytes_out["reduce-scatter"] == 48
