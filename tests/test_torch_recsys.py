"""The four recsys archetypes (FM, BST, SASRec, DIN) of the port against the
JAX package, on the CPU, at the sizes of the reference's own smoke test
(``tests/test_models.py::test_recsys_smoke``: B 16; FM ``(50,) * 39``; BST
``100, (20,) * 8``; SASRec ``100``; DIN ``100, (20,) * 4``).

The reference initialises the state (``repro.core.hybrid.init_state``), the
port takes its numpy arrays through ``weights.state_from_numpy``, and both
get the same seeded numpy batches (labels, a random ``seq_mask`` and
``hist_mask``).  Held here: the dense scorer and loss on one bag output, one
(1, 1) train step (loss, dense ``hi`` / ``lo``, the store), the state-based
score step, the snapshot score step and the bucket scorers, the retrieval
step at 64 candidates and its target slot, and ``models.recsys``'s
batched-dot retrieval.

Tolerances.  FM has no bf16 product: its loss is held within 1e-6 relative,
its scores within 1e-6 relative plus 1e-6, and its store and dense state
(Split-SGD) bit for bit.  BST, SASRec and DIN round bf16 products whose fp32
sums run in another order in XLA and in PyTorch: their scores and losses
are held within 2e-3 relative plus 1e-4 (the reference's own bf16 model
tolerance is 2e-2; what came out here: most scores within 1e-5 relative,
losses within 7e-6, but one bf16 intermediate rounded the other way moves
a SASRec score by 5e-4 relative), the fp32 masters of
the store's touched rows and of the dense weights within 1e-3 relative plus
1e-5 (``tests/test_torch_hybrid.py``'s), and the rows no step touched bit
for bit.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as j_h
from repro.launch.mesh import make_mesh
from repro.models import recsys as j_rec
from repro.serve import snapshot as j_snap
from repro_torch import weights
from repro_torch.core import hybrid as t_h
from repro_torch.launch.local import run_ranks
from repro_torch.models import recsys as t_rec
from repro_torch.serve import snapshot as t_snap
from _torch_cases import bits, dense_master, master
from _torch_ranks import retrieval_ties_rank

B = 16
NAMES = ("fm", "bst", "sasrec", "din")
# (rtol, atol) of scores and losses; FM's hold to fp32 rounding
SCORE_TOL = {"fm": (1e-6, 1e-6), "bst": (2e-3, 1e-4), "sasrec": (2e-3, 1e-4),
             "din": (2e-3, 1e-4)}


def make(name: str, pkg, **kw):
    """The smoke-size archetype ``name`` of ``pkg`` (``j_rec`` or ``t_rec``)."""
    if name == "fm":
        return pkg.make_fm((50,) * 39, batch=B, **kw)
    if name == "bst":
        return pkg.make_bst(100, (20,) * 8, batch=B, **kw)
    if name == "sasrec":
        return pkg.make_sasrec(100, batch=B, **kw)
    return pkg.make_din(100, (20,) * 4, batch=B, **kw)


TARGET = {"fm": 0, "bst": 20, "sasrec": 50, "din": 100}


def j_mesh():
    return make_mesh((1, 1), ("data", "model"))


def batch_np(mdef, n: int, seed: int) -> dict:
    """n samples: ids below each slot's table rows, the model's extras
    (labels in {0, 1}; seq_mask and hist_mask with about a fifth zero)."""
    rng = np.random.default_rng(seed)
    rows = [mdef.spec.table_rows[t] for t in (mdef.slot_to_table
                                              or range(mdef.spec.num_tables))]
    out = {"idx": np.stack([rng.integers(0, m, (n, 1)) for m in rows], axis=1).astype(np.int32)}
    if "labels" in mdef.extras:
        out["labels"] = rng.integers(0, 2, (n,)).astype(np.float32)
    for k in ("seq_mask", "hist_mask"):
        if k in mdef.extras:
            out[k] = (rng.random((n, *mdef.extras[k][0])) > 0.2).astype(np.float32)
    return out


def to_j(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_t(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def start(name: str, **kw):
    """(jax mdef, port mdef, the reference's start state as numpy arrays,
    the port's copy of it on the CPU)."""
    jm, tm = make(name, j_rec, **kw), make(name, t_rec, **kw)
    state, _ = j_h.init_state(jax.random.PRNGKey(0), jm, j_mesh())
    state_np = jax.tree.map(np.asarray, state)
    # state_from_numpy shares the arrays' memory on the CPU: the port trains in place
    ts = weights.state_to(weights.state_from_numpy(state_np, tm, device="cpu"), "cpu")
    return jm, tm, state_np, ts


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol[0], atol=tol[1], err_msg=what)


def hold_step(name, got_np, want_np, start_np, idx):
    """One step's state: FM bit for bit; the others within the stated
    tolerances on the touched rows and the dense master, the untouched rows
    bit for bit."""
    if name == "fm":
        for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want_np)):
            np.testing.assert_array_equal(bits(a), bits(b))
        return
    touched = np.zeros(want_np["emb"]["hi"].shape[0], bool)
    touched[np.unique(idx)] = True
    for k in want_np["emb"]:
        np.testing.assert_array_equal(bits(got_np["emb"][k])[~touched],
                                      bits(want_np["emb"][k])[~touched])
        np.testing.assert_array_equal(bits(got_np["emb"][k])[~touched],
                                      bits(start_np["emb"][k])[~touched])
    np.testing.assert_allclose(master(got_np["emb"])[touched], master(want_np["emb"])[touched],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dense_master(got_np, 1), dense_master(want_np, 1),
                               rtol=1e-3, atol=1e-5)


def global_rows(mdef, idx: np.ndarray) -> np.ndarray:
    s2t = np.asarray(mdef.slot_to_table or range(mdef.spec.num_tables))
    return idx + mdef.spec.row_offsets[s2t][None, :, None]


@pytest.mark.parametrize("name", NAMES)
def test_dense_score_and_loss_match_reference(name):
    """``dense_score`` and ``dense_loss`` on one bag output (bf16 values, as
    the row-mode bag gives them) and the reference's dense ``hi``."""
    jm, tm, state_np, ts = start(name)
    S = len(jm.slot_to_table or range(jm.spec.num_tables))
    rng = np.random.default_rng(1)
    emb = (rng.standard_normal((B, S, jm.spec.dim)) * 0.1).astype(np.float32)
    emb = np.array(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
    b = batch_np(jm, B, 2)
    hi_j = jax.tree.map(jnp.asarray, state_np["dense"]["hi"])
    want_s = np.asarray(jax.jit(jm.dense_score)(hi_j, jnp.asarray(emb), to_j(b)))
    want_l = float(jax.jit(jm.dense_loss)(hi_j, jnp.asarray(emb), to_j(b)))
    got_s = tm.dense_score(ts["dense"]["hi"], torch.from_numpy(emb), to_t(b))
    got_l = float(tm.dense_loss(ts["dense"]["hi"], torch.from_numpy(emb), to_t(b)))
    assert got_s.shape == (B,) and got_s.dtype == torch.float32
    close(got_s.numpy(), want_s, SCORE_TOL[name], "scores")
    close(got_l, want_l, SCORE_TOL[name], "loss")


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    """One (1, 1) train step from the reference's start state: the loss, the
    dense ``hi`` / ``lo`` and the store (see the module's tolerances)."""
    jm, tm, state_np, ts = start(name)
    b = batch_np(jm, B, 3)
    step, _, _, _ = j_h.make_train_step(jm, j_mesh())
    j_state, j_loss = step(jax.tree.map(jnp.asarray, state_np), to_j(b))
    t_step = t_h.make_train_step(tm, device="cpu")
    ts, t_loss = t_step(ts, to_t(b))
    close(float(t_loss), float(j_loss), SCORE_TOL[name], "loss")
    hold_step(name, weights.state_to_numpy(ts), jax.tree.map(np.asarray, j_state), state_np,
              global_rows(jm, b["idx"]))


@pytest.mark.parametrize("name", NAMES)
def test_score_step_matches_reference(name):
    """``core.hybrid.make_score_step`` against the reference's on one state."""
    jm, tm, state_np, ts = start(name)
    b = batch_np(jm, B, 4)
    sc, _, _, _ = j_h.make_score_step(jm, j_mesh(), batch=B)
    want = np.asarray(sc(jax.tree.map(jnp.asarray, state_np), to_j(b)))
    got = t_h.make_score_step(tm, device="cpu")(ts, to_t(b))
    close(got.numpy(), want, SCORE_TOL[name])


@pytest.mark.parametrize("name", NAMES)
def test_snapshot_scorers_match_reference(name):
    """The snapshot score step and the bucket scorers against the
    reference's, and the snapshot step bit for bit the state-based one (the
    reference's contract)."""
    jm, tm, state_np, ts = start(name)
    b = batch_np(jm, 8, 5)
    j_state = jax.tree.map(jnp.asarray, state_np)
    fn, _, _, _ = j_snap.make_snapshot_score_step(jm, j_mesh(), batch=8, donate_batch=False)
    want = np.asarray(fn(j_snap.snapshot_state(jm, j_state), to_j(b)))
    snap = t_snap.snapshot_state(tm, ts)
    t_fn, structs = t_snap.make_snapshot_score_step(tm, batch=8, device="cpu")
    assert set(structs) == {"idx", *(k for k in tm.extras if k != "labels")}
    got = t_fn(snap, to_t(b))
    close(got.numpy(), want, SCORE_TOL[name])
    state_scores = t_h.make_score_step(tm, device="cpu")(ts, to_t(b))
    assert torch.equal(got, state_scores)
    fns, pad = t_snap.make_bucket_scorers(tm, (4, 8), lambda: snap, device="cpu")
    payloads = [{k: v[i] for k, v in b.items()} for i in range(5)]
    padded = pad(payloads, 8)
    assert set(padded) == set(structs)
    j_fns, j_pad = j_snap.make_bucket_scorers(jm, j_mesh(), (4, 8),
                                             lambda: j_snap.snapshot_state(jm, j_state),
                                             donate_batch=False)
    close(fns[8](padded)[:5], np.asarray(j_fns[8](j_pad(payloads, 8)))[:5], SCORE_TOL[name])


@pytest.mark.parametrize("name", NAMES)
def test_retrieval_step_matches_reference(name, monkeypatch):
    """``make_retrieval_step`` at 64 candidates and the archetype's target
    slot, chunked (16 candidates a chunk) against the reference's one
    batch: the top-8 values within the scores' tolerance, the same
    candidates in the same order; a rank-1 extra is taken as ``(1, ...)``."""
    jm, tm, state_np, ts = start(name)
    q = batch_np(jm, 1, 6)
    for k in ("seq_mask", "hist_mask"):
        if k in q:
            q[k] = q[k][0]  # B-squeezed
    rng = np.random.default_rng(7)
    cand = np.asarray(jnp.asarray(rng.standard_normal((64, jm.spec.dim)) * 0.1, jnp.bfloat16))
    fn, _, _, _ = j_h.make_retrieval_step(jm, j_mesh(), 64, TARGET[name], topk=8)
    wv, wi = fn(jax.tree.map(jnp.asarray, state_np), to_j(q), jnp.asarray(cand))
    monkeypatch.setattr(t_h, "RETRIEVAL_CHUNK", 16)
    t_fn = t_h.make_retrieval_step(tm, None, 64, TARGET[name], topk=8, device="cpu")
    gv, gi = t_fn(ts, to_t(q), weights.to_torch(cand))
    close(gv.numpy(), np.asarray(wv), SCORE_TOL[name])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_batched_dot_retrieval_matches_reference():
    """``models.recsys.make_retrieval_step``: a user representation against
    64 candidate rows, the top-16 values within fp32 rounding and the same
    candidates."""
    rng = np.random.default_rng(8)
    urep = rng.standard_normal(50).astype(np.float32)
    cand = np.asarray(jnp.asarray(rng.standard_normal((64, 50)), jnp.bfloat16))
    fn = j_rec.make_retrieval_step(make("sasrec", j_rec), j_mesh(), 64, 50, topk=16)
    wv, wi = fn(jnp.asarray(urep), jnp.asarray(cand))
    t_fn = t_rec.make_retrieval_step(make("sasrec", t_rec), None, 64, topk=16, device="cpu")
    gv, gi = t_fn(torch.from_numpy(urep), weights.to_torch(cand))
    close(gv.numpy(), np.asarray(wv), (1e-6, 1e-6))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _ties(n: int, k: int, seed: int) -> np.ndarray:
    """n fp32 scores of which many tie: every seventh is 1, the rest U[0, 1)
    rounded to multiples of 1/k (k values a tie each, on average)."""
    rng = np.random.default_rng(seed)
    x = (np.floor(rng.random(n) * k) / k).astype(np.float32)
    x[::7] = 1.0
    return x


TOPK_CASES = {
    "every seventh equal, 5000": (np.where(np.arange(5000) % 7 == 0, 1.0,
                                           np.random.default_rng(1).random(5000))
                                  .astype(np.float32), 128),
    "all equal": (np.zeros(300, np.float32), 50),
    "few distinct values": (_ties(1000, 4, 2), 200),
    "k = n": (_ties(64, 8, 3), 64),
    "infinities and ties": (np.concatenate([np.full(40, -np.inf), _ties(200, 16, 4),
                                            np.full(30, np.inf)]).astype(np.float32), 100),
}


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_stable_matches_lax_top_k(case):
    """``core.hybrid.topk_stable`` returns ``jax.lax.top_k``'s values and
    indices: largest first, the lower index first among equal values."""
    x, k = TOPK_CASES[case]
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = t_h.topk_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(bits(gv.numpy()), bits(np.asarray(wv)))


# the tie cases: FM's smoke-size tables, 4096 candidates made of 16 distinct
# rows (each score shared by 256 candidates), the top-128
TIE_N, TIE_K, TIE_DISTINCT = 4096, 128, 16


def _tie_case(seed: int) -> dict:
    """Candidates whose scores tie: FM's (bf16 rows ~ N(0, 0.1) repeated)
    and the batched dot's (integers in [-2, 2], so every dot product is
    exact in any summation order, repeated) with an integer query."""
    rng = np.random.default_rng(seed)
    fm_base = np.asarray(jnp.asarray(rng.standard_normal((TIE_DISTINCT, 11)) * 0.1,
                                     jnp.bfloat16)).astype(np.float32)
    dot_base = rng.integers(-2, 3, (TIE_DISTINCT, 50)).astype(np.float32)
    pick = np.arange(TIE_N) % TIE_DISTINCT
    return {"cand": fm_base[pick], "dot_cand": dot_base[pick],
            "urep": rng.integers(-2, 3, 50).astype(np.float32)}


def test_retrieval_ties_match_reference_on_one_rank(monkeypatch):
    """Both retrieval steps on one rank, every score tied with 255 others:
    the top-128 the reference's values and indices (the lower candidate
    first among equal scores, ``jax.lax.top_k``'s order), FM chunked 1024
    candidates a chunk so that equal rows are scored in different chunks."""
    c = _tie_case(11)
    jm, tm, state_np, ts = start("fm")
    q = batch_np(jm, 1, 6)
    fn, _, _, _ = j_h.make_retrieval_step(jm, j_mesh(), TIE_N, 0, topk=TIE_K)
    wv, wi = fn(jax.tree.map(jnp.asarray, state_np), to_j(q),
                jnp.asarray(c["cand"], jnp.bfloat16))
    monkeypatch.setattr(t_h, "RETRIEVAL_CHUNK", 1024)
    t_fn = t_h.make_retrieval_step(tm, None, TIE_N, 0, topk=TIE_K, device="cpu")
    gv, gi = t_fn(ts, to_t(q), torch.from_numpy(c["cand"]).to(torch.bfloat16))
    assert len(set(np.asarray(wv).tolist())) < TIE_K // 64  # the top-128 is ties
    close(gv.numpy(), np.asarray(wv), SCORE_TOL["fm"])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))

    dot = j_rec.make_retrieval_step(make("sasrec", j_rec), j_mesh(), TIE_N, 50, topk=TIE_K)
    wv, wi = dot(jnp.asarray(c["urep"]), jnp.asarray(c["dot_cand"], jnp.bfloat16))
    t_dot = t_rec.make_retrieval_step(make("sasrec", t_rec), None, TIE_N, topk=TIE_K,
                                      device="cpu")
    gv, gi = t_dot(torch.from_numpy(c["urep"]), torch.from_numpy(c["dot_cand"]).to(torch.bfloat16))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


TIES_REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.core import hybrid as H
from repro.launch.mesh import make_mesh
from repro.models import recsys as R
c = pickle.load(open(sys.argv[1], "rb"))
mesh = make_mesh((1, 2), ("data", "model"))
mdef = R.make_fm(c["fm_rows"], batch=c["batch"])
state, _ = H.init_state(jax.random.PRNGKey(0), mdef, mesh)
n, k = c["cand"].shape[0], c["topk"]
fn, _, shardings, _ = H.make_retrieval_step(mdef, mesh, n, 0, topk=k)
v, i = fn(jax.device_put(state, shardings[0]), jax.tree.map(jnp.asarray, c["query"]),
          jax.device_put(jnp.asarray(c["cand"], jnp.bfloat16), shardings[2]))
dot = R.make_retrieval_step(R.make_sasrec(c["item_vocab"], batch=c["batch"]), mesh, n, 50, topk=k)
dv, di = dot(jnp.asarray(c["urep"]), jnp.asarray(c["dot_cand"], jnp.bfloat16))
pickle.dump({"state": jax.tree.map(np.asarray, state), "fm": (np.asarray(v), np.asarray(i)),
             "dot": (np.asarray(dv), np.asarray(di))}, open(sys.argv[2], "wb"))
"""


def test_retrieval_ties_on_two_ranks_match_reference(tmp_path):
    """Both retrieval steps on a (1, 2) mesh over two gloo ranks against the
    reference's two XLA devices, every score tied with 255 others in each
    rank's half: the merged top-128 the reference's (the lower rank's
    candidates first among equal scores), the same on both ranks."""
    c = {**_tie_case(12), "fm_rows": (50,) * 39, "item_vocab": 100, "batch": B, "topk": TIE_K}
    c["query"] = batch_np(make("fm", j_rec), 1, 6)
    with open(tmp_path / "case.pkl", "wb") as f:
        pickle.dump(c, f)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, "-c", textwrap.dedent(TIES_REF),
                          str(tmp_path / "case.pkl"), str(tmp_path / "ref.pkl")],
                         env=env, capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    c["state"] = want["state"]
    port = run_ranks(retrieval_ties_rank, 2, (c,), timeout_s=180, store_dir=str(tmp_path))
    wv, wi = want["fm"]
    assert len(set(wv.tolist())) < TIE_K // 64  # the top-128 is ties
    for got in port:
        close(got["fm"][0], wv, SCORE_TOL["fm"])
        np.testing.assert_array_equal(got["fm"][1], wi)
        np.testing.assert_array_equal(got["dot"][0], want["dot"][0])
        np.testing.assert_array_equal(got["dot"][1], want["dot"][1])


@pytest.mark.parametrize("opt", ["split_sgd", "adagrad_rowwise", "momentum_bf16"])
def test_fm_odd_width_optimizers_match_reference(opt):
    """FM's E = 11 with three row optimizers, one step each, the plain row
    updates at that width against the reference's jitted rows
    (``fused_update=False``): Split-SGD and the seeded bf16 momentum bit for
    bit, row-wise Adagrad (its square sum in another order) within the
    module's tolerances, averaged over the 11 real columns."""
    kw = dict(sparse_optimizer=opt, lr=0.01, emb_lr=0.01)
    if opt == "momentum_bf16":
        kw["sr_seed"] = 2 ** 31 - 2
    jm, tm, state_np, ts = start("fm", **kw)
    assert tm.spec.dim == 11
    jm = dataclasses.replace(jm, fused_update=False)
    b = batch_np(jm, B, 9)
    step, _, _, _ = j_h.make_train_step(jm, j_mesh())
    j_state, j_loss = step(jax.tree.map(jnp.asarray, state_np), to_j(b))
    ts, t_loss = t_h.make_train_step(tm, device="cpu")(ts, to_t(b))
    close(float(t_loss), float(j_loss), SCORE_TOL["fm"])
    got, want = weights.state_to_numpy(ts), jax.tree.map(np.asarray, j_state)
    if opt == "adagrad_rowwise":
        np.testing.assert_allclose(got["emb"]["w"], want["emb"]["w"], rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["emb"]["acc"], want["emb"]["acc"], rtol=1e-3, atol=1e-9)
        np.testing.assert_array_equal(bits(got["dense"]["lo"]), bits(want["dense"]["lo"]))
    else:
        for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(bits(a), bits(c))


def test_lr_and_emb_lr_step_their_own_updates():
    """``lr`` steps the dense update and ``emb_lr`` the sparse one: FM with
    lr 0.05 and emb_lr 0.5 is the reference's step bit for bit, and differs
    from the step with the two swapped."""
    jm, tm, state_np, ts = start("fm", lr=0.05, emb_lr=0.5)
    b = batch_np(jm, B, 10)
    step, _, _, _ = j_h.make_train_step(jm, j_mesh())
    j_state, _ = step(jax.tree.map(jnp.asarray, state_np), to_j(b))
    swapped = t_h.make_train_step(dataclasses.replace(tm, lr=0.5, emb_lr=0.05), device="cpu")
    other, _ = swapped(weights.state_to(ts, "cpu"), to_t(b))
    ts, _ = t_h.make_train_step(tm, device="cpu")(ts, to_t(b))
    got, want = weights.state_to_numpy(ts), jax.tree.map(np.asarray, j_state)
    for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(bits(a), bits(c))
    other = weights.state_to_numpy(other)
    assert not np.array_equal(bits(other["emb"]["hi"]), bits(got["emb"]["hi"]))
    assert not np.array_equal(bits(other["dense"]["lo"]), bits(got["dense"]["lo"]))


def test_weighted_score_step_and_retrieval_refusals():
    """The reference's ``tests/test_weighted.py``: the weighted FM score
    step reads its weights (doubled weights give other scores) and matches
    the reference's; the retrieval step refuses weighted bags, table mode
    and the sharded stream with the reference's messages."""
    jm = dataclasses.replace(j_rec.make_fm((50,) * 6, batch=8), weighted=True)
    tm = dataclasses.replace(t_rec.make_fm((50,) * 6, batch=8), weighted=True)
    state, _ = j_h.init_state(jax.random.PRNGKey(0), jm, j_mesh())
    state_np = jax.tree.map(np.asarray, state)
    ts = weights.state_from_numpy(state_np, tm, device="cpu")
    rng = np.random.default_rng(0)
    b = {"idx": rng.integers(0, 50, (8, 6, 1)).astype(np.int32),
         "labels": rng.integers(0, 2, 8).astype(np.float32),
         "weights": rng.uniform(0.5, 1.5, (8, 6, 1)).astype(np.float32)}
    sc, _, _, _ = j_h.make_score_step(jm, j_mesh())
    want = np.asarray(sc(state, to_j(b)))
    t_sc = t_h.make_score_step(tm, device="cpu")
    s1 = t_sc(ts, to_t(b)).numpy()
    s2 = t_sc(ts, to_t({**b, "weights": b["weights"] * 2})).numpy()
    assert s1.shape == (8,) and not np.array_equal(s1, s2)
    close(s1, want, SCORE_TOL["fm"])
    with pytest.raises(ValueError, match="weighted"):
        t_h.make_retrieval_step(tm, None, n_candidates=8, target_slot=0, device="cpu")
    base = t_rec.make_fm((50,) * 6, batch=8)
    with pytest.raises(ValueError, match="emb_mode='row'"):
        t_h.make_retrieval_step(dataclasses.replace(base, emb_mode="table"), None, 8, 0,
                                device="cpu")
    with pytest.raises(ValueError, match="idx_input='replicated'"):
        t_h.make_retrieval_step(dataclasses.replace(base, idx_input="sharded"), None, 8, 0,
                                device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_state_and_batch_structs_follow_the_model(name):
    """The state's dense ``hi`` is the model's ``init_dense`` tree in bf16
    (SASRec's stacked blocks included) and the layout maps the slots to the
    shared item table; the batch carries the model's extras; the structs
    and the ravel order are the reference's."""
    jm, tm = make(name, j_rec), make(name, t_rec)
    j_structs, _, _, j_layout = j_h.state_struct(jm, j_mesh())
    t_structs = t_h.state_struct(tm)
    assert [tuple(s.shape) for s in jax.tree.leaves(j_structs["dense"]["hi"])] == \
        [shape for shape, _ in t_structs_leaves(t_structs["dense"]["hi"])]
    assert t_structs["dense"]["lo"][0] == (j_structs["dense"]["lo"].shape[0],)
    layout = t_h.make_layout(tm, t_h.resolve_mesh(None, "cpu"))
    np.testing.assert_array_equal(layout.slot_to_table, j_layout.slot_to_table)
    assert layout.total_rows == j_layout.total_rows
    jb, _ = j_h.batch_struct(jm, j_mesh(), j_layout)
    tb = t_h.batch_struct(tm, t_h.resolve_mesh(None, "cpu"), layout)
    assert list(tb) == list(jb)
    assert [shape for shape, _ in tb.values()] == [tuple(s.shape) for s in jb.values()]


def t_structs_leaves(tree):
    """The ``(shape, dtype)`` leaves of a struct tree, in pytree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in t_structs_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in t_structs_leaves(t)]
    return [tree]


def test_hybrid_stream_is_the_reference_s():
    """``data.synthetic.hybrid_stream`` gives the reference's batches, masks
    included."""
    from repro.data import synthetic as j_syn
    from repro_torch.data import synthetic as t_syn
    for name in ("sasrec", "din"):
        jm, tm = make(name, j_rec), make(name, t_rec)
        a, c = next(j_syn.hybrid_stream(3, jm, 1.05)), next(t_syn.hybrid_stream(3, tm, 1.05))
        assert set(a) == set(c)
        for k in a:
            np.testing.assert_array_equal(a[k], c[k])


def test_packed_format_refuses_extras_it_cannot_carry(tmp_path):
    """``data.format.DatasetSpec.check_model`` of a ``HybridDef``: FM's
    labels fit; SASRec's ``seq_mask`` and DIN's ``hist_mask`` are refused
    with the reference's message."""
    from repro_torch.data.format import DatasetSpec
    spec = DatasetSpec(table_rows=(50,) * 39, pooling=1, labels=True)
    spec.check_model(make("fm", t_rec))
    for name, field in (("sasrec", "seq_mask"), ("din", "hist_mask")):
        with pytest.raises(ValueError, match=field):
            spec.check_model(make(name, t_rec))
