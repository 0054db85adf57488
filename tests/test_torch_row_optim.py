"""The port's stateful sparse optimizers against the JAX package, on the CPU.

``momentum``, ``adagrad``, ``adagrad_rowwise`` and ``adagrad_freq``: the
port's row updates run their kernels' plain versions (what the wrappers do
with CPU tensors) and are held against the reference's
``RowOptimizer.apply_sparse``, jitted, on the reference row math
(``fused=False``), and against its interpret-mode Pallas kernels
(``fused=True``); then the whole train step against the reference's for
three steps.  Inputs are numpy arrays from fixed seeds.

What is held bitwise: ``momentum``, ``adagrad`` and ``adagrad_freq`` against
the jitted reference (``s + acc*acc`` and ``w - lr*m`` rounded once, as
jitted JAX contracts them; momentum's run added onto ``beta*m``, as XLA
folds ``beta*m + segment_sum`` into one scatter-add; square roots correctly
rounded), ``bump_counters``, the all-masked no-op and the state hand-off.
Within a tolerance: ``adagrad_rowwise``, whose sum of ``acc^2`` over a row
jitted XLA takes in an order of its own, and the interpret-mode kernels,
which round products apart from their sums and sum momentum's run from 0.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.launch.mesh import make_mesh
from repro.optim import row as j_row
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import hybrid as t_hybrid
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import embedding_update as t_eu
from repro_torch.kernels import ref
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import row as t_row
from repro_torch.testing import to_torch

ROOT = Path(__file__).resolve().parents[1]
LR = 0.1
STATEFUL = ["momentum", "adagrad", "adagrad_rowwise", "adagrad_freq"]
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=32, mlp_impl="xla",
             lr=LR)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _bf16_values(rng, shape, scale=1.0) -> np.ndarray:
    """fp32 values that bf16 holds exactly, as the row-mode cotangent wire is."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16), np.float32)


def _store(name: str, M: int, E: int, rng) -> dict:
    """A store with nonzero state, as a few steps leave it."""
    st = {"w": rng.uniform(-0.5, 0.5, (M, E)).astype(np.float32)}
    if name == "momentum":
        st["mom"] = (rng.standard_normal((M, E)) * 0.1).astype(np.float32)
    elif name == "adagrad":
        st["acc"] = (rng.random((M, E)) * 0.05).astype(np.float32)
    elif name == "adagrad_rowwise":
        st["acc"] = (rng.random((M, 1)) * 0.05).astype(np.float32)
    else:
        st["cnt"] = rng.integers(0, 6, (M, 1)).astype(np.int32)
    return st


def _lookups(rng, M: int, NB: int, P: int) -> tuple[np.ndarray, np.ndarray]:
    """[NB, P] rows with duplicates, a long run of row 3, out-of-range ids,
    masked lookups, and the last row touched (its run holds the masked
    tail); the validity mask with the out-of-range ids masked, as the
    reference's ``_local_rows`` gives it."""
    L = NB * P
    tgt = rng.integers(0, M, L)
    tgt[rng.random(L) < 0.4] = 3
    tgt[rng.random(L) < 0.05] = -2
    tgt[rng.random(L) < 0.05] = M + 5
    tgt[-2:] = M - 1
    valid = (rng.random(L) > 0.1) & (tgt >= 0) & (tgt < M)
    valid[-1] = True
    return tgt.astype(np.int32).reshape(NB, P), valid.reshape(NB, P)


def _case(name: str, E: int, seed: int):
    rng = np.random.default_rng(seed)
    M, NB, P = 48, 60, 4
    store = _store(name, M, E, rng)
    idx, valid = _lookups(rng, M, NB, P)
    dY = _bf16_values(rng, (NB, E), 0.5)
    return store, idx, valid, dY


def _port_update(name: str, store: dict, idx, valid, dY) -> dict:
    t_store = {k: to_torch(v.copy()) for k, v in store.items()}
    M = store["w"].shape[0]
    stream = t_eu.sort_lookups(torch.from_numpy(idx.reshape(-1)),
                               torch.from_numpy(valid.reshape(-1)), M, idx.shape[-1])
    t_row.apply_sparse(name, t_store, stream, torch.from_numpy(dY).to(torch.bfloat16), LR)
    return t_store


def _jax_update(name: str, store: dict, idx, valid, dY, fused: bool) -> dict:
    opt = j_row.get(name)

    def upd(st, i, d, v):
        return opt.apply_sparse(st, j_row.SparseStream(idx=i, dY=d, valid=v), LR, fused=fused,
                                interpret=True if fused else None)

    fn = upd if fused else jax.jit(upd)
    out = fn({k: jnp.asarray(v) for k, v in store.items()}, jnp.asarray(idx), jnp.asarray(dY),
             jnp.asarray(valid))
    return {k: np.asarray(v) for k, v in out.items()}


def _untouched(store: dict, idx, valid) -> np.ndarray:
    rows = np.ones(store["w"].shape[0], bool)
    rows[idx[valid]] = False
    return rows


@pytest.mark.parametrize("E", [16, 64])
@pytest.mark.parametrize("name", STATEFUL)
def test_plain_update_matches_jitted_reference(name, E):
    """The port's row update (plain versions) against the jitted reference
    row math on the expanded per-lookup gradients.  ``momentum``,
    ``adagrad`` and ``adagrad_freq``: bit for bit, weights and state.
    ``adagrad_rowwise``: jitted XLA sums ``acc^2`` over a row in an order
    that no sequential, pairwise, halving or vector-lane order reproduces,
    so its accumulator may differ in the last bits; held to rtol 2^-21
    (a few fp32 ulps, the sum's rounding) on the accumulator and 2^-21
    relative plus 1e-7 on the weights (the step divides by its root).
    Untouched rows keep their weights and state bit for bit."""
    store, idx, valid, dY = _case(name, E, seed=E + len(name))
    got = {k: v.numpy() for k, v in _port_update(name, store, idx, valid, dY).items()}
    want = _jax_update(name, store, idx, valid, dY, fused=False)
    assert sorted(got) == sorted(want) == sorted(store)
    assert (got["w"] != store["w"]).any()
    keep = _untouched(store, idx, valid)
    for k in store:
        np.testing.assert_array_equal(_bits(got[k])[keep], _bits(store[k])[keep])
    if name == "adagrad_rowwise":
        np.testing.assert_allclose(got["acc"], want["acc"], rtol=2 ** -21, atol=0)
        np.testing.assert_allclose(got["w"], want["w"], rtol=2 ** -21, atol=1e-7)
    else:
        for k in store:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("name", STATEFUL)
def test_plain_update_matches_interpret_kernel(name):
    """Against the reference's interpret-mode Pallas kernel (``fused=True``).
    ``adagrad_freq`` has no FMA and no fold: bit for bit.  The kernel rounds
    ``acc*acc`` apart from the sum it enters and ``lr*m`` apart from the
    difference: ``adagrad`` and ``adagrad_rowwise`` within rtol 2^-20 on the
    state, and 2^-20 relative plus 1e-7 on the weights (a few ulps of each
    rounding).  For ``momentum`` it also sums the run from 0 and adds
    ``beta*m`` last, where jitted JAX, and so the port, starts from
    ``beta*m``: the same terms in another order, so atol 4e-6 besides, a few
    ulps of the longest run's partial sums (about 10 here, ulp 9.5e-7)."""
    store, idx, valid, dY = _case(name, 64, seed=3)
    got = {k: v.numpy() for k, v in _port_update(name, store, idx, valid, dY).items()}
    want = _jax_update(name, store, idx, valid, dY, fused=True)
    if name == "adagrad_freq":
        for k in store:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
        return
    for k in store:
        atol = 4e-6 if name == "momentum" else (1e-7 if k == "w" else 0)
        np.testing.assert_allclose(got[k], want[k], rtol=2 ** -20, atol=atol, err_msg=k)


# --------------------------------------- the reference's own fp32 cotangent --

SEED = 2 ** 31 - 9  # the stochastic rounding's seed (ignored by the fp32-state kinds)


def _fp32_cotangent_case(name: str, E: int, seed: int):
    """A store with nonzero state (bf16 for the compressed-state kinds), a
    stream, and an fp32 cotangent that bf16 cannot hold: the reference's
    kernels read ``gather_dY``'s fp32 output in every mode."""
    rng = np.random.default_rng(seed)
    M, NB, P = 48, 60, 4
    if name.endswith("_bf16"):
        key = "mom" if name.startswith("momentum") else "acc"
        s = rng.standard_normal((M, E)) * 0.1 if key == "mom" else rng.random((M, E)) * 0.05
        store = {"w": rng.uniform(-0.5, 0.5, (M, E)).astype(np.float32),
                 key: np.asarray(jnp.asarray(s, jnp.bfloat16))}
    else:
        store = _store(name, M, E, rng)
    idx, valid = _lookups(rng, M, NB, P)
    dY = (rng.standard_normal((NB, E)) * 0.5).astype(np.float32)
    assert (np.asarray(jnp.asarray(dY, jnp.bfloat16), np.float32) != dY).mean() > 0.9
    return store, idx, valid, dY


def _fp32_cotangent_updates(name: str, store: dict, idx, valid, dY, fused: bool):
    """(port, reference) stores after one update with the fp32 ``dY``: the
    port's plain version, and the reference's ``apply_sparse``, jitted on
    its row math or its interpret-mode Pallas kernel."""
    t_store = {k: to_torch(v.copy()) for k, v in store.items()}
    stream = t_eu.sort_lookups(torch.from_numpy(idx.reshape(-1)),
                               torch.from_numpy(valid.reshape(-1)), store["w"].shape[0],
                               idx.shape[-1])
    t_row.apply_sparse(name, t_store, stream, torch.from_numpy(dY), LR,
                       seed=torch.tensor(SEED, dtype=torch.int32))
    opt = j_row.get(name)

    def upd(st, i, d, v, sd):
        return opt.apply_sparse(st, j_row.SparseStream(idx=i, dY=d, valid=v), LR, seed=sd,
                                fused=fused, interpret=True if fused else None)

    fn = upd if fused else jax.jit(upd)
    out = fn({k: jnp.asarray(v) for k, v in store.items()}, jnp.asarray(idx), jnp.asarray(dY),
             jnp.asarray(valid), jnp.int32(SEED))
    return t_store, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", [*STATEFUL, "momentum_bf16", "adagrad_bf16"])
def test_plain_update_fp32_cotangent_matches_jitted_reference(name):
    """Each stateful plain row update with an fp32 cotangent against the
    jitted reference fed the same numpy ``dY``: bit for bit on the weights
    and the state, but for ``adagrad_rowwise``, held as in
    :func:`test_plain_update_matches_jitted_reference` (its row sum of
    ``acc^2`` is jitted XLA's own order)."""
    store, idx, valid, dY = _fp32_cotangent_case(name, 64, seed=21 + len(name))
    got, want = _fp32_cotangent_updates(name, store, idx, valid, dY, fused=False)
    assert sorted(got) == sorted(want) == sorted(store)
    assert (_bits(got["w"]) != _bits(store["w"])).any()
    if name == "adagrad_rowwise":
        np.testing.assert_allclose(got["acc"].numpy(), want["acc"], rtol=2 ** -21, atol=0)
        np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=2 ** -21, atol=1e-7)
        return
    for k in store:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("name", [*STATEFUL, "adagrad_bf16"])
def test_plain_update_fp32_cotangent_matches_interpret_kernel(name):
    """The same against the reference's interpret-mode Pallas kernel
    (``fused=True``) fed the same numpy ``dY``: bit for bit for
    ``adagrad_freq`` and ``adagrad_bf16``; ``momentum``, ``adagrad`` and
    ``adagrad_rowwise`` within the tolerances of
    :func:`test_plain_update_matches_interpret_kernel`, whose reasons (the
    kernel's own roundings and momentum's order) do not depend on dY's type.
    ``momentum_bf16``'s kernel sums the run from 0 and adds ``beta * m``
    last, then rounds the result to bf16: the reference's own three-path
    test fails for it on this tree, so it is held to the jitted path above."""
    store, idx, valid, dY = _fp32_cotangent_case(name, 64, seed=3)
    got, want = _fp32_cotangent_updates(name, store, idx, valid, dY, fused=True)
    for k in store:
        if name in ("adagrad_freq", "adagrad_bf16"):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
        else:
            atol = 4e-6 if name == "momentum" else (1e-7 if k == "w" else 0)
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2 ** -20, atol=atol,
                                       err_msg=k)

@pytest.mark.parametrize("name", STATEFUL)
def test_all_masked_stream_is_an_exact_no_op(name):
    """A stream whose every lookup is masked forms one dead run on the last
    row (the sorted tail): no weight and no state changes, not even the
    last row's, though ``beta * m`` and a rewritten accumulator would."""
    store, idx, _, dY = _case(name, 16, seed=5)
    got = _port_update(name, store, idx, np.zeros(idx.shape, bool), dY)
    for k in store:
        np.testing.assert_array_equal(_bits(got[k]), _bits(store[k]), err_msg=k)


def test_bump_counters_bitwise_to_reference():
    """+1 per valid lookup from the sorted stream equals the reference's
    ``bump_counters`` on the flat targets (masked and out-of-range dropped)."""
    rng = np.random.default_rng(9)
    M = 30
    cnt = rng.integers(0, 100, (M, 1)).astype(np.int32)
    idx, valid = _lookups(rng, M, 50, 6)
    want = j_row.bump_counters(jnp.asarray(cnt), jnp.where(jnp.asarray(valid), jnp.asarray(idx),
                                                           M).reshape(-1), M)
    stream = t_eu.sort_lookups(torch.from_numpy(idx.reshape(-1)),
                               torch.from_numpy(valid.reshape(-1)), M, 6)
    got = t_row.bump_counters(torch.from_numpy(cnt.copy()), stream[0], stream[2])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != cnt).any()


def test_row_square_sum_follows_the_kernel_order():
    """The documented order, written out as 32 lanes of a warp: lane l adds
    its two columns' squares block after block, then the butterfly.  E = 96
    has a ragged last block."""
    rng = np.random.default_rng(12)
    acc = (rng.standard_normal((7, 96)) * 10.0 ** rng.integers(-3, 3, (7, 96))).astype(np.float32)
    got = ref.row_square_sum(torch.from_numpy(acc)).numpy()
    for u in range(7):
        q = [np.float32(0)] * 32
        for cb in range(0, 96, 64):
            for lane in range(32):
                c = cb + 2 * lane
                if c < 96:
                    for x in acc[u, c:c + 2]:
                        q[lane] = np.float32(q[lane] + np.float32(x * x))
        for k in (16, 8, 4, 2, 1):
            q = [np.float32(q[lane] + q[lane ^ k]) for lane in range(32)]
        assert len({float(v) for v in q}) == 1
        assert got[u].view(np.int32) == q[0].view(np.int32)


def test_resolve_applies_overrides_and_refuses_what_is_not_ported():
    """Every optimizer of the reference's registry resolves in the port,
    with its defaults, its state slabs and their types and its stochastic
    rounding; a name neither knows raises."""
    _, t_cfg = _configs("momentum", opt_beta=0.5, opt_eps=1e-4)
    opt = t_row.resolve(t_cfg)
    assert (opt.name, opt.beta, opt.eps) == ("momentum", 0.5, 1e-4)
    assert sorted(t_row.OPTIMIZERS) == sorted(j_row.names())
    for name in j_row.names():
        ref_opt = j_row.get(name)
        opt = t_row.get(name)
        assert (opt.beta, opt.eps, opt.split, opt.stochastic_round) == (
            ref_opt.beta, ref_opt.eps, ref_opt.split, ref_opt.stochastic_round)
        assert opt.state_keys == ref_opt.state_keys
        for (key, width, dtype), (r_key, r_width, *r_dtype) in zip(opt.state, ref_opt.state):
            assert (key, width) == (r_key, r_width)
            assert str(dtype).removeprefix("torch.") == (r_dtype or ["float32"])[0]
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        t_row.get("rmsprop")


def _compared_strings(path: Path) -> set[str]:
    """The string constants that take part in a comparison (``==``, ``in``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Compare):
            for operand in (node.left, *node.comparators):
                for c in ast.walk(operand):
                    if isinstance(c, ast.Constant) and isinstance(c.value, str):
                        out.add(c.value)
    return out


def test_no_per_optimizer_branch_outside_the_optimizer_table():
    """As in the reference (``kernels/ops.py:80``): the kernels' dispatch,
    the sharded embedding and the pipeline compare nothing with an
    optimizer's name; ``optim.row`` alone picks a row kernel."""
    names = set(t_row.OPTIMIZERS)
    for rel in ("kernels/ops.py", "core/sharded_embedding.py", "core/pipeline.py"):
        assert not _compared_strings(ROOT / "src" / "repro_torch" / rel) & names, rel


def test_sqrt32_is_correctly_rounded():
    """``ref.sqrt32`` against numpy's fp32 square root (IEEE, correctly
    rounded) on 2^16 values over 60 binades, where torch's own CPU ``sqrt``
    is off by an ulp in some."""
    rng = np.random.default_rng(13)
    x = (rng.random(1 << 16) * 10.0 ** rng.integers(-30, 30, 1 << 16)).astype(np.float32)
    x[:3] = (0.0, 1.0, 4.0)
    got = ref.sqrt32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))


def _configs(name, **over):
    kw = {**SMALL, "sparse_optimizer": name, **over}
    return j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)


def _jax_state(j_cfg):
    mesh = make_mesh((1, 1), ("data", "model"))
    state, layout = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    return mesh, state, layout


@pytest.mark.parametrize("name", STATEFUL)
def test_state_hand_off_and_layout(name):
    """JAX state -> port -> numpy gives back every array bit for bit (the
    state slabs included: ``acc`` [rows, 1] fp32, ``cnt`` [rows, 1] int32);
    the port's own state has the reference's leaves, shapes and types, and
    ``state_struct`` describes it."""
    j_cfg, t_cfg = _configs(name)
    _, state, _ = _jax_state(j_cfg)
    state_np = jax.tree.map(np.asarray, state)
    assert sorted(state_np["emb"]) == sorted(("w", *j_row.get(name).state_keys))
    back = weights.state_to_numpy(weights.state_from_numpy(state_np, t_cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(state_np)
    for want, got in zip(jax.tree.leaves(state_np), jax.tree.leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    own = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(1), device="cpu")
    for k in t_row.get(name).state_keys:
        assert not own["emb"][k].any()
    own_np = weights.state_to_numpy(own)
    for a, b in zip(jax.tree.leaves(own_np), jax.tree.leaves(state_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
    struct = t_hybrid.state_struct(t_cfg)
    assert [(tuple(t.shape), t.dtype) for t in t_dp.tree_leaves(own)] == [
        x for x in jax.tree.leaves(struct, is_leaf=lambda x: isinstance(x, tuple)
                                   and isinstance(x[1], torch.dtype))]
    again = weights.state_from_numpy(own_np, t_cfg, device="cpu")
    for a, b in zip(t_dp.tree_leaves(own), t_dp.tree_leaves(again)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _batches(cfg, n: int, seed: int = 7) -> list[dict]:
    out = []
    for b, _ in zip(t_syn.dlrm_stream(seed, cfg, 1.05), range(n)):
        b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
        out.append(b)
    return out


@pytest.mark.parametrize("name", STATEFUL)
def test_train_step_matches_reference_for_three_steps(name):
    """Three steps of the port's train step against
    ``repro.core.dlrm.make_train_step`` (``fused_update=False``, the jitted
    reference row math) on a (1, 1) mesh, from the same state on the same
    zipf batches.  Rows no step touched keep their weights and state bit
    for bit.  The loss agrees within 1e-6 relative (8.8e-8 measured); the
    touched rows' weights and state and the dense weights within 1e-3
    relative plus 1e-5: the dense network's sums run in other orders, which
    may move a bf16 cotangent by an ulp, and ``adagrad_rowwise`` sums its
    squares in another order (see above).  Measured at this size and seed:
    bitwise equal for all but ``adagrad_rowwise`` (weights within 6e-8)."""
    j_cfg, t_cfg = _configs(name)
    mesh, state, layout = _jax_state(j_cfg)
    start = jax.tree.map(np.asarray, state)
    t_state = weights.state_from_numpy(start, t_cfg, device="cpu")
    j_step, _, _, _ = j_dlrm.make_train_step(j_cfg, mesh)
    t_step = t_dlrm.make_train_step(t_cfg, device="cpu")
    touched = np.zeros(layout.total_rows, bool)
    for b in _batches(t_cfg, 3):
        state, want_loss = j_step(state, jax.tree.map(jnp.asarray, b))
        t_state, loss = t_step(t_state, {k: to_torch(v) for k, v in b.items()})
        assert loss.dim() == 0 and torch.isfinite(loss)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6, atol=0)
        touched[(b["idx"] + layout.row_offsets[None, :, None]).reshape(-1)] = True
    want = jax.tree.map(np.asarray, state)
    got = weights.state_to_numpy(t_state)
    for k in start["emb"]:
        np.testing.assert_array_equal(_bits(got["emb"][k])[~touched],
                                      _bits(start["emb"][k])[~touched], err_msg=k)
        np.testing.assert_array_equal(_bits(want["emb"][k])[~touched],
                                      _bits(start["emb"][k])[~touched], err_msg=k)
        assert (want["emb"][k][touched] != start["emb"][k][touched]).any(), k
        np.testing.assert_allclose(got["emb"][k][touched], want["emb"][k][touched], rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    for g, w in zip(jax.tree.leaves(got["dense"]["hi"]), jax.tree.leaves(want["dense"]["hi"])):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=1e-3, atol=1e-5)
