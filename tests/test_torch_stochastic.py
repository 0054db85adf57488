"""The port's compressed-state sparse optimizers and their stochastic
rounding against the JAX package, on the CPU.

``momentum_bf16`` and ``adagrad_bf16`` keep their state slab as bf16 and
store it rounded stochastically, with a dither that is a pure function of
``(seed, row, column)``.  The port's hash (``repro_torch.optim.stochastic``,
int64 arithmetic masked to 32 bits) is held bit for bit to
``repro.optim.stochastic``; the plain row updates (what the wrappers run for
CPU tensors) bit for bit to the reference's ``RowOptimizer.apply_sparse``,
jitted, on its reference row math (``fused=False``), on ``w`` and on the
state; ``adagrad_bf16`` also to its interpret-mode Pallas kernel; and three
train steps of each kind to ``repro.core.dlrm.make_train_step``, the ``sr``
counter included.

What jitted XLA computes (pinned here): as for fp32 momentum, it folds
``beta * decode(m) + segment_sum`` into a scatter-add that starts from
``beta * decode(m)`` and contracts ``w - lr * m`` into an FMA; Adagrad's
``s + acc * acc`` is one FMA, and its weight step divides by the root of the
unrounded ``s``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.launch.mesh import make_mesh
from repro.optim import row as j_row
from repro.optim import stochastic as j_sr
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import hybrid as t_hybrid
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import embedding_update as t_eu
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import row as t_row
from repro_torch.optim import stochastic as t_sr
from repro_torch.testing import to_torch

LR = 0.1
KINDS = ["momentum_bf16", "adagrad_bf16"]
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=32, mlp_impl="xla",
             lr=LR)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# ----------------------------------------------------------------- the hash --

def test_mix32_bitwise_to_reference():
    """Random 32-bit words and the edges (0, 1, 2^31 - 1, 2^31, 2^32 - 1)."""
    x = np.random.default_rng(0).integers(0, 2 ** 32, 1 << 16, dtype=np.uint64)
    x[:5] = (0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1)
    want = np.asarray(j_sr.mix32(jnp.asarray(x.astype(np.uint32))))
    np.testing.assert_array_equal(_u32(t_sr.mix32(torch.from_numpy(x.astype(np.int64)))), want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2, 2 ** 31 - 1, -1, -12345, -2 ** 31])
@pytest.mark.parametrize("width", [16, 64, 96])
def test_sr_noise_bitwise_to_reference(seed, width):
    """Seeds near 2^31 and negative int32 seeds (which wrap as uint32), row
    ids up to 2^32 - 1, as a 0-d int32 tensor and as an int."""
    rows = np.array([0, 1, 3, 47, 2 ** 20 + 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                    np.int64)
    want = np.asarray(j_sr.sr_noise(jnp.int32(seed), jnp.asarray(rows.astype(np.uint32)), width))
    got = t_sr.sr_noise(torch.tensor(seed, dtype=torch.int32), torch.from_numpy(rows), width)
    assert got.shape == (rows.size, width)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(t_sr.sr_noise(seed, torch.from_numpy(rows), width)), want)


def test_sr_round_bf16_bitwise_to_reference():
    """Values over 270 binades of both signs, zeros, subnormals, the largest
    finite values (whose carry reaches infinity), the edges of binades (where
    the carry runs into the exponent) and values bf16 holds exactly, which
    pass unchanged whatever the dither."""
    rng = np.random.default_rng(1)
    n = 1 << 14
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-44, 37, n)).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 3.4028235e38, -3.4028235e38,
                      np.nextafter(np.float32(1), np.float32(0)),
                      np.nextafter(np.float32(2), np.float32(0)),
                      np.nextafter(np.float32(-4), np.float32(0)), 1.0, 2.0, -0.5], np.float32)
    x[:edges.size] = edges
    noise = np.asarray(j_sr.sr_noise(jnp.int32(5), jnp.arange(n // 16, dtype=jnp.int32), 16))
    noise = noise.reshape(-1)
    want = np.asarray(j_sr.sr_round_bf16(jnp.asarray(x), jnp.asarray(noise)))
    got = t_sr.sr_round_bf16(torch.from_numpy(x), torch.from_numpy(noise.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    exact = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    got = t_sr.sr_round_bf16(torch.from_numpy(exact), torch.from_numpy(noise.astype(np.int64)))
    np.testing.assert_array_equal(got.float().numpy().view(np.int32), exact.view(np.int32))


def test_sr_round_bf16_is_unbiased():
    """Over the uniform dither the stored value's mean is the fp32 value:
    2^16 draws of one value between two bf16 neighbours land on them in
    proportion to their distance."""
    x = torch.full((1 << 16,), 1.0 + 2 ** -9)  # a quarter of the way from 1 to 1 + 2^-7
    got = t_sr.sr_round_bf16(x, t_sr.sr_noise(9, torch.arange(1 << 16), 1)[:, 0]).float()
    assert set(got.unique().tolist()) == {1.0, 1.0 + 2 ** -7}
    assert abs(float(got.double().mean()) - (1.0 + 2 ** -9)) < 2 ** -14


# ------------------------------------------------------------- row updates --

def _lookups(rng, M: int, NB: int, P: int) -> tuple[np.ndarray, np.ndarray]:
    """[NB, P] rows with duplicates, a long run of row 3, out-of-range ids,
    masked lookups, and the last row touched (its run holds the masked
    tail); the validity mask with the out-of-range ids masked."""
    L = NB * P
    tgt = rng.integers(0, M, L)
    tgt[rng.random(L) < 0.4] = 3
    tgt[rng.random(L) < 0.05] = -2
    tgt[rng.random(L) < 0.05] = M + 5
    tgt[-2:] = M - 1
    valid = (rng.random(L) > 0.1) & (tgt >= 0) & (tgt < M)
    valid[-1] = True
    return tgt.astype(np.int32).reshape(NB, P), valid.reshape(NB, P)


def _case(name: str, E: int, seed: int, weighted: bool = False):
    """A store with nonzero bf16 state, as a few steps leave it, a stream,
    bf16 cotangents and, when ``weighted``, weights U[0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    M, NB, P = 48, 60, 4
    key = "mom" if name == "momentum_bf16" else "acc"
    s = rng.standard_normal((M, E)) * 0.1 if key == "mom" else rng.random((M, E)) * 0.05
    store = {"w": rng.uniform(-0.5, 0.5, (M, E)).astype(np.float32),
             key: np.asarray(jnp.asarray(s, jnp.bfloat16))}
    idx, valid = _lookups(rng, M, NB, P)
    dY = np.asarray(jnp.asarray(rng.standard_normal((NB, E)) * 0.5, jnp.bfloat16), np.float32)
    wgt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32) if weighted else None
    return store, idx, valid, dY, wgt


def _port_update(name, store, idx, valid, dY, seed, wgt=None) -> dict:
    t_store = {k: to_torch(v.copy()) for k, v in store.items()}
    M = store["w"].shape[0]
    stream = t_eu.sort_lookups(torch.from_numpy(idx.reshape(-1)),
                               torch.from_numpy(valid.reshape(-1)), M, idx.shape[-1],
                               None if wgt is None else torch.from_numpy(wgt.reshape(-1)))
    t_row.apply_sparse(name, t_store, stream, torch.from_numpy(dY).to(torch.bfloat16), LR,
                       seed=torch.tensor(seed, dtype=torch.int32))
    return t_store


def _jax_update(name, store, idx, valid, dY, seed, fused: bool, wgt=None) -> dict:
    opt = j_row.get(name)

    def upd(st, i, d, v, w, sd):
        return opt.apply_sparse(st, j_row.SparseStream(idx=i, dY=d, valid=v, weights=w), LR,
                                seed=sd, fused=fused, interpret=True if fused else None)

    fn = upd if fused else jax.jit(upd)
    out = fn({k: jnp.asarray(v) for k, v in store.items()}, jnp.asarray(idx), jnp.asarray(dY),
             jnp.asarray(valid), None if wgt is None else jnp.asarray(wgt), jnp.int32(seed))
    return {k: np.asarray(v) for k, v in out.items()}


def _untouched(store: dict, idx, valid) -> np.ndarray:
    rows = np.ones(store["w"].shape[0], bool)
    rows[idx[valid]] = False
    return rows


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("E", [16, 64])
@pytest.mark.parametrize("name", KINDS)
def test_plain_update_bitwise_to_jitted_reference(name, E, weighted):
    """Bit for bit on ``w`` and on the bf16 state, at a nonzero seed, with
    and without bag weights; untouched rows keep both."""
    store, idx, valid, dY, wgt = _case(name, E, seed=E + len(name), weighted=weighted)
    sd = 2 ** 31 - 5 if weighted else 12345
    got = _port_update(name, store, idx, valid, dY, sd, wgt)
    want = _jax_update(name, store, idx, valid, dY, sd, fused=False, wgt=wgt)
    assert sorted(got) == sorted(want) == sorted(store)
    assert got["w"].dtype == torch.float32 and all(
        v.dtype == torch.bfloat16 for k, v in got.items() if k != "w")
    keep = _untouched(store, idx, valid)
    for k in store:
        assert (_bits(got[k]) != _bits(store[k])).any(), k
        np.testing.assert_array_equal(_bits(got[k])[keep], _bits(store[k])[keep], err_msg=k)
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_adagrad_bf16_bitwise_to_interpret_kernel():
    """``adagrad_bf16`` against the reference's interpret-mode Pallas kernel
    (``fused=True``), bit for bit on ``w`` and the state: the reference's
    own three-path test holds the two equal for this kind.  (Its
    ``momentum_bf16`` kernel sums a run from 0 and adds ``beta * m`` last,
    and its three-path test fails on this tree; the port follows the jitted
    reference, above.)"""
    store, idx, valid, dY, _ = _case("adagrad_bf16", 64, seed=3)
    got = _port_update("adagrad_bf16", store, idx, valid, dY, 77)
    want = _jax_update("adagrad_bf16", store, idx, valid, dY, 77, fused=True)
    for k in store:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("name", KINDS)
def test_all_masked_stream_is_an_exact_no_op(name):
    """A stream whose every lookup is masked writes nothing: not the last
    row's weights, nor its state, though the decay ``beta * m`` and a
    re-rounding of the state would change them."""
    store, idx, _, dY, _ = _case(name, 16, seed=5)
    got = _port_update(name, store, idx, np.zeros(idx.shape, bool), dY, 3)
    for k in store:
        np.testing.assert_array_equal(_bits(got[k]), _bits(store[k]), err_msg=k)


@pytest.mark.parametrize("name", KINDS)
def test_a_new_seed_changes_only_the_stored_state(name):
    """Two seeds: the same weights (the step reads the unrounded state), a
    different stored state (another dither), each the reference's; an
    unset seed is the reference's 0."""
    store, idx, valid, dY, _ = _case(name, 64, seed=11)
    a = _port_update(name, store, idx, valid, dY, 1)
    b = _port_update(name, store, idx, valid, dY, 2)
    key = t_row.get(name).state_keys[0]
    np.testing.assert_array_equal(_bits(a["w"]), _bits(b["w"]))
    assert (_bits(a[key]) != _bits(b[key])).any()
    np.testing.assert_array_equal(_bits(b[key]),
                                  _bits(_jax_update(name, store, idx, valid, dY, 2, False)[key]))
    t_store = {k: to_torch(v.copy()) for k, v in store.items()}
    stream = t_eu.sort_lookups(torch.from_numpy(idx.reshape(-1)),
                               torch.from_numpy(valid.reshape(-1)), 48, idx.shape[-1])
    t_row.apply_sparse(name, t_store, stream, torch.from_numpy(dY).to(torch.bfloat16), LR)
    np.testing.assert_array_equal(_bits(t_store[key]),
                                  _bits(_jax_update(name, store, idx, valid, dY, 0, False)[key]))


def test_wrappers_refuse_a_bad_seed():
    W, S = torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.bfloat16)
    stream = (torch.zeros(2, dtype=torch.int32),) * 3 + (torch.ones(2),)
    dY = torch.zeros(1, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        t_eu.fused_update_momentum_bf16(W, S, *stream, dY, LR, 0.9, torch.tensor(1))
    with pytest.raises(TypeError):
        t_eu.fused_update_adagrad_bf16(W, S, *stream, dY, LR, 1e-8,
                                       torch.ones(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        t_eu.fused_update_adagrad_bf16(W, S.float(), *stream, dY, LR, 1e-8,
                                       torch.tensor(1, dtype=torch.int32))


# ------------------------------------------------------------ train steps --

def _configs(name, **over):
    kw = {**SMALL, "sparse_optimizer": name, **over}
    return j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)


def _jax_state(j_cfg):
    mesh = make_mesh((1, 1), ("data", "model"))
    state, layout = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    return mesh, state, layout


@pytest.mark.parametrize("name", KINDS)
def test_state_hand_off_carries_sr_and_the_bf16_slab(name):
    """JAX state -> port -> numpy gives every array back bit for bit, the
    bf16 state slab and the ``sr`` seed included; the port's own state has
    the reference's leaves, shapes and types, ``sr`` = ``sr_seed``."""
    j_cfg, t_cfg = _configs(name, sr_seed=-7)
    _, state, _ = _jax_state(j_cfg)
    state_np = jax.tree.map(np.asarray, state)
    assert int(state_np["sr"]) == -7
    back = weights.state_to_numpy(weights.state_from_numpy(state_np, t_cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(state_np)
    for want, got in zip(jax.tree.leaves(state_np), jax.tree.leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    own = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(1), device="cpu")
    assert own["sr"].dtype == torch.int32 and own["sr"].dim() == 0 and int(own["sr"]) == -7
    for a, b in zip(jax.tree.leaves(weights.state_to_numpy(own)), jax.tree.leaves(state_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
    struct = t_hybrid.state_struct(t_cfg)
    assert struct["sr"] == ((), torch.int32)
    assert [(tuple(t.shape), t.dtype) for t in t_dp.tree_leaves(own)] == [
        x for x in jax.tree.leaves(struct, is_leaf=lambda x: isinstance(x, tuple)
                                   and isinstance(x[1], torch.dtype))]
    copy = weights.state_to(own, "cpu")
    assert int(copy["sr"]) == -7 and copy["sr"] is not own["sr"]
    with pytest.raises(ValueError, match="sr"):
        weights.state_from_numpy({k: v for k, v in state_np.items() if k != "sr"}, t_cfg,
                                 device="cpu")


def _batches(cfg, n: int, seed: int = 7) -> list[dict]:
    out = []
    for b, _ in zip(t_syn.dlrm_stream(seed, cfg, 1.05), range(n)):
        b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
        out.append(b)
    return out


@pytest.mark.parametrize("name", KINDS)
def test_train_step_matches_reference_for_three_steps(name):
    """Three steps of the port's train step against
    ``repro.core.dlrm.make_train_step`` (``fused_update=False``) on a (1, 1)
    mesh, from the same state (``sr`` starting at 2^31 - 2, so it wraps to
    -2^31 on the way) on the same zipf batches.  ``sr`` advances by one a
    step on both sides.  Untouched rows keep their weights and state bit for
    bit; the loss within 1e-6 relative, the touched rows and the dense
    weights within 1e-3 relative plus 1e-5, as ``test_torch_train.py``
    holds the Split-SGD step (the dense network sums in other orders).
    Measured at this size and seed: bitwise equal."""
    j_cfg, t_cfg = _configs(name, sr_seed=2 ** 31 - 2)
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
        assert int(t_state["sr"]) == int(state["sr"])
        touched[(b["idx"] + layout.row_offsets[None, :, None]).reshape(-1)] = True
    assert int(t_state["sr"]) == -2 ** 31 + 1 and t_state["sr"].dtype == torch.int32
    want = jax.tree.map(np.asarray, state)
    got = weights.state_to_numpy(t_state)
    for k in start["emb"]:
        np.testing.assert_array_equal(_bits(got["emb"][k])[~touched],
                                      _bits(start["emb"][k])[~touched], err_msg=k)
        assert (want["emb"][k][touched] != start["emb"][k][touched]).any(), k
        np.testing.assert_allclose(np.asarray(got["emb"][k][touched], np.float32),
                                   np.asarray(want["emb"][k][touched], np.float32),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    for g, w in zip(jax.tree.leaves(got["dense"]["hi"]), jax.tree.leaves(want["dense"]["hi"])):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=1e-3, atol=1e-5)
