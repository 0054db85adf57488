"""The port's single-rank train step against the JAX package, on the CPU.

Inputs are numpy arrays from fixed seeds; a JAX train state is carried across
with ``repro_torch.weights``.  The JAX side runs as its own tests run it: a
(1, 1) mesh, Pallas kernels in interpret mode on tiny shards, and the
jitted reference row math.  The port runs its kernels' plain versions, which
is what its wrappers do with CPU tensors.

What is held bitwise: the row updates (split and fp32), the flat Split-SGD
step, the sorted stream, the synthetic batches and the state hand-off.  What
is held within a tolerance: anything that runs through the dense network,
whose fp32 sums the two frameworks take in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.core import interaction as j_inter
from repro.data import synthetic as j_syn
from repro.kernels import embedding_update as j_eu
from repro.kernels import ops as j_ops
from repro.launch.mesh import make_mesh
from repro.optim import data_parallel as j_dp
from repro.optim import row as j_row
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import hybrid as t_hybrid
from repro_torch.core import interaction as t_inter
from repro_torch.core import sharded_embedding as t_se
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import embedding_update as t_eu
from repro_torch.kernels import ref
from repro_torch.optim import data_parallel as t_dp
from repro_torch.testing import assert_close, to_torch

LR = 0.1
# table sizes that are not multiples of row_pad = 8, so the row offsets matter
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=32, mlp_impl="xla",
             lr=LR)


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy or torch array, for bitwise comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _bf16_values(rng, shape, scale=1.0) -> np.ndarray:
    """fp32 values that bf16 holds exactly, as the row-mode cotangent wire is."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16), np.float32)


def _lookups(rng, M: int, L: int) -> tuple[np.ndarray, np.ndarray]:
    """[L] rows with duplicates, one long run, out-of-range ids and masked
    lookups; and the validity mask."""
    tgt = rng.integers(0, M, L)
    tgt[rng.random(L) < 0.4] = 3                     # a long run of row 3
    tgt[rng.random(L) < 0.05] = -2                   # out of range below
    tgt[rng.random(L) < 0.05] = M + 5                # and above
    tgt[-1] = M - 1                                  # the tail run's row is also touched
    valid = rng.random(L) > 0.1                      # and some lookups masked
    return tgt.astype(np.int32), valid


@pytest.mark.parametrize("E", [16, 64])
def test_split_row_update_bitwise_to_reference_and_interpret_kernel(E):
    """The plain split row update on the sorted stream equals, bit for bit,
    the jitted ``apply_rows_split_sgd`` on the expanded per-lookup gradients
    and the interpret-mode Pallas kernel ``fused_row_update``."""
    rng = np.random.default_rng(E)
    M, P, L = 48, 4, 240
    W = rng.uniform(-0.5, 0.5, (M, E)).astype(np.float32)
    hi, lo = (np.asarray(x) for x in j_row.split_fp32(jnp.asarray(W)))
    tgt, valid = _lookups(rng, M, L)
    dY = _bf16_values(rng, (L // P, E))

    ok = valid & (tgt >= 0) & (tgt < M)
    grad = np.where(ok[:, None], dY[np.arange(L) // P], 0.0).astype(np.float32)
    want_h, want_l = jax.jit(j_row.apply_rows_split_sgd)(
        hi, lo, jnp.asarray(np.where(ok, tgt, 0)), jnp.asarray(grad), LR)
    kern = j_ops.fused_row_update("split_sgd", {"hi": jnp.asarray(hi), "lo": jnp.asarray(lo)},
                                  jnp.asarray(tgt), jnp.asarray(dY), LR, valid=jnp.asarray(valid),
                                  pooling=P, interpret=True)

    t_hi, t_lo = to_torch(hi), to_torch(lo)
    stream = t_eu.sort_lookups(torch.from_numpy(tgt), torch.from_numpy(valid), M, P)
    t_eu.fused_update_split(t_hi, t_lo, *stream, torch.from_numpy(dY).to(torch.bfloat16), LR)
    for got, want in ((t_hi, want_h), (t_lo, want_l), (t_hi, kern["hi"]), (t_lo, kern["lo"])):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(t_hi) != _bits(hi)).any()


def test_fp32_row_update_bitwise_to_interpret_kernel():
    """The plain fp32 row update equals the interpret-mode
    ``fused_update_fp32_pallas`` (through ``fused_row_update("sgd")``) bit
    for bit; dY reaches the port as fp32 here, the type the reference
    gives that kernel."""
    rng = np.random.default_rng(3)
    M, P, L, E = 40, 5, 200, 16
    W = rng.uniform(-0.5, 0.5, (M, E)).astype(np.float32)
    tgt, valid = _lookups(rng, M, L)
    dY = _bf16_values(rng, (L // P, E))
    want = j_ops.fused_row_update("sgd", {"w": jnp.asarray(W)}, jnp.asarray(tgt), jnp.asarray(dY),
                                  LR, valid=jnp.asarray(valid), pooling=P, interpret=True)["w"]
    t_W = torch.from_numpy(W.copy())
    stream = t_eu.sort_lookups(torch.from_numpy(tgt), torch.from_numpy(valid), M, P)
    t_eu.fused_update_fp32(t_W, *stream, torch.from_numpy(dY), LR)
    np.testing.assert_array_equal(_bits(t_W), _bits(want))
    assert (_bits(t_W) != _bits(W)).any()


@pytest.mark.parametrize("E", [16, 64])
@pytest.mark.parametrize("kind", ["split_sgd", "sgd"])
def test_row_update_fp32_cotangent_bitwise_to_interpret_kernel(kind, E):
    """The plain split and fp32 row updates with an fp32 cotangent that bf16
    cannot hold (the type the reference's kernels read in every mode) equal,
    bit for bit, the interpret-mode Pallas kernel fed the same numpy dY
    through ``fused_row_update``, and for the split store also the jitted
    ``apply_rows_split_sgd`` on the expanded per-lookup gradients."""
    rng = np.random.default_rng(100 + E)
    M, P, L = 48, 4, 240
    W = rng.uniform(-0.5, 0.5, (M, E)).astype(np.float32)
    tgt, valid = _lookups(rng, M, L)
    dY = (rng.standard_normal((L // P, E)) * 0.5).astype(np.float32)
    assert (np.asarray(jnp.asarray(dY, jnp.bfloat16), np.float32) != dY).mean() > 0.9
    stream = t_eu.sort_lookups(torch.from_numpy(tgt), torch.from_numpy(valid), M, P)
    kw = dict(valid=jnp.asarray(valid), pooling=P, interpret=True)
    if kind == "split_sgd":
        hi, lo = (np.asarray(x) for x in j_row.split_fp32(jnp.asarray(W)))
        want = [j_ops.fused_row_update(kind, {"hi": jnp.asarray(hi), "lo": jnp.asarray(lo)},
                                       jnp.asarray(tgt), jnp.asarray(dY), LR, **kw)]
        ok = valid & (tgt >= 0) & (tgt < M)
        grad = np.where(ok[:, None], dY[np.arange(L) // P], 0.0).astype(np.float32)
        want.append(dict(zip(("hi", "lo"), jax.jit(j_row.apply_rows_split_sgd)(
            hi, lo, jnp.asarray(np.where(ok, tgt, 0)), jnp.asarray(grad), LR))))
        got = dict(zip(("hi", "lo"), t_eu.fused_update_split(to_torch(hi), to_torch(lo), *stream,
                                                             torch.from_numpy(dY), LR)))
    else:
        want = [j_ops.fused_row_update(kind, {"w": jnp.asarray(W)}, jnp.asarray(tgt),
                                       jnp.asarray(dY), LR, **kw)]
        got = {"w": t_eu.fused_update_fp32(torch.from_numpy(W.copy()), *stream,
                                           torch.from_numpy(dY), LR)}
    for w in want:
        for k, v in got.items():
            np.testing.assert_array_equal(_bits(v), _bits(w[k]), err_msg=k)
    assert (_bits(got["w"] if kind == "sgd" else got["hi"]) != _bits(
        W if kind == "sgd" else hi)).any()

def test_sort_lookups_equals_reference():
    """Same keys, stable ties, tail convention: the four arrays are equal."""
    rng = np.random.default_rng(5)
    tgt, valid = _lookups(rng, 30, 300)
    wgt = rng.random(300).astype(np.float32)
    want = j_eu.sort_lookups(jnp.asarray(tgt), jnp.asarray(valid), 30, 6, jnp.asarray(wgt))
    got = t_eu.sort_lookups(torch.from_numpy(tgt), torch.from_numpy(valid), 30, 6,
                            torch.from_numpy(wgt))
    for g, w in zip(got, want):
        assert g.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [1, 7, 1000, 4099])
def test_flat_split_sgd_bitwise_to_interpret_kernel(n):
    """The plain flat Split-SGD step equals ``ops.split_sgd_update``
    (interpret mode) bit for bit, at lengths that are not block multiples."""
    rng = np.random.default_rng(n)
    w = (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 2, n)).astype(np.float32)
    g = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 2, n)).astype(np.float32)
    hi, lo = (np.asarray(x) for x in j_row.split_fp32(jnp.asarray(w)))
    want_h, want_l = j_ops.split_sgd_update(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(g), LR,
                                            interpret=True)
    t_hi, t_lo = to_torch(hi), to_torch(lo)
    ref.split_sgd(t_hi, t_lo, torch.from_numpy(g), LR)
    np.testing.assert_array_equal(_bits(t_hi), _bits(want_h))
    np.testing.assert_array_equal(_bits(t_lo), _bits(want_l))


def test_fma32_is_one_rounding():
    """``w - lr * g`` rounded once (an FMA), as jitted JAX computes it, and
    not as the unfused product then difference: on 2^16 values of mixed
    scale the two differ, and fma32 agrees with JAX everywhere."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal(1 << 16).astype(np.float32)
    g = (rng.standard_normal(1 << 16) * 10.0 ** rng.integers(-6, 3, 1 << 16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda w, g: w - np.float32(LR) * g)(w, g))
    got = ref.fma32(-np.float32(LR), torch.from_numpy(g), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (want != w - np.float32(LR) * g).any()


def _dense_tree(rng, cfg) -> dict:
    def mlp(sizes):
        return {"w": [rng.standard_normal((i, o)).astype(np.float32) * 0.1
                      for i, o in zip(sizes[:-1], sizes[1:])],
                "b": [rng.standard_normal(o).astype(np.float32) * 0.1 for o in sizes[1:]]}
    return {"bot": mlp(cfg.bottom_sizes), "top": mlp(cfg.top_sizes)}


def test_dense_split_sgd_bitwise_to_rs_ag_at_one_rank():
    """The dense update of the train step, ``rs_ag_split_sgd`` at one rank
    on the padded bucketed layout, equals the reference's (a (1, 1) mesh,
    four buckets, ``mean=False``, jitted as in the train step: run op by op,
    JAX rounds ``w - lr * g`` twice) bit for bit: ``hi`` leaves and ``lo``."""
    j_cfg = j_dlrm.DLRMConfig(**SMALL)
    rng = np.random.default_rng(2)
    params = _dense_tree(rng, j_cfg)
    grads = jax.tree.map(lambda p: np.asarray(jnp.asarray(rng.standard_normal(p.shape),
                                                          jnp.bfloat16)), params)
    arrays = j_dp.dp_global_arrays(jax.tree.map(jnp.asarray, params), 1)
    mesh = make_mesh((1, 1), ("data", "model"))
    axes = ("data", "model")

    def upd(hi, lo, g):
        st = j_dp.rs_ag_split_sgd(j_dp.DPState(hi, lo, None, None), g, LR, axes, mean=False)
        return st.hi, st.lo_shard

    fn = jax.jit(compat.shard_map(upd, mesh=mesh, in_specs=(P(), P(axes), P()),
                                  out_specs=(P(), P(axes)), check_vma=False))
    want_hi, want_lo = fn(arrays["hi"], arrays["lo"], jax.tree.map(jnp.asarray, grads))

    t_params = jax.tree.map(torch.from_numpy, params)
    state = t_dp.dp_global_arrays(t_params)
    np.testing.assert_array_equal(_bits(state["lo"]), _bits(arrays["lo"]))
    out = t_dp.rs_ag_split_sgd(state, jax.tree.map(to_torch, grads), LR)
    assert t_dp.flat_hi(out["hi"], out["lo"].numel()) is not None
    np.testing.assert_array_equal(_bits(out["lo"]), _bits(want_lo))
    for got, want in zip(t_dp.tree_leaves(out["hi"]), jax.tree.leaves(want_hi)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_interaction_backward_matches_jax_vjp():
    """dense and emb cotangents of the interaction: the same fp32 products
    summed in another order, rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(4)
    B, S, E = 6, 5, 16
    dense = rng.standard_normal((B, E)).astype(np.float32)
    emb = rng.standard_normal((B, S, E)).astype(np.float32)
    ct = rng.standard_normal((B, E + (S + 1) * S // 2)).astype(np.float32)
    _, vjp = jax.vjp(j_inter.dot_interaction, jnp.asarray(dense), jnp.asarray(emb))
    want_d, want_e = vjp(jnp.asarray(ct))
    d, e = torch.from_numpy(dense).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    out = t_inter.dot_interaction(d, e)
    got_d, got_e = torch.autograd.grad(out, [d, e], torch.from_numpy(ct))
    assert_close(out, j_inter.dot_interaction(jnp.asarray(dense), jnp.asarray(emb)), rtol=1e-5,
                 atol=1e-6)
    assert_close(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert_close(got_e, want_e, rtol=1e-5, atol=1e-6)


def _configs(**over):
    kw = {**SMALL, **over}
    return j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)


def _jax_state(j_cfg):
    mesh = make_mesh((1, 1), ("data", "model"))
    state, layout = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    return mesh, state, layout


def _batches(cfg, n: int, seed: int = 7, alpha: float = 1.05) -> list[dict]:
    """n batches from the port's stream (held equal to the reference's in
    test_synthetic_stream_equals_reference), dense_x rounded to bf16."""
    out = []
    for b, _ in zip(t_syn.dlrm_stream(seed, cfg, alpha), range(n)):
        b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
        out.append(b)
    return out


def _torch_batch(b: dict) -> dict:
    return {k: to_torch(v) for k, v in b.items()}


def test_synthetic_stream_equals_reference():
    j_cfg, t_cfg = _configs()
    for want, got, _ in zip(j_syn.dlrm_stream(3, j_cfg, 1.05), t_syn.dlrm_stream(3, t_cfg, 1.05),
                            range(2)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_loss_and_gradients_match_value_and_grad():
    """The dense_fwd_bwd stage against ``jax.value_and_grad`` of the
    reference's loss / B on the same weights and bag outputs.  Both run the
    same bf16 layers with fp32 sums in other orders, so a bf16 rounding
    between layers may fall either way: loss within 1e-6 relative; the bf16
    dense gradients within 2^-6 relative plus 1e-4 (two bf16 ulps); the fp32
    bag cotangents within 1e-2 relative plus 1e-6."""
    j_cfg, t_cfg = _configs()
    _, state, _ = _jax_state(j_cfg)
    rng = np.random.default_rng(6)
    emb_out = _bf16_values(rng, (j_cfg.batch, len(j_cfg.table_rows), j_cfg.emb_dim), 0.3)
    batch = _batches(t_cfg, 1)[0]
    dense_loss = j_dlrm.dlrm_dense_loss(j_cfg)
    loss_fn = jax.jit(lambda hi, e, b: dense_loss(hi, e, b) / j_cfg.batch)
    want_loss, (want_g, want_d) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        state["dense"]["hi"], jnp.asarray(emb_out), jax.tree.map(jnp.asarray, batch))

    t_state = weights.state_from_numpy(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    step = t_dlrm.make_train_step(t_cfg, device="cpu")
    loss, g_dense, d_emb = step.stages.dense_fwd_bwd(t_state["dense"]["hi"],
                                                     torch.from_numpy(emb_out), _torch_batch(batch))
    assert loss.dim() == 0
    assert_close(loss, np.asarray(want_loss), rtol=1e-6, atol=0)
    for got, want in zip(t_dp.tree_leaves(g_dense), jax.tree.leaves(want_g)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert_close(got, np.asarray(want, np.float32), rtol=2 ** -6, atol=1e-4)
    assert d_emb.dtype == torch.float32
    assert_close(d_emb, want_d, rtol=1e-2, atol=1e-6)


def test_train_step_matches_reference_for_three_steps():
    """Three steps of the port's train step against
    ``repro.core.dlrm.make_train_step`` (``fused_update=False``, the jitted
    reference row math) from the same state on the same zipf batches.
    Rows no step touched stay bitwise equal.  The loss agrees within 1e-6
    relative (8.6e-8 measured); the touched embedding rows and the dense weights within
    1e-3 relative plus 1e-5 (the dense network's sums in another order move
    each step's cotangents by a few bf16 ulps, and the steps compound; at
    this size and seed they came out bitwise equal)."""
    j_cfg, t_cfg = _configs()
    mesh, state, layout = _jax_state(j_cfg)
    t_state = weights.state_from_numpy(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    start = jax.tree.map(np.asarray, state)
    j_step, _, _, _ = j_dlrm.make_train_step(j_cfg, mesh)
    t_step = t_dlrm.make_train_step(t_cfg, device="cpu")
    touched = np.zeros(layout.total_rows, bool)
    for b in _batches(t_cfg, 3):
        state, want_loss = j_step(state, jax.tree.map(jnp.asarray, b))
        t_state, loss = t_step(t_state, _torch_batch(b))
        assert loss.dim() == 0 and torch.isfinite(loss)
        assert_close(loss, np.asarray(want_loss), rtol=1e-6, atol=0, what="loss")
        g = b["idx"] + layout.row_offsets[None, :, None]
        touched[g.reshape(-1)] = True
    want = jax.tree.map(np.asarray, state)
    got = weights.state_to_numpy(t_state)
    for k in ("hi", "lo"):
        np.testing.assert_array_equal(_bits(got["emb"][k])[~touched], _bits(start["emb"][k])[~touched])
        np.testing.assert_array_equal(_bits(got["emb"][k])[~touched], _bits(want["emb"][k])[~touched])
    w_got = np.asarray(j_row.combine_split(got["emb"]["hi"], got["emb"]["lo"]))
    w_want = np.asarray(j_row.combine_split(want["emb"]["hi"], want["emb"]["lo"]))
    w_start = np.asarray(j_row.combine_split(start["emb"]["hi"], start["emb"]["lo"]))
    assert (w_want[touched] != w_start[touched]).any()
    np.testing.assert_allclose(w_got[touched], w_want[touched], rtol=1e-3, atol=1e-5)
    for g_, w_ in zip(jax.tree.leaves(got["dense"]["hi"]), jax.tree.leaves(want["dense"]["hi"])):
        np.testing.assert_allclose(np.asarray(g_, np.float32), np.asarray(w_, np.float32),
                                   rtol=1e-3, atol=1e-5)


def test_sgd_train_step_runs_and_updates_the_fp32_table():
    """``sparse_optimizer="sgd"``: the fp32 store trains, finite losses,
    only looked-up rows change."""
    _, t_cfg = _configs(sparse_optimizer="sgd")
    st = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(0), device="cpu")
    W0 = st["emb"]["w"].clone()
    step = t_dlrm.make_train_step(t_cfg, device="cpu")
    touched = torch.zeros(W0.shape[0], dtype=torch.bool)
    offsets = torch.as_tensor(t_se.make_layout(t_cfg.spec, 1).row_offsets)
    for b in _batches(t_cfg, 2):
        st, loss = step(st, _torch_batch(b))
        assert torch.isfinite(loss)
        touched[(torch.from_numpy(b["idx"]) + offsets[None, :, None]).reshape(-1).long()] = True
    changed = (st["emb"]["w"] != W0).any(dim=1)
    assert changed.any() and not (changed & ~touched).any()


def test_state_hand_off_round_trips_bit_for_bit():
    """JAX state -> port -> numpy gives back every array bit for bit, with
    the JAX package's dtypes; and the port's own state survives the trip."""
    j_cfg, t_cfg = _configs()
    _, state, _ = _jax_state(j_cfg)
    state_np = jax.tree.map(np.asarray, state)
    back = weights.state_to_numpy(weights.state_from_numpy(state_np, t_cfg, device="cpu"))
    for want, got in zip(jax.tree.leaves(state_np), jax.tree.leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    own = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(1), device="cpu")
    again = weights.state_from_numpy(weights.state_to_numpy(own), t_cfg, device="cpu")
    for a, b in zip(t_dp.tree_leaves(own), t_dp.tree_leaves(again)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_init_state_has_the_reference_layout():
    """The port's state has the reference's leaves, shapes and (bit) types,
    and ``state_struct`` describes it."""
    j_cfg, t_cfg = _configs()
    _, state, _ = _jax_state(j_cfg)
    own = weights.state_to_numpy(t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(0),
                                                   device="cpu"))
    want = jax.tree.map(np.asarray, state)
    assert jax.tree.structure(own) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
    state = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(0), device="cpu")
    struct = t_hybrid.state_struct(t_cfg)
    assert struct["dense"]["err"] is None and state["dense"]["err"] is None
    leaves = t_dp.tree_leaves(state)
    specs = [x for x in jax.tree.leaves(struct, is_leaf=lambda x: isinstance(x, tuple)
                                        and isinstance(x[1], torch.dtype))]
    assert [(tuple(t.shape), t.dtype) for t in leaves] == specs


def test_gather_dY_and_apply_update_mask_out_of_range_rows():
    """The cotangent goes through the bf16 wire; lookups outside the row
    space change nothing, in-range ones do."""
    _, t_cfg = _configs()
    layout = t_se.make_layout(t_cfg.spec, 1)
    dY = t_se.gather_dY(layout, torch.full((2, 4, 16), 1.0 + 2 ** -12))
    assert dY.dtype == torch.bfloat16 and bool((dY.float() == 1.0).all())
    W = torch.zeros(layout.total_rows, 16)
    idx = torch.full((2, 4, 3), -1000, dtype=torch.int32)
    idx[0, 0, 0] = 5
    store = t_se.apply_update(layout, {"w": W}, "sgd", idx, dY, LR)
    assert torch.equal((store["w"] != 0).any(dim=1).nonzero().flatten(), torch.tensor([5]))


@pytest.mark.parametrize("over,exc,match", [
    ({"mlp_impl": "pallas"}, NotImplementedError, "no backward"),
    ({"hot_rows": 4, "hot_sync": "deferred:0"}, ValueError, "hot_sync")])
def test_train_step_refuses_what_is_not_ported(over, exc, match):
    _, t_cfg = _configs(**over)
    with pytest.raises(exc, match=match):
        t_dlrm.make_train_step(t_cfg, device="cpu")


def test_row_update_wrappers_refuse_bad_inputs():
    hi, lo = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(4, 8, dtype=torch.int16)
    stream = (torch.zeros(2, dtype=torch.int32),) * 3 + (torch.ones(2),)
    dY = torch.zeros(1, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        t_eu.fused_update_split(hi, lo.float(), *stream, dY, LR)
    with pytest.raises(TypeError):
        t_eu.fused_update_fp32(hi, *stream, dY, LR)
    with pytest.raises(ValueError):
        t_eu.fused_update_split(hi, lo, *stream, torch.zeros(1, 4, dtype=torch.bfloat16), LR)
    with pytest.raises(TypeError):
        t_eu.fused_update_split(hi, lo, stream[0].long(), *stream[1:], dY, LR)
