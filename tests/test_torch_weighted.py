"""Weighted bags in the port against the JAX package, on the CPU.

With ``weighted=True`` a batch carries ``weights`` [B, S, P] fp32 in the
layout of ``idx``: the forward sums ``w_p * W[g_p]`` (the embedding_bag
kernel's weighted variant; its plain version is the reference's
``_partial_bag_masked``) and the sparse update scales each lookup's
cotangent by its weight (the ``wgt`` stream of every row kernel).

The reference's contracts, held here: all-ones weights give the unweighted
step bit for bit (``w * 1.0`` is exact on both paths); zero weights on one
slot freeze its table under Split-SGD (``tests/test_weighted.py``); the
weighted forward, the sorted stream, the snapshot scores and three weighted
train steps match the reference's, at the tolerances the unweighted tests
use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.core import sharded_embedding as j_se
from repro.launch.mesh import make_mesh
from repro.optim import row as j_row
from repro.serve import snapshot as j_snapshot
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import ops
from repro_torch.serve import make_snapshot_score_step
from repro_torch.testing import assert_close, to_torch

LR = 0.1
# table sizes that are not multiples of row_pad = 8, so the row offsets matter
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=32, mlp_impl="xla",
             lr=LR)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _configs(**over):
    kw = {**SMALL, "weighted": True, **over}
    return j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)


def _jax_state(j_cfg):
    mesh = make_mesh((1, 1), ("data", "model"))
    state, layout = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    return mesh, state, layout


def _batches(cfg, n: int, seed: int = 7, ones: bool = False) -> list[dict]:
    """n zipf batches of the port's stream, dense_x rounded to bf16, with
    weights U[0.5, 1.5) (or all ones) from a numpy generator of ``seed``."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for b, _ in zip(t_syn.dlrm_stream(seed, cfg, 1.05), range(n)):
        b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
        b["weights"] = (np.ones(b["idx"].shape, np.float32) if ones
                        else rng.uniform(0.5, 1.5, b["idx"].shape).astype(np.float32))
        out.append(b)
    return out


def _torch(b: dict) -> dict:
    return {k: to_torch(v) for k, v in b.items()}


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("E,P", [(16, 3), (64, 50), (96, 7)])
def test_weighted_bag_matches_reference(dtype, E, P):
    """The weighted bag (plain version, as the wrapper runs it on the CPU)
    against the reference's ``_partial_bag_masked`` with weights, out-of-
    range rows adding nothing whatever their weight (zero, negative and
    large weights among them): the same products, summed in fp32 in other
    orders, rtol = atol = 1e-5 as the unweighted bag is held."""
    rng = np.random.default_rng(E * P)
    rows, rows_per_shard = 300, 290
    W = jnp.asarray(rng.standard_normal((rows, E)), dtype)
    g = rng.integers(-20, rows + 20, (7, 5, P)).astype(np.int32)
    w = rng.uniform(-2.0, 2.0, g.shape).astype(np.float32)
    w[0, 0] = 0.0
    w[1, 1, 0] = 1e30  # on an out-of-range row it must add nothing
    g[1, 1, 0] = rows + 3
    valid = (g >= 0) & (g < rows_per_shard)
    want = np.asarray(j_se._partial_bag_masked(W, jnp.asarray(g), jnp.asarray(valid),
                                               jnp.asarray(w)))
    got = ops.embedding_bag(to_torch(np.asarray(W)), torch.from_numpy(g), rows_per_shard,
                            torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert not got[0, 0].any()
    assert np.isfinite(got.numpy()).all()
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_all_ones_bag_is_the_unweighted_bag_bitwise():
    rng = np.random.default_rng(4)
    W = torch.from_numpy(rng.standard_normal((120, 32)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.integers(-5, 125, (9, 4, 6)).astype(np.int32))
    plain = ops.embedding_bag(W, g, 120)
    ones = ops.embedding_bag(W, g, 120, torch.ones(g.shape))
    np.testing.assert_array_equal(_bits(ones), _bits(plain))


def test_sorted_stream_carries_weights_as_reference():
    """``_row_sorted_streams`` with weights: the four arrays bit for bit the
    reference's (its localisation into the one shard's window is the
    identity)."""
    j_cfg, t_cfg = _configs()
    _, _, layout = _jax_state(j_cfg)
    b = _batches(t_cfg, 1)[0]
    g = (b["idx"] + layout.row_offsets[None, :, None]).reshape(-1)
    g[::17] = -4
    g[5::23] = layout.total_rows + 2
    wf = b["weights"].reshape(-1)
    want = j_se._row_sorted_streams(layout, jnp.asarray(g), 0, t_cfg.pooling, jnp.asarray(wf))
    t_layout = t_se.make_layout(t_cfg.spec, 1)
    got = t_se._row_sorted_streams(t_layout, torch.from_numpy(g), t_cfg.pooling,
                                   torch.from_numpy(wf))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    assert (got[3] != 1.0).any()


@pytest.mark.parametrize("name", ["split_sgd", "momentum_bf16", "adagrad"])
def test_all_ones_weights_bitwise_equal_unweighted(name):
    """Two steps with all-ones weights and two unweighted steps from one
    state: the same losses and the same store, bit for bit."""
    res = {}
    for weighted in (False, True):
        _, t_cfg = _configs(sparse_optimizer=name, weighted=weighted, sr_seed=5)
        state = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(0), device="cpu")
        step = t_dlrm.make_train_step(t_cfg, device="cpu")
        losses = []
        for b in _batches(t_cfg, 2, ones=True):
            if not weighted:
                del b["weights"]
            state, loss = step(state, _torch(b))
            losses.append(float(loss))
        res[weighted] = (losses, state)
    assert res[False][0] == res[True][0]
    for k, v in res[False][1]["emb"].items():
        np.testing.assert_array_equal(_bits(res[True][1]["emb"][k]), _bits(v), err_msg=k)


def test_zero_weight_slot_freezes_its_table():
    """Zeroing slot 2's weights leaves table 2's rows bit for bit as they
    were after a Split-SGD step, while the same step with ones moves them;
    the other tables move in both."""
    _, t_cfg = _configs()
    layout = t_se.make_layout(t_cfg.spec, 1)
    lo2, hi2 = int(layout.row_offsets[2]), int(layout.row_offsets[3])
    b = _batches(t_cfg, 1, ones=True)[0]
    moved = {}
    for tag in ("zeroed", "ones"):
        state = t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(0), device="cpu")
        init = {k: v.clone() for k, v in state["emb"].items()}
        w = b["weights"].copy()
        if tag == "zeroed":
            w[:, 2, :] = 0.0
        state, _ = t_dlrm.make_train_step(t_cfg, device="cpu")(state, _torch({**b, "weights": w}))
        moved[tag] = any(not torch.equal(state["emb"][k][lo2:hi2], init[k][lo2:hi2])
                         for k in init)
        assert not torch.equal(state["emb"]["hi"][:lo2], init["hi"][:lo2])
    assert moved["ones"] and not moved["zeroed"]


@pytest.mark.parametrize("name", ["split_sgd", "momentum_bf16"])
def test_weighted_train_step_matches_reference_for_three_steps(name):
    """Three weighted steps of the port's train step against
    ``repro.core.dlrm.make_train_step`` (``fused_update=False``) on a (1, 1)
    mesh, from the same state on the same zipf batches and weights: the
    loss within 1e-6 relative, the touched rows and the dense weights within
    1e-3 relative plus 1e-5, the untouched rows bit for bit, as
    ``test_torch_train.py`` holds the unweighted step.  Measured at this
    size and seed: bitwise equal."""
    j_cfg, t_cfg = _configs(sparse_optimizer=name)
    mesh, state, layout = _jax_state(j_cfg)
    start = jax.tree.map(np.asarray, state)
    t_state = weights.state_from_numpy(start, t_cfg, device="cpu")
    j_step, _, _, _ = j_dlrm.make_train_step(j_cfg, mesh)
    t_step = t_dlrm.make_train_step(t_cfg, device="cpu")
    touched = np.zeros(layout.total_rows, bool)
    for b in _batches(t_cfg, 3):
        state, want_loss = j_step(state, jax.tree.map(jnp.asarray, b))
        t_state, loss = t_step(t_state, _torch(b))
        assert loss.dim() == 0 and torch.isfinite(loss)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6, atol=0)
        touched[(b["idx"] + layout.row_offsets[None, :, None]).reshape(-1)] = True
    want = jax.tree.map(np.asarray, state)
    got = weights.state_to_numpy(t_state)
    if name == "split_sgd":
        master = {k: np.asarray(j_row.combine_split(d["emb"]["hi"], d["emb"]["lo"]))
                  for k, d in (("got", got), ("want", want), ("start", start))}
    else:
        master = {"got": got["emb"]["w"], "want": want["emb"]["w"], "start": start["emb"]["w"]}
        np.testing.assert_allclose(np.asarray(got["emb"]["mom"][touched], np.float32),
                                   np.asarray(want["emb"]["mom"][touched], np.float32),
                                   rtol=1e-3, atol=1e-5)
    for k in start["emb"]:
        np.testing.assert_array_equal(_bits(got["emb"][k])[~touched],
                                      _bits(start["emb"][k])[~touched], err_msg=k)
    assert (master["want"][touched] != master["start"][touched]).any()
    np.testing.assert_allclose(master["got"][touched], master["want"][touched], rtol=1e-3,
                               atol=1e-5)
    for g_, w_ in zip(jax.tree.leaves(got["dense"]["hi"]), jax.tree.leaves(want["dense"]["hi"])):
        np.testing.assert_allclose(np.asarray(g_, np.float32), np.asarray(w_, np.float32),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_weighted_snapshot_scores_match_reference(impl):
    """The weighted score step against the reference's, within the bf16
    tolerance of ``test_torch_serve.py`` (2e-2); with all-ones weights the
    port's scores are its unweighted scores, bit for bit."""
    j_cfg, t_cfg = _configs(mlp_impl=impl, batch=8)
    mesh, state, _ = _jax_state(j_cfg)
    mdef = j_dlrm.as_hybrid_def(j_cfg)
    b = _batches(t_cfg, 1)[0]
    batch = {k: b[k] for k in ("idx", "dense_x", "weights")}
    fn, _, _, _ = j_snapshot.make_snapshot_score_step(mdef, mesh, donate_batch=False)
    want = np.asarray(fn(j_snapshot.snapshot_state(mdef, state),
                         {k: jnp.asarray(v) for k, v in b.items()}))
    snap = weights.state_to_snapshot(jax.tree.map(np.asarray, state), t_cfg, device="cpu")
    t_fn, bstructs = make_snapshot_score_step(t_cfg, device="cpu")
    assert bstructs["weights"] == ((8, 4, 3), torch.float32)
    got = t_fn(snap, _torch(batch))
    assert got.shape == want.shape == (8,)
    assert_close(got, want, rtol=2e-2, atol=2e-2)
    ones = t_fn(snap, _torch({**batch, "weights": np.ones_like(batch["weights"])}))
    _, t_plain = _configs(mlp_impl=impl, batch=8, weighted=False)
    plain = make_snapshot_score_step(t_plain, device="cpu")[0](
        snap, _torch({k: batch[k] for k in ("idx", "dense_x")}))
    np.testing.assert_array_equal(_bits(ones), _bits(plain))
