"""The port's Fig. 16 pieces against the JAX package, on the CPU.

``core.embedding``'s bags (``globalize``, ``bag_lookup`` with its gradient,
the ragged and plain lookups, ``bag_update`` and ``bag_update_split``),
``optim.split_sgd``'s tree-wide step, and the first steps of each mode of
``examples/split_sgd_convergence_torch.py`` against the reference example's
``run``.  Inputs are numpy arrays from fixed seeds; the reference runs
jitted (its Pallas row kernels in interpret mode), the port runs its
kernels' plain versions, which is what its wrappers do with CPU tensors.

Held bit for bit: the bag gradient at bf16 and fp32 (duplicate ids added one
lookup at a time in the table's dtype), the scatter and fused updates, the
Split-SGD step with and without momentum.  Held within a tolerance: the bag
sums (1e-6 relative: the two sum a bag's P rows in fp32, in orders that may
differ) and whatever runs through the dense network (losses rtol 1e-5,
masters 1e-3 relative + 1e-5, the tolerances of
``tests/test_torch_hybrid.py``; bf16 weights within one bf16 ulp).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as j_dlrm
from repro.core import embedding as j_emb
from repro.optim import split_sgd as j_split
from repro_torch import weights
from repro_torch.core import embedding as t_emb
from repro_torch.optim import split_sgd as t_split
from repro_torch.optim.data_parallel import tree_leaves
from repro_torch.testing import bf16_ulps, to_numpy, to_torch

ROOT = Path(__file__).resolve().parents[1]
SPEC = dict(table_rows=(100, 37, 250, 13), dim=16)
B, P = 16, 6


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_EX = _load("split_sgd_convergence")
PORT_EX = _load("split_sgd_convergence_torch")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _ids(seed: int, dup: bool = True) -> np.ndarray:
    """[B, S, P] table-local ids; with ``dup`` most lookups fall on a few
    rows of each table, so rows repeat within and across bags."""
    rng = np.random.default_rng(seed)
    cols = []
    for m in SPEC["table_rows"]:
        c = rng.integers(0, m, (B, P))
        if dup:
            c = np.where(rng.random((B, P)) < 0.7, c % 3, c)
        cols.append(c)
    return np.stack(cols, axis=1).astype(np.int32)


def _table(seed: int, dtype) -> np.ndarray:
    spec = j_emb.EmbeddingSpec(**SPEC)
    W = np.random.default_rng(seed).standard_normal((spec.total_rows, SPEC["dim"]))
    return np.asarray(jnp.asarray(W, dtype))


def test_globalize_matches_reference():
    idx = _ids(0, dup=False)
    want = j_emb.globalize(j_emb.EmbeddingSpec(**SPEC), jnp.asarray(idx))
    got = t_emb.globalize(t_emb.EmbeddingSpec(**SPEC), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bag_lookup_value_and_grad_match_reference(dtype, weighted):
    """``jax.value_and_grad`` of ``sum(bag_lookup(W, g) * dY)`` against the
    port's autograd: the bags within 1e-6 relative, the table's gradient
    (in the table's dtype) bit for bit.  Three in four lookups fall on three
    rows of their table, so a row's bf16 gradient is a long chain of bf16
    adds; an fp32 sum of the same cotangents rounded once is not it."""
    spec = j_emb.EmbeddingSpec(**SPEC)
    W = _table(1, getattr(jnp, dtype))
    g = np.array(j_emb.globalize(spec, jnp.asarray(_ids(2))))
    rng = np.random.default_rng(3)
    dY = rng.standard_normal((B, len(SPEC["table_rows"]), SPEC["dim"])).astype(np.float32)
    wgt = rng.random(g.shape).astype(np.float32) if weighted else None

    def f(W):
        Y = j_emb.bag_lookup(W, jnp.asarray(g), None if wgt is None else jnp.asarray(wgt))
        return (Y * dY).sum(), Y

    (_, Y_ref), dW_ref = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(W))
    Wt = to_torch(W).requires_grad_()
    Y = t_emb.bag_lookup(Wt, torch.from_numpy(g), None if wgt is None else torch.from_numpy(wgt))
    (dW,) = torch.autograd.grad((Y * torch.from_numpy(dY)).sum(), [Wt])
    assert Y.dtype == torch.float32 and dW.dtype == Wt.dtype
    np.testing.assert_allclose(Y.detach().numpy(), np.asarray(Y_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_bits(dW), _bits(dW_ref))
    if dtype == "bfloat16" and not weighted:
        upd = torch.from_numpy(dY)[:, :, None, :].expand(*g.shape, SPEC["dim"])
        once = torch.zeros(dW.shape).index_add_(0, torch.from_numpy(g).long().reshape(-1),
                                               upd.to(torch.bfloat16).float().reshape(
                                                   -1, SPEC["dim"])).to(torch.bfloat16)
        assert not np.array_equal(_bits(once), _bits(dW_ref))  # the chain of bf16 adds shows


def test_ragged_and_plain_lookups_match_reference():
    spec = j_emb.EmbeddingSpec(**SPEC)
    W = _table(4, jnp.bfloat16)
    rng = np.random.default_rng(5)
    flat = rng.integers(0, spec.total_rows, 40).astype(np.int32)
    seg = np.sort(rng.integers(0, 7, 40)).astype(np.int32)
    want = j_emb.bag_lookup_ragged(jnp.asarray(W), jnp.asarray(flat), jnp.asarray(seg), 9)
    got = t_emb.bag_lookup_ragged(to_torch(W), torch.from_numpy(flat), torch.from_numpy(seg), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    idx = rng.integers(0, spec.total_rows, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        _bits(t_emb.lookup(to_torch(W), torch.from_numpy(idx))),
        _bits(j_emb.lookup(jnp.asarray(W), jnp.asarray(idx))))


@pytest.mark.parametrize("case", ["scatter-bf16", "scatter-fp32", "scatter-weighted", "fused",
                                  "fused-weighted", "split", "split-weighted"])
def test_bag_updates_match_reference(case):
    """``bag_update`` (scatter on a bf16 and an fp32 table, fused on fp32)
    and ``bag_update_split`` against the reference's under ``jax.jit`` (its
    fused paths the interpret-mode Pallas kernels) on ids with duplicates:
    bit for bit, but for the fused weighted cases, held within 1e-6
    relative + 1e-7 (as fp32 masters): under ``jit`` XLA contracts each of
    the interpret-mode kernel's ``acc + wgt * dY`` into an FMA, where the
    port's plain run sum rounds the product first."""
    spec = j_emb.EmbeddingSpec(**SPEC)
    g = np.array(j_emb.globalize(spec, jnp.asarray(_ids(6))))
    rng = np.random.default_rng(7)
    dY = np.asarray(jnp.asarray(rng.standard_normal((B, len(SPEC["table_rows"]), SPEC["dim"])),
                                jnp.bfloat16).astype(jnp.float32))
    wgt = rng.random(g.shape).astype(np.float32) if case.endswith("weighted") else None
    jw = None if wgt is None else jnp.asarray(wgt)
    tw = None if wgt is None else torch.from_numpy(wgt)
    lr = 0.05
    if case.startswith("split"):
        hi, lo = j_split.split_fp32(jnp.asarray(_table(8, jnp.float32)))
        want = jax.jit(lambda h, l: j_emb.bag_update_split(h, l, jnp.asarray(g),
                                                           jnp.asarray(dY), lr, jw))(hi, lo)
        got = t_emb.bag_update_split(to_torch(np.asarray(hi)), to_torch(np.asarray(lo)),
                                     torch.from_numpy(g), torch.from_numpy(dY), lr, tw)
        if wgt is not None:
            np.testing.assert_allclose(to_numpy(t_split.combine_split(*got)),
                                       np.asarray(j_split.combine_split(*want)), rtol=1e-6,
                                       atol=1e-7)
            return
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        return
    dtype = jnp.bfloat16 if case == "scatter-bf16" else jnp.float32
    method = "fused" if case.startswith("fused") else "scatter"
    W = _table(8, dtype)
    want = jax.jit(lambda W: j_emb.bag_update(W, jnp.asarray(g), jnp.asarray(dY), lr, jw,
                                              method=method))(jnp.asarray(W))
    got = t_emb.bag_update(to_torch(W), torch.from_numpy(g), torch.from_numpy(dY), lr, tw,
                           method=method)
    if case == "fused-weighted":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        return
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _dense_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"bot": {"w": [rng.standard_normal((8, 16)).astype(np.float32),
                          rng.standard_normal((16, 4)).astype(np.float32)],
                    "b": [rng.standard_normal(16).astype(np.float32),
                          rng.standard_normal(4).astype(np.float32)]},
            "emb": rng.standard_normal((50, 4)).astype(np.float32)}


@pytest.mark.parametrize("beta", [0.0, 0.9], ids=["plain", "momentum"])
def test_apply_updates_bitwise_against_jitted_reference(beta):
    """Three Split-SGD steps on a tree with bf16 gradients, with and without
    momentum, against ``jax.jit(apply_updates)``: every ``hi``, ``lo`` and
    momentum leaf bit for bit; ``init`` and ``materialize_fp32`` round trip."""
    params = _dense_tree(9)
    j_state = j_split.init(jax.tree.map(jnp.asarray, params), momentum=beta)
    t_state = weights.split_state_from_numpy(jax.tree.map(np.asarray, j_state), device="cpu")
    t_init = t_split.init(weights.params_from_numpy(params, device="cpu"), momentum=beta)
    for a, b in zip(tree_leaves(t_init.params.hi) + tree_leaves(t_init.params.lo),
                    tree_leaves(t_state.params.hi) + tree_leaves(t_state.params.lo)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (t_init.momentum is None) == (beta == 0.0)
    step = jax.jit(lambda s, g: j_split.apply_updates(s, g, 0.05, beta))
    for k in range(3):
        grads = jax.tree.map(lambda p: np.asarray(jnp.asarray(
            np.random.default_rng(10 + k).standard_normal(p.shape), jnp.bfloat16)), params)
        j_state = step(j_state, jax.tree.map(jnp.asarray, grads))
        t_state = t_split.apply_updates(t_state, weights.params_from_numpy(grads, "cpu"), 0.05,
                                        beta)
    got = weights.split_state_to_numpy(t_state)
    want = jax.tree.map(np.asarray, j_state)
    for part, wtree in (("hi", want.params.hi), ("lo", want.params.lo),
                        ("momentum", want.momentum)):
        for a, b in zip(jax.tree.leaves(got[part]), jax.tree.leaves(wtree)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    fp32 = t_split.materialize_fp32(t_state)
    for a, b in zip(tree_leaves(fp32), jax.tree.leaves(j_split.materialize_fp32(j_state))):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    again = t_split.init(fp32)
    for a, b in zip(tree_leaves(again.params.lo), tree_leaves(t_state.params.lo)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_update_leaf_returns_its_parts():
    hi, lo = t_split.split_fp32(torch.linspace(-1, 1, 24).reshape(4, 6))
    out = t_split.update_leaf(hi, lo, torch.ones(4, 6, dtype=torch.bfloat16), 0.5)
    assert len(out) == 2 and out[0] is hi and out[1] is lo
    mom = torch.zeros(4, 6)
    out = t_split.update_leaf(hi, lo, torch.ones(4, 6), 0.5, mom, 0.9)
    assert len(out) == 3 and bool((out[2] == 1).all())


def _ref_train(mode: str, steps: int):
    """The reference example's ``run`` (``examples/split_sgd_convergence.py``)
    with its final state returned as well, and its initial arrays."""
    cfg = j_dlrm.DLRMConfig(name="fig16", num_dense=32, bottom=(64, 16), top=(64, 32),
                            table_rows=(2000,) * 4, emb_dim=16, pooling=4, batch=512, lr=0.05)
    ke, kd = jax.random.split(jax.random.PRNGKey(0))
    W = jax.random.uniform(ke, (cfg.spec.total_rows, cfg.emb_dim), jnp.float32, -0.02, 0.02)
    params = {"emb": W, "dense": j_dlrm.init_dense_params(kd, cfg)}
    init = jax.tree.map(np.asarray, params)
    lr = 0.05
    if mode == "fp32":
        state = params
    elif mode in ("split", "split8"):
        state = j_split.init(params)
    else:
        state = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)

    def loss_fn(fwd_params, batch):
        g = j_emb.globalize(cfg.spec, batch["idx"])
        emb_out = j_emb.bag_lookup(fwd_params["emb"], g)
        logits = j_dlrm.forward_local(fwd_params["dense"], emb_out,
                                      batch["dense_x"].astype(jnp.bfloat16))
        return j_dlrm.bce_with_logits(logits, batch["labels"]).mean()

    @jax.jit
    def step(state, batch):
        if mode == "fp32":
            loss, g = jax.value_and_grad(loss_fn)(state, batch)
            return jax.tree.map(lambda p, gg: p - lr * gg, state, g), loss
        if mode == "bf16":
            loss, g = jax.value_and_grad(loss_fn)(state, batch)
            return jax.tree.map(lambda p, gg: (p.astype(jnp.float32) - lr * gg.astype(
                jnp.float32)).astype(jnp.bfloat16), state, g), loss
        loss, g = jax.value_and_grad(loss_fn)(state.params.hi, batch)
        new = j_split.apply_updates(state, g, lr)
        if mode == "split8":
            new = j_split.SplitSGDState(j_split.SplitParams(new.params.hi, jax.tree.map(
                lambda lo: lo & jnp.uint16(0xFF00), new.params.lo)), new.momentum)
        return new, loss

    from repro.data.synthetic import dlrm_stream
    losses = []
    for _, b in zip(range(steps), dlrm_stream(7, cfg)):
        y = ((b["idx"][:, 0, 0] % 2).astype(np.float32)
             + (b["dense_x"][:, 0] > 0).astype(np.float32)) >= 1.5
        b["labels"] = y.astype(np.float32)
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state)


FIG16_STEPS = 5


@pytest.mark.parametrize("mode", ["fp32", "split", "split8", "bf16"])
def test_fig16_first_steps_match_reference(mode):
    """Five steps of each mode from the reference's initial arrays (carried
    in through ``weights.params_from_numpy``): the losses within 1e-5
    relative; the split modes' fp32 masters and the fp32 weights within 1e-3
    relative + 1e-5; the bf16 mode's weights within one bf16 ulp.  The
    test's copy of the reference's loop gives the example's own losses bit
    for bit."""
    init, want_losses, want = _ref_train(mode, FIG16_STEPS)
    assert want_losses == REF_EX.run(mode, steps=FIG16_STEPS)
    losses, state = PORT_EX.train(mode, FIG16_STEPS, device="cpu",
                                  params=weights.params_from_numpy(init, "cpu"))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    if mode in ("split", "split8"):
        got = tree_leaves(t_split.materialize_fp32(state))
        ref = jax.tree.leaves(jax.tree.map(np.asarray, j_split.materialize_fp32(
            jax.tree.map(jnp.asarray, want))))
        if mode == "split8":
            assert all(not (_bits(lo).view(np.uint16) & 0xFF).any()
                       for lo in tree_leaves(state.params.lo))
    else:
        got, ref = tree_leaves(state), jax.tree.leaves(want)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if mode == "bf16":
            assert a.dtype == torch.bfloat16
            assert bf16_ulps(to_numpy(a), np.asarray(b, np.float32)).max() <= 1
        else:
            np.testing.assert_allclose(to_numpy(a), np.asarray(b, np.float32), rtol=1e-3,
                                       atol=1e-5)
