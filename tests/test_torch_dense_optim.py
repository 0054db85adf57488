"""The port's dense optimizers (``repro_torch.optim.sgd`` and
``repro_torch.optim.adamw``) against the JAX package's, jitted, on the CPU:
five steps of random gradients over a tree of an fp32 matrix, an fp32
vector of odd length and (SGD) a bf16 leaf, every leaf and moment bit for
bit.  The port rounds as jitted XLA does: FMAs where XLA contracts,
``(m / c1) / d`` as ``m / (c1 * d)``, a correctly rounded square root.
The reference's own test of them is ``tests/test_split_sgd.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch import weights
from repro_torch.optim import adamw, sgd
from repro_torch.optim.data_parallel import tree_leaves

STEPS = 5


def _params(bf16: bool) -> dict:
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": {"c": rng.standard_normal(1001).astype(np.float32)}}
    if bf16:
        p["d"] = np.asarray(jnp.asarray(rng.standard_normal((8, 9)), jnp.bfloat16))
    return p


def _grads(p: dict, rng) -> dict:
    """Gradients of each leaf's shape at a scale from 1e-4 to 10, fp32."""
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                   * 10 ** rng.uniform(-4, 1)).astype(np.float32), p)


def _same(a, b: torch.Tensor) -> bool:
    """A JAX array and a port tensor hold the same bits in matching types
    (uint16 as the port's int16, bf16, fp32)."""
    a = np.asarray(a)
    if b.dtype == torch.int16:
        return a.dtype == np.uint16 and a.tobytes() == b.numpy().tobytes()
    if b.dtype == torch.bfloat16:
        return a.dtype.name == "bfloat16" and a.tobytes() == b.view(torch.int16).numpy().tobytes()
    return a.dtype == np.float32 and a.tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("momentum", [False, True])
def test_sgd_is_bitwise_the_jitted_reference(momentum):
    """``p - lr * g`` (one rounding), cast back to each leaf's dtype; with
    momentum ``m = beta * m + g`` first (one rounding) and the step by
    ``m``."""
    p = _params(bf16=True)
    rng = np.random.default_rng(1)
    jp, tp = jax.tree.map(jnp.asarray, p), weights.params_from_numpy(p, device="cpu")
    jm = jsgd.init_momentum(jp) if momentum else None
    tm = sgd.init_momentum(tp) if momentum else None
    step = jax.jit(lambda q, g, m: jsgd.apply_updates(q, g, 0.05, m, 0.9))
    for _ in range(STEPS):
        g = _grads(p, rng)
        out = step(jp, jax.tree.map(jnp.asarray, g), jm)
        tout = sgd.apply_updates(tp, weights.params_from_numpy(g, device="cpu"), 0.05, tm, 0.9)
        (jp, jm), (tp, tm) = (out, tout) if momentum else ((out, None), (tout, None))
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert _same(a, b)
        for a, b in zip(jax.tree.leaves(jm), tree_leaves(tm)):
            assert _same(a, b)
    assert tree_leaves(tp)[-1].dtype == torch.bfloat16


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_is_bitwise_the_jitted_reference(split, weight_decay):
    """AdamW (lr 1e-3, b1 0.9, b2 0.999, eps 1e-8) with the weights split
    into ``hi`` / ``lo`` (the paper's C5) or kept in fp32: the weights, both
    moments and the count bit for bit after each step."""
    p = _params(bf16=False)
    rng = np.random.default_rng(2)
    js = jadamw.init(jax.tree.map(jnp.asarray, p), split=split)
    ts = adamw.init(weights.params_from_numpy(p, device="cpu"), split=split)
    assert ts.split == split and int(ts.count) == 0
    step = jax.jit(lambda s, g: jadamw.apply_updates(s, g, 1e-3, weight_decay=weight_decay))
    for _ in range(STEPS):
        g = _grads(p, rng)
        js = step(js, jax.tree.map(jnp.asarray, g))
        ts = adamw.apply_updates(ts, weights.params_from_numpy(g, device="cpu"), 1e-3,
                                 weight_decay=weight_decay)
        assert int(ts.count) == int(js.count)
        pairs = [(js.m, ts.m), (js.v, ts.v)]
        pairs += ([(js.params.hi, ts.params.hi), (js.params.lo, ts.params.lo)] if split
                  else [(js.params, ts.params)])
        for jt, tt in pairs:
            for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
                assert _same(a, b)
    if split:
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(ts.params.hi))
        assert all(t.dtype == torch.int16 for t in tree_leaves(ts.params.lo))
    assert all(bool(t.any()) for t in tree_leaves(ts.m))
