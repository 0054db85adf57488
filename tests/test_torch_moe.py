"""The port's MoE block (``repro_torch.models.transformer.moe_block`` and its
router ``moe_route``) against the JAX package's ``moe_block`` at
``capacity_factor=1.0``, where pairs drop: the reduced qwen3-moe and
deepseek-v2 configs of ``tests/test_models.py::reduced`` (8 experts, top 2,
d_model 64; deepseek's shared expert), one layer's parameters drawn by
``repro.models.transformer.init_params`` and cast to bf16.

The reference's ``moe_block`` returns only its output, so its kept set and
slots are read from its own routing lines (``transformer.py:381-396``),
copied below and jitted.  Both routers compute the same fp32 logits and
softmax, so on these inputs the kept pairs and their slots agree exactly;
the outputs agree bit for bit (held within one bf16 step, 2^-7 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.models import transformer as tf
from repro_torch.testing import assert_close, to_numpy

from test_torch_lm import _port_cfg, _reduced

B, L = 2, 32


def _ref_route(x, router, cfg):
    """The reference's routing (``repro/models/transformer.py:381-396``):
    gates, experts, slots and the kept mask."""
    Bx, Lx, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = min(max(8, int(np.ceil(Lx * k * cfg.capacity_factor / E))), Lx * k)
    logits = jnp.einsum("bld,de->ble", x.astype(jnp.float32), router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    ef = eidx.reshape(Bx, Lx * k)
    oh = jax.nn.one_hot(ef, E, dtype=jnp.int32)
    pos = jnp.cumsum(oh, axis=1) - oh
    slot = jnp.take_along_axis(pos, ef[..., None], -1)[..., 0]
    return gate, eidx, slot, slot < C


def _layer(name: str, cf: float, seed: int = 0):
    """One MoE layer of the reduced config at capacity factor ``cf``: the
    JAX config, its bf16 ``moe`` leaves and the port's."""
    cfg = dataclasses.replace(_reduced(name), capacity_factor=cf)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                     jtf.init_params(jax.random.PRNGKey(seed), cfg))["layers"]["moe"]
    p = jax.tree.map(lambda a: a[0], p)
    tp = weights.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return cfg, p, tp


def _x(cfg, Lx: int, seed: int = 0):
    """Inputs of RMSNorm's scale, [B, Lx, d] in bf16, in both packages."""
    x = np.random.default_rng(seed).standard_normal((B, Lx, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, weights.to_torch(np.asarray(xj))


@pytest.mark.parametrize("name,Lx", [("qwen3-moe-30b-a3b", L), ("deepseek-v2-236b", L),
                                     ("qwen3-moe-30b-a3b", 1)])
def test_moe_block_matches_jax_where_pairs_drop(name, Lx):
    """At ``capacity_factor=1.0`` and L 32 (C = 8, the mean load) some
    pairs drop: the port keeps exactly the reference's pairs, in the same
    slots, with the same experts and gates (fp32, within 1e-6), and its
    output is the reference's within one bf16 step.  At L 1 (decode) C =
    min(8, k) and nothing drops."""
    cfg, p, tp = _layer(name, 1.0)
    xj, xt = _x(cfg, Lx)
    gate, eidx, slot, keep = jax.jit(lambda x, r: _ref_route(x, r, cfg))(xj, p["router"])
    tgate, teidx, tslot, tkeep, dest, C = tf.moe_route(xt, tp["router"], _port_cfg(cfg))
    assert C == min(max(8, int(np.ceil(Lx * cfg.top_k / cfg.n_experts))), Lx * cfg.top_k)
    assert np.array_equal(to_numpy(teidx), np.asarray(eidx))
    assert np.array_equal(to_numpy(tkeep), np.asarray(keep))
    assert np.array_equal(to_numpy(tslot), np.asarray(slot))
    kept = to_numpy(tkeep)
    assert (not kept.all()) == (Lx > 1), f"{int((~kept).sum())} of {kept.size} pairs dropped"
    ef = to_numpy(teidx).reshape(B, -1)
    assert np.array_equal(to_numpy(dest), np.where(kept, ef * C + to_numpy(tslot), cfg.n_experts * C))
    assert_close(tgate, np.asarray(gate), rtol=0, atol=1e-6, what="gates")
    want = np.asarray(jax.jit(lambda x, q: jtf.moe_block(x, q, cfg))(xj, p)).astype(np.float32)
    got = tf.moe_block(xt, tp, _port_cfg(cfg))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, Lx, cfg.d_model)
    assert_close(got, want, rtol=2 ** -7, atol=2 ** -7, what="moe_block")


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each value of ``v``."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def test_dropped_pairs_add_nothing():
    """A dropped pair contributes nothing: the output with capacity cut to
    the mean load differs from the no-drop output exactly at the tokens
    that lost a pair, and there by that pair's gated expert output alone
    (recomputed directly: SwiGLU of the token through its expert, times its
    gate), within the two outputs' bf16 steps at their own values (up to
    0.25 at values near 50) and 2^-7 of each lost term."""
    cfg, _, tp = _layer("qwen3-moe-30b-a3b", 1.0)
    pcfg = _port_cfg(cfg)
    _, xt = _x(cfg, L, seed=2)
    drop = tf.moe_block(xt, tp, pcfg).float()
    full = tf.moe_block(xt, tp, dataclasses.replace(pcfg, capacity_factor=8.0)).float()
    gate, eidx, _, keep, _, _ = tf.moe_route(xt, tp["router"], pcfg)
    lost = ~keep.view(B, L, cfg.top_k)
    assert lost.any()
    hit = lost.any(-1)
    assert torch.equal(drop[~hit], full[~hit])
    for b, t in hit.nonzero().tolist():
        miss, size = torch.zeros(cfg.d_model), torch.zeros(cfg.d_model)
        for r in lost[b, t].nonzero()[:, 0].tolist():
            e = int(eidx[b, t, r])
            y = tf.swiglu(xt[b, t][None], tp["wg"][e], tp["wu"][e], tp["wd"][e])[0].float()
            miss += float(gate[b, t, r]) * y
            size += (float(gate[b, t, r]) * y).abs()
        tol = _ulp(full[b, t]) + _ulp(drop[b, t]) + 2 ** -7 * size
        assert ((full[b, t] - drop[b, t] - miss).abs() <= tol).all(), f"token ({b}, {t})"


def test_router_ties_take_the_lower_expert_first():
    """Tied probabilities: every router column the same (all E tie) and two
    duplicated columns (experts 2 and 5 tie): the port picks
    ``jax.lax.top_k``'s experts in its order, the lower expert first."""
    cfg, p, _ = _layer("qwen3-moe-30b-a3b", 8.0)
    xj, xt = _x(cfg, L, seed=1)
    r = np.asarray(p["router"]).astype(np.float32)
    flat = np.repeat(r[:, :1], cfg.n_experts, axis=1)
    dup = r.copy()
    dup[:, 5] = r[:, 2]
    for router in (flat, dup):
        rj = jnp.asarray(router, jnp.bfloat16)
        _, eidx, _, _ = jax.jit(lambda x, q: _ref_route(x, q, cfg))(xj, rj)
        _, teidx, _, _, _, _ = tf.moe_route(xt, weights.to_torch(np.asarray(rj)), _port_cfg(cfg))
        assert np.array_equal(to_numpy(teidx), np.asarray(eidx))
    e = to_numpy(teidx).reshape(-1, cfg.top_k)
    both = (e == 2).any(-1) & (e == 5).any(-1)
    assert both.sum() > 0 and (e[both] == [2, 5]).all()   # top k = 2: the tied pair alone
    _, teidx, _, _, _, _ = tf.moe_route(
        xt, weights.to_torch(np.asarray(jnp.asarray(flat, jnp.bfloat16))), _port_cfg(cfg))
    assert (to_numpy(teidx) == np.arange(cfg.top_k)).all()
