"""The port's LM training (``repro_torch.models.transformer.lm_loss``,
``repro_torch.models.lm_steps.make_lm_train_step``, the MoE dispatch and
combine backward, ``optim.split_sgd.update_leaf`` with momentum, the LM
state's numpy and checkpoint hand-off, ``data.synthetic.token_stream``)
against the JAX package, on the CPU.

The five archs run at ``tests/test_models.py::reduced`` sizes (4 layers,
d_model 64; MoE 8 experts, top 2), with ``loss_chunk`` 16 and
``attn_chunk`` 8 so that the loss and the attention run chunk by chunk
(L 32).  The state comes from the reference's ``init_lm_state`` through
``weights.lm_state_from_numpy``.

The tolerances.  The gradients are bf16, as the reference's (taken with
respect to the bf16 ``hi``), and the two packages round some bf16
cotangents in other places: JAX rounds a reduction of bf16 values (the
gates' cotangent summed over d, RMSNorm's weight gradient over the tokens)
at every add where PyTorch adds in fp32 and rounds once, and it adds a
leaf's cotangents from its uses in another order; jitted XLA on the CPU
also keeps some bf16 intermediates in fp32 (``--xla_allow_excess_precision``).
So each gradient leaf is held within 4e-2 of its largest value (2.7e-2
measured, internlm2's wq at the default flag; 2.6e-2 without it, deepseek's
q_norm) and the loss within 1e-3 (4.3e-4 measured, phi3 at the default
flag; 6.6e-5 without it).  The MoE archs
are held to the JAX run without excess precision (a subprocess): at the
default flag a router input one bf16 step away flips a top-k choice
(``tests/test_torch_lm.py``'s note).
The dispatch and combine Functions alone agree with ``jax.vjp`` of the
reference's ``custom_vjp`` gathers bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import synthetic as jsyn
from repro.launch.mesh import make_mesh
from repro.models import lm_steps as jlm
from repro.models import transformer as jtf
from repro.optim import split_sgd as jsplit
from repro_torch import weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.kernels import ref
from repro_torch.models import attention, lm_steps
from repro_torch.models import transformer as tf
from repro_torch.optim import split_sgd
from repro_torch.optim.data_parallel import tree_leaves, tree_map
from repro_torch.testing import to_numpy
from test_models import reduced
from test_torch_moe import _x

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["internlm2-1.8b", "gemma2-27b", "phi3-medium-14b", "qwen3-moe-30b-a3b",
         "deepseek-v2-236b"]
DENSE, MOE = NAMES[:3], NAMES[3:]
B, L = 2, 32
GRAD_TOL = 4e-2   # of each leaf's largest |g| (module note)
LOSS_TOL = 1e-3


def _cfg(name: str, **over) -> jtf.TransformerConfig:
    return dataclasses.replace(reduced(name), loss_chunk=16, attn_chunk=8, **over)


def _port_cfg(cfg: jtf.TransformerConfig) -> tf.TransformerConfig:
    return tf.TransformerConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(jtf.TransformerConfig)})


def _tokens(cfg, seed: int = 0, batch: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, L + 1)).astype(np.int32)


def _state_np(cfg, momentum: bool = True, seed: int = 0) -> dict:
    """A training state drawn with numpy in the reference's types and
    layout (``hi`` bf16, ``lo`` uint16, ``mom`` fp32 zeros): fp32 weights
    at the reference's scales (N(0, 1/fan-in), the embeddings 0.02; the
    norms' weights N(0, 0.1²), not its zeros, so that their gradients
    reach every value), split by truncation."""
    import ml_dtypes
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        scale = tree[1] ** -0.5 if len(tree) >= 3 else 0.02 if "embed" in name else 0.1
        return (rng.standard_normal(tree) * scale).astype(np.float32)

    w = draw(tf.param_shapes(_port_cfg(cfg)))
    bits = jax.tree.map(lambda a: a.view(np.uint32), w)
    state = {"hi": jax.tree.map(lambda b: (b >> 16).astype(np.uint16).view(ml_dtypes.bfloat16),
                                bits),
             "lo": jax.tree.map(lambda b: (b & 0xFFFF).astype(np.uint16), bits)}
    if momentum:
        state["mom"] = jax.tree.map(np.zeros_like, w)
    return state


def _port_grads(cfg, state_np, toks):
    """The port's loss and gradient leaves (fp32 numpy, pytree order)."""
    st = weights.lm_state_from_numpy(state_np, _port_cfg(cfg), device="cpu")
    params = tree_map(lambda t: t.detach().requires_grad_(), st["hi"])
    loss = tf.lm_loss(params, torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]),
                      _port_cfg(cfg))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    return float(loss.detach()), [to_numpy(g) for g in grads]


def _hold_grads(name, want_loss, want, got_loss, got) -> None:
    assert abs(got_loss - want_loss) <= LOSS_TOL, (name, got_loss, want_loss)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w).astype(np.float32)
        assert w.shape == g.shape, (name, i)
        top = float(np.abs(w).max())
        assert top > 0, (name, i)
        gap = float(np.abs(w - g).max())
        assert gap <= GRAD_TOL * top, f"{name} leaf {i}: {gap} against {top}"


_EXACT = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.models import transformer as jtf
with open({src!r}, "rb") as f:
    cases = pickle.load(f)
out = {{}}
for fields, state, toks in cases:
    cfg = jtf.TransformerConfig(**fields)
    t, l = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    hi = jax.tree.map(jnp.asarray, state["hi"])
    loss, g = jax.jit(jax.value_and_grad(lambda h: jtf.lm_loss(h, t, l, cfg)))(hi)
    out[cfg.name + "/loss"] = np.asarray(loss)
    for i, a in enumerate(jax.tree.leaves(g)):
        out[cfg.name + "/" + str(i)] = np.asarray(a).astype(np.float32)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _exact_run(tmp_path_factory):
    """Starts the subprocess of :func:`exact` with the module's first test,
    so that it runs beside the in-process cases."""
    import pickle
    tmp = tmp_path_factory.mktemp("exact")
    cases = [({**dataclasses.asdict(_cfg(n)), "dp_axes": ("data",)}, _state_np(_cfg(n)),
              _tokens(_cfg(n))) for n in MOE]
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    code = _EXACT.format(src=str(tmp / "cases.pkl"), path=str(tmp / "jax_grads.npz"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, tmp / "jax_grads.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def exact(_exact_run):
    """The MoE archs' JAX loss and gradients with XLA's excess precision
    off, in one subprocess (so that no other test sees the flag)."""
    proc, path = _exact_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return np.load(path)


@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_grads_match_jax(name, request):
    """``lm_loss`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's, from the same state and tokens (the module note's
    tolerances); the MoE archs against the subprocess without excess
    precision."""
    cfg = _cfg(name)
    st, toks = _state_np(cfg), _tokens(cfg)
    got_loss, got = _port_grads(cfg, st, toks)
    if name in MOE:
        exact = request.getfixturevalue("exact")
        want_loss = float(exact[name + "/loss"])
        want = [exact[f"{name}/{i}"] for i in range(len(got))]
    else:
        t, lab = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
        hi = jax.tree.map(jnp.asarray, st["hi"])
        loss, g = jax.jit(jax.value_and_grad(lambda h: jtf.lm_loss(h, t, lab, cfg)))(hi)
        want_loss, want = float(loss), jax.tree.leaves(g)
    _hold_grads(name, want_loss, want, got_loss, got)


def _master(hi, lo) -> np.ndarray:
    h = np.asarray(hi).view(np.uint16).astype(np.uint32) << 16
    return (h | np.asarray(lo).view(np.uint16).astype(np.uint32)).view(np.float32)


@pytest.mark.parametrize("mb,momentum", [(1, True), (2, True), (1, False), (2, False)])
def test_three_train_steps_match_the_reference(mb, momentum):
    """Three ``make_lm_train_step`` steps of reduced internlm2 cut to 2
    layers (lr 0.05, beta 0.9) against the reference's on a (1, 1) mesh,
    from one state and batch stream: each step's loss within 1e-3; after
    each step every leaf's update (its fp32 master ``combine(hi, lo)`` less
    the start's) within 4e-2 of that leaf's largest update and ``mom``
    within 4e-2 of its largest value (2.6e-2 and 2.5e-2 measured: the gradients' gaps of
    the module note, carried over the steps); the step trains in place."""
    cfg = _cfg("internlm2-1.8b", microbatch=mb, n_layers=2)
    Bt = 4
    mesh = make_mesh((1, 1), ("data", "model"))
    jstep, _, (ssh, bsh) = jlm.make_lm_train_step(cfg, mesh, Bt, L, lr=0.05, beta=0.9,
                                                  momentum=momentum)
    start = _state_np(cfg, momentum)
    st = jax.device_put(start, ssh)   # placed as the step's shardings: one compile
    port = weights.lm_state_from_numpy(start, _port_cfg(cfg), device="cpu")
    step, (structs, bstructs) = lm_steps.make_lm_train_step(_port_cfg(cfg), Bt, L, lr=0.05,
                                                            beta=0.9, momentum=momentum,
                                                            device="cpu")
    assert set(structs) == ({"hi", "lo", "mom"} if momentum else {"hi", "lo"})
    assert bstructs["tokens"] == ((Bt, L), torch.int32)
    w0 = [_master(h, lo) for h, lo in zip(jax.tree.leaves(start["hi"]),
                                          jax.tree.leaves(start["lo"]))]
    stream = jsyn.token_stream(7, cfg.vocab, Bt, L)
    for i in range(3):
        batch = next(stream)
        st, jloss = jstep(st, jax.device_put(batch, bsh))
        out, loss = step(port, batch)
        assert out is port
        assert abs(float(loss) - float(jloss)) <= LOSS_TOL, (i, float(loss), float(jloss))
        got = weights.lm_state_to_numpy(port)
        want = jax.tree.map(np.asarray, st)
        for j, (w_start, hj, lj, ht, lt) in enumerate(zip(
                w0, jax.tree.leaves(want["hi"]), jax.tree.leaves(want["lo"]),
                jax.tree.leaves(got["hi"]), jax.tree.leaves(got["lo"]))):
            dw, dg = _master(hj, lj) - w_start, _master(ht, lt) - w_start
            top = float(np.abs(dw).max())
            assert top > 0 and np.abs(dw - dg).max() <= 4e-2 * top, (i, j)
        if momentum:
            for j, (mj, mt) in enumerate(zip(jax.tree.leaves(want["mom"]),
                                             jax.tree.leaves(got["mom"]))):
                top = float(np.abs(mj).max())
                assert np.abs(mj - mt).max() <= 4e-2 * top, (i, j)


def test_microbatches_accumulate_bf16_gradients_as_the_reference():
    """``microbatch`` 2 runs two halves: the loss is their mean and the
    gradient ``(g1 + g2)`` rounded to bf16, then halved in bf16, as the
    reference's scan accumulates; the port's step is that, from its own
    half-batch gradients, bit for bit."""
    cfg = _port_cfg(_cfg("phi3-medium-14b", n_layers=2))
    st = lm_steps.init_lm_state(cfg, torch.Generator().manual_seed(0), device="cpu",
                                momentum=False)
    toks = torch.from_numpy(_tokens(cfg, seed=3, batch=4))
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        params = tree_map(lambda t: t.detach().requires_grad_(), st["hi"])
        loss = tf.lm_loss(params, toks[rows, :-1], toks[rows, 1:], cfg)
        halves.append((loss.detach(), torch.autograd.grad(loss, tree_leaves(params))))
    w0 = [split_sgd.combine_split(h, lo) for h, lo in
          zip(tree_leaves(st["hi"]), tree_leaves(st["lo"]))]
    step, _ = lm_steps.make_lm_train_step(dataclasses.replace(cfg, microbatch=2), 4, L, lr=0.5,
                                          momentum=False, device="cpu")
    _, loss = step(st, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert float(loss) == float((halves[0][0] + halves[1][0]) / 2)
    for w, g1, g2, h, lo in zip(w0, halves[0][1], halves[1][1], tree_leaves(st["hi"]),
                                tree_leaves(st["lo"])):
        g = (g1 + g2) / 2
        assert g.dtype == torch.bfloat16
        hi_w, lo_w = split_sgd.split_fp32(w.reshape(-1))
        ref.split_sgd(hi_w, lo_w, g.reshape(-1), 0.5)
        assert torch.equal(h.reshape(-1).view(torch.int16), hi_w.view(torch.int16))
        assert torch.equal(lo.reshape(-1), lo_w)


@pytest.mark.parametrize("shape", [(1001,), (3, 5, 7), (2, 64, 33)])
@pytest.mark.parametrize("gdtype", [np.float32, "bfloat16"])
def test_update_leaf_with_momentum_is_bitwise_the_jitted_reference(shape, gdtype,
                                                                   monkeypatch):
    """``update_leaf`` with momentum (and without) on a flat leaf of odd
    length and on stacked leaves, the gradient fp32 or bf16, the CPU's
    chunks cut to 100 values (so that a leaf takes several and a ragged
    last one): ``hi``, ``lo`` and ``mom`` bit for bit the jitted
    ``repro.optim.split_sgd.update_leaf`` (which contracts ``beta * mom +
    g`` and ``w - lr * mom`` into FMAs)."""
    monkeypatch.setattr(split_sgd, "CPU_CHUNK", 100)
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    if gdtype == "bfloat16":
        g = np.asarray(jnp.asarray(g, jnp.bfloat16))
    m = rng.standard_normal(shape).astype(np.float32) * 1e-2
    hi, lo = jsplit.split_fp32(jnp.asarray(w))
    for mom in (m, None):
        if mom is None:
            want = jax.jit(lambda h, lo_, gg: jsplit.update_leaf(h, lo_, gg, 0.05))(
                hi, lo, jnp.asarray(g))
        else:
            want = jax.jit(lambda h, lo_, gg, mm: jsplit.update_leaf(h, lo_, gg, 0.05, mm, 0.9))(
                hi, lo, jnp.asarray(g), jnp.asarray(mom))
        th, tl = weights.to_torch(np.asarray(hi)), weights.to_torch(np.asarray(lo))
        tm = None if mom is None else torch.from_numpy(mom.copy())
        got = split_sgd.update_leaf(th, tl, weights.to_torch(g), 0.05, tm, 0.9)
        assert got[0] is th and got[1] is tl
        assert np.array_equal(to_numpy(th.view(torch.int16)),
                              np.asarray(want[0]).view(np.int16))
        assert np.array_equal(to_numpy(tl).view(np.uint16), np.asarray(want[1]))
        if mom is not None:
            assert got[2] is tm and np.array_equal(to_numpy(tm), np.asarray(want[2]))


def _layer(name: str):
    """One MoE layer of the reduced config at capacity factor 1.0 (pairs
    drop), drawn with numpy in bf16: the JAX config, its leaves and the
    port's."""
    cfg = dataclasses.replace(_cfg(name), capacity_factor=1.0)
    tree = tf.param_shapes(_port_cfg(cfg))["layers"]["moe"]
    rng = np.random.default_rng(1)
    draw = lambda t: {k: draw(v) if isinstance(v, dict) else  # noqa: E731
                      np.asarray(jnp.asarray(rng.standard_normal(v[1:]) * v[1] ** -0.5,
                                             jnp.bfloat16)) for k, v in t.items()}
    p = draw(tree)
    return cfg, jax.tree.map(jnp.asarray, p), weights.params_from_numpy(p, device="cpu")


def _ref_slots(x, router, cfg):
    """The reference's dispatch indices (``transformer.py:385-408``)."""
    Bx, Lx, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = min(max(8, int(np.ceil(Lx * k * cfg.capacity_factor / E))), Lx * k)
    probs = jax.nn.softmax(jnp.einsum("bld,de->ble", x.astype(jnp.float32),
                                      router.astype(jnp.float32)), axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    ef = eidx.reshape(Bx, Lx * k)
    oh = jax.nn.one_hot(ef, E, dtype=jnp.int32)
    slot = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - oh, ef[..., None], -1)[..., 0]
    dest = jnp.where(slot < C, ef * C + slot, E * C)
    src_pair = jnp.full((Bx, E * C), Lx * k, jnp.int32).at[jnp.arange(Bx)[:, None], dest].set(
        jnp.broadcast_to(jnp.arange(Lx * k, dtype=jnp.int32)[None], (Bx, Lx * k)))
    return C, dest, src_pair, jnp.minimum(src_pair // k, Lx - 1), src_pair < Lx * k


def test_dispatch_and_combine_backward_are_the_reference_gathers():
    """The MoE dispatch and combine Functions against ``jax.vjp`` of the
    reference's ``_moe_dispatch`` / ``_moe_combine`` at capacity factor 1.0
    (pairs drop), random cotangents: forward and backward bit for bit (the
    port's buffer is expert-major, [E, B*C, d], the reference's [B, E*C,
    d]: compared after a transpose); a dropped pair's cotangent is zero."""
    cfg, p, tp = _layer("qwen3-moe-30b-a3b")
    pcfg = _port_cfg(cfg)
    xj, xt = _x(cfg, L)
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    C, dest, src_pair, tok, filled = jax.jit(lambda x, r: _ref_slots(x, r, cfg))(xj, p["router"])
    C = int(C)
    _, _, _, keep, tdest, tC = tf.moe_route(xt, tp["router"], pcfg)
    assert tC == C and np.array_equal(to_numpy(tdest), np.asarray(dest))
    assert not bool(keep.all())
    rows, tfilled, at, src_row = tf.moe_slots(tdest, L, k, E, C)
    rng = np.random.default_rng(4)

    def to_port(a):      # [B, E*C, d] -> [E, B*C, d]
        return np.asarray(a).reshape(B, E, C, d).transpose(1, 0, 2, 3).reshape(E, B * C, d)

    # dispatch
    ct = jnp.asarray(rng.standard_normal((B, E * C, d)), jnp.bfloat16)
    buf, vjp = jax.vjp(lambda x: jtf._moe_dispatch(k, x, tok, filled, dest), xj)
    (dx,) = vjp(ct)
    x = xt.detach().requires_grad_()
    tbuf = tf._Dispatch.apply(x, rows, tfilled, at, keep, k)
    (tdx,) = torch.autograd.grad(tbuf, [x], weights.to_torch(to_port(ct)))
    assert np.array_equal(to_numpy(tbuf), to_port(buf).astype(np.float32))
    assert np.array_equal(to_numpy(tdx), np.asarray(dx).astype(np.float32))
    # combine
    out = jnp.asarray(rng.standard_normal((B, E * C, d)), jnp.bfloat16)
    cy = jnp.asarray(rng.standard_normal((B, L * k, d)), jnp.bfloat16)
    y, vjp = jax.vjp(lambda o: jtf._moe_combine(k, o, dest, src_pair), out)
    (dout,) = vjp(cy)
    o = weights.to_torch(to_port(out)).requires_grad_()
    ty = tf._Combine.apply(o, at, keep, src_row, tfilled)
    (tdout,) = torch.autograd.grad(ty, [o], weights.to_torch(np.asarray(cy)))
    assert np.array_equal(to_numpy(ty), np.asarray(y).astype(np.float32))
    assert not to_numpy(ty)[~to_numpy(keep)].any()
    assert np.array_equal(to_numpy(tdout), to_port(dout).astype(np.float32))


@pytest.mark.parametrize("name", MOE)
def test_moe_block_backward_matches_jax(name):
    """``moe_block``'s gradients (x, the router, the experts, deepseek's
    shared expert) against ``jax.vjp`` of the reference's at capacity
    factor 1.0 (pairs drop), one cotangent: the routed experts' ``wd`` and
    ``wu`` bit for bit; every gradient within 1e-2 of its largest value
    (7.3e-3 measured, x: JAX rounds the gates' cotangent, a bf16 sum over
    d, at every add, and sums x's three cotangents in another order); two
    backward runs bit for bit."""
    cfg, p, tp = _layer(name)
    xj, xt = _x(cfg, L)
    ct = jnp.asarray(np.random.default_rng(5).standard_normal((B, L, cfg.d_model)), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, q: jtf.moe_block(x, q, cfg), xj, p)
    dx, dp = jax.jit(vjp)(ct)
    want = [dx] + jax.tree.leaves(dp)
    names = ["x"] + [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(dp)]
    runs = []
    for _ in range(2):
        params = tree_map(lambda t: t.detach().requires_grad_(), tp)
        x = xt.detach().requires_grad_()
        y = tf.moe_block(x, params, _port_cfg(cfg))
        runs.append(torch.autograd.grad(y, [x] + tree_leaves(params),
                                        weights.to_torch(np.asarray(ct))))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for n, w, g in zip(names, want, runs[0]):
        w, g = np.asarray(w).astype(np.float32), to_numpy(g)
        if n in ("['wd']", "['wu']"):
            assert np.array_equal(w, g), n
        assert np.abs(w - g).max() <= 1e-2 * np.abs(w).max(), n


def test_chunked_attention_remat_keeps_the_gradients():
    """Per-chunk rematerialisation changes no value: the gradients with and
    without it bit for bit (gemma2's local window and soft-cap, GQA)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen).to(torch.bfloat16)
               for s in ((2, 4, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16)))
    ct = torch.randn((2, 4, 32, 16), generator=gen).to(torch.bfloat16)
    out = []
    for remat in (True, False):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = attention.chunked_attention(qq, kk, vv, window=12, softcap=50.0, bq=8, remat=remat)
        out.append((o, *torch.autograd.grad(o, [qq, kk, vv], ct)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    with torch.no_grad():
        served = attention.chunked_attention(q, k, v, window=12, softcap=50.0, bq=8)
    assert torch.equal(served, out[0][0])


def test_training_refuses_the_flash_kernel():
    """Training needs the chunked path: ``lm_loss`` and
    ``make_lm_train_step`` refuse ``attn_impl="pallas"``, naming queue 3."""
    cfg = dataclasses.replace(_port_cfg(_cfg("internlm2-1.8b")), attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="queue 3"):
        lm_steps.make_lm_train_step(cfg, B, L, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        tf.lm_loss({}, torch.zeros((B, L), dtype=torch.int32),
                   torch.zeros((B, L), dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="microbatches"):
        lm_steps.make_lm_train_step(_port_cfg(_cfg("internlm2-1.8b", microbatch=3)), 4, L,
                                    device="cpu")


def test_token_stream_is_the_reference_byte_for_byte():
    ours, theirs = synthetic.token_stream(3, 92544, 4, 64), jsyn.token_stream(3, 92544, 4, 64)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            assert a[key].tobytes() == b[key].tobytes()
        assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("name", ["gemma2-27b", "deepseek-v2-236b"])
def test_lm_state_round_trips_bit_for_bit(name):
    """The reference's ``init_lm_state`` -> ``lm_state_from_numpy`` ->
    ``lm_state_to_numpy`` gives back its arrays bit for bit in their types
    (bf16, uint16, fp32); a leaf of another shape is refused.  The port's own
    ``init_lm_state`` splits fp32 draws: ``hi`` is the truncated upper half,
    not the bf16 rounding."""
    cfg = _cfg(name, n_layers=2)
    if name == "gemma2-27b":   # the reference's own draw
        mesh = make_mesh((1, 1), ("data", "model"))
        snp = jax.tree.map(np.asarray, jlm.init_lm_state(jax.random.PRNGKey(0), cfg, mesh))
    else:
        snp = _state_np(cfg)
    port = weights.lm_state_from_numpy(snp, _port_cfg(cfg), device="cpu")
    back = weights.lm_state_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(snp)
    for a, b in zip(jax.tree.leaves(snp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    bad = jax.tree.map(lambda a: a, snp)
    bad["lo"]["embed"] = bad["lo"]["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        weights.lm_state_from_numpy(bad, _port_cfg(cfg), device="cpu")
    own = lm_steps.init_lm_state(_port_cfg(cfg), torch.Generator().manual_seed(0), device="cpu")
    w = split_sgd.combine_split(own["hi"]["embed"], own["lo"]["embed"])
    assert torch.equal(own["hi"]["embed"].view(torch.int16),
                       (w.view(torch.int32) >> 16).to(torch.int16))
    assert not torch.equal(own["hi"]["embed"], w.to(torch.bfloat16))
    assert not any(m.any() for m in tree_leaves(own["mom"]))


def test_lm_checkpoints_restore_in_either_package(tmp_path):
    """An LM training state (``hi``, ``lo``, ``mom``) checkpointed by either
    package's ``CheckpointManager`` (format v2) restores in the other, bit
    for bit."""
    cfg = _cfg("qwen3-moe-30b-a3b", n_layers=2)
    st = jax.tree.map(jnp.asarray, _state_np(cfg))
    JCheckpointManager(tmp_path / "jax").save(4, st, blocking=True)
    like = lm_steps.init_lm_state(_port_cfg(cfg), torch.Generator().manual_seed(1), device="cpu")
    step, got = CheckpointManager(tmp_path / "jax").restore(like, device="cpu")
    assert step == 4
    want = jax.tree.map(np.asarray, st)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(weights.lm_state_to_numpy(got))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    own = lm_steps.init_lm_state(_port_cfg(cfg), torch.Generator().manual_seed(2), device="cpu")
    CheckpointManager(tmp_path / "port").save(9, own, blocking=True)
    step, back = JCheckpointManager(tmp_path / "port").restore(st, verify=True)
    assert step == 9
    for a, b in zip(jax.tree.leaves(weights.lm_state_to_numpy(own)), jax.tree.leaves(back)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
