"""The port's EGNN (``repro_torch/models/egnn.py``, ``models/egnn_steps.py``,
``configs/egnn_arch.py``) against the reference's on one rank, at a small
size (2 layers, hidden 16): the same inputs, made with numpy from a seed,
and the reference's parameters and states carried across through
``weights.egnn_*_from_numpy``.

Tolerances: the logits within ``LOGIT_TOL`` of their largest magnitude and
the loss within ``LOSS_RTOL`` relative (both packages take fp32 products of
bf16 values and round h to bf16 after each layer; the forward measured
1e-8 apart); each step's update of each leaf (fp32 masters less the
start's) within ``UPDATE_TOL`` of that leaf's largest update.  The full
graph steps measured bit for bit; the minibatch step's weight gradients
sum the graphs' rows in another order than the reference's ``vmap``, so a
bf16 gradient value rounds the other way here and there (updates 2e-3
apart, the third loss 2.4e-5 relative).  The E(n)-invariance check within
the reference's own 2e-2.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import egnn_arch as r_arch
from repro.data.graph import NeighborSampler, random_powerlaw_graph
from repro.launch.mesh import make_mesh
from repro.models import egnn as R
from repro.models import egnn_steps as RS
from repro_torch import weights
from repro_torch.configs import egnn_arch as t_arch
from repro_torch.models import egnn as T
from repro_torch.models import egnn_steps as TS
from repro_torch.optim.data_parallel import tree_leaves

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-4
UPDATE_TOL = 1e-2
SMALL = dict(name="t", n_layers=2, d_hidden=16, d_feat=12, n_classes=5)


def cfgs(**over):
    kw = {**SMALL, **over}
    return R.EGNNConfig(**kw), T.EGNNConfig(**kw)


def struct_leaves(tree) -> list:
    """The ``(shape, dtype)`` leaves of a struct tree, in pytree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in struct_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in struct_leaves(t)]
    return [tree]


def master(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi).view(np.uint16).astype(np.uint32) << 16)
            | np.asarray(lo).astype(np.uint32)).view(np.float32)


def update_gaps(ref_prev: dict, ref: dict, prev: dict, mine: dict) -> list:
    """Each leaf's largest gap between the reference's step (``ref_prev`` to
    ``ref``) and the port's (``prev`` to ``mine``), over the reference's
    largest update of the leaf."""
    out = []
    for h0, l0, h1, l1, h2, l2, h3, l3 in zip(*(tree_leaves(s[k]) for s in
                                                (ref_prev, ref, prev, mine)
                                                for k in ("hi", "lo"))):
        d_ref = master(h1, l1) - master(h0, l0)
        d_mine = master(h3, l3) - master(h2, l2)
        out.append(float(np.abs(d_ref - d_mine).max()) / max(float(np.abs(d_ref).max()), 1e-30))
    return out


def graph_inputs(rng, n_nodes: int, n_edges: int, d_feat: int, n_real_edges: int):
    return {"feats": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
            "coords": rng.standard_normal((n_nodes, 3)).astype(np.float32),
            "src": rng.integers(0, n_nodes, n_edges).astype(np.int32),
            "dst": rng.integers(0, n_nodes, n_edges).astype(np.int32),
            "edge_mask": (np.arange(n_edges) < n_real_edges).astype(np.float32)}


FORWARD_CASES = {"node": {}, "masked edges": {"masked": True},
                 "static coordinates": {"update_coords": False},
                 "graph level": {"graph_level": True, "n_classes": 1}}


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_forward_and_loss_match_the_reference(case):
    over = dict(FORWARD_CASES[case])
    masked = over.pop("masked", False)
    rcfg, tcfg = cfgs(**over)
    params = jax.tree.map(np.asarray, R.init_egnn_params(jax.random.PRNGKey(3), rcfg))
    tparams = weights.egnn_params_from_numpy(params, tcfg, "cpu")
    rng = np.random.default_rng(5)
    N, E = 40, 150
    b = graph_inputs(rng, N, E, rcfg.d_feat, 120 if masked else E)
    if not masked:
        del b["edge_mask"]
    if rcfg.graph_level:
        b.update(graph_ids=(np.arange(N) // 10).astype(np.int32),
                 targets=rng.standard_normal(4).astype(np.float32), n_graphs=4)
    else:
        b.update(labels=rng.integers(0, rcfg.n_classes, N).astype(np.int32),
                 label_mask=(rng.random(N) < 0.7).astype(np.float32))
    args = ("feats", "coords", "src", "dst")
    want = np.asarray(R.egnn_forward(params, *(b[k] for k in args), rcfg, b.get("edge_mask")))
    tb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
    got = T.egnn_forward(tparams, *(tb[k] for k in args), tcfg, tb.get("edge_mask")).numpy()
    assert got.shape == want.shape == (N, rcfg.n_classes)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    want_loss = float(R.egnn_loss(params, b, rcfg))
    got_loss = float(T.egnn_loss(tparams, tb, tcfg))
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)


def test_forward_is_invariant_under_rotation_and_translation():
    """``tests/test_models.py``'s E(n) check on the port: rotated and moved
    coordinates give the same logits, within the reference's 2e-2."""
    _, cfg = cfgs(d_feat=8, n_classes=3)
    params = T.init_egnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    N, E = 20, 60
    feats = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    coords = torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    out = T.egnn_forward(params, feats, coords, src, dst, cfg)
    assert out.shape == (N, 3) and bool(torch.isfinite(out).all())
    th = 0.7
    rot = torch.tensor([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                       dtype=torch.float32)
    out2 = T.egnn_forward(params, feats, coords @ rot.T + 5.0, src, dst, cfg)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=2e-2, atol=2e-2)


def _fullgraph_case(rcfg, n_nodes, n_edges, G, rng):
    """A global padded batch of ``fullgraph_batch_structs`` at one rank:
    the padded nodes unlabelled, the last 10 edges masked."""
    N, E = -(-n_nodes // 8) * 8, n_edges
    b = graph_inputs(rng, N, E, rcfg.d_feat, E - 10)
    b["src"] %= n_nodes
    b["dst"] %= n_nodes
    b["feats"] = b["feats"].astype(ml_dtypes.bfloat16)
    if G:
        b.update(graph_ids=np.minimum(np.arange(N) * G // n_nodes, G - 1).astype(np.int32),
                 targets=rng.standard_normal(G).astype(np.float32))
    else:
        b.update(labels=rng.integers(0, rcfg.n_classes, N).astype(np.int32),
                 label_mask=((np.arange(N) < n_nodes) & (rng.random(N) < 0.8)).astype(np.float32))
    return b


def _minibatch(rcfg, G, rng, seed):
    graph = random_powerlaw_graph(500, 5000, seed=seed)
    s = NeighborSampler(graph, fanout=(4, 2), n_pad=16, e_pad=16, seed=seed)
    feats = rng.standard_normal((500, rcfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, rcfg.n_classes, 500)
    # targets among the nodes with neighbours (the power law leaves most without)
    return s.sample_batch(rng.choice(np.flatnonzero(np.diff(graph.indptr)), G, replace=False),
                          feats, labels)


STEP_CASES = {"full graph": {}, "full graph, graph level": {"graph_level": True, "n_classes": 1},
              "minibatch": {"minibatch": True}}


@pytest.mark.parametrize("case", STEP_CASES)
def test_three_steps_match_the_reference(case):
    """Three steps on one rank against the reference's step on a (1, 1)
    mesh, from one state: the loss and every leaf's update each step."""
    over = dict(STEP_CASES[case])
    mini = over.pop("minibatch", False)
    rcfg, tcfg = cfgs(**over)
    rng = np.random.default_rng(11)
    mesh = make_mesh((1, 1), ("data", "model"))
    G = 4 if rcfg.graph_level else 0
    lr = 5e-5 if G else 5e-3  # the pooled MSE of a random model diverges at 5e-3
    if mini:
        n_graphs = 8
        rstep, _, (ssh, bsh) = RS.make_minibatch_train_step(rcfg, mesh, n_graphs, 16, 16,
                                                            lr=lr)
        tstep, _ = TS.make_minibatch_train_step(tcfg, None, n_graphs, 16, 16, lr=lr,
                                                device="cpu")
        batches = [_minibatch(rcfg, n_graphs, rng, s) for s in range(3)]
    else:
        n_nodes, n_edges = (24, 64) if G else (203, 790)
        rstep, _, (ssh, bsh) = RS.make_fullgraph_train_step(
            rcfg, mesh, n_nodes, n_edges, lr=lr, graph_level_graphs=G)
        tstep, _ = TS.make_fullgraph_train_step(tcfg, None, n_nodes, n_edges, lr=lr,
                                                graph_level_graphs=G, device="cpu")
        batches = [_fullgraph_case(rcfg, n_nodes, n_edges, G, rng)] * 3
    start = jax.tree.map(np.asarray, RS.init_egnn_state(jax.random.PRNGKey(1), rcfg, mesh))
    rstate = jax.device_put(jax.tree.map(jnp.asarray, start), ssh)
    tstate = weights.egnn_state_from_numpy(start, tcfg, "cpu")
    assert len(tree_leaves(tstate["hi"])) == 18
    ref_prev = prev = start
    for b in batches:
        rstate, rloss = rstep(rstate, jax.device_put(jax.tree.map(jnp.asarray, b), bsh))
        tstate, tloss = tstep(tstate, b)
        ref = jax.tree.map(np.array, rstate)
        mine = jax.tree.map(np.array, weights.egnn_state_to_numpy(tstate))
        assert np.isfinite(float(tloss))
        assert abs(float(tloss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
        assert max(update_gaps(ref_prev, ref, prev, mine)) <= UPDATE_TOL
        ref_prev, prev = ref, mine


@pytest.mark.parametrize("shape", list(t_arch.SHAPES))
def test_build_gives_the_reference_s_shapes(shape):
    """``configs/egnn_arch.py``: the shapes copied verbatim, and each
    shape's step built with the reference's state and batch shapes."""
    assert t_arch.SHAPES[shape] == r_arch.SHAPES[shape]
    mesh = make_mesh((1, 1), ("data", "model"))
    want = r_arch.build(shape, mesh, batch=8 if shape in ("minibatch_lg", "molecule") else None)
    got = t_arch.build(shape, None, batch=8 if shape in ("minibatch_lg", "molecule") else None,
                       device="cpu")
    assert got.meta["n_edges"] == want.meta["n_edges"]
    assert got.meta["n_nodes"] == want.meta["n_nodes"]
    (rs, rb), (ts, tb) = want.args, got.args
    assert {k: tuple(v.shape) for k, v in rb.items()} == {k: tuple(v[0]) for k, v in tb.items()}
    assert [tuple(s.shape) for s in jax.tree.leaves(rs["hi"])] == \
        [tuple(s) for s, _ in struct_leaves(ts["hi"])]


def test_state_hand_off_and_init():
    """``egnn_state_from_numpy`` / ``egnn_state_to_numpy`` bit for bit and
    as copies; ``init_egnn_state`` gives the structs' 18 leaves, ``hi`` and
    ``lo`` the halves of fp32 draws."""
    rcfg, tcfg = cfgs(n_layers=4)
    mesh = make_mesh((1, 1), ("data", "model"))
    start = jax.tree.map(np.asarray, RS.init_egnn_state(jax.random.PRNGKey(2), rcfg, mesh))
    state = weights.egnn_state_from_numpy(start, tcfg, "cpu")
    back = weights.egnn_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(start), tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint16), b.view(np.uint16))
    kept = jax.tree.map(np.array, start)
    for t in tree_leaves(state):
        t.add_(1)
    for a, b in zip(jax.tree.leaves(start), jax.tree.leaves(kept)):
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
    mine = TS.init_egnn_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    structs = TS.egnn_state_structs(tcfg)
    for part in ("hi", "lo"):
        leaves, want = tree_leaves(mine[part]), struct_leaves(structs[part])
        assert len(leaves) == 18
        assert [(tuple(t.shape), t.dtype) for t in leaves] == [(tuple(s), d) for s, d in want]


@pytest.mark.parametrize("kind", ["full graph", "minibatch"])
def test_steps_hand_row_4_one_aligned_update_a_leaf(monkeypatch, kind):
    """A step calls ``update_leaf`` once for each of the 18 leaves, in
    order, each gradient contiguous and 16-byte aligned (the split_sgd
    kernel refuses any other on the card, where the CPU's plain version
    takes it)."""
    from repro_torch.optim import split_sgd
    _, tcfg = cfgs()
    seen = []
    orig = split_sgd.update_leaf

    def tapped(h, lo, g, lr, *a, **k):
        seen.append((h.data_ptr(), g.is_contiguous(), g.data_ptr() % 16, g.numel() == h.numel()))
        return orig(h, lo, g, lr, *a, **k)
    monkeypatch.setattr(split_sgd, "update_leaf", tapped)
    rng = np.random.default_rng(2)
    rcfg, _ = cfgs()
    if kind == "full graph":
        step, _ = TS.make_fullgraph_train_step(tcfg, None, 203, 790, device="cpu")
        batch = _fullgraph_case(rcfg, 203, 790, 0, rng)
    else:
        step, _ = TS.make_minibatch_train_step(tcfg, None, 8, 16, 16, device="cpu")
        batch = _minibatch(rcfg, 8, rng, 0)
    state = TS.init_egnn_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    step(state, batch)
    assert [s[0] for s in seen] == [t.data_ptr() for t in tree_leaves(state["hi"])]
    assert all(c and a == 0 and n for _, c, a, n in seen)
