"""The port's graph generators and fanout sampler (``repro_torch/data/graph.py``)
against the reference's (``repro/data/graph.py``): bit for bit for a seed, at
the sizes of ``tests/test_data.py``'s sampler tests."""

import numpy as np
import pytest

from repro.data import graph as ref
from repro_torch.data import graph as port

SEEDS = (1, 7)


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_nodes,n_edges", [(5000, 60_000), (2000, 20_000), (7, 5)])
def test_powerlaw_graph_is_the_reference_s(seed, n_nodes, n_edges):
    a, b = ref.random_powerlaw_graph(n_nodes, n_edges, seed), \
        port.random_powerlaw_graph(n_nodes, n_edges, seed)
    assert a.n_nodes == b.n_nodes and a.n_edges == b.n_edges
    _same({"indptr": a.indptr, "indices": a.indices}, {"indptr": b.indptr, "indices": b.indices})


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_list_is_the_reference_s(seed):
    for x, y in zip(ref.random_edge_list(2708, 10556, seed),
                    port.random_edge_list(2708, 10556, seed)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_sampler_is_the_reference_s(seed):
    """``sample`` on a few targets (one of degree 0 too), then
    ``sample_batch``: the same subgraphs, features, coordinates and labels,
    drawn in the same order from the sampler's generator."""
    ga, gb = ref.random_powerlaw_graph(5000, 60_000, seed), \
        port.random_powerlaw_graph(5000, 60_000, seed)
    sa = ref.NeighborSampler(ga, fanout=(5, 3), n_pad=32, e_pad=32, seed=seed)
    sb = port.NeighborSampler(gb, fanout=(5, 3), n_pad=32, e_pad=32, seed=seed)
    zero = int(np.flatnonzero(np.diff(ga.indptr) == 0)[0])
    for t in (42, 0, zero, 4999):
        _same(sa.sample(t), sb.sample(t))
    g2a, g2b = ref.random_powerlaw_graph(2000, 20_000, seed + 1), \
        port.random_powerlaw_graph(2000, 20_000, seed + 1)
    sa = ref.NeighborSampler(g2a, fanout=(4, 2), n_pad=16, e_pad=16, seed=seed)
    sb = port.NeighborSampler(g2b, fanout=(4, 2), n_pad=16, e_pad=16, seed=seed)
    feats = np.random.default_rng(seed).standard_normal((2000, 6)).astype(np.float32)
    labels = np.random.default_rng(seed + 1).integers(0, 5, 2000)
    targets = np.arange(0, 2000, 97)
    for _ in range(2):
        _same(sa.sample_batch(targets, feats, labels), sb.sample_batch(targets, feats, labels))


def test_sampled_edges_are_graph_edges():
    """``tests/test_data.py``'s validity check on the port: node 0 is the
    target, real edges use local ids below the real count, and every
    sampled child is a neighbour of its parent."""
    g = port.random_powerlaw_graph(5000, 60_000, seed=1)
    sub = port.NeighborSampler(g, fanout=(5, 3), n_pad=32, e_pad=32, seed=0).sample(42)
    n_real, e_real = sub["n_real"], int(sub["edge_mask"].sum())
    assert sub["nodes"][0] == 42 and 1 <= n_real <= 32
    assert sub["src"][:e_real].max(initial=0) < n_real
    assert sub["dst"][:e_real].max(initial=0) < n_real
    for i in range(e_real):
        child, parent = sub["nodes"][sub["src"][i]], sub["nodes"][sub["dst"][i]]
        assert child in g.indices[g.indptr[parent]:g.indptr[parent + 1]]
