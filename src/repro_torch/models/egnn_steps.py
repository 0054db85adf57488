"""Distributed EGNN train steps (twin of ``repro/models/egnn_steps.py``).

Two regimes, on this rank of a ``launch.mesh.Mesh`` (None: one rank on
``device``, whose collectives are the identity):

* full graph (cora, ogb_products, flattened molecule batches): edges cut
  into one block a rank over the whole mesh, node features replicated for
  the gathers; each layer's partial aggregates are ``psum_scatter``-ed onto
  the rank's node shard, the node MLP runs on the shard and an
  ``all_gather`` rebuilds the replicated features: the paper's Alg. 4
  ownership pattern, applied to nodes.  Each layer is rematerialised in
  backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``),
  its collectives with it.
* sampled minibatch (minibatch_lg): pure data parallelism, each rank
  training on its block of the padded subgraphs of the fanout sampler
  (``data/graph.py``), flattened into one graph (node ids offset by ``g *
  n_pad``: each node sums the same edges as the reference's ``vmap``).

Both take the reference's global batch (numpy or tensors) and read this
rank's part; both take the gradients of the loss with respect to the bf16
``hi`` (bf16, as the reference's), sum them over the ranks (``psum``) and
step each of the tree's 18 leaves in place with
``optim.split_sgd.update_leaf``: one launch of the split_sgd kernel a leaf
on the card.  The state is ``{"hi": bf16 tree, "lo": int16 tree}`` (the
reference's uint16 bits), replicated.

The collectives run under autograd with the reference's transposes
(``dist.comm``'s ``_ad`` forms).  The scatters (``index_add``) and the
gathers' backward are plain PyTorch, as the reference leaves them to XLA.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import comm
from repro_torch.launch.mesh import resolve_mesh
from repro_torch.models.egnn import (EGNNConfig, egnn_layer, egnn_node_update,
                                     init_egnn_params, node_ce, normalize_dx, param_shapes,
                                     segment_sum, unstack_layers)
from repro_torch.models.mlp import mlp_forward
from repro_torch.optim import split_sgd
from repro_torch.optim.data_parallel import tree_leaves, tree_map
from repro_torch.weights import to_torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def grad_psum(x: torch.Tensor, g: comm.Group) -> torch.Tensor:
    """``psum`` whose backward is ``psum``.  The reference's steps run
    inside ``shard_map(check_vma=False)`` (``repro/models/egnn_steps.py:170``
    and ``:242``), where JAX transposes ``psum`` to ``psum``: every rank
    seeds its copy of the psum'd loss, so the gradients summed over N ranks
    are N times the loss's, and an N-rank step applies N times the update of
    the one-rank step.  The port keeps that factor (ROADMAP queue 3, held;
    pinned by ``tests/test_torch_egnn_mesh.py``)."""
    return comm.psum_ad(x, g)


def egnn_state_structs(cfg: EGNNConfig) -> dict:
    """``{"hi", "lo"}`` trees of ``(shape, dtype)``: bf16 and int16 (the
    reference's uint16), replicated on every rank."""
    def walk(tree, dtype):
        if isinstance(tree, dict):
            return {k: walk(v, dtype) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, dtype) for v in tree]
        return (tree, dtype)     # a shape
    shapes = param_shapes(cfg)
    return {"hi": walk(shapes, torch.bfloat16), "lo": walk(shapes, torch.int16)}


def init_egnn_state(cfg: EGNNConfig, generator: torch.Generator, device="cuda") -> dict:
    """A state from fp32 weights drawn by ``egnn.init_egnn_params``
    (``generator`` on ``device``, seeded alike on every rank), each leaf
    split into its upper (``hi``, truncated) and lower (``lo``) 16 bits."""
    params = init_egnn_params(cfg, generator, device)
    return {"hi": tree_map(lambda p: split_sgd.split_fp32(p)[0], params),
            "lo": tree_map(lambda p: split_sgd.split_fp32(p)[1], params)}


def fullgraph_batch_structs(cfg: EGNNConfig, mesh, n_nodes: int, n_edges: int,
                            graph_level_graphs: int = 0) -> tuple[dict, tuple]:
    """The global batch's ``{key: (shape, dtype)}`` and its padded ``(N,
    E)``: nodes to a multiple of ``ranks * 8``, edges of ``ranks``.  The
    features may come in any float type (the encoder casts them to bf16,
    as the reference's; its struct says bf16)."""
    ns = 1 if mesh is None else mesh.size
    N, E = _round_up(n_nodes, ns * 8), _round_up(n_edges, ns)
    structs = {"feats": ((N, cfg.d_feat), torch.bfloat16),
               "coords": ((N, cfg.coord_dim), torch.float32),
               "src": ((E,), torch.int32), "dst": ((E,), torch.int32),
               "edge_mask": ((E,), torch.float32)}
    if graph_level_graphs:
        structs["graph_ids"] = ((N,), torch.int32)
        structs["targets"] = ((graph_level_graphs,), torch.float32)
    else:
        structs["labels"] = ((N,), torch.int32)
        structs["label_mask"] = ((N,), torch.float32)
    return structs, (N, E)


def _mesh_axes(mesh) -> tuple:
    return ("data", "model") if mesh is None else tuple(mesh.axis_names)


def fullgraph_batch_specs(structs: dict, mesh) -> dict:
    """How the reference's mesh holds each field of
    :func:`fullgraph_batch_structs` (``dist.sharding``'s spec tuples): the
    edge arrays by position over the whole mesh, the node arrays whole."""
    edges = _mesh_axes(mesh)
    return {k: (edges,) if k in ("src", "dst", "edge_mask") else (None,) * len(s)
            for k, (s, _) in structs.items()}


def minibatch_batch_specs(structs: dict, mesh) -> dict:
    """How the reference's mesh holds each field of
    :func:`minibatch_batch_structs`: by graph over the whole mesh."""
    return {k: (_mesh_axes(mesh),) + (None,) * (len(s) - 1) for k, (s, _) in structs.items()}


def _part(batch: dict, structs: dict, cuts: dict, dev: torch.device) -> dict:
    """``batch`` checked against ``structs``' shapes, each key cut to
    ``cuts[key]`` (a slice of dim 0) where given and moved to ``dev``."""
    out = {}
    for k, (shape, _) in structs.items():
        v = batch[k]
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"batch[{k!r}] is {tuple(v.shape)}, the step needs {tuple(shape)}")
        v = v[cuts[k]] if k in cuts else v
        out[k] = to_torch(v, dev) if isinstance(v, np.ndarray) else v.to(dev)
    return out


def _apply(state: dict, loss_fn, batch: dict, g: comm.Group, lr: float) -> torch.Tensor:
    """The loss and its gradients with respect to ``hi`` (bf16), summed over
    ``g`` as one flat buffer (``psum``; each leaf's gradient at a multiple of
    8 values, the 16 bytes the split_sgd kernel's loads align to), then
    each leaf's Split-SGD step in place.  Returns the loss."""
    params = tree_map(lambda t: t.detach().requires_grad_(), state["hi"])
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    at = [0]
    for t in grads:
        at.append(at[-1] + _round_up(t.numel(), 8))
    flat = torch.zeros(at[-1], dtype=grads[0].dtype, device=grads[0].device)
    for a, t in zip(at, grads):
        flat[a:a + t.numel()] = t.reshape(-1)
    flat = comm.psum(flat, g)
    with torch.no_grad():
        for a, h, lo in zip(at, tree_leaves(state["hi"]), tree_leaves(state["lo"])):
            split_sgd.update_leaf(h, lo, flat[a:a + h.numel()], lr)
    return loss.detach()


def make_fullgraph_train_step(cfg: EGNNConfig, mesh, n_nodes: int, n_edges: int,
                              lr: float = 1e-2, graph_level_graphs: int = 0, *, device="cuda"):
    """``(step, (state_structs, batch_structs))``; ``state, loss =
    step(state, batch)`` with the global batch of
    :func:`fullgraph_batch_structs` (padded; ``edge_mask`` 0 on padded
    edges, ``label_mask`` 0 on unlabelled nodes): the loss (fp32 0-d, the
    same on every rank) and the state stepped IN PLACE, where the reference
    donates it.  ``graph_level_graphs`` > 0: the pooled MSE over that many
    graphs (``graph_ids`` a node's graph), else the masked node CE.  This
    rank (index r of ``ns`` over all the mesh's axes) owns the edges ``[r *
    E / ns, (r + 1) * E / ns)`` and the nodes ``[r * N / ns, ...)``."""
    mesh = resolve_mesh(mesh, device)
    dev, g = mesh.device, mesh.group(mesh.axis_names)
    sstructs = egnn_state_structs(cfg)
    bstructs, (N, E) = fullgraph_batch_structs(cfg, mesh, n_nodes, n_edges, graph_level_graphs)
    Nsh, Esh = N // mesh.size, E // mesh.size
    rows = slice(g.index * Nsh, (g.index + 1) * Nsh)
    edges = slice(g.index * Esh, (g.index + 1) * Esh)
    cuts = {"src": edges, "dst": edges, "edge_mask": edges}

    def layer(h, x, lp, src, dst, emask):
        magg, dx_raw, deg = egnn_layer(h, x, src, dst, lp, emask, num_nodes=N)
        # partial aggregates -> node shard, update, regather
        h_sh = egnn_node_update(h[rows], comm.psum_scatter_ad(magg, g), lp)
        h = comm.all_gather_ad(h_sh, g)
        if cfg.update_coords:
            # sum the partials, THEN normalise by the global degree
            x = x + normalize_dx(grad_psum(dx_raw, g), comm.psum(deg, g))
        return h, x

    def loss_fn(hi: dict, b: dict) -> torch.Tensor:
        h_sh = mlp_forward(hi["encoder"], b["feats"][rows],
                           final_activation=True).to(torch.bfloat16)
        h, x = comm.all_gather_ad(h_sh, g), b["coords"].float()
        for lp in unstack_layers(hi["layers"], cfg.n_layers):
            h, x = checkpoint(layer, h, x, lp, b["src"], b["dst"], b["edge_mask"],
                              use_reentrant=False)
        logits = mlp_forward(hi["head"], h[rows])                   # [N / ns, C]
        if graph_level_graphs:
            pooled = grad_psum(segment_sum(logits, b["graph_ids"][rows], graph_level_graphs),
                               g)
            return ((pooled[:, 0] - b["targets"]) ** 2).mean()
        lmask = b["label_mask"][rows]
        num = grad_psum(node_ce(logits, b["labels"][rows], lmask), g).sum()
        return num / torch.clamp(comm.psum(lmask.sum(), g), min=1.0)

    def step(state: dict, batch: dict):
        return state, _apply(state, loss_fn, _part(batch, bstructs, cuts, dev), g, lr)

    return step, (sstructs, bstructs)


def minibatch_batch_structs(cfg: EGNNConfig, n_graphs: int, n_pad: int, e_pad: int) -> dict:
    """The global batch's ``{key: (shape, dtype)}``: ``n_graphs`` padded
    subgraphs of ``n_pad`` nodes and ``e_pad`` edges (``NeighborSampler``'s
    ``sample_batch``), cut over the ranks by graph."""
    return {"feats": ((n_graphs, n_pad, cfg.d_feat), torch.bfloat16),
            "coords": ((n_graphs, n_pad, cfg.coord_dim), torch.float32),
            "src": ((n_graphs, e_pad), torch.int32), "dst": ((n_graphs, e_pad), torch.int32),
            "edge_mask": ((n_graphs, e_pad), torch.float32),
            "labels": ((n_graphs,), torch.int32)}


def make_minibatch_train_step(cfg: EGNNConfig, mesh, n_graphs: int, n_pad: int, e_pad: int,
                              lr: float = 1e-2, *, device="cuda"):
    """Sampled-subgraph data parallelism: ``(step, (state_structs,
    batch_structs))``, one padded subgraph a target node, the target its
    local node 0.  This rank (index r of ``ns``) trains on the graphs ``[r
    * n_graphs / ns, ...)`` of the global batch; the loss is the CE of each
    graph's node 0 summed over the ranks, over ``n_graphs``."""
    mesh = resolve_mesh(mesh, device)
    dev, g = mesh.device, mesh.group(mesh.axis_names)
    if n_graphs % mesh.size:
        raise ValueError(f"{n_graphs} graphs do not split over {mesh.size} ranks")
    sstructs = egnn_state_structs(cfg)
    bstructs = minibatch_batch_structs(cfg, n_graphs, n_pad, e_pad)
    Gl = n_graphs // mesh.size
    mine = slice(g.index * Gl, (g.index + 1) * Gl)
    cuts = dict.fromkeys(bstructs, mine)
    off = torch.arange(Gl, device=dev)[:, None] * n_pad
    n = Gl * n_pad

    def loss_fn(hi: dict, b: dict) -> torch.Tensor:
        h = mlp_forward(hi["encoder"], b["feats"].reshape(n, cfg.d_feat),
                        final_activation=True).to(torch.bfloat16)
        x = b["coords"].reshape(n, cfg.coord_dim).float()
        src, dst = ((b[k] + off).reshape(-1) for k in ("src", "dst"))
        emask = b["edge_mask"].reshape(-1)
        for lp in unstack_layers(hi["layers"], cfg.n_layers):
            magg, dx_raw, deg = egnn_layer(h, x, src, dst, lp, emask, num_nodes=n)
            h = egnn_node_update(h, magg, lp)
            if cfg.update_coords:
                x = x + normalize_dx(dx_raw, deg)
        logits = mlp_forward(hi["head"], h.view(Gl, n_pad, -1)[:, 0])   # target nodes
        return grad_psum(node_ce(logits, b["labels"]).sum(), g) / n_graphs

    def step(state: dict, batch: dict):
        return state, _apply(state, loss_fn, _part(batch, bstructs, cuts, dev), g, lr)

    return step, (sstructs, bstructs)
