"""egnn [arXiv:2102.09844]: 4 layers, hidden 64, E(n)-equivariant (twin of
``repro/configs/egnn_arch.py``).

Four shape cells:
    full_graph_sm   cora-like      N=2708      E=10556      d_feat=1433
    minibatch_lg    reddit-like    fanout 15-10, 1024 target nodes
    ogb_products    full-batch     N=2449029   E=61859140   d_feat=100
    molecule        128 graphs x (30 nodes, 64 edges), graph-level target

Citation and product graphs carry synthesised 3D coordinates (EGNN needs
geometry).  :func:`build` returns the port's step for a shape, and
:data:`ARCH` registers the four cells.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchDef, Cell, CellBuild, register
from repro_torch.models.egnn import EGNNConfig

SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="train", n_graphs=1024, fanout=(15, 10),
                         d_feat=602, n_classes=41,
                         n_pad=192, e_pad=192),
    "ogb_products": dict(kind="train", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="train", n_graphs=128, nodes_per=30, edges_per=64,
                     d_feat=11, n_classes=1),
}


def config(shape: str, n_layers: int | None = None) -> EGNNConfig:
    """The shape's model: 4 layers (or ``n_layers``), hidden 64, its
    ``d_feat`` and ``n_classes``; graph level for ``molecule``."""
    sh = SHAPES[shape]
    return EGNNConfig("egnn", n_layers=n_layers or 4, d_hidden=64, d_feat=sh["d_feat"],
                      n_classes=sh["n_classes"], graph_level=(shape == "molecule"))


def build(shape: str, mesh=None, n_layers: int | None = None, batch: int | None = None,
          cost_mode: bool = False, *, device="cuda") -> CellBuild:
    """The step of ``shape`` on this rank of ``mesh`` (None: one rank on
    ``device``): the minibatch step for ``minibatch_lg`` (``batch`` graphs,
    1024 by default), the full-graph step otherwise (``molecule``: ``batch``
    graphs of 30 nodes and 64 edges, flattened, graph level).  ``args`` are
    the state and the global batch, ``specs`` how the mesh holds them.
    ``cost_mode`` unrolls the reference's layer scan for its cost
    analysis; the port's layers are a loop already, so it changes
    nothing."""
    from repro_torch.models import egnn_steps

    sh = SHAPES[shape]
    cfg = config(shape, n_layers)
    meta = dict(arch="egnn", shape=shape, kind="train", family="gnn", n_layers=cfg.n_layers,
                scan_unit=1, scan_outside=0)
    if shape == "minibatch_lg":
        g = batch or sh["n_graphs"]
        fn, structs = egnn_steps.make_minibatch_train_step(
            cfg, mesh, g, sh["n_pad"], sh["e_pad"], device=device)
        meta.update(n_edges=g * sh["e_pad"], n_nodes=g * sh["n_pad"], batch=g)
        return CellBuild(fn, structs, meta,
                         specs=(None, egnn_steps.minibatch_batch_specs(structs[1], mesh)),
                         model=cfg)
    if shape == "molecule":
        g = batch or sh["n_graphs"]
        nodes, edges = g * sh["nodes_per"], g * sh["edges_per"]
        fn, structs = egnn_steps.make_fullgraph_train_step(
            cfg, mesh, nodes, edges, graph_level_graphs=g, device=device)
        meta.update(n_edges=edges, n_nodes=nodes, batch=g)
        return CellBuild(fn, structs, meta,
                         specs=(None, egnn_steps.fullgraph_batch_specs(structs[1], mesh)),
                         model=cfg)
    fn, structs = egnn_steps.make_fullgraph_train_step(
        cfg, mesh, sh["n_nodes"], sh["n_edges"], device=device)
    meta.update(n_edges=sh["n_edges"], n_nodes=sh["n_nodes"], batch=1)
    return CellBuild(fn, structs, meta,
                     specs=(None, egnn_steps.fullgraph_batch_specs(structs[1], mesh)),
                         model=cfg)


ARCH = register(ArchDef(
    "egnn", "gnn",
    [Cell(s, "train") for s in SHAPES], build,
    notes="edge-sharded message passing; segment_sum scatter; "
          "minibatch_lg uses the fanout neighbor sampler in repro/data"))
