"""E(n)-equivariant GNN (EGNN, arXiv:2102.09844; twin of
``repro/models/egnn.py``).

Message passing is built from ``index_select`` (edge gathers) and
``index_add_`` (node scatters), as the reference builds it from ``jnp.take``
and ``jax.ops.segment_sum``: no sparse formats.  The MLPs are
``models.mlp.mlp_forward`` with ``impl="xla"`` (bf16 values, fp32 products
and sums, fp32 out of the last layer), the reference's path.

Layer (h: node features, x: coordinates, edges j -> i):
    m_ij = phi_e([h_i, h_j, ||x_i - x_j||^2])
    x_i' = x_i + (1/deg_i) sum_j (x_i - x_j) / (||x_i - x_j|| + 1) * tanh(phi_x(m_ij))
    h_i' = phi_h([h_i, sum_j m_ij]) + h_i

The gathers' backward adds each row's bf16 cotangents in bf16, rounding at
every add, as the reference's scatter does (summed in fp32 and rounded
once instead, the CPU tests' full-graph step moved 3.7e-2 of a leaf's
largest update away from the reference's).
On the card the scatters add with atomics in no fixed order: the card is
held to the CPU within a tolerance, not bit for bit.  The distributed steps
are ``models.egnn_steps``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.mlp import init_mlp, mlp_forward


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    coord_dim: int = 3
    graph_level: bool = False      # molecule: pooled regression head
    update_coords: bool = True


def param_shapes(cfg: EGNNConfig) -> dict:
    """The parameter tree's leaf shapes: ``encoder`` [d_feat -> H], the
    ``layers`` stacked ``[n_layers, ...]`` (``phi_e`` [2H+1 -> H -> H],
    ``phi_x`` [H -> H -> 1], ``phi_h`` [2H -> H -> H]), ``head`` [H -> H ->
    n_classes]."""
    h, L = cfg.d_hidden, cfg.n_layers

    def mlp(sizes, stack=()):
        pairs = list(zip(sizes[:-1], sizes[1:]))
        return {"w": [stack + (i, o) for i, o in pairs], "b": [stack + (o,) for _, o in pairs]}
    return {"encoder": mlp([cfg.d_feat, h]),
            "layers": {"phi_e": mlp([2 * h + 1, h, h], (L,)), "phi_x": mlp([h, h, 1], (L,)),
                       "phi_h": mlp([2 * h, h, h], (L,))},
            "head": mlp([h, h, cfg.n_classes])}


def init_egnn_params(cfg: EGNNConfig, generator: Optional[torch.Generator],
                     device="cuda") -> dict:
    """fp32 parameters with the reference's distributions (``mlp.init_mlp``
    a layer, each ``layers`` leaf the stack of the layers'), drawn from
    ``generator`` on ``device``.  The numbers differ from the reference's
    ``jax.random`` draw; ``weights.egnn_params_from_numpy`` carries a JAX
    tree across instead."""
    h = cfg.d_hidden
    layers = [{"phi_e": init_mlp([2 * h + 1, h, h], generator, device),
               "phi_x": init_mlp([h, h, 1], generator, device),
               "phi_h": init_mlp([2 * h, h, h], generator, device)}
              for _ in range(cfg.n_layers)]
    stacked = {k: {p: [torch.stack([lay[k][p][i] for lay in layers])
                       for i in range(len(layers[0][k][p]))] for p in ("w", "b")}
               for k in ("phi_e", "phi_x", "phi_h")}
    return {"encoder": init_mlp([cfg.d_feat, h], generator, device),
            "layers": stacked,
            "head": init_mlp([h, h, cfg.n_classes], generator, device)}


def unstack_layers(layers: dict, n_layers: int) -> list[dict]:
    """Every layer's parameters as views of the stacked ``layers`` tree, in
    one ``unbind`` a leaf: under autograd each leaf's gradient is then one
    stack of its layers' gradients, not a zero-padded stack a layer."""
    parts = {k: {p: [t.unbind(0) for t in v[p]] for p in ("w", "b")}
             for k, v in layers.items()}
    return [{k: {p: [t[i] for t in v[p]] for p in ("w", "b")} for k, v in parts.items()}
            for i in range(n_layers)]


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments=n)``: rows of ``data``
    added into [n, ...] zeros at ``ids``."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)


def egnn_layer(h, x, src, dst, lp, edge_mask=None, num_nodes=None):
    """h [N, H] bf16, x [N, C] fp32, src / dst [E] (message j = src -> i =
    dst), ``lp`` one layer's parameters.

    Returns PARTIAL aggregates ``(magg [N, H] fp32, dx_raw [N, C] fp32, deg
    [N] fp32)``, so that edge-sharded callers sum them over ranks before the
    degree normalisation.  The coordinate update takes the normalised
    difference (x_i - x_j) / (|x_i - x_j| + 1)."""
    N = h.shape[0] if num_nodes is None else num_nodes
    hs = h.index_select(0, src)
    hd = h.index_select(0, dst)
    diff = (x.index_select(0, dst) - x.index_select(0, src)).float()   # x_i - x_j
    d2 = (diff ** 2).sum(-1, keepdim=True)
    # eps inside the sqrt: padded and self edges have diff == 0, where
    # d(sqrt) is inf and the gradients NaN without it
    diff_n = diff / (torch.sqrt(d2 + 1e-6) + 1.0)
    m = mlp_forward(lp["phi_e"], torch.cat([hs, hd, d2.to(hs.dtype)], -1),
                    final_activation=True)                          # [E, H] fp32
    if edge_mask is not None:
        m = m * edge_mask[:, None]
    w = torch.tanh(mlp_forward(lp["phi_x"], m.to(h.dtype)))         # [E, 1]
    if edge_mask is not None:
        w = w * edge_mask[:, None]
    ones = torch.ones_like(w[:, 0]) if edge_mask is None else edge_mask
    deg = segment_sum(ones, dst, N)
    dx_raw = segment_sum(diff_n * w, dst, N)
    magg = segment_sum(m, dst, N)                                   # [N, H]
    return magg, dx_raw, deg


def normalize_dx(dx_raw, deg):
    return dx_raw / torch.clamp(deg, min=1.0)[:, None]


def egnn_node_update(h, magg, lp):
    out = mlp_forward(lp["phi_h"], torch.cat([h, magg.to(h.dtype)], -1),
                      final_activation=True)
    return h + out.to(h.dtype)


def egnn_forward(params, feats, coords, src, dst, cfg: EGNNConfig, edge_mask=None):
    """Single-device forward (tests, smoke).  Returns [N, classes] node
    logits, fp32."""
    h = mlp_forward(params["encoder"], feats.to(torch.bfloat16),
                    final_activation=True).to(torch.bfloat16)
    x = coords.float()
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        magg, dx_raw, deg = egnn_layer(h, x, src, dst, lp, edge_mask)
        h = egnn_node_update(h, magg, lp)
        if cfg.update_coords:
            x = x + normalize_dx(dx_raw, deg)
    return mlp_forward(params["head"], h)                          # [N, classes]


def node_ce(logits, labels, mask=None):
    """The per-node cross-entropy ``logsumexp - logit[label]`` (fp32)."""
    lse = torch.logsumexp(logits, -1)
    lab = logits.gather(-1, labels.long()[:, None])[:, 0]
    ce = lse - lab
    return ce if mask is None else ce * mask


def egnn_loss(params, batch, cfg: EGNNConfig):
    """Node classification CE over labelled nodes, or graph-level MSE."""
    logits = egnn_forward(params, batch["feats"], batch["coords"], batch["src"],
                          batch["dst"], cfg, batch.get("edge_mask"))
    if cfg.graph_level:
        pooled = segment_sum(logits, batch["graph_ids"], batch["n_graphs"])
        return ((pooled[:, 0] - batch["targets"]) ** 2).mean()
    mask = batch.get("label_mask")
    ce = node_ce(logits, batch["labels"], mask)
    if mask is not None:
        return ce.sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()
