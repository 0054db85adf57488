"""Train-state layout and initialisation on a mesh (twin of the state
functions of ``repro/core/hybrid.py``).

A rank's state is its shard of the reference's global pytree:

    {"emb": {"hi": [R, E] bf16, "lo": [R, E] int16}    (split_sgd)
            | {"w": [R, E] fp32, + state slabs}         (the others)
     "dense": {"hi": {"bot"|"top": {"w": [...], "b": [...]}} bf16,
               "lo": [padded / ranks] int16,
               "err": [padded / ranks] fp32 | None}}

``R`` is the layout's ``rows_per_shard``: in row mode the rank's window of
the row space, in table mode its bin of tables (replicated over the data
axes).  ``lo`` is the rank's chunk of the bucketed dense ``lo``
(``optim.data_parallel``), and ``err`` its chunk of the dense error
feedback's residual, present with the ``"bf16"`` dense wire and
``error_feedback`` (``ExchangeConfig.needs_err``).  ``lo`` slabs hold the
bits of the reference's uint16 slabs as int16, since PyTorch has no
arithmetic on uint16.  The state slabs are the optimizer's
(``optim.row.RowOptimizer.state``): ``mom`` or ``acc`` [R, E] fp32, ``acc``
[R, 1] fp32 (row-wise Adagrad), ``cnt`` [R, 1] int32, or ``mom`` / ``acc``
[R, E] bf16 (the compressed-state kinds), zero at the start.  An optimizer
that rounds its state stochastically, or a ``"bf16_sr"`` wire, adds
``"sr"``, the per-step seed, replicated: a 0-d int32 tensor,
``cfg.sr_seed`` at the start, one more after each step.  With
``cfg.hot_rows`` the store carries the touch counts ``cnt`` [R, 1] int32
(unless the optimizer declares them) and the state the replicated
``"cache"`` (``core.cache``: ``hot_w``, ``hot_ids``, ``hot_pos``, ``tick``);
with ``cfg.step_metrics`` the replicated fp32 vector ``"metrics"``
(``telemetry.metrics``).  The dense ``hi``
leaves are views into one flat bf16 buffer (``optim.data_parallel.pack_hi``),
which the dense update steps in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.core import sharded_embedding as se
from repro_torch.dist.exchange import resolve_exchange
from repro_torch.launch.mesh import Mesh, resolve_mesh
from repro_torch.optim import data_parallel as dp
from repro_torch.optim import row as row_optim


def make_layout(cfg, mesh: Mesh) -> se.ShardedEmbeddingLayout:
    """The embedding layout of ``cfg`` over the shards of ``mesh``."""
    return se.make_layout(cfg.spec, pipeline.num_shards(cfg, mesh), cfg.emb_mode)


def emb_shard(cfg, mesh: Mesh) -> int:
    """The embedding shard this rank holds."""
    return mesh.group(pipeline.emb_axes(cfg, mesh)[0]).index


def dense_sizes(cfg) -> int:
    return sum(i * o + o for sizes in (cfg.bottom_sizes, cfg.top_sizes)
               for i, o in zip(sizes[:-1], sizes[1:]))


def padded_dense(cfg, mesh: Mesh) -> int:
    """The length of the reference's global dense ``lo``."""
    return dp.padded_size(dense_sizes(cfg), mesh.size, resolve_exchange(cfg).num_buckets)


def needs_sr(cfg) -> bool:
    """Whether the train state carries the per-step seed ``sr``: the
    optimizer rounds its state stochastically, or a wire is ``"bf16_sr"``."""
    return row_optim.resolve(cfg).stochastic_round or resolve_exchange(cfg).needs_sr


def hot_rows(cfg) -> int:
    """The hot-row cache's rows a table (0: no cache)."""
    return int(getattr(cfg, "hot_rows", 0))


def state_struct(cfg, mesh=None) -> dict:
    """``(shape, dtype)`` of every leaf of this rank's train state of ``cfg``
    on ``mesh`` (None: one rank), ``None`` for an absent error-feedback
    slab."""
    mesh = resolve_mesh(mesh, "cpu")
    layout = make_layout(cfg, mesh)
    E = cfg.emb_dim
    opt = row_optim.resolve(cfg)
    emb = opt.store_struct(layout.rows_per_shard, E, counters=hot_rows(cfg) > 0)
    hi = {}
    for part, sizes in (("bot", cfg.bottom_sizes), ("top", cfg.top_sizes)):
        pairs = list(zip(sizes[:-1], sizes[1:]))
        hi[part] = {"w": [((i, o), torch.bfloat16) for i, o in pairs],
                    "b": [((o,), torch.bfloat16) for _, o in pairs]}
    chunk = (padded_dense(cfg, mesh) // mesh.size,)
    err = (chunk, torch.float32) if resolve_exchange(cfg).needs_err else None
    out = {"emb": emb, "dense": {"hi": hi, "lo": (chunk, torch.int16), "err": err}}
    if needs_sr(cfg):
        out["sr"] = ((), torch.int32)
    if hot_rows(cfg) > 0:
        from repro_torch.core.cache import cache_struct
        out["cache"] = cache_struct(cfg, layout, opt)
    if getattr(cfg, "step_metrics", False):
        from repro_torch.telemetry.metrics import metrics_struct
        out["metrics"] = metrics_struct()
    return out


def init_state(cfg, generator: torch.Generator, device="cuda", mesh=None) -> dict:
    """This rank's train state, drawn from ``generator`` (which must live on
    the rank's device and be seeded alike on every rank) with the
    reference's distributions: table rows ~ U(-a, a), a = 1 / sqrt(mean
    table rows), over the layout's whole row space; dense weights as
    ``core.dlrm.init_dense_params``.  Each rank draws the global arrays and
    keeps its shard.  ``mesh`` (None: one rank on ``device``).  The numbers
    differ from the reference's ``jax.random`` draw;
    ``weights.state_from_numpy`` carries a JAX state across instead."""
    from repro_torch.core.dlrm import init_dense_params

    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    layout = make_layout(cfg, mesh)
    a = 1.0 / float(np.sqrt(np.mean(cfg.table_rows)))
    W = torch.empty((layout.total_rows, cfg.emb_dim), device=dev).uniform_(-a, a,
                                                                          generator=generator)
    R, s = layout.rows_per_shard, emb_shard(cfg, mesh)
    if layout.num_shards > 1:
        W = W[s * R:(s + 1) * R].clone()
    opt = row_optim.resolve(cfg)
    emb = row_optim.init_store(opt, W, counters=hot_rows(cfg) > 0)
    del W
    params = init_dense_params(cfg, generator, dev)
    ex = resolve_exchange(cfg)
    dense = dp.init_dp_state(params, mesh.size, mesh.rank, ex.num_buckets, ex.needs_err)
    state = {"emb": emb, "dense": dense}
    if needs_sr(cfg):
        state["sr"] = torch.tensor(cfg.sr_seed, dtype=torch.int32, device=dev)
    if hot_rows(cfg) > 0:
        from repro_torch.core.cache import init_cache
        state["cache"] = init_cache(cfg, layout, opt, dev)
    if getattr(cfg, "step_metrics", False):
        from repro_torch.telemetry.metrics import init_metrics
        state["metrics"] = init_metrics(dev)
    return state


def batch_struct(cfg, mesh: Mesh, layout: se.ShardedEmbeddingLayout,
                 batch: int | None = None) -> dict:
    """``(shape, dtype)`` of each field of one global batch of ``cfg`` on
    ``mesh`` (``batch`` samples, ``cfg.batch`` by default), in the
    reference's ``batch_struct`` order."""
    B, S, Pq = batch or cfg.batch, layout.num_orig_slots, cfg.pooling
    slots = layout.num_padded_slots if (cfg.emb_mode == "table"
                                        and cfg.idx_input == "replicated") else S
    out = {"idx": ((B, slots, Pq), torch.int32)}
    if cfg.weighted:
        out["weights"] = ((B, slots, Pq), torch.float32)
    if cfg.host_presort:
        ns_emb = pipeline.num_shards(cfg, mesh)
        L = B * (S if cfg.emb_mode == "row" else layout.slots_per_shard) * Pq
        for name, dt in (("psort_rows", torch.int32), ("psort_bags", torch.int32),
                         ("psort_msk", torch.int32), ("psort_wgt", torch.float32)):
            out[name] = ((ns_emb, L), dt)
    out["dense_x"] = ((B, cfg.num_dense), torch.bfloat16)
    out["labels"] = ((B,), torch.float32)
    return out


def batch_struct_from_spec(cfg, mesh: Mesh, layout: se.ShardedEmbeddingLayout, dataset_spec,
                           batch: int | None = None) -> dict:
    """:func:`batch_struct` checked against a packed dataset's
    ``data.format.DatasetSpec``: the loader-facing entry.  A mismatch
    between the dataset and the model fails here, at wiring time, with the
    reference's field-by-field message, not as a shape error inside the
    step."""
    dataset_spec.check_model(cfg)
    if dataset_spec.weighted and not cfg.weighted:
        # legal (weights are simply not read) but worth rejecting loudly:
        # the reader WILL yield a weights field the struct won't declare.
        raise ValueError("dataset is weighted but mdef.weighted=False; "
                         "set weighted=True (or strip the weights field)")
    return batch_struct(cfg, mesh, layout, batch)


def local_batch(cfg, mesh: Mesh, batch: dict) -> dict:
    """This rank's block of the reference's global batch (``batch_struct``'s
    partition specs): ``idx`` and ``weights`` whole in row mode with the
    replicated stream; in table mode with the replicated stream the
    padded-slot [B, num_padded_slots, P] arrays cut to this rank's data
    replica's rows and its model shard's slots; the host pre-sort's
    ``psort_*`` fields ([num_shards, L], ``data.pipeline.presort_batch``)
    cut to the row of this rank's embedding shard, [1, L] (every replica of
    a table-mode shard takes the same row); every other field, and the
    batch-sharded streams, cut to this rank's rows (device-major over the
    mesh)."""
    from repro_torch.data.pipeline import PSORT_KEYS

    all_axes, model, batch_axes = pipeline.mesh_axes(mesh)
    n, i = mesh.size, mesh.rank
    shard = emb_shard(cfg, mesh)

    def rows(v, parts, j):
        c = v.shape[0] // parts
        return v[j * c:(j + 1) * c]

    out = {}
    for k, v in batch.items():
        if k in PSORT_KEYS:
            v = v[shard:shard + 1]
        elif k in ("idx", "weights") and cfg.idx_input == "replicated":
            if cfg.emb_mode == "table":
                nb = int(np.prod([mesh.shape[a] for a in batch_axes])) if batch_axes else 1
                d = mesh.group(batch_axes).index if batch_axes else 0
                K = v.shape[1] // mesh.shape[model]
                m = mesh.coords[model]
                v = rows(v, nb, d)[:, m * K:(m + 1) * K]
        else:
            v = rows(v, n, i)
        out[k] = v.contiguous()
    return out
