"""The hybrid-parallel model definition and its train-state layout and
batch on a mesh (twin of ``repro/core/hybrid.py``).

:class:`HybridDef` is what a model of the hybrid skeleton provides: its
embedding spec, pooling and batch, its dense tree (``init_dense``), its loss
and scorer on the bag outputs (``dense_loss`` / ``dense_score``), the extra
batch fields they read (``extras``) and the slot -> table map of models that
read one table from several slots, with the step's options.  DLRM is one
(``core.dlrm.as_hybrid_def``), and the four recsys archetypes of
``models.recsys`` are the others.  Every function here and in
``core.pipeline``, ``weights``, ``serve.snapshot`` and ``serve.publish``,
and ``train.TrainLoop(model_cfg=)``, takes a :class:`HybridDef` or a
``core.dlrm.DLRMConfig``, which :func:`as_hybrid` converts at the entry.

A rank's state is its shard of the reference's global pytree:

    {"emb": {"hi": [R, E] bf16, "lo": [R, E] int16}    (split_sgd)
            | {"w": [R, E] fp32, + state slabs}         (the others)
     "dense": {"hi": the model's dense tree, bf16,
               "lo": [padded / ranks] int16,
               "err": [padded / ranks] fp32 | None}}

``R`` is the layout's ``rows_per_shard``: in row mode the rank's window of
the row space, in table mode its bin of tables (replicated over the data
axes).  ``lo`` is the rank's chunk of the bucketed dense ``lo``
(``optim.data_parallel``), raveled in JAX's pytree order (dict keys sorted,
list items in order) whatever the tree's nesting, and ``err`` its chunk of
the dense error feedback's residual, present with the ``"bf16"`` dense wire
and ``error_feedback`` (``ExchangeConfig.needs_err``).  ``lo`` slabs hold
the bits of the reference's uint16 slabs as int16, since PyTorch has no
arithmetic on uint16.  The state slabs are the optimizer's
(``optim.row.RowOptimizer.state``): ``mom`` or ``acc`` [R, E] fp32, ``acc``
[R, 1] fp32 (row-wise Adagrad), ``cnt`` [R, 1] int32, or ``mom`` / ``acc``
[R, E] bf16 (the compressed-state kinds), zero at the start.  An optimizer
that rounds its state stochastically, or a ``"bf16_sr"`` wire, adds
``"sr"``, the per-step seed, replicated: a 0-d int32 tensor,
``mdef.sr_seed`` at the start, one more after each step.  With
``hot_rows`` the store carries the touch counts ``cnt`` [R, 1] int32
(unless the optimizer declares them) and the state the replicated
``"cache"`` (``core.cache``: ``hot_w``, ``hot_ids``, ``hot_pos``, ``tick``);
with ``step_metrics`` the replicated fp32 vector ``"metrics"``
(``telemetry.metrics``).  The dense ``hi`` leaves are views into one flat
bf16 buffer (``optim.data_parallel.pack_hi``), which the dense update steps
in place.

:func:`make_score_step` and :func:`make_retrieval_step` are the forward-only
steps on a train state: a batch's scores, and one query scored against a
candidate matrix with a top-k merged over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.core import sharded_embedding as se
from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.dist import comm
from repro_torch.dist.exchange import ExchangeConfig, resolve_exchange
from repro_torch.launch.mesh import Mesh, resolve_mesh
from repro_torch.optim import data_parallel as dp
from repro_torch.optim import row as row_optim


@dataclasses.dataclass(frozen=True)
class HybridDef:
    """What a hybrid-parallel recsys model must provide (the reference's
    fields; ``init_dense`` takes a ``torch.Generator`` and a device in place
    of a JAX key, ``extras`` dtypes are torch dtypes).  The reference's
    deprecated flat sugar (``split_sgd``, ``compress_grads``,
    ``num_buckets``, ``exchange_impl``) and ``fused_update`` are not carried:
    the port reads the typed ``exchange`` alone, and a CUDA store always
    takes the fused kernel."""

    name: str
    spec: EmbeddingSpec
    pooling: int                   # P (max lookups per slot)
    batch: int                     # global batch
    # init_dense(generator, device) -> the fp32 dense tree (dicts and lists)
    init_dense: Callable[[Optional[torch.Generator], Any], Any]
    # dense_loss(dense_hi, emb_out [b, S, E] fp32, batch) -> this rank's SUM loss;
    # None: the model scores but does not train
    dense_loss: Optional[Callable[[Any, torch.Tensor, dict], torch.Tensor]]
    # dense_score(dense_hi, emb_out, batch) -> [b] scores
    dense_score: Callable[[Any, torch.Tensor, dict], torch.Tensor]
    # extra batch fields: name -> (shape after B, torch dtype); all batch-sharded
    extras: dict = dataclasses.field(default_factory=dict)
    # slot -> table map (sequence models share one item table across slots)
    slot_to_table: Optional[tuple] = None
    emb_mode: str = "row"
    # the sparse row optimizer (optim.row; unset: 'split_sgd'), opt_beta /
    # opt_eps overriding its defaults
    sparse_optimizer: Optional[str] = None
    opt_beta: Optional[float] = None
    opt_eps: Optional[float] = None
    # the collectives' configuration (dist/exchange.py): a typed
    # ExchangeConfig, or exchange_dtype setting both wire formats
    exchange: Optional[ExchangeConfig] = None
    exchange_dtype: Optional[str] = None
    lr: float = 0.01               # the dense update's step
    emb_lr: float = 0.01           # the sparse update's step
    idx_input: str = "replicated"  # 'sharded': the on-device index exchange
    microbatches: int = 1
    # weighted bags: the batch carries 'weights' [B, S, P] fp32 in idx's layout
    weighted: bool = False
    # the update's stream sorted on the host: the batch carries psort_*
    host_presort: bool = False
    sr_seed: int = 0
    # the hot-row cache (core/cache.py) and its cadence
    hot_rows: int = 0
    promote_every: int = 1
    hot_sync: str = "allreduce"
    # the in-graph step metrics (telemetry/metrics.py)
    step_metrics: bool = False


def as_hybrid(model) -> HybridDef:
    """``model`` as a :class:`HybridDef`: itself, or a
    ``core.dlrm.DLRMConfig`` through ``core.dlrm.as_hybrid_def``."""
    if isinstance(model, HybridDef):
        return model
    from repro_torch.core.dlrm import DLRMConfig, as_hybrid_def
    if isinstance(model, DLRMConfig):
        return as_hybrid_def(model)
    raise TypeError(f"need a HybridDef or a DLRMConfig, got {type(model).__name__}")


def _struct_of(tree, dtype: Optional[torch.dtype] = None):
    """``(shape, dtype)`` at each leaf of a tree of tensors (dicts and lists
    kept), ``dtype`` in place of the leaves' own where given."""
    if isinstance(tree, dict):
        return {k: _struct_of(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_struct_of(v, dtype) for v in tree]
    return (tuple(tree.shape), dtype or tree.dtype)


def dense_tree(mdef) -> Any:
    """The model's fp32 dense tree as ``meta`` tensors: its shapes, with
    nothing allocated or drawn."""
    return as_hybrid(mdef).init_dense(torch.Generator(), torch.device("meta"))


def make_layout(mdef, mesh: Mesh | None = None) -> se.ShardedEmbeddingLayout:
    """The embedding layout of ``mdef`` over the shards of ``mesh`` (None:
    one rank), its slots mapped to tables by ``slot_to_table``."""
    mdef = as_hybrid(mdef)
    mesh = resolve_mesh(mesh, "cpu")
    return se.make_layout(mdef.spec, pipeline.num_shards(mdef, mesh), mdef.emb_mode,
                          slot_to_table=mdef.slot_to_table)


def emb_shard(cfg, mesh: Mesh) -> int:
    """The embedding shard this rank holds."""
    return mesh.group(pipeline.emb_axes(cfg, mesh)[0]).index


def dense_sizes(mdef) -> int:
    """The values of the model's dense tree."""
    return dp.ravel_size(dense_tree(mdef))


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
    slab; the dense ``hi`` tree is ``init_dense``'s, in bf16."""
    cfg = as_hybrid(cfg)
    mesh = resolve_mesh(mesh, "cpu")
    layout = make_layout(cfg, mesh)
    E = cfg.spec.dim
    opt = row_optim.resolve(cfg)
    emb = opt.store_struct(layout.rows_per_shard, E, counters=hot_rows(cfg) > 0)
    hi = _struct_of(dense_tree(cfg), torch.bfloat16)
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


def init_state(cfg, generator: torch.Generator, device="cuda", mesh=None, *,
               shard_only: bool = False) -> dict:
    """This rank's train state, drawn from ``generator`` (which must live on
    the rank's device and be seeded alike on every rank) with the
    reference's distributions: table rows ~ U(-a, a), a = 1 / sqrt(mean
    table rows), over the layout's whole row space; dense weights as
    ``core.dlrm.init_dense_params``.  Each rank draws the global arrays and
    keeps its shard.  ``mesh`` (None: one rank on ``device``).  The numbers
    differ from the reference's ``jax.random`` draw;
    ``weights.state_from_numpy`` carries a JAX state across instead.
    ``shard_only``: draw this rank's rows alone, a block at a time (the dry
    run's production meshes, whose global tables no card holds); the rows
    then depend on the rank's shard, not on the global draw."""
    cfg = as_hybrid(cfg)
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    layout = make_layout(cfg, mesh)
    a = 1.0 / float(np.sqrt(np.mean(cfg.spec.table_rows)))
    opt = row_optim.resolve(cfg)
    R, s = layout.rows_per_shard, emb_shard(cfg, mesh)
    if shard_only:
        emb = _drawn_store(opt, R, cfg.spec.dim, a, generator, dev, hot_rows(cfg) > 0)
    else:
        W = torch.empty((layout.total_rows, cfg.spec.dim), device=dev).uniform_(
            -a, a, generator=generator)
        if layout.num_shards > 1:
            W = W[s * R:(s + 1) * R].clone()
        emb = row_optim.init_store(opt, W, counters=hot_rows(cfg) > 0)
        del W
    params = cfg.init_dense(generator, dev)
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


def _drawn_store(opt, rows: int, E: int, a: float, generator: torch.Generator, dev,
                 counters: bool, block: int = 1 << 20) -> dict:
    """A store of ``rows`` rows ~ U(-a, a), drawn ``block`` rows at a time
    (no fp32 copy of the whole table), the state slabs zero."""
    from repro_torch.optim.split_sgd import split_fp32
    store = {k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in opt.store_struct(rows, E, counters=counters).items()}
    for r in range(0, rows, block):
        W = torch.empty((min(block, rows - r), E), device=dev).uniform_(-a, a, generator=generator)
        if opt.split:
            store["hi"][r:r + len(W)], store["lo"][r:r + len(W)] = split_fp32(W)
        else:
            store["w"][r:r + len(W)] = W
    return store


def batch_struct(cfg, mesh: Mesh, layout: se.ShardedEmbeddingLayout,
                 batch: int | None = None) -> dict:
    """``(shape, dtype)`` of each field of one global batch of ``cfg`` on
    ``mesh`` (``batch`` samples, ``cfg.batch`` by default), in the
    reference's ``batch_struct`` order: the ids, the bag weights, the host
    pre-sort's fields, then the model's ``extras``."""
    cfg = as_hybrid(cfg)
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
    for name, (shape, dtype) in cfg.extras.items():
        out[name] = ((B, *shape), dtype)
    return out


def batch_specs(cfg, mesh: Mesh) -> dict:
    """How the reference's mesh holds each field of :func:`batch_struct`
    (``dist.sharding``'s spec tuples): the replicated index stream whole in
    row mode, in table mode its padded slots over the model axis and its
    rows over the data axes; a batch-sharded stream and the extras by rows
    over the whole mesh; the ``psort_*`` fields a row an embedding shard."""
    cfg = as_hybrid(cfg)
    all_axes, model, batch_axes = pipeline.mesh_axes(mesh)
    if cfg.idx_input == "sharded":
        idx = (all_axes, None, None)
    elif cfg.emb_mode == "row":
        idx = (None, None, None)
    else:
        idx = (batch_axes if batch_axes else None, model, None)
    out = {"idx": idx}
    if cfg.weighted:
        out["weights"] = idx
    if cfg.host_presort:
        emb_ax = pipeline.emb_axes(cfg, mesh)[0]
        for name in ("psort_rows", "psort_bags", "psort_msk", "psort_wgt"):
            out[name] = (emb_ax, None)
    for name, (shape, _) in cfg.extras.items():
        out[name] = (all_axes,) + (None,) * len(shape)
    return out


def batch_struct_from_spec(cfg, mesh: Mesh, layout: se.ShardedEmbeddingLayout, dataset_spec,
                           batch: int | None = None) -> dict:
    """:func:`batch_struct` checked against a packed dataset's
    ``data.format.DatasetSpec``: the loader-facing entry.  A mismatch
    between the dataset and the model fails here, at wiring time, with the
    reference's field-by-field message, not as a shape error inside the
    step."""
    cfg = as_hybrid(cfg)
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

    cfg = as_hybrid(cfg)
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


def make_train_step(mdef, mesh=None, microbatches: int | None = None, *, device="cuda"):
    """The staged train step of ``mdef`` on this rank of ``mesh`` (None: one
    rank on ``device``) over ``microbatches`` (``mdef.microbatches`` by
    default): ``core.pipeline.make_pipelined_train_step``."""
    M = mdef.microbatches if microbatches is None else microbatches
    return pipeline.make_pipelined_train_step(mdef, resolve_mesh(mesh, device), M)


def make_score_step(mdef, mesh=None, *, device="cuda"):
    """Forward-only scoring of a train state (serve_p99 / serve_bulk shapes)
    on this rank of ``mesh`` (None: one rank on ``device``): the train
    step's ``index_exchange`` (its forward stream) and ``embedding_fwd``
    stages on the optimizer's forward slabs, weighted with ``mdef.weighted``,
    then ``mdef.dense_score``.  Returns ``score(state, batch) -> [b]``, the
    scores of this rank's block of a global batch of any size, cut by
    :func:`local_batch`; no ``psort_*`` field is read."""
    mdef = as_hybrid(mdef)
    mesh = resolve_mesh(mesh, device)
    stages = pipeline.build_stages(mdef, make_layout(mdef, mesh), mesh)
    opt = row_optim.resolve(mdef)

    def score(state: dict, batch_d: dict) -> torch.Tensor:
        idx_fwd = stages.index_exchange(batch_d["idx"], fwd_only=True)[0]
        wgt_fwd = (stages.index_exchange(batch_d["weights"], fwd_only=True)[0]
                   if mdef.weighted else None)
        emb_out = stages.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), idx_fwd,
                                       wgt_fwd)
        return mdef.dense_score(state["dense"]["hi"], emb_out, batch_d)

    return score


#: candidates a retrieval step scores at once: the dense scorer's
#: intermediates of 2^14 candidates stay within a few GB at the archetypes'
#: widths (DIN's attention input alone is 100 x 72 fp32 values a candidate)
RETRIEVAL_CHUNK = 1 << 14


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of ``x`` along its last dim and their indices,
    largest first and the lower index first among equal values:
    ``jax.lax.top_k``'s order (``torch.topk`` leaves the order of ties open,
    and may even pick another set of them).  A stable descending sort, cut
    at ``k``."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def make_retrieval_step(mdef, mesh, n_candidates: int, target_slot: int, topk: int = 128, *,
                        device="cuda"):
    """retrieval_cand shape: ONE query against ``n_candidates`` candidates,
    on this rank of ``mesh`` (None: one rank on ``device``).

    Returns ``fn(state, batch, cand)
    -> (values [topk], indices [topk])``, the same on every rank. ``batch``:
    the query, ``idx`` [1, S, P] and the model's extras (rank-1 extras are
    reshaped to ``(1, *shape)``), whole on every rank; ``cand``: this rank's
    block of the candidate matrix, rows ``[rank * per, (rank + 1) * per)``
    of the global [n_candidates, E] bf16 (``per = n_candidates / ranks``).
    The query's bags are summed over the row shards with a replicated output
    (``sharded_embedding.row_bag_fwd_replicated``), the target slot is
    replaced by each local candidate, and ``mdef.dense_score`` runs over the
    local candidates :data:`RETRIEVAL_CHUNK` at a time (16,384: each
    candidate's score depends on its own row alone, so the chunks keep the
    scorer's memory bounded whatever the count). The local top-k
    (:func:`topk_stable` over all local scores) is merged over the ranks by an
    all-gather and a second top-k, as the reference merges it: among equal
    scores the lower candidate index comes first, the lower rank's first
    across ranks."""
    mdef = as_hybrid(mdef)
    if mdef.weighted:
        raise ValueError("retrieval scores a single replicated query "
                         "against a prebuilt candidate matrix; weighted "
                         "bags are not supported on this path — replace "
                         "the mdef with weighted=False for retrieval")
    if mdef.emb_mode != "row":
        raise ValueError("retrieval step requires emb_mode='row' "
                         f"(got {mdef.emb_mode!r})")
    if mdef.idx_input != "replicated":
        raise ValueError("retrieval step scores ONE replicated query; a "
                         "batch-sharded index stream (idx_input='sharded') "
                         "cannot shard a single sample — replace the mdef "
                         "with idx_input='replicated' for retrieval")
    mesh = resolve_mesh(mesh, device)
    layout = make_layout(mdef, mesh)
    all_axes, _, _ = pipeline.mesh_axes(mesh)
    g_all = mesh.group(all_axes)
    g_emb = mesh.group(pipeline.emb_axes(mdef, mesh)[0])
    offsets = torch.as_tensor(se.local_offsets(layout, g_emb.index), dtype=torch.int32,
                              device=mesh.device)
    ns = mesh.size
    if n_candidates % ns:
        raise ValueError(f"{n_candidates} candidates do not split over {ns} ranks")
    per = n_candidates // ns
    opt = row_optim.resolve(mdef)

    def normalize(batch: dict) -> dict:
        """Every declared extra reshaped to ``(1, *shape)``, so a rank-1
        (B-squeezed) extra is accepted instead of silently dropped."""
        out = dict(batch)
        for k, (shape, _) in mdef.extras.items():
            if k in out:
                out[k] = out[k].reshape((1,) + tuple(shape))
        return out

    def broadcast(batch: dict, n: int) -> dict:
        """The query as a batch of ``n`` candidates: declared extras
        broadcast by their schema, other fields with a leading 1 by it."""
        out = {}
        for k, v in batch.items():
            if k in mdef.extras:
                out[k] = v.expand((n,) + tuple(mdef.extras[k][0]))
            elif torch.is_tensor(v) and v.shape[:1] == (1,):
                out[k] = v.expand((n,) + tuple(v.shape[1:]))
            else:
                out[k] = v
        return out

    def fn(state: dict, batch: dict, cand: torch.Tensor):
        if tuple(cand.shape) != (per, mdef.spec.dim):
            raise ValueError(f"this rank's candidates must be [{per}, {mdef.spec.dim}], got "
                             f"{tuple(cand.shape)}")
        batch = normalize(batch)
        emb = se.row_bag_fwd_replicated(layout, row_optim.fwd_weights(opt, state["emb"]),
                                        batch["idx"], offsets, g_emb)  # [1, S, E] fp32
        scores = torch.empty(per, dtype=torch.float32, device=cand.device)
        for c0 in range(0, per, RETRIEVAL_CHUNK):
            n = min(RETRIEVAL_CHUNK, per - c0)
            emb_c = emb.expand((n,) + tuple(emb.shape[1:])).clone()
            emb_c[:, target_slot] = cand[c0:c0 + n].float()
            scores[c0:c0 + n] = mdef.dense_score(state["dense"]["hi"], emb_c, broadcast(batch, n))
        v, i = topk_stable(scores, min(topk, per))
        i = (i + g_all.index * per).to(torch.int32)   # the reference's int32 indices on the wire
        vg, ig = comm.all_gather(v, g_all), comm.all_gather(i, g_all)
        vv, pos = topk_stable(vg, min(topk, vg.numel()))
        return vv, ig[pos]

    return fn
