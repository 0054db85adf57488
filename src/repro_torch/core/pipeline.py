"""The hybrid-parallel train step as named stages (twin of
``repro/core/pipeline.py``), on a mesh of ranks, with one microbatch.

The reference composes six stages, and the port keeps their names so a
stage's time and its reference line up.  Each rank runs them on its shard
of the state and its block of the batch (``core.hybrid.local_batch``):

    index_exchange   the index stream from the loader's layout to the
                     compute layout (and the bag weights, which ride idx's
                     layout): row mode with the replicated stream, the
                     identity; with the batch-sharded one, an all-gather
                     over the mesh.  Table mode with the replicated
                     (padded-slot, model-sharded) stream: the update side
                     all-gathers the replicas' batch rows; with the
                     batch-sharded stream: an all-gather over the mesh, the
                     padded-slot permute, this shard's slots, and the data
                     replica's rows for the forward
    embedding_fwd    the bag forward (embedding_bag kernel, weighted with
                     ``cfg.weighted``) and the layout switch to the batch
                     split: row mode's bf16 reduce-scatter, table mode's
                     fp32 all-to-all
    dense_fwd_bwd    this rank's share of loss / B and its gradients with
                     respect to the bf16 dense leaves and the bag outputs
                     (autograd; the interaction's forward is the
                     dot_interaction kernel)
    dY_exchange      the cotangent back to the update's layout: row mode's
                     bf16 all-gather, table mode's inverse fp32 all-to-all
                     and replica all-gather
    sparse_update    one stable sort of the shard's lookups, then the fused
                     sparse backward + row update of the config's optimizer
                     (one of the embedding_update kernels, picked by
                     optim.row), each lookup's cotangent scaled by its bag
                     weight, the stochastic rounding keyed on the state's
                     ``sr``
    dense_update     the bucketed reduce-scatter, the flat Split-SGD step on
                     this rank's shard (split_sgd kernel) and the all-gather
                     of the new ``hi``

The collectives are ``dist.comm``'s over the mesh's groups; on a one-rank
mesh without a process group each is the identity, and the step is the
one-rank step of the earlier slices, bit for bit.  The step has no host
sync between the batch's arrival and the returned loss (no ``.item()``,
``nonzero`` or ``unique``) unless its collectives stage through host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import sharded_embedding as se
from repro_torch.dist import comm
from repro_torch.dist import exchange as exchange_cfg
from repro_torch.optim import data_parallel as dp
from repro_torch.optim import row as row_optim

@dataclasses.dataclass(frozen=True)
class Stage:
    """One named piece of the train step."""

    name: str
    fn: Callable

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class PipelineStages:
    index_exchange: Stage
    embedding_fwd: Stage
    dense_fwd_bwd: Stage
    dY_exchange: Stage
    sparse_update: Stage
    dense_update: Stage


def mesh_axes(mesh) -> tuple[tuple[str, ...], str, tuple[str, ...]]:
    """(all_axes, model_axis, batch_axes).  The last mesh axis is 'model'."""
    names = tuple(mesh.axis_names)
    return names, names[-1], names[:-1]


def emb_axes(cfg, mesh) -> tuple[tuple, Optional[tuple]]:
    """(the axes the rows are sharded over, the axes the shards are
    replicated over or None): row mode shards over the whole mesh; table
    mode over the model axis, replicated over the rest."""
    all_axes, model, batch_axes = mesh_axes(mesh)
    if cfg.emb_mode == "row":
        return all_axes, None
    return (model,), (batch_axes if batch_axes else None)


def num_shards(cfg, mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in emb_axes(cfg, mesh)[0]]))


def validate_pipeline(cfg, mesh, microbatches: int) -> None:
    """Refuse what the port does not train, or what cannot be laid out.
    Every optimizer of ``optim.row.OPTIMIZERS`` trains, with or without
    weighted bags, in either mode and with either index input."""
    if cfg.emb_mode not in ("row", "table"):
        raise ValueError(f"unknown emb_mode {cfg.emb_mode!r}; expected 'row' or 'table'")
    if cfg.idx_input not in ("replicated", "sharded"):
        raise ValueError(f"unknown idx_input {cfg.idx_input!r}; expected 'replicated' or "
                         "'sharded'")
    exchange_cfg.resolve_exchange(cfg).check_ported()
    if cfg.mlp_impl != "xla":
        raise NotImplementedError(
            f"mlp_impl {cfg.mlp_impl!r}: the train step runs the MLP as torch.matmul ('xla'), as "
            "the reference does; its fused_mlp kernel has no backward")
    if microbatches != 1:
        raise NotImplementedError(f"microbatches={microbatches}: the port trains with 1 "
                                  "(ROADMAP queue 1 item 4)")
    if getattr(cfg, "hot_rows", 0):
        raise NotImplementedError(f"hot_rows={cfg.hot_rows}: the hot-row cache is not ported "
                                  "(ROADMAP queue 1 item 5)")
    if getattr(cfg, "host_presort", False):
        raise NotImplementedError("host_presort: the host-sorted update stream is not ported "
                                  "(ROADMAP queue 1 item 3)")
    ns = mesh.size
    if cfg.batch % (microbatches * ns):
        raise ValueError(f"global batch {cfg.batch} must be divisible by microbatches * mesh "
                         f"size = {microbatches} * {ns}")
    row_optim.resolve(cfg)


def build_stages(cfg, layout: se.ShardedEmbeddingLayout, mesh) -> PipelineStages:
    """The six stages of ``cfg`` on this rank of ``mesh`` (a
    ``launch.mesh.Mesh``; its device is the rank's)."""
    from repro_torch.core.dlrm import dlrm_dense_loss

    dev = mesh.device
    all_axes, model, batch_axes = mesh_axes(mesh)
    emb_ax, replica_ax = emb_axes(cfg, mesh)
    g_all, g_emb = mesh.group(all_axes), mesh.group(emb_ax)
    g_rep = None if replica_ax is None else mesh.group(replica_ax)
    shard = g_emb.index
    nb = int(np.prod([mesh.shape[a] for a in batch_axes])) if batch_axes else 1
    d_idx = mesh.group(batch_axes).index if batch_axes else 0
    ex = exchange_cfg.resolve_exchange(cfg)
    opt = row_optim.resolve(cfg)
    offsets = torch.as_tensor(se.local_offsets(layout, shard), dtype=torch.int32, device=dev)
    dense_loss = dlrm_dense_loss(cfg)
    B = cfg.batch
    table = cfg.emb_mode == "table"
    maps = se.slot_maps(layout, dev) if table else None

    def index_exchange(idx, fwd_only: bool = False):
        """(idx_fwd, idx_upd): what the forward reads and what the update
        reads (``fwd_only``: the update side is None)."""
        if not table:
            if cfg.idx_input == "sharded":
                idx = comm.all_gather(idx, g_emb)
            return idx, idx
        if cfg.idx_input == "sharded":
            full = comm.all_gather(idx, g_all)
            K = layout.slots_per_shard
            idx_upd = se.permute_indices(layout, full, maps)[:, shard * K:(shard + 1) * K]
            c = idx_upd.shape[0] // nb
            idx_fwd = idx_upd[d_idx * c:(d_idx + 1) * c].contiguous()
            return idx_fwd, None if fwd_only else idx_upd.contiguous()
        if fwd_only:
            return idx, None
        return idx, (idx if g_rep is None else comm.all_gather(idx, g_rep))

    def embedding_fwd(W_fwd, idx_fwd, wgt_fwd=None):
        if table:
            return se.table_sharded_bag_fwd(layout, W_fwd, idx_fwd, g_emb, wgt_fwd, offsets, maps)
        return se.row_sharded_bag_fwd(layout, W_fwd, idx_fwd, offsets, weights=wgt_fwd,
                                      group=g_emb)

    def dense_fwd_bwd(dense_hi, emb_out, batch):
        params = [p.detach().requires_grad_() for p in dp.tree_leaves(dense_hi)]
        emb = emb_out.detach().requires_grad_()
        with torch.enable_grad():
            loss = dense_loss(dp.tree_unflatten(dense_hi, params), emb, batch) / B
            *g_dense, d_emb = torch.autograd.grad(loss, [*params, emb])
        return loss.detach(), dp.tree_unflatten(dense_hi, g_dense), d_emb

    def dY_exchange(d_emb):
        return se.gather_dY(layout, d_emb, g_emb, g_rep, maps)

    def sparse_update(emb_store, idx_upd, dY, weights=None, seed=None):
        return se.apply_update(layout, emb_store, opt, idx_upd, dY, cfg.lr, offsets,
                               weights=weights, seed=seed, group=g_emb)

    def dense_update(dense_state, g_dense):
        return dp.rs_ag_split_sgd(dense_state, g_dense, cfg.lr, num_buckets=ex.num_buckets,
                                  group=g_all)

    return PipelineStages(*(Stage(f.__name__, f) for f in (
        index_exchange, embedding_fwd, dense_fwd_bwd, dY_exchange, sparse_update, dense_update)))


def make_pipelined_train_step(cfg, mesh, microbatches: int = 1):
    """The train step of ``cfg`` on this rank of ``mesh``,
    ``step(state, batch) -> (state, loss)``.

    ``state``: this rank's shard, as :func:`repro_torch.core.hybrid.init_state`
    or ``weights.state_from_numpy`` makes it; ``batch``: this rank's block of
    the reference's global batch (``core.hybrid.local_batch``): ``idx``
    int32 table-local ids, ``dense_x`` [B / ranks, num_dense] (bf16 or fp32:
    the first layer casts to bf16), ``labels`` [B / ranks] fp32 and, with
    ``cfg.weighted``, ``weights`` fp32 in idx's layout, on the rank's
    device.  ``loss`` is the batch's mean binary cross-entropy, the same on
    every rank, as a 0-d device tensor.

    The step updates the embedding store and the dense state IN PLACE,
    where the reference donates them, and returns the same dict: clone a
    state before a step to keep it.  A state with ``sr`` (the stochastic
    rounding's seed) hands it to the sparse update, then adds one to it, in
    place on the device, as the reference's step returns ``sr + 1``.
    ``step.stages`` holds the stages and ``step.mesh`` the mesh, whose
    ``stats`` count the collectives."""
    from repro_torch.core import hybrid

    validate_pipeline(cfg, mesh, microbatches)
    opt = row_optim.resolve(cfg)
    layout = hybrid.make_layout(cfg, mesh)
    stages = build_stages(cfg, layout, mesh)
    g_all = mesh.group(mesh_axes(mesh)[0])

    def step(state: dict, batch: dict):
        emb_store = state["emb"]
        sr = state.get("sr")
        idx_fwd, idx_upd = stages.index_exchange(batch["idx"])
        wgt_fwd, wgt_upd = (stages.index_exchange(batch["weights"]) if cfg.weighted
                            else (None, None))
        emb_out = stages.embedding_fwd(row_optim.fwd_weights(opt, emb_store), idx_fwd, wgt_fwd)
        loss, g_dense, d_emb = stages.dense_fwd_bwd(state["dense"]["hi"], emb_out, batch)
        dY = stages.dY_exchange(d_emb)
        new_emb = stages.sparse_update(emb_store, idx_upd, dY, wgt_upd, sr)
        new_dense = stages.dense_update(state["dense"], g_dense)
        new_state = {"emb": new_emb, "dense": new_dense}
        if sr is not None:
            new_state["sr"] = sr.add_(1)
        return new_state, comm.psum(loss, g_all)

    step.stages = stages
    step.mesh = mesh
    return step
