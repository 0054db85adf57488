"""The train step as named stages (twin of ``repro/core/pipeline.py``), at
one rank with one microbatch.

The reference composes six stages, and the port keeps their names so a
stage's time and its reference line up:

    index_exchange   row mode, replicated index: the identity (for the
                     bag weights too, which ride idx's layout)
    embedding_fwd    the bag forward (embedding_bag kernel, weighted with
                     ``cfg.weighted``) and the bf16 round trip of the
                     row-mode wire
    dense_fwd_bwd    loss / B and its gradients with respect to the bf16
                     dense leaves and the bag outputs (autograd; the
                     interaction's forward is the dot_interaction kernel)
    dY_exchange      the cotangent rounded to bf16, as the row-mode wire is
    sparse_update    one stable sort of the lookups, then the fused sparse
                     backward + row update of the config's optimizer (one
                     of the embedding_update kernels, picked by optim.row),
                     each lookup's cotangent scaled by its bag weight, the
                     stochastic rounding keyed on the state's ``sr``
    dense_update     the flat Split-SGD step over the raveled dense
                     gradient (split_sgd kernel)

The step has no host sync between the batch's arrival and the returned
loss: no ``.item()``, ``nonzero`` or ``unique``.  More ranks, table mode,
M > 1 and the bf16 wires of the exchange come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.core import sharded_embedding as se
from repro_torch.optim import data_parallel as dp
from repro_torch.optim import row as row_optim

NUM_BUCKETS = 4  # the reference's RS+AG bucketing; at one rank it sets the padding only


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


def validate_pipeline(cfg, microbatches: int) -> None:
    """Refuse what the port does not train yet.  Every optimizer of
    ``optim.row.OPTIMIZERS`` trains, the compressed-state kinds included,
    with or without weighted bags."""
    if cfg.emb_mode != "row":
        raise NotImplementedError(f"emb_mode {cfg.emb_mode!r}: the port trains in row mode only")
    if cfg.mlp_impl != "xla":
        raise NotImplementedError(
            f"mlp_impl {cfg.mlp_impl!r}: the train step runs the MLP as torch.matmul ('xla'), as "
            "the reference does; its fused_mlp kernel has no backward")
    if microbatches != 1:
        raise NotImplementedError(f"microbatches={microbatches}: the port trains with 1")
    row_optim.resolve(cfg)


def build_stages(cfg, layout: se.ShardedEmbeddingLayout, device) -> PipelineStages:
    from repro_torch.core.dlrm import dlrm_dense_loss

    dev = resolve_device(device)
    opt = row_optim.resolve(cfg)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    dense_loss = dlrm_dense_loss(cfg)
    B = cfg.batch

    def index_exchange(idx):
        return idx, idx

    def embedding_fwd(W_fwd, idx_fwd, wgt_fwd=None):
        return se.row_sharded_bag_fwd(layout, W_fwd, idx_fwd, offsets, weights=wgt_fwd)

    def dense_fwd_bwd(dense_hi, emb_out, batch):
        params = [p.detach().requires_grad_() for p in dp.tree_leaves(dense_hi)]
        emb = emb_out.detach().requires_grad_()
        with torch.enable_grad():
            loss = dense_loss(dp.tree_unflatten(dense_hi, params), emb, batch) / B
            *g_dense, d_emb = torch.autograd.grad(loss, [*params, emb])
        return loss.detach(), dp.tree_unflatten(dense_hi, g_dense), d_emb

    def dY_exchange(d_emb):
        return se.gather_dY(layout, d_emb)

    def sparse_update(emb_store, idx_upd, dY, weights=None, seed=None):
        return se.apply_update(layout, emb_store, opt, idx_upd, dY, cfg.lr, offsets,
                               weights=weights, seed=seed)

    def dense_update(dense_state, g_dense):
        return dp.rs_ag_split_sgd(dense_state, g_dense, cfg.lr, num_buckets=NUM_BUCKETS)

    return PipelineStages(*(Stage(f.__name__, f) for f in (
        index_exchange, embedding_fwd, dense_fwd_bwd, dY_exchange, sparse_update, dense_update)))


def make_pipelined_train_step(cfg, device="cuda", microbatches: int = 1):
    """The train step of ``cfg``, ``step(state, batch) -> (state, loss)``.

    ``state`` as :func:`repro_torch.core.hybrid.init_state` makes it;
    ``batch``: ``idx`` [B, S, P] int32 table-local ids, ``dense_x``
    [B, num_dense] (bf16 or fp32: the first layer casts to bf16),
    ``labels`` [B] fp32 and, with ``cfg.weighted``, ``weights`` [B, S, P]
    fp32, on ``device``.  ``loss`` is the mean binary cross-entropy as a 0-d
    device tensor (no host sync).

    The step updates the embedding store and the dense state IN PLACE,
    where the reference donates them, and returns the same dict: clone a
    state before a step to keep it.  A state with ``sr`` (the stochastic
    rounding's seed) hands it to the sparse update, then adds one to it, in
    place on the device, as the reference's step returns ``sr + 1``."""
    validate_pipeline(cfg, microbatches)
    opt = row_optim.resolve(cfg)
    layout = se.make_layout(cfg.spec, 1, cfg.emb_mode)
    stages = build_stages(cfg, layout, device)

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
        return new_state, loss

    step.stages = stages
    return step
