"""The hybrid-parallel train step as named stages (twin of
``repro/core/pipeline.py``), on a mesh of ranks, over M microbatches.

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
                     bf16 all-gather, table mode's inverse all-to-all and
                     replica all-gather, on the config's ``dY_dtype`` wire
                     (``dist.exchange``; the ``bf16_sr`` dither keyed on
                     ``sr`` and the microbatch)
    sparse_update    one stable sort of the shard's lookups (or, with
                     ``host_presort``, the batch's ``psort_*`` fields
                     sorted on the host: no sort), then the fused
                     sparse backward + row update of the config's optimizer
                     (one of the embedding_update kernels, picked by
                     optim.row), each lookup's cotangent scaled by its bag
                     weight, the stochastic rounding keyed on the state's
                     ``sr``
    dense_update     the bucketed reduce-scatter (on the ``dense_dtype``
                     wire, with the ``bf16`` wire's error feedback), the
                     flat Split-SGD step on this rank's shard (split_sgd
                     kernel) and the all-gather of the new ``hi``

With ``microbatches`` M > 1, microbatch i is every rank's i-th slice of its
block of the batch (the replicated index streams: the matching strided
selection), microbatch i + 1's index exchange is issued before microbatch
i's compute, every microbatch's forward and backward read the step's
initial weights, the losses and the dense gradients accumulate microbatch
by microbatch, and the update streams, concatenated, are put back in the
batch's order: one sparse update and one dense update a step, as at M = 1.

With ``hot_rows`` (``core.cache``) table mode with the sharded stream puts
the bags whose lookups all hit the replicated mirror in place of the
forward's (summed from the rank's own block by the same bag kernel), and
after the sparse update the cache's epilogue promotes and refreshes; with
``step_metrics`` an epilogue adds the step's counts to the state's
``metrics`` (``telemetry.metrics``).  Neither reads anything on the host.

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
    weighted bags, in either mode and with either index input, on every wire
    and index exchange, with the host pre-sort or without, at any M, with
    the hot-row cache and the step metrics or without."""
    if cfg.emb_mode not in ("row", "table"):
        raise ValueError(f"unknown emb_mode {cfg.emb_mode!r}; expected 'row' or 'table'")
    if cfg.idx_input not in ("replicated", "sharded"):
        raise ValueError(f"unknown idx_input {cfg.idx_input!r}; expected 'replicated' or "
                         "'sharded'")
    exchange_cfg.resolve_exchange(cfg)
    if cfg.dense_loss is None:
        raise NotImplementedError(f"model {cfg.name!r} has no dense_loss: its forward scores "
                                  "but has no backward to train with")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    hot_rows = int(cfg.hot_rows)
    if hot_rows < 0:
        raise ValueError(f"hot_rows must be >= 0, got {hot_rows}")
    # checked with the cache off too: a malformed 'deferred:' fails when the step is built
    from repro_torch.core.cache import parse_hot_sync
    parse_hot_sync(cfg.hot_sync)
    if hot_rows > 0:
        if int(cfg.promote_every) < 1:
            raise ValueError(f"promote_every must be >= 1, got {cfg.promote_every}")
        if hot_rows > cfg.spec.total_rows:
            raise ValueError(f"hot_rows {hot_rows} exceeds the unified row space "
                             f"({cfg.spec.total_rows} rows)")
    ns = mesh.size
    if cfg.batch % (microbatches * ns):
        raise ValueError(f"global batch {cfg.batch} must be divisible by microbatches * mesh "
                         f"size = {microbatches} * {ns}")
    row_optim.resolve(cfg)


def _ring_all_gather_1d(x: torch.Tensor, g: comm.Group) -> torch.Tensor:
    """The tiled all-gather over one axis's group as size - 1 shifts of one
    along its ring (``comm.ppermute``): after shift k a rank holds the
    block of the rank k before it.  Pure data movement."""
    if g.size == 1:
        return x
    c = x.shape[0]
    out = torch.empty((g.size * c,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[g.index * c:(g.index + 1) * c] = x
    cur = x
    for k in range(1, g.size):
        cur = comm.ppermute(cur, g)
        src = (g.index - k) % g.size
        out[src * c:(src + 1) * c] = cur
    return out


def ring_all_gather(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The tiled all-gather over the mesh axes ``axes`` as one ring an axis,
    minor axis first: the fused all-gather's block order, bit for bit."""
    for a in reversed(tuple(axes)):
        x = _ring_all_gather_1d(x, mesh.group(a))
    return x


def build_stages(cfg, layout: se.ShardedEmbeddingLayout, mesh) -> PipelineStages:
    """The six stages of the model ``cfg`` (a ``core.hybrid.HybridDef`` or a
    ``core.dlrm.DLRMConfig``) on this rank of ``mesh`` (a
    ``launch.mesh.Mesh``; its device is the rank's): the loss is the
    model's ``dense_loss``, the sparse update steps by ``emb_lr`` and the
    dense update by ``lr``."""
    from repro_torch.core.hybrid import as_hybrid

    cfg = as_hybrid(cfg)
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
    dense_loss = cfg.dense_loss
    B = cfg.batch
    table = cfg.emb_mode == "table"
    maps = se.slot_maps(layout, dev) if table else None

    def gather(x, axes):
        if ex.impl == "ring":
            return ring_all_gather(x, mesh, axes)
        return comm.all_gather(x, mesh.group(axes))

    def index_exchange(idx, fwd_only: bool = False):
        """(idx_fwd, idx_upd): what the forward reads and what the update
        reads (``fwd_only``: the update side is None)."""
        if not table:
            if cfg.idx_input == "sharded":
                idx = gather(idx, emb_ax)
            return idx, idx
        if cfg.idx_input == "sharded":
            full = gather(idx, all_axes)
            K = layout.slots_per_shard
            idx_upd = se.permute_indices(layout, full, maps)[:, shard * K:(shard + 1) * K]
            c = idx_upd.shape[0] // nb
            idx_fwd = idx_upd[d_idx * c:(d_idx + 1) * c].contiguous()
            return idx_fwd, None if fwd_only else idx_upd.contiguous()
        if fwd_only:
            return idx, None
        return idx, (idx if replica_ax is None else gather(idx, replica_ax))

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

    def dY_exchange(d_emb, seed=None, tag: int = 0):
        # seed: the state's sr (None: 0); tag: the microbatch
        return se.gather_dY(layout, d_emb, g_emb, g_rep, maps, wire_dtype=ex.dY_dtype,
                            seed=seed, tag=tag)

    def sparse_update(emb_store, idx_upd, dY, weights=None, seed=None, presort=None):
        return se.apply_update(layout, emb_store, opt, idx_upd, dY, cfg.emb_lr, offsets,
                               weights=weights, seed=seed, group=g_emb, presort=presort)

    def dense_update(dense_state, g_dense, seed=None):
        return dp.rs_ag_split_sgd(dense_state, g_dense, cfg.lr, num_buckets=ex.num_buckets,
                                  group=g_all, wire_dtype=ex.dense_dtype,
                                  error_feedback=ex.error_feedback, seed=seed)

    return PipelineStages(*(Stage(f.__name__, f) for f in (
        index_exchange, embedding_fwd, dense_fwd_bwd, dY_exchange, sparse_update, dense_update)))


def _slice_local(v: torch.Tensor, i: int, M: int) -> torch.Tensor:
    c = v.shape[0] // M
    return v[i * c:(i + 1) * c]


def _slice_idx(v: torch.Tensor, i: int, M: int, idx_input: str, width: int) -> torch.Tensor:
    """Microbatch i of an index stream (or of its bag weights): a contiguous
    slice of a batch-sharded stream; of a replicated one the strided
    selection ``[width, M, c][:, i]`` (``width`` the ranks the stream is
    replicated over), so the microbatch's bags land on the rows whose dense
    features each rank holds."""
    if M == 1:
        return v
    if idx_input == "sharded":
        return _slice_local(v, i, M)
    c = v.shape[0] // (width * M)
    return v.reshape((width, M, c) + tuple(v.shape[1:]))[:, i].reshape(
        (width * c,) + tuple(v.shape[1:]))


def _interleave_perm(B: int, M: int, ns: int) -> np.ndarray:
    """The permutation that puts the concatenated microbatch streams (order
    ``(i, rank, j)``) back in the batch's order ``(rank, i, j)``."""
    c = B // (M * ns)
    return np.arange(B).reshape(M, ns, c).transpose(1, 0, 2).reshape(-1)


def make_pipelined_train_step(cfg, mesh, microbatches: int = 1):
    """The train step of ``cfg`` on this rank of ``mesh`` over
    ``microbatches`` microbatches, ``step(state, batch) -> (state, loss)``.

    ``state``: this rank's shard, as :func:`repro_torch.core.hybrid.init_state`
    or ``weights.state_from_numpy`` makes it; ``batch``: this rank's block of
    the reference's global batch (``core.hybrid.local_batch``): ``idx``
    int32 table-local ids, the model's extras cut to the rank's rows (a
    DLRM's ``dense_x`` [B / ranks, num_dense] bf16 or fp32, which the first
    layer casts to bf16, and ``labels`` [B / ranks] fp32), with
    ``cfg.weighted`` ``weights`` fp32 in idx's layout and with
    ``cfg.host_presort`` the ``psort_*`` fields [1, L] of this rank's
    embedding shard (``data.pipeline.presort_batch``), on the rank's device.
    ``loss`` is the model's summed loss over the batch divided by the
    global batch (a DLRM's mean binary cross-entropy), the same on every
    rank, as a 0-d device tensor.

    The step updates the embedding store and the dense state IN PLACE,
    where the reference donates them, and returns the same dict: clone a
    state before a step to keep it.  A state with ``sr`` (the seed of the
    stochastic rounding and of the ``bf16_sr`` wire) hands it to the wires
    and the sparse update, then adds one to it, in place on the device, as
    the reference's step returns ``sr + 1``.  A state's ``cache`` and
    ``metrics`` come back as new tensors in the returned dict.  The ``psort_*`` fields
    describe the whole batch: they are not cut into microbatches, and
    replace the update side of the index exchange, which the step then
    skips.  ``step.stages`` holds the stages and ``step.mesh`` the mesh,
    whose ``stats`` count the collectives."""
    from repro_torch.core import hybrid
    from repro_torch.data.pipeline import PSORT_KEYS

    M = int(microbatches)
    cfg = hybrid.as_hybrid(cfg)
    validate_pipeline(cfg, mesh, M)
    opt = row_optim.resolve(cfg)
    layout = hybrid.make_layout(cfg, mesh)
    stages = build_stages(cfg, layout, mesh)
    all_axes, model, _ = mesh_axes(mesh)
    g_all = mesh.group(all_axes)
    presorted = bool(cfg.host_presort)
    # the ranks a replicated index stream is laid out over: the mesh in row
    # mode, the model axis in table mode (its batch is already cut by replica)
    width = mesh.size if cfg.emb_mode == "row" else mesh.shape[model]
    perm = (torch.as_tensor(_interleave_perm(cfg.batch, M, mesh.size), device=mesh.device)
            if M > 1 else None)

    def microbatch(batch: dict, i: int) -> dict:
        return {k: (_slice_idx(v, i, M, cfg.idx_input, width) if k in ("idx", "weights")
                    else _slice_local(v, i, M)) if M > 1 else v
                for k, v in batch.items() if k not in PSORT_KEYS}

    def exchange(mb: dict) -> tuple:
        # the presorted stream replaces the update side of the exchange
        return (stages.index_exchange(mb["idx"], fwd_only=presorted),
                stages.index_exchange(mb["weights"], fwd_only=presorted) if cfg.weighted
                else (None, None))

    def restore(parts: list) -> torch.Tensor:
        return parts[0] if M == 1 else torch.cat(parts).index_select(0, perm)

    cache_on = int(cfg.hot_rows) > 0
    # the bypass needs each bag summed whole by one shard and the rank's own
    # block of the original-slot stream: table mode with the sharded stream.
    # Row mode's reduce-scatter sums partial bags in its wire, so there the
    # cache keeps its counts and hot set but puts no bag in place
    bypass = cache_on and cfg.emb_mode == "table" and cfg.idx_input == "sharded"
    metrics_on = bool(cfg.step_metrics)
    dev = mesh.device
    emb_group = mesh.group(emb_axes(cfg, mesh)[0])
    if cache_on:
        from repro_torch.core import cache as hot_cache
        epilogue = hot_cache.CacheEpilogue(cfg, layout, opt, emb_group, dev)
    gid_offsets = torch.as_tensor(layout.spec.row_offsets[layout.slot_to_table],
                                  dtype=torch.int32, device=dev)
    if metrics_on:
        from repro_torch.telemetry import metrics as step_mx
        caps = torch.as_tensor(step_mx.slot_caps(layout), device=dev)
        pcaps = (torch.as_tensor(step_mx.padded_caps(layout), device=dev)
                 if cfg.emb_mode == "table" else None)
        n_bags = float(cfg.batch * layout.num_orig_slots)

    def metrics_epilogue(metrics: torch.Tensor, idx: torch.Tensor, hot_pos) -> torch.Tensor:
        """This step's counts added to the vector: the rows touched over the
        whole batch (each rank counts its own block and the psum adds them;
        the replicated row-mode stream is whole on every rank), the hits by
        the hot set the forward read (``hot_pos``, None without the bypass)."""
        if cfg.idx_input == "sharded":
            rows = comm.psum(step_mx.valid_lookups(layout, idx, caps), g_all)
        elif cfg.emb_mode == "row":
            rows = step_mx.valid_lookups(layout, idx, caps)
        else:
            rows = comm.psum(step_mx.valid_lookups_padded(layout, idx, mesh.coords[model], pcaps),
                             g_all)
        if hot_pos is not None:
            hl, hb = step_mx.cache_hit_counts(layout, hot_pos, idx, gid_offsets)
            hits, skipped = comm.psum(hl, g_all), comm.psum(hb, g_all)
        else:
            hits = skipped = torch.zeros((), dtype=torch.float32, device=dev)
        payload = (n_bags - skipped) * float(cfg.spec.dim * 4)
        return metrics + step_mx.pack(dev, steps=1.0, hit_lookups=hits, skipped_bags=skipped,
                                      bags=n_bags, rows_touched=rows,
                                      exchange_payload_bytes=payload)

    def step(state: dict, batch: dict):
        emb_store = state["emb"]
        sr = state.get("sr")
        W_fwd = row_optim.fwd_weights(opt, emb_store)
        dense_hi = state["dense"]["hi"]
        presort = tuple(batch[k][0] for k in PSORT_KEYS) if presorted else None
        mbs = [microbatch(batch, i) for i in range(M)]
        ex = [exchange(mbs[0])] + [None] * (M - 1)
        loss_acc = g_acc = None
        idx_parts, dY_parts, wgt_parts = [], [], []
        for i in range(M):
            if i + 1 < M:  # microbatch i + 1's exchange before microbatch i's compute
                ex[i + 1] = exchange(mbs[i + 1])
            (idx_fwd, idx_upd), (wgt_fwd, wgt_upd) = ex[i]
            ex[i] = None
            emb_out = stages.embedding_fwd(W_fwd, idx_fwd, wgt_fwd)
            if bypass:
                # the bags whose lookups all hit the mirror, summed here from the
                # rank's own block as the owner sums them, in place of the
                # all-to-all's: bit for bit under 'allreduce'
                cache = state["cache"]
                hit, hot_bag = hot_cache.hot_bag_local(
                    layout, cache["hot_w"], cache["hot_pos"], mbs[i]["idx"],
                    mbs[i]["weights"] if cfg.weighted else None, gid_offsets,
                    layout_bags=idx_fwd.shape[0] * idx_fwd.shape[1])
                emb_out = torch.where(hit[..., None], hot_bag, emb_out)
            loss, g_dense, d_emb = stages.dense_fwd_bwd(dense_hi, emb_out, mbs[i])
            dY_parts.append(stages.dY_exchange(d_emb, sr, i))
            loss_acc = loss if loss_acc is None else loss_acc + loss
            # the bf16 gradients summed as the reference's jitted sum comes
            # out: each partial sum rounded to bf16, its type, but the last
            # one kept in fp32, as XLA folds that add into the dense update's
            # fp32 cast (bit for bit at M = 2 and 4)
            g_acc = g_dense if g_acc is None else dp.tree_unflatten(g_acc, [
                a.float() + b.float() if i == M - 1 else a + b
                for a, b in zip(dp.tree_leaves(g_acc), dp.tree_leaves(g_dense))])
            idx_parts.append(idx_upd)
            wgt_parts.append(wgt_upd)
        dY = restore(dY_parts)
        idx_upd = None if presorted else restore(idx_parts)
        wgt_upd = restore(wgt_parts) if cfg.weighted and not presorted else None
        new_emb = stages.sparse_update(emb_store, idx_upd, dY, wgt_upd, sr, presort=presort)
        new_dense = stages.dense_update(state["dense"], g_acc, sr)
        new_state = {"emb": new_emb, "dense": new_dense}
        if sr is not None:
            new_state["sr"] = sr.add_(1)
        if cache_on:
            # promotion and the mirror's refresh read the updated store, so an
            # 'allreduce' mirror is the store the next step reads
            new_state["cache"] = epilogue(state["cache"], new_emb)
        if metrics_on:
            new_state["metrics"] = metrics_epilogue(
                state["metrics"], batch["idx"], state["cache"]["hot_pos"] if bypass else None)
        return new_state, comm.psum(loss_acc, g_all)

    step.stages = stages
    step.mesh = mesh
    return step
