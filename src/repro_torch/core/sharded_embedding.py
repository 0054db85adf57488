"""The model-parallel embedding of the hybrid step (twin of
``repro/core/sharded_embedding.py``): its placement over the shards, the
bag forward with its layout switch, the cotangent's way back, and the
sparse update.

Two placements of the unified row space (``core.embedding``):

``row``
    Shard ``s`` owns rows ``[s * rows_per_shard, (s + 1) * rows_per_shard)``
    of every table, over all ranks.  Each shard sums, for the whole batch,
    the lookups that fall in its window (the others add nothing), rounds
    the partial bags to bf16 and reduce-scatters them over the batch
    (``dist.comm.psum_scatter``); the cotangent comes back as a bf16
    all-gather, and each shard updates only the rows it owns.
``table``
    Tables are bin-packed onto the ``"model"`` axis and replicated over the
    others; a shard's slots are its tables' slots in padded-slot order
    (``permute_indices``), with a dummy slot reading the shard's spare last
    row where a bin has fewer slots.  Each shard sums whole bags of its
    slots for its data replica's batch (unrounded), and one fp32 all-to-all
    switches the layout to the batch split; the cotangent takes the inverse
    all-to-all and an all-gather over the replicas.

The functions take the collective :class:`~repro_torch.dist.comm.Group` of
the embedding axes (``group``; None: one shard, ``comm.local_group()``,
whose collectives are the identity), and the per-slot offsets of a slot's first row in this shard's
rows (:func:`local_offsets`) as an int32 tensor on the batch's device.
Bags may be weighted (one fp32 weight a lookup, in idx's layout).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.embedding import EmbeddingSpec, _round_up
from repro_torch.dist import comm
from repro_torch.kernels import ops
from repro_torch.optim import row as row_optim


@dataclasses.dataclass(frozen=True)
class ShardedEmbeddingLayout:
    """Static placement of a unified embedding space over ``num_shards``."""

    spec: EmbeddingSpec
    num_shards: int
    rows_per_shard: int
    slot_to_table: np.ndarray                # [S] table id per model slot
    mode: str = "row"                        # "row" | "table"
    row_offsets: Optional[np.ndarray] = None  # row mode: [S] global row offset per slot
    # table mode:
    slots_per_shard: int = 0
    padded_slots: Optional[np.ndarray] = None        # [n_pad] slot per padded position, -1 dummy
    slot_local_offsets: Optional[np.ndarray] = None  # [n_pad] row offset in its shard
    slot_position: Optional[np.ndarray] = None       # [S] padded position of each slot

    @property
    def total_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def num_orig_slots(self) -> int:
        return len(self.slot_to_table)

    @property
    def num_padded_slots(self) -> int:
        return self.num_shards * self.slots_per_shard


def make_layout(spec: EmbeddingSpec, num_shards: int, mode: str = "row",
                slot_to_table=None) -> ShardedEmbeddingLayout:
    """The reference's placement, bit for bit: row mode pads the row space
    to ``num_shards * row_pad`` rows; table mode bin-packs the tables
    (:meth:`EmbeddingSpec.binpack_tables`) and keeps one spare ``row_pad``
    of rows a shard for the dummy slots."""
    s2t = (np.arange(spec.num_tables, dtype=np.int64) if slot_to_table is None
           else np.asarray(slot_to_table, dtype=np.int64))
    if mode == "row":
        rows = _round_up(spec.total_rows, num_shards * spec.row_pad) // num_shards
        return ShardedEmbeddingLayout(spec=spec, num_shards=num_shards, rows_per_shard=rows,
                                      slot_to_table=s2t, row_offsets=spec.row_offsets[s2t])
    if mode != "table":
        raise ValueError(f"unknown mode {mode!r}")
    padded = spec.padded_rows
    table_bin = np.zeros(spec.num_tables, np.int64)
    table_off = np.zeros(spec.num_tables, np.int64)
    max_bin_rows = 0
    for b, tables in enumerate(spec.binpack_tables(num_shards)):
        off = 0
        for t in tables:
            table_bin[t], table_off[t] = b, off
            off += int(padded[t])
        max_bin_rows = max(max_bin_rows, off)
    rows = _round_up(max_bin_rows + spec.row_pad, spec.row_pad)
    slots_by_bin: list[list[int]] = [[] for _ in range(num_shards)]
    for s, t in enumerate(s2t):
        slots_by_bin[table_bin[t]].append(s)
    K = max(1, max(len(g) for g in slots_by_bin))
    padded_slots = np.full(num_shards * K, -1, np.int64)
    local_off = np.full(num_shards * K, rows - 1, np.int64)  # dummies read the spare row
    slot_position = np.zeros(len(s2t), np.int64)
    for b, group in enumerate(slots_by_bin):
        for j, s in enumerate(group):
            p = b * K + j
            padded_slots[p], local_off[p], slot_position[s] = s, table_off[s2t[s]], p
    return ShardedEmbeddingLayout(spec=spec, num_shards=num_shards, rows_per_shard=rows,
                                  slot_to_table=s2t, mode="table", slots_per_shard=K,
                                  padded_slots=padded_slots, slot_local_offsets=local_off,
                                  slot_position=slot_position)


def layout_gid_maps(layout: ShardedEmbeddingLayout) -> tuple[np.ndarray, np.ndarray]:
    """The maps between the layout's row positions and the spec's global row
    ids (gid = ``spec.row_offsets[t]`` + the table-local row), on which the
    hot-row cache keys its members so that they outlive a reshard:
    ``(l2g [layout.total_rows], g2l [spec.total_rows])`` int32, -1 where a
    position maps nowhere (row mode's tail, table mode's bin slack and spare
    rows; the gaps of ``row_pad`` between the tables' gids)."""
    spec = layout.spec
    l2g = np.full(layout.total_rows, -1, np.int32)
    if layout.mode == "row":
        for t, rows_t in enumerate(spec.table_rows):
            base = int(spec.row_offsets[t])
            l2g[base:base + rows_t] = base + np.arange(rows_t, dtype=np.int32)
    else:
        for pos, s in enumerate(layout.padded_slots):
            if s < 0:
                continue
            t = int(layout.slot_to_table[s])
            base = ((pos // layout.slots_per_shard) * layout.rows_per_shard
                    + int(layout.slot_local_offsets[pos]))
            l2g[base:base + int(spec.table_rows[t])] = (
                int(spec.row_offsets[t]) + np.arange(int(spec.table_rows[t]), dtype=np.int32))
    g2l = np.full(spec.total_rows, -1, np.int32)
    owned = np.nonzero(l2g >= 0)[0]
    g2l[l2g[owned]] = owned.astype(np.int32)
    return l2g, g2l


def local_offsets(layout: ShardedEmbeddingLayout, shard: int) -> np.ndarray:
    """Per slot of the ids shard ``shard`` reads, the offset of the slot's
    row 0 in the shard's rows (the reference's ``_local_rows``): row mode
    [S], the global offsets less the window's start (negative below it);
    table mode [slots_per_shard], the shard's padded slots."""
    if layout.mode == "row":
        return layout.row_offsets - shard * layout.rows_per_shard
    K = layout.slots_per_shard
    return layout.slot_local_offsets[shard * K:(shard + 1) * K]


def _offsets(layout, offsets, like: torch.Tensor, shard: int) -> torch.Tensor:
    if offsets is not None:
        return offsets
    return torch.as_tensor(local_offsets(layout, shard), dtype=torch.int32, device=like.device)


@dataclasses.dataclass(frozen=True)
class SlotMaps:
    """Table mode's slot maps as tensors on one device, made once so that a
    step copies nothing from the host: ``src`` [n_pad] the original slot of
    each padded position (0 for a dummy), ``dummy`` [1, n_pad, 1] bool,
    ``position`` [S] the padded position of each original slot."""

    src: torch.Tensor
    dummy: torch.Tensor
    position: torch.Tensor


def slot_maps(layout: ShardedEmbeddingLayout, device) -> SlotMaps:
    if layout.mode != "table":
        raise ValueError("slot maps are table mode's")
    return SlotMaps(
        src=torch.as_tensor(np.where(layout.padded_slots >= 0, layout.padded_slots, 0),
                            device=device),
        dummy=torch.as_tensor(layout.padded_slots < 0, device=device)[None, :, None],
        position=torch.as_tensor(layout.slot_position, device=device))


def permute_indices(layout: ShardedEmbeddingLayout, idx: torch.Tensor,
                    maps: Optional[SlotMaps] = None) -> torch.Tensor:
    """[B, S, P] original-slot ids (or bag weights, or cotangents [B, S, E])
    -> [B, num_padded_slots, ...] padded-slot order (table mode); dummy slots
    read 0."""
    maps = maps or slot_maps(layout, idx.device)
    return torch.where(maps.dummy, torch.zeros((), dtype=idx.dtype, device=idx.device),
                       idx.index_select(1, maps.src))


def _group(group: Optional[comm.Group]) -> comm.Group:
    return comm.local_group() if group is None else group


def row_sharded_bag_fwd(layout: ShardedEmbeddingLayout, W_local: torch.Tensor,
                        idx: torch.Tensor, row_offsets: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None,
                        group: Optional[comm.Group] = None) -> torch.Tensor:
    """Row-mode forward: ``idx`` [B, S, P] table-local ids, the same on every
    shard; ``row_offsets`` the slots' offsets into this shard's window
    (:func:`local_offsets`, built when not given); ``weights`` [B, S, P]
    fp32 bag weights or None.  One launch of the embedding_bag kernel sums
    the lookups in the window (``ops.embedding_bag_stage``: the offset add,
    the window's mask and the bf16 round inside), and the bf16 partial bags
    are reduce-scattered over ``group`` along the batch.  Returns
    [B / num_shards, S, E] fp32 (each value a bf16 one)."""
    group = _group(group)
    if group.size != layout.num_shards:
        raise ValueError(f"a layout of {layout.num_shards} shards needs a group of as many ranks")
    row_offsets = _offsets(layout, row_offsets, idx, group.index)
    part = ops.embedding_bag_stage(W_local, idx, row_offsets, layout.rows_per_shard, weights)
    if group.size == 1:
        # a sum over one rank: the bags as they are, so the stage stays one launch
        # (the wire's casts would add two; the kernel already rounded to bf16)
        return part
    return comm.psum_scatter(part.to(torch.bfloat16), group).float()


def row_bag_fwd_replicated(layout: ShardedEmbeddingLayout, W_local: torch.Tensor,
                           idx: torch.Tensor, row_offsets: Optional[torch.Tensor] = None,
                           group: Optional[comm.Group] = None) -> torch.Tensor:
    """Row-mode bags with a replicated [B, S, E] fp32 output: each shard's
    unrounded partial bags (one launch of the embedding_bag kernel) summed
    over ``group`` by a ``psum`` in place of the reduce-scatter.  For a batch
    smaller than the shards, such as the retrieval step's one query."""
    group = _group(group)
    row_offsets = _offsets(layout, row_offsets, idx, group.index)
    part = ops.embedding_bag_stage(W_local, idx, row_offsets, layout.rows_per_shard,
                                   round_bf16=False)
    return comm.psum(part, group)


def table_sharded_bag_fwd(layout: ShardedEmbeddingLayout, W_local: torch.Tensor,
                          idx_slots_local: torch.Tensor, group: Optional[comm.Group],
                          weights: Optional[torch.Tensor] = None,
                          slot_offsets: Optional[torch.Tensor] = None,
                          maps: Optional[SlotMaps] = None) -> torch.Tensor:
    """Table-mode forward: ``idx_slots_local`` [B, slots_per_shard, P] this
    shard's padded slots for its replica's batch; one unrounded launch of
    the embedding_bag kernel, then an fp32 all-to-all over the model group
    ``group`` from the slot split to the batch split, and the slots put
    back in their original order.  Returns [B / num_shards, S, E] fp32."""
    group = _group(group)
    slot_offsets = _offsets(layout, slot_offsets, idx_slots_local, group.index)
    part = ops.embedding_bag_stage(W_local, idx_slots_local, slot_offsets, layout.rows_per_shard,
                                   weights, round_bf16=False)
    out = comm.all_to_all(part, group, 0, 1)
    return out.index_select(1, (maps or slot_maps(layout, out.device)).position)


def gather_dY(layout: ShardedEmbeddingLayout, dY_mp: torch.Tensor,
              group: Optional[comm.Group] = None,
              replica_group: Optional[comm.Group] = None,
              maps: Optional[SlotMaps] = None, wire_dtype: str = "fp32", seed=None,
              tag: int = 0) -> torch.Tensor:
    """The cotangent ``dY_mp`` [B / num_shards, S, E] brought to the layout
    each shard's update reads.  Row mode: rounded to bf16 (the wire) and
    all-gathered over ``group``; returns [B, S, E] bf16, whose fp32 value is
    the reference's result exactly.  Table mode: to padded-slot order
    (dummy slots zero), the inverse all-to-all over the model group
    ``group``, then an all-gather over the replicas ``replica_group``;
    returns [B, slots_per_shard, E], fp32 on the ``"fp32"`` wire, bf16 on
    the others.

    ``wire_dtype`` (``dist.exchange``): row mode's ``"fp32"`` and ``"bf16"``
    both keep the payload rounded to nearest, ``"bf16_sr"`` rounds it under
    the dither; table mode's ``"bf16"`` and ``"bf16_sr"`` narrow the
    all-to-all and the replica all-gather to 2 bytes an element.  The
    dither reads ``seed`` (the state's ``sr``; None: 0) and the tag
    ``wire_tag(TAG_DY, tag, sender)``, ``tag`` the payload's site in the
    step (the microbatch) and the sender its index over the replica axes,
    then the embedding axes."""
    from repro_torch.dist import exchange

    group = _group(group)
    sender = group.index + (0 if replica_group is None else replica_group.index * group.size)

    def encode(x):
        return exchange.wire_encode(x, wire_dtype, seed,
                                    exchange.wire_tag(exchange.TAG_DY, tag, sender))

    if layout.mode == "row":
        return comm.all_gather(encode(dY_mp) if wire_dtype == "bf16_sr"
                               else dY_mp.to(torch.bfloat16), group)
    dY_local = comm.all_to_all(encode(permute_indices(layout, dY_mp, maps)), group, 1, 0)
    return dY_local if replica_group is None else comm.all_gather(dY_local, replica_group)


def _row_sorted_streams(layout: ShardedEmbeddingLayout, local_flat: torch.Tensor,
                        pooling: int, weights_flat: Optional[torch.Tensor] = None,
                        shard: int = 0) -> tuple[torch.Tensor, ...]:
    """The sorted stream of shard ``shard``'s update from ``local_flat``
    [L], each lookup's row in the shard (:func:`local_offsets` added): one
    stable sort over the shard's rows, so per owned row the run holds its
    lookups in their flat order, as the reference's global sort localised
    into the window does, and the row kernels step each row as its update
    does.  A lookup of no row (outside the row space) is keyed past the end,
    where it clips to the last row with ``msk = 0``, as
    :func:`~repro_torch.kernels.embedding_update.sort_lookups` places it; so
    at one shard the stream is that function's.  A row-mode lookup of
    another shard's rows also gets ``msk = 0``, and as its key its flat
    index modulo the shard's rows, so those lookups spread over the rows in
    short runs: a masked lookup adds nothing wherever it sits and a run of
    masked lookups alone is not touched, while keyed past the end the half
    of a two-shard stream that the other shard owns made one run of some
    1.6 M lookups, which the row kernels walk in order (42 ms on the H100).
    ``weights_flat`` [L] (None: all 1) is gathered in the sorted order."""
    R = layout.rows_per_shard
    owned = (local_flat >= 0) & (local_flat < R)
    key = torch.where(owned, local_flat, R).to(torch.int32)
    if layout.mode == "row" and layout.num_shards > 1:
        g = local_flat.to(torch.int64) + shard * R
        elsewhere = ~owned & (g >= 0) & (g < layout.total_rows)
        spread = torch.remainder(torch.arange(key.numel(), device=key.device), R)
        key = torch.where(elsewhere, spread.to(torch.int32), key)
    skey, order = torch.sort(key, stable=True)
    rows = skey.clamp_max(R - 1)
    bags = torch.div(order, pooling, rounding_mode="floor").to(torch.int32)
    msk = owned[order].to(torch.int32)
    wgt = (torch.ones(key.shape, dtype=torch.float32, device=key.device) if weights_flat is None
           else weights_flat.float()[order])
    return rows, bags, msk, wgt


def apply_update(layout: ShardedEmbeddingLayout, store: dict, optimizer,
                 idx_local: torch.Tensor, dY: torch.Tensor, lr: float,
                 row_offsets: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None, seed=None,
                 group: Optional[comm.Group] = None,
                 replica_group: Optional[comm.Group] = None,
                 presort: Optional[tuple] = None) -> dict:
    """The sparse update of the train step, in place on this shard's
    ``store``: ``idx_local`` [B, S or slots_per_shard, P] ids, ``dY`` the
    matching [B, S or K, E] cotangents from :func:`gather_dY`, ``weights``
    the bag weights in idx's layout (each lookup's cotangent scaled by its
    own) or None; ``row_offsets`` the slots' offsets into the shard's rows
    (built from ``group``'s index when not given).  In table mode with
    ``replica_group`` the ids and weights are first all-gathered over the
    replicas, as ``dY`` was (the train step gathers them in its index
    exchange instead).  Lookups outside the shard's rows add nothing.
    ``optimizer``: a ``RowOptimizer`` of ``optim.row`` or its name; ``seed``
    the stochastic rounding's per-step seed.  The stream is sorted once on
    the device and handed to the optimizer's fused row kernel
    (``optim.row.apply_sparse``); nothing builds the [B, S, P, E]
    gradient.  ``presort``: this shard's ``(rows, bags, msk, wgt)`` [L]
    from the host (``data.pipeline.presort_batch``, the bag weights in
    ``wgt``), which go to the row kernel as they are: no sort, and
    ``idx_local`` and ``weights`` are not read."""
    if presort is not None:
        return row_optim.apply_sparse(optimizer, store, tuple(presort),
                                      dY.reshape(-1, dY.shape[-1]), lr, seed=seed)
    if layout.mode == "table" and replica_group is not None:
        idx_local = comm.all_gather(idx_local, replica_group)
        if weights is not None:
            weights = comm.all_gather(weights, replica_group)
    shard = _group(group).index
    local = idx_local + _offsets(layout, row_offsets, idx_local, shard)[None, :, None]
    streams = _row_sorted_streams(layout, local.reshape(-1), idx_local.shape[-1],
                                  None if weights is None else weights.reshape(-1), shard)
    return row_optim.apply_sparse(optimizer, store, streams, dY.reshape(-1, dY.shape[-1]), lr,
                                  seed=seed)
