"""Row-sharded embedding forward and sparse update (twin of
``repro/core/sharded_embedding.py``).

Row mode on ONE shard: the shard owns the whole unified row space, so the
reference's reduce-scatter over the model axes and its all-gather of the
cotangent are the identity.  What the reference does on its wires still
happens here: the partial bag and the cotangent are both rounded to bf16,
so the port trains and scores what the reference does.  Bags may be
weighted (one fp32 weight a lookup, in idx's layout).  Table mode and more
than one shard come with the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.embedding import EmbeddingSpec, _round_up
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_update import sort_lookups
from repro_torch.optim import row as row_optim


@dataclasses.dataclass(frozen=True)
class ShardedEmbeddingLayout:
    """Static placement of a unified embedding space over ``num_shards``
    (row mode: every shard owns ``rows_per_shard`` contiguous rows)."""

    spec: EmbeddingSpec
    num_shards: int
    rows_per_shard: int
    slot_to_table: np.ndarray  # [S] table id per model slot
    row_offsets: np.ndarray    # [S] global row offset per slot

    @property
    def total_rows(self) -> int:
        return self.num_shards * self.rows_per_shard


def make_layout(spec: EmbeddingSpec, num_shards: int, mode: str = "row",
                slot_to_table=None) -> ShardedEmbeddingLayout:
    if mode != "row":
        raise NotImplementedError(f"embedding mode {mode!r}: the port has row mode only")
    s2t = (np.arange(spec.num_tables, dtype=np.int64) if slot_to_table is None
           else np.asarray(slot_to_table, dtype=np.int64))
    rows = _round_up(spec.total_rows, num_shards * spec.row_pad) // num_shards
    return ShardedEmbeddingLayout(spec=spec, num_shards=num_shards, rows_per_shard=rows,
                                  slot_to_table=s2t, row_offsets=spec.row_offsets[s2t])


def row_sharded_bag_fwd(layout: ShardedEmbeddingLayout, W_local: torch.Tensor,
                        idx: torch.Tensor, row_offsets: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-mode forward of a one-shard layout.

    ``idx`` [B, S, P] int32 table-local ids; ``row_offsets`` the layout's
    offsets as an int32 tensor on ``idx``'s device (built from the layout
    when not given); ``weights`` [B, S, P] fp32 per-lookup bag weights or
    None.  Returns ``[B, S, E]`` fp32 bag sums, rounded through bf16 as
    the reference's reduce-scatter wire is: one launch of the embedding_bag
    kernel, which adds the offsets itself (the shard starts at row 0) and
    rounds its sums (plain version: the offset add, the reference's
    ``_partial_bag_masked``, the round)."""
    if layout.num_shards != 1:
        raise NotImplementedError("more than one shard needs the distributed slice")
    if row_offsets is None:
        row_offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=idx.device)
    return ops.embedding_bag_stage(W_local, idx, row_offsets, layout.rows_per_shard, weights)


def gather_dY(layout: ShardedEmbeddingLayout, dY_mp: torch.Tensor) -> torch.Tensor:
    """The cotangent [B, S, E] as the rows scatter from it: at one shard the
    all-gather is the identity, and what is left is the row-mode wire's
    round to bf16, which the reference makes at one shard too.  Returns the
    bf16 payload; its fp32 value is the reference's result, exactly."""
    if layout.num_shards != 1:
        raise NotImplementedError("more than one shard needs the distributed slice")
    return dY_mp.to(torch.bfloat16)


def _row_sorted_streams(layout: ShardedEmbeddingLayout, g_flat: torch.Tensor,
                        pooling: int, weights_flat: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, ...]:
    """The sorted stream of the row-mode update from the GLOBAL row ids
    ``g_flat`` [L]: one stable sort of the keys (ids outside the row space
    keyed past its end), the weights ``weights_flat`` [L] (None: all 1)
    gathered in the sorted order.  The reference then localises the stream
    into a shard's window; at one shard the window starts at 0 and is the
    whole space, so this is :func:`sort_lookups` over it."""
    if layout.num_shards != 1:
        raise NotImplementedError("more than one shard needs the distributed slice")
    return sort_lookups(g_flat, None, layout.total_rows, pooling, weights_flat)


def apply_update(layout: ShardedEmbeddingLayout, store: dict, optimizer,
                 idx_local: torch.Tensor, dY: torch.Tensor, lr: float,
                 row_offsets: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None, seed=None) -> dict:
    """The sparse update of the train step, row mode, one shard, in place on
    ``store``: ``idx_local`` [B, S, P] table-local ids, ``dY`` [B, S, E] the
    bag cotangents from :func:`gather_dY`, ``weights`` [B, S, P] the bag
    weights (each lookup's cotangent scaled by its own) or None.  Lookups
    outside the row space add nothing.  ``optimizer``: a ``RowOptimizer`` of
    ``optim.row`` or its name; ``seed`` the stochastic rounding's per-step
    seed, for the optimizers that round their state so.  The stream is
    sorted once on the device and handed to the optimizer's fused row kernel
    (``optim.row.apply_sparse``), as the reference's fused path does; the
    kernel never builds the [B, S, P, E] gradient."""
    if row_offsets is None:
        row_offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32,
                                      device=idx_local.device)
    g = idx_local + row_offsets[None, :, None]
    streams = _row_sorted_streams(layout, g.reshape(-1), idx_local.shape[-1],
                                  None if weights is None else weights.reshape(-1))
    return row_optim.apply_sparse(optimizer, store, streams, dY.reshape(-1, dY.shape[-1]), lr,
                                  seed=seed)
