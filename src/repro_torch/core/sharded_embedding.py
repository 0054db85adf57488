"""Row-sharded embedding forward (twin of ``repro/core/sharded_embedding.py``).

Row mode on ONE shard: the shard owns the whole unified row space, so the
reference's reduce-scatter over the model axes is the identity.  What the
reference does on its wire still happens here: the partial bag is rounded to
bf16 and back before it leaves the shard, so the port scores what the
reference scores.  Table mode, weighted bags and more than one shard come
with the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.embedding import EmbeddingSpec, _round_up
from repro_torch.kernels import ops


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
                        idx: torch.Tensor,
                        row_offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-mode forward of a one-shard layout.

    ``idx`` [B, S, P] int32 table-local ids; ``row_offsets`` the layout's
    offsets as an int32 tensor on ``idx``'s device (built from the layout
    when not given).  Returns ``[B, S, E]`` fp32 bag sums through the
    embedding_bag kernel (whose plain version is the reference's
    ``_partial_bag_masked``), rounded through bf16 as the reference's
    reduce-scatter wire is."""
    if layout.num_shards != 1:
        raise NotImplementedError("more than one shard needs the distributed slice")
    if row_offsets is None:
        row_offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=idx.device)
    gidx = idx + row_offsets[None, :, None]  # the shard starts at row 0
    part = ops.embedding_bag(W_local, gidx, layout.rows_per_shard)
    return part.to(torch.bfloat16).float()
