"""Unified multi-table embedding space (twin of ``repro/core/embedding.py``).

All tables of a model share ONE row space ``W [total_rows, E]``: table ``t``
starts at ``row_offsets[t]`` and its rows are padded to a multiple of
``row_pad``.  A lookup ``idx`` of slot ``s`` reads global row
``idx + row_offsets[s]`` (:func:`globalize`).

The bags over that space: :func:`bag_lookup` (the embedding_bag kernel on
the card, differentiable with the reference's VJP), its ragged and plain
forms, and the fused sparse steps :func:`bag_update` and
:func:`bag_update_split` (the row-update kernels of ``optim.row``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.embedding_update import sort_lookups


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of a unified multi-table embedding space."""

    table_rows: tuple[int, ...]  # M_i per table (original order)
    dim: int                     # E
    row_pad: int = 8             # pad each table's rows to this multiple

    @property
    def num_tables(self) -> int:
        return len(self.table_rows)

    @property
    def padded_rows(self) -> np.ndarray:
        return np.array([_round_up(m, self.row_pad) for m in self.table_rows], dtype=np.int64)

    @property
    def row_offsets(self) -> np.ndarray:
        """Start row of each table in the unified space (original order)."""
        return np.concatenate([[0], np.cumsum(self.padded_rows)[:-1]]).astype(np.int64)

    @property
    def total_rows(self) -> int:
        return int(self.padded_rows.sum())

    def binpack_tables(self, num_bins: int) -> list[list[int]]:
        """Tables greedily packed into ``num_bins`` bins by padded row count,
        the largest first into the lightest bin (the lower bin on a tie):
        ``bins[b]`` lists bin ``b``'s tables.  Table mode's placement
        (``repro/core/embedding.py::binpack_tables``); equal tables are taken
        in the order of numpy's default (unstable) sort, as there."""
        order = np.argsort(-self.padded_rows)
        bins: list[list[int]] = [[] for _ in range(num_bins)]
        loads = np.zeros(num_bins, dtype=np.int64)
        for t in order:
            b = int(np.argmin(loads))
            bins[b].append(int(t))
            loads[b] += int(self.padded_rows[t])
        return bins


def globalize(spec: EmbeddingSpec, indices: torch.Tensor) -> torch.Tensor:
    """Per-table ids ``[B, S, P]`` -> unified row ids (the same dtype)."""
    off = torch.as_tensor(spec.row_offsets, dtype=indices.dtype, device=indices.device)
    return indices + off[None, :, None]


# ---------------------------------------------------------------------------
# Forward bags
# ---------------------------------------------------------------------------

def scatter_add_rows(base: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """``base`` [M, E] with ``upd[i]`` added at row ``rows[i]``, in place and
    in ``base``'s dtype (``upd`` is cast to it first): the VJP of a row
    gather into a zero ``base``, or the reference's ``W.at[rows].add(upd)``.

    On the card, ``index_add_`` (each add rounded to the dtype, in the order
    the atomics land).  On the CPU, the order of the reference's jitted
    scatter: one lookup at a time in flat order, each add rounded to the
    dtype (``index_add_`` on the CPU sums a bf16 row's duplicates in fp32 and
    rounds once, which is another result).  The CPU loop goes by occurrence:
    round ``k`` adds every row's ``k``-th lookup, so it runs as many rounds as
    the most frequent row has lookups."""
    rows = rows.reshape(-1).long()
    upd = upd.to(base.dtype)
    if rows.numel() == 0:
        return base
    if base.device.type != "cpu":
        return base.index_add_(0, rows, upd)
    srows, order = torch.sort(rows, stable=True)
    k = torch.empty_like(order)
    k[order] = torch.arange(srows.numel()) - torch.searchsorted(srows, srows)
    for r in range(int(k.max()) + 1):
        at = (k == r).nonzero().reshape(-1)
        tgt = rows[at]
        base[tgt] = (base[tgt].float() + upd[at].float()).to(base.dtype)
    return base


class _BagLookup(torch.autograd.Function):
    """The bag sum of :func:`bag_lookup` with the reference's VJP."""

    @staticmethod
    def forward(ctx, W, g, weights):
        ctx.save_for_backward(g, weights)
        ctx.table = (W.shape[0], W.dtype)
        return ops.embedding_bag(W, g, W.shape[0], weights)

    @staticmethod
    def backward(ctx, dY):
        g, weights = ctx.saved_tensors
        num_rows, dtype = ctx.table
        B, S, P = g.shape
        upd = dY.float()[:, :, None, :].expand(B, S, P, dY.shape[-1])
        if weights is not None:
            upd = upd * weights.float()[..., None]
        dW = torch.zeros((num_rows, dY.shape[-1]), dtype=dtype, device=dY.device)
        return scatter_add_rows(dW, g, upd.reshape(-1, dY.shape[-1])), None, None


def bag_lookup(W: torch.Tensor, g: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag-sum forward: ``Y[b, s] = sum_p W[g[b, s, p]]`` (paper
    Alg. 1), or with ``weights`` [B, S, P] ``sum_p weights * W[g]``.

    ``W`` [M, E] bf16 or fp32, ``g`` [B, S, P] int32 unified row ids.
    Returns fp32 [B, S, E].  On a CUDA tensor the forward is one launch of
    the embedding_bag kernel (unrounded, as in table mode); on the CPU its
    plain version.  Differentiable in ``W`` (``weights`` gets no gradient),
    with the reference's VJP, that of ``jnp.take(W, g).astype(f32)``: each
    lookup's cotangent rounded to the table's dtype and added into a zero
    table of that dtype (:func:`scatter_add_rows`), so a bf16 table
    gets a bf16 gradient whose duplicates were added in bf16."""
    return _BagLookup.apply(W, g, weights)


def bag_lookup_ragged(W: torch.Tensor, flat_idx: torch.Tensor, segment_ids: torch.Tensor,
                      num_bags: int) -> torch.Tensor:
    """Ragged EmbeddingBag: ``Y[n] = sum_{i: seg[i] == n} W[flat_idx[i]]``,
    fp32 [num_bags, E] (the reference's ``segment_sum``; plain PyTorch, as
    the reference leaves it to XLA)."""
    rows = W[flat_idx.long()].float()
    out = torch.zeros((num_bags, W.shape[1]), dtype=torch.float32, device=W.device)
    return out.index_add_(0, segment_ids.long(), rows)


def lookup(W: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain (non-bagged) lookup, e.g. item sequences: ``idx [...]`` ->
    ``[..., E]`` in ``W``'s dtype."""
    return W[idx.long()]


# ---------------------------------------------------------------------------
# Fused backward + update: the bag's cotangent stepped into the rows it read,
# never a dense [M, E] gradient.  Duplicate ids accumulate.
# ---------------------------------------------------------------------------

def _stream(g: torch.Tensor, num_rows: int, weights: Optional[torch.Tensor]) -> tuple:
    B, S, P = g.shape
    return sort_lookups(g.reshape(-1).to(torch.int32), None, num_rows, P,
                        None if weights is None else weights.reshape(-1))


def bag_update(W: torch.Tensor, g: torch.Tensor, dY: torch.Tensor, lr: float,
               weights: Optional[torch.Tensor] = None, method: str = "scatter") -> torch.Tensor:
    """The fused sparse SGD step of a bag lookup: ``W[g[b, s, p]] -= lr *
    dY[b, s]`` (times ``weights[b, s, p]``), duplicates accumulating.
    ``W`` [M, E]; ``g`` [B, S, P] unified rows; ``dY`` [B, S, E].  Returns
    the updated table.

    ``method``: ``"scatter"`` (the reference's default), a new table: each
    lookup's ``-lr * dY`` in fp32, rounded to ``W``'s dtype and added to a
    copy of ``W`` (:func:`scatter_add_rows`); ``"fused"``, in place on the
    fp32 ``W``: one stable sort of the lookups and the row kernel of the
    ``sgd`` optimizer (``optim.row.apply_sparse``: the embedding_update
    kernel on the card, its plain version on the CPU), which sums each
    row's run and steps it once."""
    B, S, P = g.shape
    E = W.shape[1]
    if method == "fused":
        from repro_torch.optim import row
        store = row.apply_sparse("sgd", {"w": W}, _stream(g, W.shape[0], weights),
                                 dY.reshape(-1, E), lr)
        return store["w"]
    if method != "scatter":
        raise ValueError(f"unknown bag_update method {method!r}; expected 'scatter' or 'fused'")
    upd = dY.float()[:, :, None, :].expand(B, S, P, E)
    if weights is not None:
        upd = upd * weights.float()[..., None]
    upd = (-np.float32(lr) * upd).reshape(-1, E)
    return scatter_add_rows(W.clone(), g, upd)


def bag_update_split(hi: torch.Tensor, lo: torch.Tensor, g: torch.Tensor, dY: torch.Tensor,
                     lr: float, weights: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused sparse backward + Split-SGD-BF16 step on a split table
    (paper Alg. 3 + C5), in place on ``hi`` [M, E] bf16 and ``lo`` [M, E]
    int16: only the rows ``g`` names are put together, stepped and split
    again, by the ``split_sgd`` row optimizer's kernel
    (``optim.row.apply_sparse``).  Returns ``(hi, lo)``."""
    from repro_torch.optim import row
    store = row.apply_sparse("split_sgd", {"hi": hi, "lo": lo},
                             _stream(g, hi.shape[0], weights), dY.reshape(-1, hi.shape[1]), lr)
    return store["hi"], store["lo"]
