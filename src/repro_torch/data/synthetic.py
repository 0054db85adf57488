"""Synthetic batches (copies of ``zipf_indices``, ``SparseBatchSpec``,
``sparse_batch``, ``dlrm_stream``, ``hybrid_stream`` and ``token_stream`` from
``repro/data/synthetic.py``, so the port needs nothing of ``repro``).
Seeded, host-side numpy: the same seed gives both packages the same
batches.

``alpha`` sets a Zipf-like skew: real click logs reuse a few rows heavily,
which is what the tables' caches and the sparse update's runs see.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


def zipf_indices(rng: np.random.Generator, vocab: int, size, alpha: float) -> np.ndarray:
    """alpha == 0 -> uniform; larger alpha -> heavier head skew."""
    if alpha <= 0:
        return rng.integers(0, vocab, size, dtype=np.int64)
    # inverse-CDF sampling of a truncated zipf: ranks ~ u^(-1/(alpha));
    # clip in FLOAT space first (tiny alpha overflows any integer type)
    u = rng.random(size)
    with np.errstate(over="ignore"):
        ranks = np.clip(u ** (-1.0 / alpha) - 1.0, 0.0, float(vocab - 1))
    return ranks.astype(np.int64)


@dataclasses.dataclass
class SparseBatchSpec:
    table_rows: tuple               # rows per TABLE
    slot_to_table: Optional[tuple]  # slot -> table (None = identity)
    pooling: int
    batch: int
    num_dense: int = 0
    alpha: float = 0.0              # index skew
    seq_mask: bool = False          # emit an all-ones seq_mask [B, 50] (sasrec)
    hist_mask: bool = False         # emit an all-ones hist_mask [B, 100] (din)
    labels: bool = True

    @property
    def slots(self):
        return (self.slot_to_table if self.slot_to_table is not None
                else tuple(range(len(self.table_rows))))


def sparse_batch(rng: np.random.Generator, spec: SparseBatchSpec) -> dict:
    """One global batch (original slot order): ``idx`` [B, S, P] int32,
    ``dense_x`` [B, num_dense] fp32, ``labels`` [B] fp32 in {0, 1}."""
    B, P = spec.batch, spec.pooling
    cols = [zipf_indices(rng, spec.table_rows[t], (B, P), spec.alpha) for t in spec.slots]
    batch = {"idx": np.stack(cols, axis=1).astype(np.int32)}
    if spec.num_dense:
        batch["dense_x"] = rng.standard_normal((B, spec.num_dense)).astype(np.float32)
    if spec.labels:
        batch["labels"] = rng.integers(0, 2, (B,)).astype(np.float32)
    if spec.seq_mask:
        batch["seq_mask"] = np.ones((B, 50), np.float32)
    if spec.hist_mask:
        batch["hist_mask"] = np.ones((B, 100), np.float32)
    return batch


def dlrm_stream(seed: int, cfg, alpha: float = 0.0) -> Iterator[dict]:
    """Batches for a ``DLRMConfig`` (row mode slot order)."""
    rng = np.random.default_rng(seed)
    spec = SparseBatchSpec(cfg.table_rows, None, cfg.pooling, cfg.batch,
                           num_dense=cfg.num_dense, alpha=alpha)
    while True:
        yield sparse_batch(rng, spec)


def hybrid_stream(seed: int, mdef, alpha: float = 0.0) -> Iterator[dict]:
    """Batches for a ``core.hybrid.HybridDef`` model (original slot order):
    ``idx``, and ``labels`` / ``seq_mask`` / ``hist_mask`` where the model
    declares them."""
    rng = np.random.default_rng(seed)
    spec = SparseBatchSpec(mdef.spec.table_rows, mdef.slot_to_table, mdef.pooling, mdef.batch,
                           alpha=alpha, labels="labels" in mdef.extras,
                           seq_mask="seq_mask" in mdef.extras,
                           hist_mask="hist_mask" in mdef.extras)
    while True:
        yield sparse_batch(rng, spec)


def token_stream(seed: int, vocab: int, batch: int, seq: int) -> Iterator[dict]:
    """LM batches: ``tokens`` [batch, seq] and ``labels`` (the tokens one
    position on) int32 of uniform ids in ``[0, vocab)``, the reference's
    draws for ``seed`` byte for byte."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
