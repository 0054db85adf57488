"""Synthetic index streams (copy of ``zipf_indices`` from
``repro/data/synthetic.py``, so the port needs nothing of ``repro``).

``alpha`` sets a Zipf-like skew: real click logs reuse a few rows heavily,
which is what the serving table's caches see.
"""

from __future__ import annotations

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
