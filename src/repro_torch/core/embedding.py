"""Unified multi-table embedding space (twin of ``repro/core/embedding.py``).

All tables of a model share ONE row space ``W [total_rows, E]``: table ``t``
starts at ``row_offsets[t]`` and its rows are padded to a multiple of
``row_pad``.  A lookup ``idx`` of slot ``s`` reads global row
``idx + row_offsets[s]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
