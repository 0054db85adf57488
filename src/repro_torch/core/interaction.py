"""DLRM feature interaction (twin of ``repro/core/interaction.py``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def tril_indices(F: int, offset: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """Static lower-triangle (i > j) index pair for the self-dot output."""
    return np.tril_indices(F, offset)


def dot_interaction(dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction through the dot_interaction kernel.

    ``dense`` [B, E] bottom-MLP output, ``emb`` [B, S, E] bag outputs, both
    fp32.  Output [B, E + F(F-1)/2] fp32, F = S + 1: the dense vector, then
    the strict lower triangle of Z Z^T in :func:`tril_indices` order."""
    return ops.dot_interaction(dense, emb)


def interaction_output_dim(num_features: int, dim: int) -> int:
    """Static output width of the dot interaction (F = S + 1 features)."""
    return dim + num_features * (num_features - 1) // 2
