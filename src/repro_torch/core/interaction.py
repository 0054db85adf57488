"""DLRM feature interaction (twin of ``repro/core/interaction.py``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def tril_indices(F: int, offset: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """Static lower-triangle (i > j) index pair for the self-dot output."""
    return np.tril_indices(F, offset)


class DotInteraction(torch.autograd.Function):
    """The interaction with its gradient.  The forward is the
    dot_interaction kernel.  The backward is plain PyTorch, as the
    reference's is XLA's VJP of an ``einsum`` and no Pallas kernel: the
    pair cotangents scattered into a strict lower triangle ``G`` [B, F, F],
    ``dZ = (G + G^T) Z``, and the dense vector's pass-through added to
    ``dZ[:, 0]``."""

    @staticmethod
    def forward(ctx, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(dense, emb)
        return ops.dot_interaction(dense, emb)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        dense, emb = ctx.saved_tensors
        B, S, E = emb.shape
        F = S + 1
        Z = torch.cat([dense[:, None, :], emb], dim=1)
        li, lj = torch.tril_indices(F, F, -1, device=grad.device)  # np.tril_indices' order, no copy
        G = grad.new_zeros((B, F, F))
        G[:, li, lj] = grad[:, E:]
        dZ = torch.bmm(G + G.transpose(1, 2), Z)
        return grad[:, :E] + dZ[:, 0], dZ[:, 1:]


def dot_interaction(dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction through the dot_interaction kernel.

    ``dense`` [B, E] bottom-MLP output, ``emb`` [B, S, E] bag outputs, both
    fp32.  Output [B, E + F(F-1)/2] fp32, F = S + 1: the dense vector, then
    the strict lower triangle of Z Z^T in :func:`tril_indices` order.
    Differentiable (:class:`DotInteraction`)."""
    return DotInteraction.apply(dense, emb)


def concat_interaction(dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The paper's simple 'Concat' interaction: ``dense`` [B, E] and the bag
    outputs ``emb`` [B, S, E] flattened, side by side in fp32: [B, E + S *
    E].  Plain PyTorch, as the reference's is plain ``jnp``; no config
    selects it."""
    B, S, E = emb.shape
    return torch.cat([dense.float(), emb.reshape(B, S * E).float()], dim=1)


def interaction_output_dim(num_features: int, dim: int, kind: str = "dot",
                           self_interaction: bool = False) -> int:
    """Static output width of the interaction over ``num_features`` (F = S +
    1, the bottom MLP's output included): ``F * dim`` for ``"concat"``;
    for ``"dot"`` the dense vector and the lower triangle's pairs, the
    diagonal too with ``self_interaction``."""
    F = num_features
    if kind == "concat":
        return F * dim
    pairs = F * (F + 1) // 2 if self_interaction else F * (F - 1) // 2
    return dim + pairs
