"""Plain PyTorch versions of the port's kernels.

The kernel wrappers run these for tensors that lie on the CPU, the CPU
tests hold them against the JAX package, and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def embedding_bag(W: torch.Tensor, gidx: torch.Tensor, rows_per_shard: int) -> torch.Tensor:
    """The reference's masked partial bag (``_partial_bag_masked``): W [M, E],
    gidx [B, S, P] rows -> [B, S, E] fp32 sums; a row outside
    [0, rows_per_shard) adds zero."""
    valid = (gidx >= 0) & (gidx < rows_per_shard)
    rows = W[gidx.clamp(0, W.shape[0] - 1).long()].float()
    return torch.where(valid[..., None], rows, 0.0).sum(dim=2)


def dot_interaction(dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """dense [B, E], emb [B, S, E] -> [B, E + F(F-1)/2] fp32: the dense vector,
    then the strict lower triangle of Z Z^T (Z = [dense; emb], F = S + 1) in
    ``np.tril_indices(F, -1)`` order."""
    B, S, E = emb.shape
    F = S + 1
    Z = torch.cat([dense[:, None, :], emb], dim=1).float()
    ZZt = torch.bmm(Z, Z.transpose(1, 2))
    li, lj = np.tril_indices(F, -1)
    flat_idx = torch.as_tensor(li * F + lj, device=Z.device)
    pairs = ZZt.reshape(B, F * F)[:, flat_idx]
    return torch.cat([dense.float(), pairs], dim=1)


def fused_mlp_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, activation: str = "relu",
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """act(x @ w + b): products and sums in fp32 (exact products of bf16
    inputs), bias added in fp32, then cast to ``out_dtype``."""
    y = x.float() @ w.float() + b.float()
    if activation == "relu":
        y = torch.relu(y)
    elif activation == "sigmoid":
        y = torch.sigmoid(y)
    elif activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return y.to(out_dtype)
