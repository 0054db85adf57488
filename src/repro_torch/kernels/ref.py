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


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` for fp32 operands, rounded to fp32 ONCE, as the FMA of
    the kernels (``fmaf``) and of jitted JAX (which contracts ``c - lr * x``
    into one) rounds it.  ``a * b`` is exact in f64 (24 + 24 bits); the sum
    is taken in f64 with its exact error (TwoSum) and rounded to odd, from
    which the cast to fp32 rounds correctly (53 >= 24 + 2 bits)."""
    a, b, c = (torch.as_tensor(t, dtype=torch.float32) for t in (a, b, c))
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.float()


def _combine(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    h = hi.contiguous().view(torch.int16).to(torch.int32) << 16
    return (h | (lo.to(torch.int32) & 0xFFFF)).view(torch.float32)


def _split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    bits = w.contiguous().view(torch.int32)
    return (bits >> 16).to(torch.int16).view(torch.bfloat16), (bits & 0xFFFF).to(torch.int16)


def _run_sums(srows: torch.Tensor, sbags: torch.Tensor, smsk: torch.Tensor,
              swgt: torch.Tensor, dY: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [U] int64, acc [U, E] fp32) of the sorted stream, on the CPU:
    one entry per run of equal rows, ``acc = sum(wgt * dY[bag])`` over the
    run, masked lookups adding exact 0.0.  The order is fixed: each run sums
    in its sorted flat order, starting from 0.0 (``index_add_`` on the CPU
    walks its index in order), as ``segment_sum`` on sorted segments and the
    TPU kernel's sequential grid do."""
    rows = srows.cpu().long()
    start = torch.ones_like(rows, dtype=torch.bool)
    start[1:] = rows[1:] != rows[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    g = dY.cpu()[sbags.cpu().long()].float() * swgt.cpu().float()[:, None]
    g = torch.where(smsk.cpu()[:, None] != 0, g, 0.0)
    acc = torch.zeros((int(start.sum()), dY.shape[1]), dtype=torch.float32)
    acc.index_add_(0, run, g)
    return rows[start], acc


def fused_update_split(hi: torch.Tensor, lo: torch.Tensor, srows: torch.Tensor,
                       sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                       dY: torch.Tensor, lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused sparse backward + Split-SGD row update, in place on the
    split table ``hi`` [M, E] bf16 / ``lo`` [M, E] int16: for each run of
    the sorted stream (``kernels.embedding_update.sort_lookups``),
    ``w = combine(hi, lo)[row]``, ``w = fma32(-lr, acc, w)``, re-split.  Rows
    outside the stream are not written.  Sums run on the CPU to fix their
    order (:func:`_run_sums`); the result goes back to the table's device."""
    rows, acc = _run_sums(srows, sbags, smsk, swgt, dY)
    r = rows.to(hi.device)
    w = fma32(-np.float32(lr), acc, _combine(hi[r], lo[r]).cpu())
    nh, nl = _split(w)
    hi[r] = nh.to(hi.device)
    lo[r] = nl.to(lo.device)
    return hi, lo


def fused_update_fp32(W: torch.Tensor, srows: torch.Tensor, sbags: torch.Tensor,
                      smsk: torch.Tensor, swgt: torch.Tensor, dY: torch.Tensor,
                      lr: float) -> torch.Tensor:
    """:func:`fused_update_split` on an fp32 table ``W`` [M, E], in place:
    ``W[row] = fma32(-lr, acc, W[row])`` once per run."""
    rows, acc = _run_sums(srows, sbags, smsk, swgt, dY)
    r = rows.to(W.device)
    W[r] = fma32(-np.float32(lr), acc, W[r].cpu()).to(W.device)
    return W


def split_sgd(hi: torch.Tensor, lo: torch.Tensor, g: torch.Tensor,
              lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat Split-SGD step, in place on ``hi`` [n] bf16 / ``lo`` [n] int16
    with ``g`` [n] fp32: ``w = fma32(-lr, g, combine(hi, lo))``, re-split."""
    nh, nl = _split(fma32(-np.float32(lr), g.float(), _combine(hi, lo)))
    hi.copy_(nh)
    lo.copy_(nl)
    return hi, lo
