"""Plain PyTorch versions of the port's kernels.

The kernel wrappers run these for tensors that lie on the CPU, the CPU
tests hold them against the JAX package, and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def embedding_bag(W: torch.Tensor, gidx: torch.Tensor, rows_per_shard: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's masked partial bag (``_partial_bag_masked``): W [M, E],
    gidx [B, S, P] rows -> [B, S, E] fp32 sums; a row outside
    [0, rows_per_shard) adds zero.  With ``weights`` [B, S, P] each row is
    first multiplied by its lookup's fp32 weight (rounded on its own)."""
    valid = (gidx >= 0) & (gidx < rows_per_shard)
    rows = W[gidx.clamp(0, W.shape[0] - 1).long()].float()
    if weights is not None:
        rows = rows * weights.float()[..., None]
    return torch.where(valid[..., None], rows, 0.0).sum(dim=2)


def embedding_bag_stage(W: torch.Tensor, idx: torch.Tensor, row_offsets: torch.Tensor,
                        rows_per_shard: int, weights: torch.Tensor | None = None,
                        round_bf16: bool = True) -> torch.Tensor:
    """The bag stage as the reference composes it: the slot's row offset
    added to the table-local ids ``idx`` [B, S, P], the masked bag
    :func:`embedding_bag`, and with ``round_bf16`` each sum rounded to bf16
    (the row-mode reduce-scatter wire) and widened back to fp32."""
    out = embedding_bag(W, idx + row_offsets[None, :, None], rows_per_shard, weights)
    return out.to(torch.bfloat16).float() if round_bf16 else out


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


# values a block of fma32 and sqrt32 on the CPU: each block's f64 temporaries stay in the
# cache, where whole-tensor temporaries of dlrm-small's uniform stream ran 3-8x slower
CPU_BLOCK = 1 << 20


def _cpu_blocks(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)``, elementwise over their broadcast; on the CPU in blocks
    of CPU_BLOCK values (a 0-d operand goes whole to every block)."""
    shape = torch.broadcast_shapes(*(t.shape for t in args))
    n = math.prod(shape)
    if n <= CPU_BLOCK or not all(t.is_cpu for t in args):
        return fn(*args)
    flat = [t if t.dim() == 0 else t.expand(shape).reshape(-1) for t in args]
    return torch.cat([fn(*(t if t.dim() == 0 else t[i:i + CPU_BLOCK] for t in flat))
                      for i in range(0, n, CPU_BLOCK)]).view(shape)


def _to_odd(p: torch.Tensor, c64: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``s = p + c64`` (f64) rounded to odd where it is inexact: its exact
    error by TwoSum, and an even ``s`` moved one f64 ulp toward it."""
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where(inexact_even, torch.nextafter(s, toward), s)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    if not s.is_cpu:
        return _to_odd(p, c64, s).float()
    # moving an even s by one f64 ulp changes its fp32 rounding only where s is the
    # midpoint of two fp32 values: among the fp32 normals, where its low 29 bits are 2^28;
    # below them (an f64 exponent field under 897) every value takes the check.  On the
    # CPU only those do (a host sync, which the card's path avoids)
    u = s.view(torch.int64)
    at = (((u & 0x1FFFFFFF) == 1 << 28) | (((u >> 52) & 0x7FF) < 897)).nonzero().squeeze(1)
    if at.numel():
        s.view(-1)[at] = _to_odd(p.expand_as(s).reshape(-1)[at],
                                 c64.expand_as(s).reshape(-1)[at], s.view(-1)[at])
    return s.float()


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` for fp32 operands, rounded to fp32 ONCE, as the FMA of
    the kernels (``fmaf``) and of jitted JAX (which contracts ``c - lr * x``
    into one) rounds it.  ``a * b`` is exact in f64 (24 + 24 bits); the sum
    is taken in f64 with its exact error (TwoSum) and rounded to odd, from
    which the cast to fp32 rounds correctly (53 >= 24 + 2 bits)."""
    a, b, c = (torch.as_tensor(t, dtype=torch.float32) for t in (a, b, c))
    return _cpu_blocks(_fma32, a, b, c)


def _combine(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    h = hi.contiguous().view(torch.int16).to(torch.int32) << 16
    return (h | (lo.to(torch.int32) & 0xFFFF)).view(torch.float32)


def _split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    bits = w.contiguous().view(torch.int32)
    return (bits >> 16).to(torch.int16).view(torch.bfloat16), (bits & 0xFFFF).to(torch.int16)


def _run_sums(srows: torch.Tensor, sbags: torch.Tensor, smsk: torch.Tensor,
              swgt: torch.Tensor, dY: torch.Tensor, start=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows [U] int64, acc [U, E] fp32, live [U] bool) of the sorted stream,
    on the CPU: one entry per run of equal rows, ``acc = sum(wgt * dY[bag])``
    over the run, masked lookups adding exact 0.0, and whether any lookup of
    the run is valid (the sorted masked tail alone is a dead run).  The order
    is fixed: each run sums in its sorted flat order (``index_add_`` on the
    CPU walks its index in order), as ``segment_sum`` on sorted segments and
    the TPU kernel's sequential grid do, from 0.0 or from ``start(rows)``
    [U, E] fp32 where given."""
    rows = srows.cpu().long()
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    run = torch.cumsum(first.long(), 0) - 1
    valid = smsk.cpu() != 0
    g = dY.cpu()[sbags.cpu().long()].float() * swgt.cpu().float()[:, None]
    g = torch.where(valid[:, None], g, 0.0)
    U = int(first.sum())
    acc = (torch.zeros((U, dY.shape[1]), dtype=torch.float32) if start is None
           else start(rows[first]).float().cpu().clone())
    acc.index_add_(0, run, g)
    live = torch.zeros(U, dtype=torch.int64).index_add_(0, run, valid.long()) > 0
    return rows[first], acc, live


def fused_update_split(hi: torch.Tensor, lo: torch.Tensor, srows: torch.Tensor,
                       sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                       dY: torch.Tensor, lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused sparse backward + Split-SGD row update, in place on the
    split table ``hi`` [M, E] bf16 / ``lo`` [M, E] int16: for each run of
    the sorted stream (``kernels.embedding_update.sort_lookups``),
    ``w = combine(hi, lo)[row]``, ``w = fma32(-lr, acc, w)``, re-split.  Rows
    outside the stream are not written.  Sums run on the CPU to fix their
    order (:func:`_run_sums`); the result goes back to the table's device."""
    rows, acc, _ = _run_sums(srows, sbags, smsk, swgt, dY)
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
    rows, acc, _ = _run_sums(srows, sbags, smsk, swgt, dY)
    r = rows.to(W.device)
    W[r] = fma32(-np.float32(lr), acc, W[r].cpu()).to(W.device)
    return W


def _f32(x) -> torch.Tensor:
    """A Python number as a 0-d fp32 tensor, so that every operation with it
    rounds in fp32."""
    return torch.tensor(np.float32(x))


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(x.double())
    r = d.float()
    if x.is_cpu:
        # r is correctly rounded unless d lies near the midpoint of two fp32 values (its
        # low 29 bits near 2^28): an f64 root within 2^16 f64 ulps of the exact one is on
        # the exact root's side of every other midpoint.  Only those values take the check
        near = ((d.view(torch.int64) & 0x1FFFFFFF) - (1 << 28)).abs() <= (1 << 16)
        at = near.nonzero().squeeze(1)
        if at.numel():
            r[at] = _sqrt32_check(x[at], r[at])
        return r
    return _sqrt32_check(x, r)


def _sqrt32_check(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``r`` moved to a neighbour where the exact f64 square of the midpoint
    to it (25 bits, so 50 bits squared) says the root of ``x`` lies beyond."""
    inf = torch.tensor(float("inf"), device=x.device)
    up, dn = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    xd, rd = x.double(), r.double()
    hi, lo = (rd + up.double()) / 2, (rd + dn.double()) / 2
    r = torch.where(hi * hi < xd, up, r)
    return torch.where((lo * lo > xd) & (x > 0), dn, r)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The square root of fp32 values >= 0, correctly rounded, as
    ``__fsqrt_rn`` and XLA round it; torch's CPU ``sqrt`` is not (in fp32 or
    f64).  A candidate from f64 is within one fp32 ulp; it moves by one where
    the exact f64 square of the midpoint to its neighbour says the root lies
    beyond it."""
    x = x.float()
    return _cpu_blocks(lambda t: _sqrt32(t.reshape(-1)).view(t.shape), x)


def _live_runs(W: torch.Tensor, srows, sbags, smsk, swgt, dY, start=None):
    """(rows on W's device, acc [U, E] fp32 on the CPU) of the runs that hold
    a valid lookup: the stateful kinds step only those."""
    rows, acc, live = _run_sums(srows, sbags, smsk, swgt, dY, start)
    return rows[live].to(W.device), acc[live]


def scaled_step(w: torch.Tensor, acc: torch.Tensor, lr: float, denom: torch.Tensor) -> torch.Tensor:
    """``w - (lr * acc) / denom``, each operation rounded on its own in fp32:
    jitted JAX contracts none of them (no product is added)."""
    return w - (_f32(lr) * acc) / denom


def fused_update_momentum(W: torch.Tensor, mom: torch.Tensor, srows: torch.Tensor,
                          sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                          dY: torch.Tensor, lr: float, beta: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + heavy-ball momentum, in place on ``W`` [M, E]
    fp32 and ``mom`` [M, E] fp32: for each live run, ``m`` = the run's
    lookups added in order onto ``beta * m`` (rounded once), then ``w =
    fma32(-lr, m, w)``.  That is jitted JAX's ``beta * m + acc``: XLA folds
    the add of the segment sum into a scatter-add that starts from
    ``beta * m``, and contracts ``w - lr * m``.  Dead runs and untouched rows
    are not written."""
    r, m = _live_runs(W, srows, sbags, smsk, swgt, dY,
                      start=lambda rows: _f32(beta) * mom[rows.to(mom.device)].cpu())
    W[r] = fma32(-np.float32(lr), m, W[r].cpu()).to(W.device)
    mom[r] = m.to(mom.device)
    return W, mom


def fused_update_adagrad(W: torch.Tensor, acc_slab: torch.Tensor, srows: torch.Tensor,
                         sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                         dY: torch.Tensor, lr: float, eps: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + elementwise Adagrad, in place on ``W`` and
    ``acc_slab`` [M, E] fp32: for each live run, ``s = fma32(acc, acc, s)``
    (jitted JAX contracts it), ``w = scaled_step(w, acc, lr, sqrt32(s) + eps)``."""
    r, acc = _live_runs(W, srows, sbags, smsk, swgt, dY)
    s = fma32(acc, acc, acc_slab[r].cpu())
    W[r] = scaled_step(W[r].cpu(), acc, lr, sqrt32(s) + _f32(eps)).to(W.device)
    acc_slab[r] = s.to(acc_slab.device)
    return W, acc_slab


def _sr_store(S: torch.Tensor, r: torch.Tensor, new: torch.Tensor, seed) -> None:
    """``S[r] = sr_round_bf16(new, sr_noise(seed, r, E))``: the bf16 state
    rows of the live runs, rounded stochastically on ``S``'s device (the
    hash is elementwise, so any device gives the same bits)."""
    from repro_torch.optim.stochastic import sr_noise, sr_round_bf16
    new = new.to(S.device)
    S[r] = sr_round_bf16(new, sr_noise(seed, r, new.shape[1]))


def fused_update_momentum_bf16(W: torch.Tensor, mom: torch.Tensor, srows: torch.Tensor,
                               sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                               dY: torch.Tensor, lr: float, beta: float, seed
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_update_momentum` with ``mom`` [M, E] stored as bf16:
    for each live run, ``m`` = the run's lookups added in order onto
    ``beta * decode(m)`` (the decode is exact; jitted XLA folds the add into
    its scatter-add here too), ``w = fma32(-lr, m, w)``, and only the stored
    ``m`` rounds, stochastically under ``seed`` (an int or a 0-d int32
    tensor) with the dither of ``(seed, row, column)``."""
    r, m = _live_runs(W, srows, sbags, smsk, swgt, dY,
                      start=lambda rows: _f32(beta) * mom[rows.to(mom.device)].float().cpu())
    W[r] = fma32(-np.float32(lr), m, W[r].cpu()).to(W.device)
    _sr_store(mom, r, m, seed)
    return W, mom


def fused_update_adagrad_bf16(W: torch.Tensor, acc_slab: torch.Tensor, srows: torch.Tensor,
                              sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                              dY: torch.Tensor, lr: float, eps: float, seed
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_update_adagrad` with ``acc_slab`` [M, E] stored as bf16:
    for each live run, ``s = fma32(acc, acc, decode(s))``, the weight step
    divides by the root of this UNROUNDED ``s``, and only the stored ``s``
    rounds, stochastically under ``seed``."""
    r, acc = _live_runs(W, srows, sbags, smsk, swgt, dY)
    s = fma32(acc, acc, acc_slab[r].float().cpu())
    W[r] = scaled_step(W[r].cpu(), acc, lr, sqrt32(s) + _f32(eps)).to(W.device)
    _sr_store(acc_slab, r, s, seed)
    return W, acc_slab


def row_square_sum(acc: torch.Tensor) -> torch.Tensor:
    """``sum_e acc[:, e]^2`` [U] in the row-wise Adagrad kernel's order.  Lane
    l of a warp holds columns 64b + 2l and 64b + 2l + 1 of each block b of 64
    columns; it adds their squares to its sum ``q_l``, block after block, the
    even column first (each product and each add rounded on its own; columns
    past E add nothing).  A butterfly then adds ``q_l + q_(l xor k)`` for
    k = 16, 8, 4, 2, 1, which leaves the same sum in every lane."""
    U, E = acc.shape
    nb = -(-E // 64)
    a = torch.zeros((U, nb * 64), dtype=torch.float32)
    a[:, :E] = acc
    a = a.view(U, nb, 32, 2)
    q = torch.zeros((U, 32), dtype=torch.float32)
    for b in range(nb):
        for j in range(2):
            q = q + a[:, b, :, j] * a[:, b, :, j]
    lanes = torch.arange(32)
    for k in (16, 8, 4, 2, 1):
        q = q + q[:, lanes ^ k]
    return q[:, 0]


def fused_update_adagrad_rowwise(W: torch.Tensor, acc_row: torch.Tensor, srows: torch.Tensor,
                                 sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                                 dY: torch.Tensor, lr: float, eps: float
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + row-wise Adagrad (one accumulator a row), in
    place on ``W`` [M, E] and ``acc_row`` [M, 1] fp32: for each live run,
    ``s = s + row_square_sum(acc) / E``, then ``w = scaled_step(w, acc, lr,
    sqrt(s) + eps)``; every operation rounded on its own.  Jitted JAX sums
    the squares in an order of its own, so this matches it within a
    tolerance, not bit for bit."""
    r, acc = _live_runs(W, srows, sbags, smsk, swgt, dY)
    tot = row_square_sum(acc)
    s = acc_row[r, 0].cpu() + tot / torch.full_like(tot, float(acc.shape[1]))
    denom = (sqrt32(s) + _f32(eps))[:, None]
    W[r] = scaled_step(W[r].cpu(), acc, lr, denom).to(W.device)
    acc_row[r, 0] = s.to(acc_row.device)
    return W, acc_row


def fused_update_freq(W: torch.Tensor, cnt: torch.Tensor, srows: torch.Tensor,
                      sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                      dY: torch.Tensor, lr: float, eps: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + the frequency-adaptive step, in place on ``W``
    [M, E] fp32: for each live run, ``w = scaled_step(w, acc, lr,
    sqrt(max(cnt, 1)) + eps)`` with ``cnt`` [M, 1] int32 the row's touch
    count, already bumped (``optim.row.bump_counters``) and only read."""
    r, acc = _live_runs(W, srows, sbags, smsk, swgt, dY)
    c = cnt[r, 0].cpu().float()
    denom = (sqrt32(torch.clamp_min(c, 1.0)) + _f32(eps))[:, None]
    W[r] = scaled_step(W[r].cpu(), acc, lr, denom).to(W.device)
    return W, cnt


def split_sgd(hi: torch.Tensor, lo: torch.Tensor, g: torch.Tensor, lr: float,
              mom: torch.Tensor | None = None, beta: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat Split-SGD step, in place on ``hi`` [n] bf16 / ``lo`` [n] int16
    with ``g`` [n] fp32 or bf16: ``w = fma32(-lr, g, combine(hi, lo))``,
    re-split.  With ``mom`` [n] fp32, first ``mom = fma32(beta, mom, g)``
    in place, and the step by ``mom``."""
    g = g.float()
    if mom is not None:
        mom.copy_(fma32(np.float32(beta), mom, g))
        g = mom
    nh, nl = _split(fma32(-np.float32(lr), g, _combine(hi, lo)))
    hi.copy_(nh)
    lo.copy_(nl)
    return hi, lo


# the flash kernel's score for a masked (query, key) pair
# (repro/kernels/flash_attention.py: NEG_INF)
NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    softcap: float = 0.0, window: int = 0, scale: float | None = None,
                    bk: int = 128) -> torch.Tensor:
    """The flash kernel's recurrence (``repro/kernels/flash_attention.py::
    _kernel``) over key tiles of ``bk``: q [B, H, Lq, D], k, v [B, Hkv, Lk,
    D] -> [B, H, Lq, D] in q's dtype.  Head h reads KV head ``h // (H /
    Hkv)``; query i sits at absolute position ``Lk - Lq + i``.  Per tile the
    scores are ``scale · q kᵀ`` in fp32, soft-capped after the scale, masked
    to ``NEG_INF``; the running max ``m``, sum ``l`` and ``acc`` are fp32,
    and ``p = exp(s - m)`` is rounded to v's dtype before the PV product, so
    the bits depend on where the tiles split the keys.  A row that sees no
    key gives 0."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, rep, Lq, D).float()
    qpos = (torch.arange(Lq, device=q.device) + (Lk - Lq))[:, None]
    m = torch.full((B, Hkv, rep, Lq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep, Lq, v.shape[-1]), device=q.device)
    for k0 in range(0, Lk, bk):
        kpos = torch.arange(k0, min(k0 + bk, Lk), device=q.device)[None, :]
        s = (qg @ k[:, :, None, k0:k0 + bk].float().transpose(-1, -2)) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones((Lq, kpos.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ v[:, :, None, k0:k0 + bk].float()
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).to(q.dtype).reshape(B, H, Lq, v.shape[-1])
