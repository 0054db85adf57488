"""Attention for the LM family (twin of ``repro/models/attention.py``).

Three paths, as in the reference:

* ``pallas``  — the flash kernel (``kernels.flash_attention``; on the CPU
  its plain version);
* ``chunked`` — plain PyTorch, q-chunked, a one-shot softmax per chunk
  (the config's default impl);
* ``decode``  — plain PyTorch for Lq == 1 against a KV cache, whatever the
  impl, as in the reference: no kernel.

Scores are fp32 products of bf16 operands; ``p`` is rounded to v's dtype
before the PV product, as the reference rounds it.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops


def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, Hkv, L, D] -> [B, Hkv * rep, L, D] in ``jnp.repeat``'s order."""
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=1)


def _mask(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` written out: exp(s - max) over its sum, a divide."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _chunk(qc, kk, vv, q0: int, start: int, causal: bool, softcap: float, window: int,
           scale: float) -> torch.Tensor:
    """One q chunk's attention over the keys ``kk`` / ``vv`` from absolute
    position ``start``: fp32 scores, the one-shot softmax, ``p`` rounded to
    v's dtype before the PV product."""
    kpos = start + torch.arange(kk.shape[2], device=qc.device)[None, :]
    s = (qc.float() @ kk.float().transpose(-1, -2)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = q0 + torch.arange(qc.shape[2], device=qc.device)[:, None]
    s = torch.where(_mask(qpos, kpos, causal, window), s, -torch.inf)
    p = _softmax(s)
    return (p.to(vv.dtype).float() @ vv.float()).to(vv.dtype)


def chunked_attention(q, k, v, *, causal=True, softcap=0.0, window=0, scale=None,
                      bq=256, remat: bool = True) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, Hkv, Lk, D] -> [B, H, Lq, Dv], q chunk by q
    chunk; a local layer scores only the ``window + bq`` keys a chunk can
    reach.  Under autograd each chunk is rematerialised
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    each chunk): backward keeps one chunk's scores at a time, not the
    [B, H, Lq, Lk] the chunking exists to avoid; ``remat=False`` keeps them
    all (the same values)."""
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // Hkv)
    v = repeat_kv(v, H // Hkv)
    scale = scale if scale is not None else D ** -0.5
    bq = min(bq, Lq)
    if Lq % bq:
        bq = math.gcd(bq, Lq)
    wsz = min(Lk, window + bq) if window > 0 else Lk
    sliced = 0 < wsz < Lk
    ckpt = remat and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(Lq // bq):
        q0 = (Lk - Lq) + i * bq            # absolute position of the chunk's first query
        start = min(max(q0 - window + 1, 0), Lk - wsz) if sliced else 0
        args = (q[:, :, i * bq:(i + 1) * bq], k[:, :, start:start + wsz],
                v[:, :, start:start + wsz], q0, start, causal, softcap, window, scale)
        outs.append(torch.utils.checkpoint.checkpoint(_chunk, *args, use_reentrant=False)
                    if ckpt else _chunk(*args))
    return torch.cat(outs, dim=2).to(q.dtype)


def decode_attention(q, k, v, *, softcap=0.0, window=0, scale=None, kv_len=None) -> torch.Tensor:
    """One-token attention.  q [B, H, 1, D], k/v [B, Hkv, Lk, D] (the
    cache); ``kv_len`` [B]: positions at or past it are masked.  GQA by a
    grouped view of q, with no repeated copy of the cache: the same sums as
    ``repeat_kv``."""
    B, H, _, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, rep, D)
    s = (qg.float() @ k.float().transpose(-1, -2)) * scale       # [B, Hkv, rep, Lk]
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(Lk, device=q.device)[None, None, None, :]
    if kv_len is None:
        valid = torch.ones((B, 1, 1, Lk), dtype=torch.bool, device=q.device)
        qpos = Lk - 1
    else:
        valid = kpos < kv_len[:, None, None, None]
        qpos = kv_len[:, None, None, None] - 1
    if window > 0:
        valid &= kpos > qpos - window
    p = _softmax(torch.where(valid, s, -torch.inf))
    o = (p.to(v.dtype).float() @ v.float()).to(v.dtype)           # [B, Hkv, rep, Dv]
    return o.reshape(B, H, 1, v.shape[-1]).to(q.dtype)


def attention(q, k, v, *, causal=True, softcap=0.0, window=0, scale=None, impl: str = "chunked",
              bq: int = 256) -> torch.Tensor:
    """The transformer's dispatcher: decode shapes take the decode path
    whatever ``impl``; ``"pallas"`` the flash kernel."""
    if q.shape[2] == 1:
        return decode_attention(q, k, v, softcap=softcap, window=window, scale=scale)
    if impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal, softcap=softcap, window=window,
                                   scale=scale)
    return chunked_attention(q, k, v, causal=causal, softcap=softcap, window=window, scale=scale,
                             bq=bq)


# ---------------------------------------------------------------------------
# RoPE and RMSNorm, shared by every LM arch
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x [..., L, D] with D even; positions [..., L] absolute.  Angles in
    fp32."""
    D = x.shape[-1]
    freqs = theta ** (-torch.arange(0, D // 2, dtype=torch.float32, device=x.device) / (D // 2))
    ang = positions[..., None].to(torch.float32) * freqs            # [..., L, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
