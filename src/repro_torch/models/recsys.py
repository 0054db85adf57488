"""The four recsys archetypes as ``HybridDef`` models (twin of
``repro/models/recsys.py``):

    fm       FM 2-way (Rendle, ICDM'10) via the O(nk) sum-square trick
    bst      Behavior Sequence Transformer (arXiv:1905.06874)
    sasrec   self-attentive sequential rec (arXiv:1808.09781)
    din      Deep Interest Network target attention (arXiv:1706.06978)

All share the hybrid-parallel skeleton (``core/hybrid.py``): one unified
embedding space (items + context fields), model-parallel over the mesh,
dense nets data-parallel.  A sequence lookup is a bag of one (P = 1), and the
sequence slots read one shared item table (``slot_to_table``).

Dtypes follow the reference at every seam: a ``jnp.dot`` of bf16 by bf16 is
an fp32 product rounded to bf16 (``_dot``), ``seq + pos`` is added in bf16,
the MLPs are ``models.mlp.mlp_forward`` (bf16 in, fp32 out of the last
layer) and the attention is the plain ``models.attention.chunked_attention``
(no kernel: the reference calls the plain one here).  SASRec's stacked
``blocks`` (each leaf [n_blocks, ...]) are walked by block index where the
reference scans them.

``make_retrieval_step`` is the batched-dot retrieval of a user
representation against a candidate matrix split over the ranks, with the
top-k merged over them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.core.hybrid import HybridDef, topk_stable
from repro_torch.models.attention import chunked_attention
from repro_torch.models.mlp import init_mlp, mlp_forward


def bce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed binary cross-entropy on logits, in the reference's form."""
    x, y = logits.float(), labels.float()
    return (torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))).sum()


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot`` of bf16 operands: the fp32 product rounded to bf16."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def _randn(shape, scale: float, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device) * scale


# ---------------------------------------------------------------------------
# FM — n_sparse=39, embed_dim=10, fm-2way.  The unified table carries E=11 a
# row: dims 0..9 are the factor vector v, dim 10 the linear weight w.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FMSizes:
    n_fields: int = 39
    k: int = 10


def fm_dense_init(generator: Optional[torch.Generator], device) -> dict:
    return {"bias": torch.zeros((1,), device=device)}


def fm_score(dense_hi, emb_out: torch.Tensor, batch: dict, k: int = 10) -> torch.Tensor:
    v = emb_out[:, :, :k]                   # [B, S, k] fp32
    w = emb_out[:, :, k]                    # [B, S]
    sv = v.sum(dim=1)                       # [B, k]
    fm2 = 0.5 * ((sv * sv).sum(-1) - (v * v).sum(dim=(1, 2)))
    return dense_hi["bias"][0].float() + w.sum(-1) + fm2


def make_fm(table_rows, batch: int = 65536, **kw) -> HybridDef:
    sizes = FMSizes()
    spec = EmbeddingSpec(tuple(table_rows), sizes.k + 1)
    return HybridDef(
        name="fm", spec=spec, pooling=1, batch=batch, init_dense=fm_dense_init,
        dense_loss=lambda hi, e, b: bce_sum(fm_score(hi, e, b, sizes.k), b["labels"]),
        dense_score=lambda hi, e, b: fm_score(hi, e, b, sizes.k),
        extras={"labels": ((), torch.float32)}, **kw)


# ---------------------------------------------------------------------------
# BST — embed_dim=32, seq_len=20, 1 transformer block, 8 heads, MLP
# 1024-512-256.  Slots: [0..19] behavior seq, [20] target item, [21..28]
# context fields.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BSTSizes:
    seq_len: int = 20
    emb_dim: int = 32
    n_heads: int = 8
    n_ctx: int = 8
    mlp: tuple = (1024, 512, 256)


def bst_dense_init(generator: Optional[torch.Generator], device,
                   s: BSTSizes = BSTSizes()) -> dict:
    d = s.emb_dim
    L = s.seq_len + 1
    mlp_in = L * d + s.n_ctx * d
    return {
        "pos": _randn((L, d), 0.02, generator, device),
        "wq": _randn((d, d), d ** -0.5, generator, device),
        "wk": _randn((d, d), d ** -0.5, generator, device),
        "wv": _randn((d, d), d ** -0.5, generator, device),
        "wo": _randn((d, d), d ** -0.5, generator, device),
        "ffn": init_mlp([d, 4 * d, d], generator, device),
        "mlp": init_mlp([mlp_in, *s.mlp, 1], generator, device),
    }


def _heads(x: torch.Tensor, B: int, L: int, H: int, d: int) -> torch.Tensor:
    return x.reshape(B, L, H, d // H).transpose(1, 2)


def bst_score(dense_hi, emb_out: torch.Tensor, batch: dict, s: BSTSizes = BSTSizes()):
    B = emb_out.shape[0]
    d, H = s.emb_dim, s.n_heads
    L = s.seq_len + 1
    seq = emb_out[:, :L].to(torch.bfloat16) + dense_hi["pos"].to(torch.bfloat16)[None]
    ctx = emb_out[:, L:]
    q = _heads(_dot(seq, dense_hi["wq"]), B, L, H, d)
    k = _heads(_dot(seq, dense_hi["wk"]), B, L, H, d)
    v = _heads(_dot(seq, dense_hi["wv"]), B, L, H, d)
    o = chunked_attention(q, k, v, causal=False)
    o = o.transpose(1, 2).reshape(B, L, d)
    h = seq + _dot(o, dense_hi["wo"])
    h = h + mlp_forward(dense_hi["ffn"], h).to(torch.bfloat16)
    flat = torch.cat([h.reshape(B, L * d).float(), ctx.reshape(B, -1)], dim=-1)
    return mlp_forward(dense_hi["mlp"], flat.to(torch.bfloat16))[:, 0]


def make_bst(item_vocab: int, ctx_rows, batch: int = 65536, **kw) -> HybridDef:
    s = BSTSizes()
    rows = (item_vocab,) + tuple(ctx_rows)   # ONE shared item table
    spec = EmbeddingSpec(rows, s.emb_dim)
    s2t = tuple([0] * (s.seq_len + 1)) + tuple(range(1, 1 + len(ctx_rows)))
    return HybridDef(
        name="bst", spec=spec, pooling=1, batch=batch,
        init_dense=lambda g, dev: bst_dense_init(g, dev, s),
        dense_loss=lambda hi, e, b: bce_sum(bst_score(hi, e, b, s), b["labels"]),
        dense_score=lambda hi, e, b: bst_score(hi, e, b, s),
        extras={"labels": ((), torch.float32)}, slot_to_table=s2t, **kw)


# ---------------------------------------------------------------------------
# SASRec — embed_dim=50, 2 blocks, 1 head, seq_len=50.  Slots: [0..49] input
# seq, [50..99] positive next items, [100..149] sampled negatives.  BCE over
# (pos, neg) per position.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SASRecSizes:
    seq_len: int = 50
    emb_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1


def sasrec_dense_init(generator: Optional[torch.Generator], device,
                      s: SASRecSizes = SASRecSizes()) -> dict:
    """The blocks' parameters stacked as the reference stacks them: each
    leaf [n_blocks, ...]."""
    d = s.emb_dim
    blocks = []
    for _ in range(s.n_blocks):
        blocks.append({"wq": _randn((d, d), d ** -0.5, generator, device),
                       "wk": _randn((d, d), d ** -0.5, generator, device),
                       "wv": _randn((d, d), d ** -0.5, generator, device),
                       "wo": _randn((d, d), d ** -0.5, generator, device),
                       "ffn": init_mlp([d, d, d], generator, device)})

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], list):
            return [stack(*parts) for parts in zip(*xs)]
        return torch.stack(xs)
    return {"pos": _randn((s.seq_len, d), 0.02, generator, device), "blocks": stack(*blocks)}


def _block(stacked, i: int):
    """Block ``i`` of the stacked block tree."""
    if isinstance(stacked, dict):
        return {k: _block(v, i) for k, v in stacked.items()}
    if isinstance(stacked, list):
        return [_block(v, i) for v in stacked]
    return stacked[i]


def sasrec_user_rep(dense_hi, seq_emb: torch.Tensor, s: SASRecSizes = SASRecSizes()):
    """seq_emb [B, L, E] fp32 -> causal user representations [B, L, E] fp32."""
    B, L, d = seq_emb.shape
    H = s.n_heads
    h = seq_emb.to(torch.bfloat16) + dense_hi["pos"].to(torch.bfloat16)[None]
    n_blocks = dense_hi["blocks"]["wq"].shape[0]
    for i in range(n_blocks):
        bp = _block(dense_hi["blocks"], i)
        q = _heads(_dot(h, bp["wq"]), B, L, H, d)
        k = _heads(_dot(h, bp["wk"]), B, L, H, d)
        v = _heads(_dot(h, bp["wv"]), B, L, H, d)
        o = chunked_attention(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(B, L, d)
        h = h + _dot(o, bp["wo"])
        h = h + mlp_forward(bp["ffn"], h).to(torch.bfloat16)
    return h.float()


def sasrec_loss_sum(dense_hi, emb_out: torch.Tensor, batch: dict,
                    s: SASRecSizes = SASRecSizes()) -> torch.Tensor:
    L = s.seq_len
    u = sasrec_user_rep(dense_hi, emb_out[:, :L], s)        # [B, L, E]
    pos, neg = emb_out[:, L:2 * L], emb_out[:, 2 * L:3 * L]
    sp = (u * pos).sum(-1)
    sn = (u * neg).sum(-1)
    m = batch["seq_mask"].float()                           # [B, L]
    return ((torch.log1p(torch.exp(-sp)) + torch.log1p(torch.exp(sn))) * m).sum()


def sasrec_score(dense_hi, emb_out: torch.Tensor, batch: dict,
                 s: SASRecSizes = SASRecSizes()) -> torch.Tensor:
    """Serve: dot(user rep at the last position, the target item), the
    target riding in slot L (the first 'positive' slot)."""
    L = s.seq_len
    u = sasrec_user_rep(dense_hi, emb_out[:, :L], s)[:, -1]
    return (u * emb_out[:, L]).sum(-1)


def make_sasrec(item_vocab: int, batch: int = 65536, **kw) -> HybridDef:
    s = SASRecSizes()
    spec = EmbeddingSpec((item_vocab,), s.emb_dim)   # ONE shared item table
    s2t = tuple([0] * (3 * s.seq_len))               # seq + pos + neg slots
    return HybridDef(
        name="sasrec", spec=spec, pooling=1, batch=batch,
        init_dense=lambda g, dev: sasrec_dense_init(g, dev, s),
        dense_loss=lambda hi, e, b: sasrec_loss_sum(hi, e, b, s),
        dense_score=lambda hi, e, b: sasrec_score(hi, e, b, s),
        extras={"seq_mask": ((s.seq_len,), torch.float32)}, slot_to_table=s2t, **kw)


# ---------------------------------------------------------------------------
# DIN — embed_dim=18, hist len=100, attention MLP 80-40, main MLP 200-80.
# Slots: [0..99] history, [100] target, [101..104] context fields.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DINSizes:
    hist: int = 100
    emb_dim: int = 18
    n_ctx: int = 4
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)


def din_dense_init(generator: Optional[torch.Generator], device,
                   s: DINSizes = DINSizes()) -> dict:
    d = s.emb_dim
    return {"attn": init_mlp([4 * d, *s.attn_mlp, 1], generator, device),
            "mlp": init_mlp([(2 + s.n_ctx) * d, *s.mlp, 1], generator, device)}


def din_score(dense_hi, emb_out: torch.Tensor, batch: dict, s: DINSizes = DINSizes()):
    B = emb_out.shape[0]
    h = emb_out[:, :s.hist]                    # [B, T, E]
    t = emb_out[:, s.hist]                     # [B, E]
    ctx = emb_out[:, s.hist + 1:]              # [B, n_ctx, E]
    tt = t[:, None, :].expand(h.shape)
    a_in = torch.cat([h, tt, h - tt, h * tt], dim=-1)
    a = mlp_forward(dense_hi["attn"], a_in.to(torch.bfloat16))[..., 0]
    mask = batch.get("hist_mask")
    if mask is not None:
        a = a * mask.float()
    pooled = (a[..., None] * h).sum(dim=1)     # [B, E]
    flat = torch.cat([pooled, t, ctx.reshape(B, -1)], dim=-1)
    return mlp_forward(dense_hi["mlp"], flat.to(torch.bfloat16))[:, 0]


def make_din(item_vocab: int, ctx_rows, batch: int = 65536, **kw) -> HybridDef:
    s = DINSizes()
    rows = (item_vocab,) + tuple(ctx_rows)           # ONE shared item table
    spec = EmbeddingSpec(rows, s.emb_dim)
    s2t = tuple([0] * (s.hist + 1)) + tuple(range(1, 1 + len(ctx_rows)))
    return HybridDef(
        name="din", spec=spec, pooling=1, batch=batch,
        init_dense=lambda g, dev: din_dense_init(g, dev, s),
        dense_loss=lambda hi, e, b: bce_sum(din_score(hi, e, b, s), b["labels"]),
        dense_score=lambda hi, e, b: din_score(hi, e, b, s),
        extras={"labels": ((), torch.float32), "hist_mask": ((s.hist,), torch.float32)},
        slot_to_table=s2t, **kw)


# ---------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand shape): candidates split over the ranks,
# per-rank scores and a top-k merged over them.
# ---------------------------------------------------------------------------

def make_retrieval_step(mdef: HybridDef, mesh, n_candidates: int, topk: int = 128, *,
                        device="cuda"):
    """Batched-dot candidate scoring on this rank of ``mesh`` (None: one rank
    on ``device``): ``fn(urep [E], cand [n_candidates / ranks, E]) ->
    (values [topk], indices [topk])``, the same on every rank.  ``cand`` is
    this rank's block of the candidate rows (gathered from the item table);
    each score is ``urep . cand`` in fp32, the local top-k is merged over
    the ranks by an all-gather and a second top-k, ties in the reference's
    order (``core.hybrid.topk_stable``)."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import resolve_mesh

    mesh = resolve_mesh(mesh, device)
    g_all = mesh.group(tuple(mesh.axis_names))
    per = n_candidates // mesh.size

    def fn(urep: torch.Tensor, cand: torch.Tensor):
        s = cand.float() @ urep.float()
        v, i = topk_stable(s, min(topk, per))
        i = i + g_all.index * per
        vg, ig = comm.all_gather(v, g_all), comm.all_gather(i, g_all)
        vv, pos = topk_stable(vg, min(topk, vg.numel()))
        return vv, ig[pos]

    return fn
