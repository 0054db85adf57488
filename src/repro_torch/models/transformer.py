"""Transformer LM serving and training (twin of ``repro/models/transformer.py``).

The reference covers five architectures, and the port serves and trains
all of them on one card and on a mesh: :func:`prefill` and
:func:`decode_step` for dense
GQA (internlm2, gemma2's local/global layers and soft-caps, phi3), MoE
(qwen3-moe: :func:`moe_block`, the reference's per-sequence grouped top-k
dispatch with its capacity drops) and MLA (deepseek-v2: the latent cache and
the absorbed decode, with its first dense layers); :func:`lm_loss`, the
causal cross-entropy whose gradients ``models.lm_steps.make_lm_train_step``
takes.  On one card the reference's sharding constraints are identity and
its expert FFN is its one-device (``not cfg.seq_shard``) path; on a mesh
(the section "On a mesh" below: :class:`MeshPlan`, :func:`mesh_lm_loss`,
:func:`mesh_prefill`, :func:`mesh_decode_step`) the collectives GSPMD
inserts are written out.

Parameters keep the reference's stacked layout: ``{"embed" [V, d],
"layers": {"ln1", "ln2" [n, d], "attn": {"wq", "wk", "wv", "wo"} (MLA:
{"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}), "mlp":
{"wg", "wu", "wd"} (MoE layers: "moe": {"router", "wg", "wu", "wd",
"shared"?})} (each [n, ...]), "dense_layers" (the first
``first_dense_layers``, the same with "mlp"), "final_norm" [d], "unembed"
[d, V] (untied only)}``; serving holds them in bf16, training reads the
bf16 ``hi`` halves of its Split-SGD state.  The layers run in a plain
Python loop, the dense_layers first, layer ``i`` of a stack reading slice
``i`` of each stacked leaf.  Training rematerialises each layer (gemma2's
each (local, global) pair) in backward, as the reference's ``jax.checkpoint``
of its scan body does, and writes each layer's gradient into its slice of
one stacked gradient (:class:`_LayerStack`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.core.hybrid import topk_stable
from repro_torch.models.attention import _softmax, attention, decode_attention, rms_norm, rope
from repro_torch.optim.data_parallel import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # gemma2
    local_global: bool = False
    window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    embed_scale: bool = False       # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    attn_impl: str = "chunked"      # 'chunked' | 'pallas'
    # the reference's compile and mesh settings; on one card only
    # prefill_microbatch and attn_chunk change what runs
    remat: bool = True
    seq_shard: bool = True
    dp_axes: tuple = ("data",)
    tp_size: int = 16
    loss_chunk: int = 1024
    microbatch: int = 1
    prefill_microbatch: int = 1     # batch-chunked prefill (serving)
    attn_chunk: int = 256           # q-chunk of the chunked attention path
    fsdp: bool = True
    cost_mode: bool = False

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_scale(self) -> float:
        if self.mla:
            return float((self.qk_nope + self.qk_rope) ** -0.5)
        return float(self.d_head ** -0.5)

    def layer_windows(self) -> list[int]:
        """Per-layer local window (0 = global).  gemma2 alternates
        local(window), global, local, ..."""
        if not self.local_global:
            return [0] * self.n_layers
        return [self.window if i % 2 == 0 else 0 for i in range(self.n_layers)]

    def param_count(self) -> int:
        c = self
        d = c.d_model
        if c.mla:
            attn = (d * c.q_lora + c.q_lora * c.n_heads * (c.qk_nope + c.qk_rope)
                    + d * (c.kv_lora + c.qk_rope)
                    + c.kv_lora * c.n_heads * (c.qk_nope + c.v_head)
                    + c.n_heads * c.v_head * d)
        else:
            attn = d * c.n_heads * c.d_head + 2 * d * c.n_kv_heads * c.d_head \
                + c.n_heads * c.d_head * d
        dense_ffn = 3 * d * c.d_ff
        if c.moe:
            moe_ffn = c.n_experts * 3 * d * c.moe_d_ff + d * c.n_experts
            if c.n_shared_experts:
                moe_ffn += 3 * d * c.moe_d_ff * c.n_shared_experts
            n_moe = c.n_layers - c.first_dense_layers
            ffn_total = n_moe * moe_ffn + c.first_dense_layers * dense_ffn
        else:
            ffn_total = c.n_layers * dense_ffn
        total = c.n_layers * (attn + 2 * d) + ffn_total + c.vocab * d
        if not c.tie_embeddings:
            total += c.vocab * d
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        c = self
        n_moe = c.n_layers - c.first_dense_layers
        return (self.param_count() - n_moe * c.n_experts * 3 * c.d_model * c.moe_d_ff
                + n_moe * c.top_k * 3 * c.d_model * c.moe_d_ff)


def check_supported(cfg: TransformerConfig) -> None:
    """Raises for what the port does not serve: MLA with
    ``attn_impl="pallas"``.  The reference fails there too (its flash kernel
    takes one head dim for q, k and v; MLA's are qk_nope + qk_rope and
    v_head): ``ROADMAP.md``, queue 3."""
    if cfg.mla and cfg.attn_impl == "pallas":
        raise NotImplementedError(
            f"{cfg.name}: MLA runs on attn_impl='chunked' only; with attn_impl='pallas' the "
            "reference cannot run it either (ROADMAP.md, queue 3)")


def check_trainable(cfg: TransformerConfig) -> None:
    """:func:`check_supported`, and training needs ``attn_impl="chunked"``:
    the flash kernel has no backward, and the reference cannot train
    through its ``flash_attention`` either (no transpose rule or
    ``custom_vjp``): ``ROADMAP.md``, queue 3.  Serving keeps the kernel."""
    check_supported(cfg)
    if cfg.attn_impl == "pallas":
        raise NotImplementedError(
            f"{cfg.name}: training runs on attn_impl='chunked' only; the flash kernel has no "
            "backward, and the reference cannot train through it either (ROADMAP.md, queue 3)")


def _attn_shapes(cfg: TransformerConfig, n: int) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla:
        return {"wq_a": (n, d, cfg.q_lora), "q_norm": (n, cfg.q_lora),
                "wq_b": (n, cfg.q_lora, H * (cfg.qk_nope + cfg.qk_rope)),
                "wkv_a": (n, d, cfg.kv_lora + cfg.qk_rope), "kv_norm": (n, cfg.kv_lora),
                "wkv_b": (n, cfg.kv_lora, H * (cfg.qk_nope + cfg.v_head)),
                "wo": (n, H * cfg.v_head, d)}
    Hkv, dh = cfg.n_kv_heads, cfg.d_head
    return {"wq": (n, d, H * dh), "wk": (n, d, Hkv * dh), "wv": (n, d, Hkv * dh),
            "wo": (n, H * dh, d)}


def _stack_shapes(cfg: TransformerConfig, n: int, moe_layer: bool) -> dict:
    d = cfg.d_model
    stack = {"ln1": (n, d), "ln2": (n, d), "attn": _attn_shapes(cfg, n)}
    if moe_layer:
        E, f = cfg.n_experts, cfg.moe_d_ff
        stack["moe"] = {"router": (n, d, E), "wg": (n, E, d, f), "wu": (n, E, d, f),
                        "wd": (n, E, f, d)}
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            stack["moe"]["shared"] = {"wg": (n, d, fs), "wu": (n, d, fs), "wd": (n, fs, d)}
    else:
        stack["mlp"] = {"wg": (n, d, cfg.d_ff), "wu": (n, d, cfg.d_ff), "wd": (n, cfg.d_ff, d)}
    return stack


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree's leaf shapes, stacked over the layers: the
    ``first_dense_layers`` in ``dense_layers``, the rest in ``layers``."""
    check_supported(cfg)
    n_pre = cfg.first_dense_layers
    shapes = {"embed": (cfg.vocab, cfg.d_model),
              "layers": _stack_shapes(cfg, cfg.n_layers - n_pre, cfg.moe),
              "final_norm": (cfg.d_model,)}
    if n_pre:
        shapes["dense_layers"] = _stack_shapes(cfg, n_pre, False)
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.d_model, cfg.vocab)
    return shapes


def cache_shapes(cfg: TransformerConfig, B: int, L: int) -> dict:
    """The serving cache's shapes, layers in the cache's order (the
    dense_layers first): GQA {'k', 'v'} [n_layers, B, Hkv, L, dh]; MLA the
    latent {'c_kv' [n_layers, B, L, kv_lora], 'k_rope' [n_layers, B, L,
    qk_rope]}."""
    n = cfg.n_layers
    if cfg.mla:
        return {"c_kv": (n, B, L, cfg.kv_lora), "k_rope": (n, B, L, cfg.qk_rope)}
    shape = (n, B, cfg.n_kv_heads, L, cfg.d_head)
    return {"k": shape, "v": shape}


def init_params(cfg: TransformerConfig, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.bfloat16, leaf=None, cut=None) -> dict:
    """The reference's distributions: each projection ~ N(0, 1/s) with s
    its per-layer leaf's first dim (its fan-in; an expert stack's expert
    count, as the reference draws it), the embedding (and unembedding) ~
    N(0, 0.02²), the norms' weights 0; drawn in fp32 one matrix at a time
    and stored in ``dtype`` (bf16, as the serving step holds them; fp32 for
    a training state), each finished leaf mapped by ``leaf`` where given
    (``init_lm_state`` splits it there, one leaf at a time).  With ``cut``,
    each drawn leaf is first replaced by ``cut(t, keys)`` (``keys`` its path
    in the tree): a rank's block of it, so that a mesh's rank never holds
    more than one whole leaf.  ``generator`` must live on ``device``; the
    numbers differ from the reference's (``jax.random`` is not ported)."""
    dev = resolve_device(device)
    leaf = leaf or (lambda t: t)
    cut = cut or (lambda t, keys: t)

    def normal(shape, scale, keys):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in (out.flatten(0, -3) if len(shape) >= 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator, device=dev) * scale)
        return leaf(cut(out, keys))

    def zeros(shape, keys):
        return leaf(cut(torch.zeros(shape, dtype=dtype, device=dev), keys))

    def draw(tree, keys):   # a stack: every leaf of rank 2 is a norm ([n, width])
        return {k: draw(s, keys + (k,)) if isinstance(s, dict) else
                normal(s, s[1] ** -0.5, keys + (k,)) if len(s) >= 3 else zeros(s, keys + (k,))
                for k, s in tree.items()}

    shapes = param_shapes(cfg)
    params = {"embed": normal(shapes["embed"], 0.02, ("embed",)),
              "layers": draw(shapes["layers"], ("layers",))}
    if "dense_layers" in shapes:
        params["dense_layers"] = draw(shapes["dense_layers"], ("dense_layers",))
    params["final_norm"] = zeros(shapes["final_norm"], ("final_norm",))
    if "unembed" in shapes:
        params["unembed"] = normal(shapes["unembed"], 0.02, ("unembed",))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def swiglu(x, wg, wu, wd):
    """bf16 outputs of each product (fp32 accumulation inside), the SiLU in
    fp32."""
    g = x @ wg
    u = x @ wu
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return (h @ wd).to(x.dtype)


def moe_route(x, router, cfg: TransformerConfig):
    """The router of :func:`moe_block`, per sequence: x [B, L, d] ->
    ``(gate [B, L, k] fp32, eidx [B, L, k], slot [B, L*k], keep [B, L*k],
    dest [B, L*k], C)``.  fp32 router logits and softmax; the top k with
    ``jax.lax.top_k``'s order (the lower expert first among ties); gates
    over their sum, floored at 1e-9; the capacity C = min(max(8, ceil(L k
    cf / E)), L k); each (token, rank) pair's slot is the count of earlier
    pairs, token-major then rank, that chose its expert; a pair at or past C
    is dropped (``keep`` False, ``dest`` E*C), a kept one goes to ``dest`` =
    expert * C + slot."""
    B, L, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = min(max(8, int(np.ceil(L * k * cfg.capacity_factor / E))), L * k)
    probs = _softmax(x.float() @ router.float())
    gate, eidx = topk_stable(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    ef = eidx.reshape(B, L * k)
    oh = torch.zeros((B, L * k, E), dtype=torch.int32, device=x.device).scatter_(2, ef[..., None], 1)
    slot = (oh.cumsum(1, dtype=torch.int32) - oh).gather(2, ef[..., None])[..., 0].long()
    keep = slot < C
    dest = torch.where(keep, ef * C + slot, E * C)
    return gate, eidx, slot, keep, dest, C


def _expert_ffn(buf, wg, wu, wd):
    """The reference's one-device expert FFN: three batched products over
    the experts, buf [E, N, d] -> [E, N, d] (bf16 outputs, the SiLU in
    fp32)."""
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, wd).to(buf.dtype)


def moe_slots(dest, L: int, k: int, E: int, C: int) -> tuple:
    """The gathers' indices of :func:`moe_block` from the router's ``dest``
    [B, L*k] (:func:`moe_route`): ``rows`` [E, B*C], the token row of
    ``x.view(B*L, d)`` each slot reads; ``filled`` [E, B*C], the slots a
    kept pair holds; ``at`` [B, L*k], the row of the flat expert-major
    output [E*B*C, d] each pair reads (clamped where it dropped); ``src_row``
    [E, B*C], the row of the pairs' [B*L*k, d] each slot's cotangent comes
    from (clamped where empty)."""
    B, Lk = dest.shape
    dev = dest.device
    # each slot's pair id (the dropped pairs scatter into a spare slot, cut off)
    src_pair = torch.full((B, E * C + 1), Lk, dtype=torch.int64, device=dev)
    src_pair.scatter_(1, dest, torch.arange(Lk, device=dev).expand(B, Lk))
    src_pair = src_pair[:, :E * C].reshape(B, E, C).transpose(0, 1).reshape(E, B * C)
    seq = torch.arange(B, device=dev).repeat_interleave(C)[None, :]       # [1, B*C]
    rows = seq * L + (src_pair // k).clamp_max(L - 1)
    # pair (b, i) reads row (e * B + b) * C + c of the expert-major output
    at = ((dest // C * B + torch.arange(B, device=dev)[:, None]) * C
          + dest % C).clamp_max(E * B * C - 1)
    return rows, src_pair < Lk, at, seq * Lk + src_pair.clamp_max(Lk - 1)


class _Dispatch(torch.autograd.Function):
    """The MoE dispatch as a gather, with the reference's gather backward
    (its ``_moe_dispatch`` custom_vjp).  Forward: x [B, L, d] -> buf [E,
    B*C, d], slot ``s`` of expert ``e`` reading row ``rows[e, s]`` of
    ``x.view(B*L, d)`` where ``filled``, else zeros.  Backward: each (token,
    rank) pair gathers its slot's cotangent (row ``at`` of the flat buffer;
    zero where the pair dropped), summed over the k ranks in ``[B, L, k,
    d]`` order: no scatter, so the sum's order is fixed on the card too."""

    @staticmethod
    def forward(ctx, x, rows, filled, at, keep, k: int):
        B, L, d = x.shape
        ctx.save_for_backward(at, keep)
        ctx.k = k
        return torch.where(filled[..., None], x.reshape(B * L, d)[rows], 0)

    @staticmethod
    def backward(ctx, d_buf):
        at, keep = ctx.saved_tensors
        B, Lk = keep.shape
        d = d_buf.shape[-1]
        dp = torch.where(keep[..., None], d_buf.reshape(-1, d)[at], 0)
        return dp.view(B, Lk // ctx.k, ctx.k, d).sum(dim=2).to(d_buf.dtype), *[None] * 5


class _Combine(torch.autograd.Function):
    """The MoE combine as a gather, with the reference's gather backward
    (its ``_moe_combine`` custom_vjp).  Forward: out [E, B*C, d] -> per-pair
    rows [B, L*k, d], pair ``(b, i)`` reading row ``at[b, i]`` of the flat
    output where ``keep``, else zeros.  Backward: each slot gathers its
    pair's cotangent (row ``src_row`` of ``d_y.view(B*L*k, d)``; zero where
    the slot is empty)."""

    @staticmethod
    def forward(ctx, out, at, keep, src_row, filled):
        ctx.save_for_backward(src_row, filled)
        d = out.shape[-1]
        return torch.where(keep[..., None], out.reshape(-1, d)[at], 0)

    @staticmethod
    def backward(ctx, d_y):
        src_row, filled = ctx.saved_tensors
        d = d_y.shape[-1]
        return torch.where(filled[..., None], d_y.reshape(-1, d)[src_row], 0), *[None] * 4


def moe_block(x, p, cfg: TransformerConfig):
    """The reference's per-sequence grouped top-k dispatch: x [B, L, d] ->
    [B, L, d].  :func:`moe_route` places each kept pair in its expert's
    slots; a scatter of pair ids, then a gather of their tokens' features
    (:class:`_Dispatch`), fills the [E, B*C, d] buffer (the reference's [B,
    E*C, d], expert-major so that each expert's products are one batch
    entry; empty slots are zeros); the expert FFN; each kept pair gathers
    its slot's row (:class:`_Combine`), times its gate in the activation
    dtype, summed over the k ranks; then the shared experts through
    :func:`swiglu`.  Under autograd the gradients reach the router through
    the gates, as the reference's do; a dropped pair's are zero."""
    B, L, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    gate, _, _, keep, dest, C = moe_route(x, p["router"], cfg)
    rows, filled, at, src_row = moe_slots(dest, L, k, E, C)
    buf = _Dispatch.apply(x, rows, filled, at, keep, k)
    out = _expert_ffn(buf, p["wg"], p["wu"], p["wd"])
    y_pair = _Combine.apply(out, at, keep, src_row, filled)
    Lk = L * k
    y_pair = y_pair * (keep * gate.reshape(B, Lk)).to(y_pair.dtype)[..., None]
    y = y_pair.view(B, L, k, d).sum(dim=2).to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        y = y + swiglu(x, sh["wg"], sh["wu"], sh["wd"])
    return y


def _gqa_qkv(x, ap, cfg: TransformerConfig, positions):
    B, L, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ ap["wq"]).reshape(B, L, H, dh).transpose(1, 2)
    kk = (x @ ap["wk"]).reshape(B, L, Hkv, dh).transpose(1, 2)
    vv = (x @ ap["wv"]).reshape(B, L, Hkv, dh).transpose(1, 2)
    q = rope(q, positions[None, None, :], cfg.rope_theta)
    kk = rope(kk, positions[None, None, :], cfg.rope_theta)
    return q.contiguous(), kk.contiguous(), vv.contiguous()


def _mla_qkv(x, ap, cfg: TransformerConfig, positions):
    """MLA's decompression path (prefill): q, k [B, H, L, qk_nope + qk_rope],
    v [B, H, L, v_head] and the latent cache entry (c_kv [B, L, kv_lora],
    k_rope [B, L, qk_rope], after RoPE)."""
    B, L, _ = x.shape
    H, nope, rd = cfg.n_heads, cfg.qk_nope, cfg.qk_rope
    cq = rms_norm(x @ ap["wq_a"], ap["q_norm"], cfg.norm_eps)
    q_nope, q_rope = (cq @ ap["wq_b"]).reshape(B, L, H, nope + rd).split([nope, rd], dim=-1)
    c_kv, k_rope = (x @ ap["wkv_a"]).split([cfg.kv_lora, rd], dim=-1)
    c_kv = rms_norm(c_kv, ap["kv_norm"], cfg.norm_eps)
    k_nope, v = (c_kv @ ap["wkv_b"]).reshape(B, L, H, nope + cfg.v_head).split([nope, cfg.v_head],
                                                                               dim=-1)
    q_rope = rope(q_rope.transpose(1, 2), positions[None, None, :], cfg.rope_theta)
    k_rope = rope(k_rope, positions[None, :], cfg.rope_theta)
    q = torch.cat([q_nope.transpose(1, 2), q_rope], dim=-1)
    k = torch.cat([k_nope.transpose(1, 2), k_rope[:, None].expand(B, H, L, rd)], dim=-1)
    return q, k, v.transpose(1, 2).contiguous(), (c_kv, k_rope)


def attn_block(x, ap, cfg: TransformerConfig, positions, window: int):
    """Returns the block's output and its cache entry: (k, v) [B, Hkv, L,
    dh], or MLA's (c_kv, k_rope)."""
    B, L, _ = x.shape
    if cfg.mla:
        q, k, v, entry = _mla_qkv(x, ap, cfg, positions)
    else:
        q, k, v = _gqa_qkv(x, ap, cfg, positions)
        entry = (k, v)
    o = attention(q, k, v, causal=True, softcap=cfg.attn_softcap, window=window,
                  scale=cfg.attn_scale, impl=cfg.attn_impl, bq=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(B, L, cfg.n_heads * v.shape[-1])
    return (o @ ap["wo"]).to(x.dtype), entry


def _layer(lp: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked parameter tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in lp.items()}


def layer_fwd(x, lp, cfg: TransformerConfig, positions, window: int, moe_layer: bool):
    h, cache = attn_block(rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg, positions,
                          window)
    x = x + h
    z = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if moe_layer:
        return x + moe_block(z, lp["moe"], cfg), cache
    return x + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"]), cache


def _layer_plan(cfg: TransformerConfig) -> list:
    """Every layer in the cache's order, the dense_layers first, as (stack,
    index in it, MoE layer, prefill window, decode window): the reference's
    prefill gives the dense stack no window and gemma2's main stack (local,
    global) pairs; its decode reads ``layer_windows()`` by cache index."""
    n_pre = cfg.first_dense_layers
    win = cfg.layer_windows()
    plan = [("dense_layers", i, False, 0, win[i]) for i in range(n_pre)]
    return plan + [("layers", j, cfg.moe, win[j], win[n_pre + j])
                   for j in range(cfg.n_layers - n_pre)]


def _cache_keys(cfg: TransformerConfig) -> tuple:
    return ("c_kv", "k_rope") if cfg.mla else ("k", "v")


def _embed(params, tokens, cfg: TransformerConfig):
    x = params["embed"][tokens.long()].to(torch.bfloat16)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=torch.bfloat16, device=x.device)
    return x


def _unembed(params, x, cfg: TransformerConfig):
    """fp32 logits: the products of bf16 operands summed in fp32, not
    rounded to bf16."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x.float() @ w.to(x.dtype).float()
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Training: the loss
# ---------------------------------------------------------------------------

class _LayerStack(torch.autograd.Function):
    """The layers of one stacked parameter tree, a group at a time (one
    layer, or gemma2's (local, global) pair), rematerialised in backward as
    the reference's ``jax.checkpoint`` of its scan body: forward keeps each
    group's input alone; backward reruns the group on it with autograd on,
    takes its gradients and writes each layer's into its slice of one
    gradient a stacked leaf, so that every slice is written once (autograd
    of ``leaf[i]`` would add a zero-padded gradient of the whole stack, a
    layer at a time).  ``run(h, lp, j)`` applies layer ``j`` with ``lp`` its
    parameter slices; ``tree`` is the stack's structure for ``leaves``."""

    @staticmethod
    def forward(ctx, x, run, tree, groups, *leaves):
        ctx.run, ctx.tree, ctx.groups = run, tree, groups
        ctx.inputs = []
        for grp in groups:
            ctx.inputs.append(x)
            for j in grp:
                x = run(x, tree_unflatten(tree, [leaf[j] for leaf in leaves]), j)
        ctx.save_for_backward(*leaves)
        return x

    @staticmethod
    def backward(ctx, dy):
        leaves = ctx.saved_tensors
        grads = [torch.empty_like(leaf) for leaf in leaves]
        for grp, x in zip(reversed(ctx.groups), reversed(ctx.inputs)):
            h = x.detach().requires_grad_()
            slices = [[leaf[j].detach().requires_grad_() for leaf in leaves] for j in grp]
            with torch.enable_grad():
                out = h
                for j, sl in zip(grp, slices):
                    out = ctx.run(out, tree_unflatten(ctx.tree, sl), j)
            got = torch.autograd.grad(out, [h] + [t for sl in slices for t in sl], dy,
                                      allow_unused=True)
            dy, got = got[0], got[1:]
            for n, j in enumerate(grp):
                for g, t, buf in zip(got[n * len(leaves):], slices[n], grads):
                    if g is None:
                        buf[j].zero_()
                    else:
                        buf[j].copy_(g)
        ctx.inputs = None
        return (dy, None, None, None, *grads)


def _train_layers(x, params, cfg: TransformerConfig, positions):
    """The layer stacks of :func:`lm_loss`: the dense_layers (no window),
    then the main stack, in groups of one layer or, for gemma2, of a (local,
    global) pair, as the reference's ``_scan_layers`` scans them."""
    plan = _layer_plan(cfg)
    for stack in ("dense_layers", "layers"):
        if stack not in params:
            continue
        rows = {j: (moe_layer, window) for st, j, moe_layer, window, _ in plan if st == stack}
        per = 2 if cfg.local_global and stack == "layers" else 1
        groups = [list(range(i, min(i + per, len(rows)))) for i in range(0, len(rows), per)]

        def run(h, lp, j, rows=rows):
            moe_layer, window = rows[j]
            return layer_fwd(h, lp, cfg, positions, window, moe_layer)[0]

        x = _LayerStack.apply(x, run, params[stack], groups, *tree_leaves(params[stack]))
    return x


def _ce_sum(params, x, labels, cfg: TransformerConfig):
    """The summed cross-entropy of one token chunk: fp32 logits (soft-capped
    for gemma2), their log-sum-exp less the label's logit."""
    logits = _unembed(params, x, cfg)
    lab = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - lab).sum()


def _chunked_ce(params, x, labels, cfg: TransformerConfig):
    """The cross-entropy summed over token chunks of ``c`` (the largest
    divisor of L not above ``cfg.loss_chunk``), each chunk's [B, c, V]
    logits rematerialised in backward (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint`` of its scan body), so the full [B, L, V]
    is never held; the chunks' sums added in order in fp32."""
    B, L, _ = x.shape
    c = min(cfg.loss_chunk, L)
    while L % c:
        c -= 1
    if c == L:
        return _ce_sum(params, x, labels, cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for i in range(0, L, c):
        args = (params, x[:, i:i + c], labels[:, i:i + c], cfg)
        total = total + (torch.utils.checkpoint.checkpoint(_ce_sum, *args, use_reentrant=False)
                         if remat else _ce_sum(*args))
    return total


def lm_loss(params, tokens, labels, cfg: TransformerConfig):
    """The causal LM cross-entropy, the mean over the B·L tokens (fp32 0-d);
    ``params`` the bf16 tree, tokens and labels [B, L] int.  Gradients to
    ``params`` by autograd: every layer rematerialised (:class:`_LayerStack`),
    each attention q chunk and each loss chunk too."""
    check_trainable(cfg)
    B, L = tokens.shape
    x = _embed(params, tokens, cfg)
    x = _train_layers(x, params, cfg, torch.arange(L, device=x.device))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _chunked_ce(params, x, labels, cfg) / (B * L)


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------

def prefill(params, tokens, cfg: TransformerConfig, out: dict | None = None):
    """Last-token logits [B, V] fp32 and the cache (:func:`cache_shapes`)
    of tokens [B, L]; with ``out``, the cache is written into its tensors
    (views allowed) and returned."""
    check_supported(cfg)
    B, L = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(L, device=x.device)
    cache = out if out is not None else {
        k: torch.empty(s, dtype=x.dtype, device=x.device) for k, s in cache_shapes(cfg, B, L).items()}
    for i, (stack, j, moe_layer, window, _) in enumerate(_layer_plan(cfg)):
        x, entry = layer_fwd(x, _layer(params[stack], j), cfg, positions, window, moe_layer)
        for key, t in zip(_cache_keys(cfg), entry):
            cache[key][i] = t
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x[:, -1:], cfg)[:, 0], cache


def _mla_decode_attn(z, ap, cfg: TransformerConfig, c_kv, k_rope, pos):
    """The absorbed MLA decode, in fp32 as the reference writes it: the
    scores in the latent space, no K/V decompressed.  z [B, 1, d] normed;
    caches [B, Lmax, kv_lora] / [B, Lmax, qk_rope]; pos [B]."""
    B = z.shape[0]
    H, nope = cfg.n_heads, cfg.qk_nope
    cq = rms_norm(z @ ap["wq_a"], ap["q_norm"], cfg.norm_eps)
    q_nope, q_rope = (cq @ ap["wq_b"]).reshape(B, H, nope + cfg.qk_rope).split(
        [nope, cfg.qk_rope], dim=-1)
    q_rope = rope(q_rope[:, :, None, :], pos[:, None, None], cfg.rope_theta)[:, :, 0]
    wkv_b = ap["wkv_b"].reshape(cfg.kv_lora, H, nope + cfg.v_head).float()
    wk, wv = wkv_b[:, :, :nope], wkv_b[:, :, nope:]
    q_eff = torch.einsum("bhn,lhn->bhl", q_nope.float(), wk)          # absorbed
    ckv = c_kv.float()
    s = torch.einsum("bhl,btl->bht", q_eff, ckv)
    s = s + torch.einsum("bhr,btr->bht", q_rope.float(), k_rope.float())
    s = s * cfg.attn_scale
    valid = torch.arange(c_kv.shape[1], device=z.device)[None, None, :] < pos[:, None, None] + 1
    p = _softmax(torch.where(valid, s, -torch.inf))
    ctx = torch.einsum("bht,btl->bhl", p, ckv)
    o = torch.einsum("bhl,lhv->bhv", ctx, wv).reshape(B, 1, H * cfg.v_head).to(z.dtype)
    return (o @ ap["wo"]).to(z.dtype)


def _decode_attn(z, ap, cache: dict, cfg: TransformerConfig, pos, window: int):
    """One decode layer's attention block: z [B, 1, d] normed -> [B, 1,
    d]; writes this token's cache entry into the layer's cache slices at
    each row's ``pos``, in place."""
    B = z.shape[0]
    rows = torch.arange(B, device=z.device)
    if cfg.mla:
        c_new, kr_new = (z @ ap["wkv_a"]).split([cfg.kv_lora, cfg.qk_rope], dim=-1)
        c_new = rms_norm(c_new, ap["kv_norm"], cfg.norm_eps)
        kr_new = rope(kr_new, pos[:, None], cfg.rope_theta)
        cache["c_kv"][rows, pos] = c_new[:, 0]
        cache["k_rope"][rows, pos] = kr_new[:, 0]
        return _mla_decode_attn(z, ap, cfg, cache["c_kv"], cache["k_rope"], pos)
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (z @ ap["wq"]).reshape(B, 1, H, dh).transpose(1, 2)
    kk = (z @ ap["wk"]).reshape(B, 1, Hkv, dh).transpose(1, 2)
    vv = (z @ ap["wv"]).reshape(B, 1, Hkv, dh).transpose(1, 2)
    q = rope(q, pos[:, None, None], cfg.rope_theta)
    kk = rope(kk, pos[:, None, None], cfg.rope_theta)
    cache["k"][rows, :, pos] = kk[:, :, 0]
    cache["v"][rows, :, pos] = vv[:, :, 0]
    o = decode_attention(q, cache["k"], cache["v"], softcap=cfg.attn_softcap, window=window,
                         scale=cfg.attn_scale, kv_len=pos + 1)
    return (o.transpose(1, 2).reshape(B, 1, H * dh) @ ap["wo"]).to(z.dtype)


def _decode_layer(x, lp, cache: dict, cfg: TransformerConfig, pos, window: int, moe_layer: bool):
    """One decode layer (:func:`_decode_attn`, then the FFN or the MoE
    block)."""
    x = x + _decode_attn(rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cache, cfg, pos, window)
    z2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if moe_layer:
        return x + moe_block(z2, lp["moe"], cfg)
    return x + swiglu(z2, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def decode_step(params, cache, tokens, pos, cfg: TransformerConfig):
    """One serving decode step.  tokens [B] int; pos [B] int = the number of
    valid cache entries (where this token is written).  Returns (logits [B,
    V] fp32, cache); the cache is updated IN PLACE, where the reference
    donates it."""
    check_supported(cfg)
    pos = pos.long()
    x = _embed(params, tokens[:, None], cfg)                    # [B, 1, d]
    for i, (stack, j, moe_layer, _, w) in enumerate(_layer_plan(cfg)):
        # a global layer's window is 2^30: every cached key is in reach
        x = _decode_layer(x, _layer(params[stack], j), {k: c[i] for k, c in cache.items()}, cfg,
                          pos, w if w > 0 else 1 << 30, moe_layer)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# On a mesh: FSDP, Megatron TP and sequence parallelism, expert parallelism
# ---------------------------------------------------------------------------
#
# Each rank holds its block of every leaf (``dist.sharding.lm_param_specs``)
# and its rows of the batch.  GSPMD runs the reference's one-device function
# over the mesh; here the collectives are written out (``dist.comm``'s
# autograd forms), so each rank computes its share of that function, up to
# the order of sums:
#
# * FSDP: a leaf is all-gathered over its data axes just before use; the
#   gather's backward reduce-scatters its gradient onto the rank's block.
# * TP over ``model`` (``MeshPlan.tp``): the column-parallel products (wq, wk,
#   wv, wg, wu, MLA's wq_b and wkv_b, the unembedding) keep the rank's
#   columns, the row-parallel ones (wo, wd) its rows, whose partial sums are
#   reduced over ``model`` (``MeshPlan.leave``): a ``psum``, or with
#   ``seq_shard`` a reduce-scatter onto the rank's block of tokens, the
#   reference's Megatron-SP layout between blocks (``MeshPlan.enter``
#   all-gathers them before the next column-parallel pair).  Heads that do
#   not divide ``model`` are computed whole on every rank and the rank keeps
#   the block of ``o`` that wo's rows want; KV heads that do not divide are
#   computed whole and each local q head takes its GQA group's.  The
#   embedding is vocab-parallel (a masked lookup, then the reduce), the loss
#   a vocab-parallel log-softmax.
# * MoE: routing, dispatch and combine on the rank's rows with the router
#   replicated; with ``seq_shard`` the expert FFN is the reference's
#   ``shard_map`` (an all-to-all over the last data axis splits the experts,
#   the rank's f columns, fp32 partial sums reduced over ``model``, one bf16
#   rounding, the all-to-all back), else its one-device einsums over the
#   gathered weights.
#
# Gradients.  Every rank's loss is its share of the global loss (its rows'
# summed cross-entropy over the global token count, over the ranks that
# hold the same rows), and every collective's backward is its transpose:
# ``psum``'s a ``psum`` (the reference's ``shard_map(check_vma=False)``
# rule), a gather's a reduce-scatter, an all-to-all's the inverse one.  So
# a value that every rank of an axis holds alike carries a partial
# cotangent on each, whose sum over the axis is the true one, and the step
# (``models/lm_steps.py``) sums each leaf's gradient over the mesh axes its
# spec does not shard: the gradient of the global loss, with no factor.


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How one rank of ``mesh`` (a ``launch.mesh.Mesh``) runs ``cfg``: the
    parameter ``specs`` (``lm_param_specs``), the mesh axes the batch rows
    are cut over, whether the products are Megatron TP over ``model``
    (``tp``) and whether the tokens are sharded over ``model`` between
    blocks (``sp``)."""

    cfg: TransformerConfig
    mesh: object
    specs: dict
    batch_axes: tuple
    tp: bool
    sp: bool

    @property
    def model(self):
        return self.mesh.group(("model",))

    @property
    def tp_size(self) -> int:
        return self.mesh.shape["model"] if self.tp else 1

    @property
    def tp_index(self) -> int:
        return self.model.index if self.tp else 0

    @property
    def n_batch(self) -> int:
        """The ranks among which the batch rows are cut."""
        return int(np.prod([self.mesh.shape[a] for a in self.batch_axes]))

    @property
    def n_rep(self) -> int:
        """The ranks that hold the same rows."""
        return self.mesh.size // self.n_batch

    def group(self, axes):
        return self.mesh.group(tuple(a for a in self.mesh.axis_names if a in axes))

    def w(self, t, spec, keep: tuple = ()):
        """Leaf (or layer slice) ``t`` under ``spec``, all-gathered over
        every sharded dim but those sharded over exactly one of ``keep``'s
        axes (``dist.comm.all_gather_ad``: its gradient reduce-scattered
        back onto the block)."""
        from repro_torch.dist import comm
        from repro_torch.dist.sharding import axis_size, spec_axes
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if not axes or axis_size(entry, self.mesh.shape) == 1 or (
                    len(axes) == 1 and axes[0] in keep):
                continue
            t = comm.all_gather_ad(t.movedim(dim, 0), self.group(axes)).movedim(0, dim)
        return t

    @property
    def cols(self) -> tuple:
        """The ``keep`` of a TP product: the rank's columns (rows) stay."""
        return ("model",) if self.tp else ()

    def enter(self, x):
        """Before a column-parallel pair: the whole sequence (sequence
        parallel: all-gathered over ``model``; x [B, L, d])."""
        if not self.sp:
            return x
        from repro_torch.dist import comm
        return comm.all_gather_ad(x.movedim(1, 0), self.model).movedim(0, 1)

    def leave(self, y, dtype=torch.bfloat16):
        """After a row-parallel product: its fp32 partial sums ``y`` reduced
        over ``model`` (sequence parallel: reduce-scattered onto the rank's
        tokens), then rounded to ``dtype`` once, as the one-device product
        rounds its fp32 sum."""
        from repro_torch.dist import comm
        if self.sp:
            y = comm.psum_scatter_ad(y.movedim(1, 0), self.model).movedim(0, 1)
        elif self.tp:
            y = comm.psum_ad(y, self.model)
        return y.to(dtype)

    def row(self, x, w):
        """A row-parallel product ``x @ w`` of bf16 operands, reduced by
        :meth:`leave`: the rank's partial sums kept in fp32 (the whole
        product, rounded once, where there is no TP)."""
        if not self.tp:
            return (x @ w).to(x.dtype)
        return self.leave(x.float() @ w.float(), x.dtype)

    def own_tokens(self, y):
        """The rank's block of tokens of a whole-sequence value (sequence
        parallel), else ``y``."""
        if not self.sp:
            return y
        n = y.shape[1] // self.tp_size
        return y[:, self.tp_index * n:(self.tp_index + 1) * n]


def mesh_plan(cfg: TransformerConfig, mesh, batch_axes) -> MeshPlan:
    """The :class:`MeshPlan` of ``cfg`` on ``mesh`` with the batch rows cut
    over ``batch_axes``: TP where ``cfg.tp_size`` > 1 and the mesh's
    ``model`` axis has more than one rank (the two must then agree), sequence
    parallel where TP and ``cfg.seq_shard``."""
    from repro_torch.dist import sharding as shd
    tp_mesh = mesh.shape.get("model", 1)
    tp = cfg.tp_size > 1 and tp_mesh > 1
    if tp and cfg.tp_size != tp_mesh:
        raise ValueError(f"{cfg.name}: tp_size {cfg.tp_size}, the mesh's model axis {tp_mesh}")
    batch_axes = tuple(batch_axes)
    if tp and "model" in batch_axes:
        raise ValueError(f"{cfg.name}: the batch cannot be cut over 'model' with TP on it")
    if cfg.moe and cfg.seq_shard and cfg.dp_axes[-1] != "data":
        raise ValueError(f"{cfg.name}: expert parallelism runs over 'data' (the experts' spec), "
                         f"not {cfg.dp_axes[-1]!r}")
    return MeshPlan(cfg, mesh, shd.lm_config_specs(cfg), batch_axes, tp, tp and cfg.seq_shard)


def _layer_specs(tree: dict) -> dict:
    """A stack's spec tree with the stack dim dropped: a layer slice's."""
    return {k: _layer_specs(v) if isinstance(v, dict) else tuple(v[1:]) for k, v in tree.items()}


def _heads(par: MeshPlan, n: int) -> tuple:
    """``(local, count, first)``: whether ``n`` heads divide over ``model``
    (TP), and the rank's count of them and its first one."""
    if par.tp and n % par.tp_size == 0:
        c = n // par.tp_size
        return True, c, par.tp_index * c
    return False, n, 0


def _o_block(par: MeshPlan, o):
    """The columns of o [B, L, H * Dv] that the rank's rows of wo take (TP
    with all heads computed)."""
    if not par.tp:
        return o
    n = o.shape[-1]
    if n % par.tp_size:
        raise ValueError(f"wo: {n} rows do not divide over model ({par.tp_size} ranks)")
    c = n // par.tp_size
    return o[..., par.tp_index * c:(par.tp_index + 1) * c]


def mesh_swiglu(par: MeshPlan, x, p, s):
    """:func:`swiglu` with wg / wu column- and wd row-parallel, reduced by
    :meth:`MeshPlan.leave`; ``x`` as :meth:`MeshPlan.enter` gives it."""
    wg, wu, wd = (par.w(p[k], s[k], par.cols) for k in ("wg", "wu", "wd"))
    g = x @ wg
    u = x @ wu
    return par.row(torch.nn.functional.silu(g.float()).to(x.dtype) * u, wd)


def _mesh_gqa_qkv(par: MeshPlan, x, ap, s, positions):
    """q [B, Hq, L, dh] for the rank's q heads (all where they do not
    divide), k / v for each of those heads' KV heads, and the cache entry:
    (k, v) of the rank's KV heads, or of all of them, with the flag
    ``kv_local``."""
    cfg = par.cfg
    B, L, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q_local, Hq, q0 = _heads(par, H)
    kv_local, Hk, _ = _heads(par, Hkv)
    kv_local = kv_local and q_local
    if not kv_local:
        Hk = Hkv
    wq = par.w(ap["wq"], s["wq"], par.cols if q_local else ())
    wk, wv = (par.w(ap[k], s[k], par.cols if kv_local else ()) for k in ("wk", "wv"))
    q = rope((x @ wq).reshape(B, L, Hq, dh).transpose(1, 2), positions[None, None, :],
             cfg.rope_theta)
    k = rope((x @ wk).reshape(B, L, Hk, dh).transpose(1, 2), positions[None, None, :],
             cfg.rope_theta).contiguous()
    v = (x @ wv).reshape(B, L, Hk, dh).transpose(1, 2).contiguous()
    entry = (k, v)
    if q_local and not kv_local:     # each local q head's GQA group
        idx = (q0 + torch.arange(Hq, device=x.device)) // (H // Hkv)
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    return q.contiguous(), k, v, entry, kv_local, q_local


def _mesh_mla_qkv(par: MeshPlan, x, ap, s, positions):
    """MLA's decompression on a mesh: wq_a and wkv_a gathered whole (q_norm,
    kv_norm and the RoPE split need the whole latent), wq_b and wkv_b on the
    rank's heads where they divide.  Returns q, k, v, the latent cache
    entry (whole) and whether the heads are local."""
    cfg = par.cfg
    B, L, _ = x.shape
    nope, rd = cfg.qk_nope, cfg.qk_rope
    local, Hq, _ = _heads(par, cfg.n_heads)
    keep = par.cols if local else ()
    cq = rms_norm(x @ par.w(ap["wq_a"], s["wq_a"]), ap["q_norm"], cfg.norm_eps)
    q_nope, q_rope = (cq @ par.w(ap["wq_b"], s["wq_b"], keep)).reshape(
        B, L, Hq, nope + rd).split([nope, rd], dim=-1)
    c_kv, k_rope = (x @ par.w(ap["wkv_a"], s["wkv_a"])).split([cfg.kv_lora, rd], dim=-1)
    c_kv = rms_norm(c_kv, ap["kv_norm"], cfg.norm_eps)
    k_nope, v = (c_kv @ par.w(ap["wkv_b"], s["wkv_b"], keep)).reshape(
        B, L, Hq, nope + cfg.v_head).split([nope, cfg.v_head], dim=-1)
    q_rope = rope(q_rope.transpose(1, 2), positions[None, None, :], cfg.rope_theta)
    k_rope = rope(k_rope, positions[None, :], cfg.rope_theta)
    q = torch.cat([q_nope.transpose(1, 2), q_rope], dim=-1)
    k = torch.cat([k_nope.transpose(1, 2), k_rope[:, None].expand(B, Hq, L, rd)], dim=-1)
    return q, k, v.transpose(1, 2).contiguous(), (c_kv, k_rope), local


def mesh_attn_block(par: MeshPlan, x, ap, s, positions, window: int):
    """:func:`attn_block` on a mesh; ``x`` the whole sequence of the rank's
    rows (:meth:`MeshPlan.enter`).  Returns the block's output (reduced by
    :meth:`MeshPlan.leave`) and the cache entry with whether it holds the
    rank's KV heads alone."""
    cfg = par.cfg
    B, L, _ = x.shape
    if cfg.mla:
        q, k, v, entry, local = _mesh_mla_qkv(par, x, ap, s, positions)
        kv_local = False
    else:
        q, k, v, entry, kv_local, local = _mesh_gqa_qkv(par, x, ap, s, positions)
    o = attention(q, k, v, causal=True, softcap=cfg.attn_softcap, window=window,
                  scale=cfg.attn_scale, impl=cfg.attn_impl, bq=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(B, L, q.shape[1] * v.shape[-1])
    if not local:
        o = _o_block(par, o)
    return par.row(o, par.w(ap["wo"], s["wo"], par.cols)), (entry, kv_local)


def _ep_ffn(par: MeshPlan, buf, p, s):
    """The reference's expert-parallel FFN (its ``_expert_ffn`` under
    ``seq_shard``): buf [E, N, d] -> all-to-all over the last data axis
    (split E, concatenate the rows) -> the rank's E / ep experts and f
    columns, the down projection's partial sums in fp32, reduced over
    ``model`` and rounded to bf16 once -> the all-to-all back."""
    from repro_torch.dist import comm
    ep = par.mesh.group((par.cfg.dp_axes[-1],))
    bx = comm.all_to_all_ad(buf, ep, 0, 1)
    wg, wu, wd = (par.w(p[k], s[k], ("data", "model")) for k in ("wg", "wu", "wd"))
    g = torch.bmm(bx, wg)
    u = torch.bmm(bx, wu)
    h = torch.nn.functional.silu(g.float()).to(bx.dtype) * u
    o = comm.psum_ad(torch.bmm(h.float(), wd.float()), par.model).to(bx.dtype)
    return comm.all_to_all_ad(o, ep, 1, 0)


def mesh_moe_block(par: MeshPlan, x, p, s):
    """:func:`moe_block` on a mesh; ``x`` the whole sequence of the rank's
    rows.  The routed output is the rank's tokens (sequence parallel) and
    the shared experts are :func:`mesh_swiglu`."""
    cfg = par.cfg
    B, L, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    gate, _, _, keep, dest, C = moe_route(x, p["router"], cfg)
    rows, filled, at, src_row = moe_slots(dest, L, k, E, C)
    buf = _Dispatch.apply(x, rows, filled, at, keep, k)
    if cfg.seq_shard:
        out = _ep_ffn(par, buf, p, s)
    else:
        out = _expert_ffn(buf, *(par.w(p[n], s[n]) for n in ("wg", "wu", "wd")))
    y_pair = _Combine.apply(out, at, keep, src_row, filled)
    y_pair = y_pair * (keep * gate.reshape(B, L * k)).to(y_pair.dtype)[..., None]
    y = par.own_tokens(y_pair.view(B, L, k, d).sum(dim=2).to(x.dtype))
    if "shared" in p:
        y = y + mesh_swiglu(par, x, p["shared"], s["shared"])
    return y


def mesh_layer_fwd(par: MeshPlan, x, lp, ls, positions, window: int, moe_layer: bool):
    """:func:`layer_fwd` on a mesh: ``x`` the rank's rows (and with
    sequence parallelism its tokens), ``ls`` the layer's spec tree."""
    h, entry = mesh_attn_block(par, par.enter(rms_norm(x, lp["ln1"], par.cfg.norm_eps)),
                               lp["attn"], ls["attn"], positions, window)
    x = x + h
    z = par.enter(rms_norm(x, lp["ln2"], par.cfg.norm_eps))
    if moe_layer:
        return x + mesh_moe_block(par, z, lp["moe"], ls["moe"]), entry
    return x + mesh_swiglu(par, z, lp["mlp"], ls["mlp"]), entry


def _mesh_embed(par: MeshPlan, params, tokens):
    """The vocab-parallel lookup: each rank's rows of the table, the other
    rows' lookups zeros, reduced over ``model`` (:meth:`MeshPlan.leave`)."""
    cfg = par.cfg
    w = par.w(params["embed"], par.specs["embed"], par.cols)
    ids = tokens.long()
    if par.tp:
        n = w.shape[0]
        ids = ids - par.tp_index * n
        inside = (ids >= 0) & (ids < n)
        x = par.leave(torch.where(inside[..., None], w[ids.clamp(0, n - 1)], 0).to(torch.bfloat16))
        # (each token's row is on one rank, the others' lookups zeros: the sum is exact)
    else:
        x = w[ids].to(torch.bfloat16)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=torch.bfloat16, device=x.device)
    return x


def _mesh_logits(par: MeshPlan, params, x):
    """fp32 logits of the rank's vocabulary columns (column-parallel
    unembedding; gemma2's soft-cap on each shard)."""
    cfg = par.cfg
    if cfg.tie_embeddings:
        w = par.w(params["embed"], par.specs["embed"], par.cols).T
    else:
        w = par.w(params["unembed"], par.specs["unembed"], par.cols)
    logits = x.float() @ w.to(x.dtype).float()
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _pmax(x, g):
    """The elementwise max of ``x`` over the group (no gradient)."""
    from repro_torch.dist import comm
    return comm.all_gather(x.detach()[None].contiguous(), g).amax(dim=0)


def _mesh_ce_sum(par: MeshPlan, params, x, labels):
    """:func:`_ce_sum` vocab-parallel: the max over ``model`` of the rank's
    maxima, the sum of exponentials and the label's logit (from the rank
    that holds it) each reduced over ``model``."""
    from repro_torch.dist import comm
    logits = _mesh_logits(par, params, x)
    if not par.tp:
        lab = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - lab).sum()
    n = logits.shape[-1]
    m = _pmax(logits.amax(dim=-1), par.model)
    se = comm.psum_ad(torch.exp(logits - m[..., None]).sum(dim=-1), par.model)
    ids = labels.long() - par.tp_index * n
    inside = (ids >= 0) & (ids < n)
    lab = torch.where(inside, logits.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0], 0.0)
    lab = comm.psum_ad(lab, par.model)
    return (torch.log(se) + m - lab).sum()


def _mesh_train_layers(par: MeshPlan, x, params, positions):
    """:func:`_train_layers` on a mesh (the same groups and remat)."""
    cfg = par.cfg
    plan = _layer_plan(cfg)
    for stack in ("dense_layers", "layers"):
        if stack not in params:
            continue
        rows = {j: (moe_layer, window) for st, j, moe_layer, window, _ in plan if st == stack}
        per = 2 if cfg.local_global and stack == "layers" else 1
        groups = [list(range(i, min(i + per, len(rows)))) for i in range(0, len(rows), per)]
        ls = _layer_specs(par.specs[stack])

        def run(h, lp, j, rows=rows, ls=ls):
            moe_layer, window = rows[j]
            return mesh_layer_fwd(par, h, lp, ls, positions, window, moe_layer)[0]

        x = _LayerStack.apply(x, run, params[stack], groups, *tree_leaves(params[stack]))
    return x


def mesh_lm_loss(par: MeshPlan, params, tokens, labels, n_tokens: int):
    """The rank's share of :func:`lm_loss` on a mesh (fp32 0-d): its rows'
    summed cross-entropy over ``n_tokens`` (the global batch's token count)
    and over the ranks that hold the same rows; summed over the mesh it is
    the reference's loss.  ``params`` the rank's blocks, tokens and labels
    its rows [b, L]."""
    cfg = par.cfg
    check_trainable(cfg)
    L = tokens.shape[1]
    x = _mesh_embed(par, params, tokens)
    x = _mesh_train_layers(par, x, params, torch.arange(L, device=x.device))
    x = par.enter(rms_norm(x, params["final_norm"], cfg.norm_eps))
    c = min(cfg.loss_chunk, L)
    while L % c:
        c -= 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled() and c < L
    for i in range(0, L, c):
        args = (par, params, x[:, i:i + c], labels[:, i:i + c])
        total = total + (torch.utils.checkpoint.checkpoint(_mesh_ce_sum, *args, use_reentrant=False)
                         if remat else _mesh_ce_sum(*args))
    return total / n_tokens / par.n_rep


def _last_token(par: MeshPlan, x):
    """The last token's row [B, 1, d] of the sequence (with sequence
    parallelism, on the last rank of ``model``: gathered)."""
    if not par.sp:
        return x[:, -1:]
    from repro_torch.dist import comm
    return comm.all_gather(x[:, -1:].transpose(0, 1).contiguous(), par.model)[-1:].transpose(0, 1)


def mesh_prefill(par: MeshPlan, params, tokens, cache_specs: dict, out: dict):
    """:func:`prefill` on a mesh: the rank's rows [b, L]; logits [b, V / tp]
    (the rank's vocabulary block, fp32) of the last token, and each layer's
    cache entry written into ``out`` (the rank's blocks under
    ``cache_specs``)."""
    from repro_torch.dist.sharding import local_block
    cfg = par.cfg
    L = tokens.shape[1]
    x = _mesh_embed(par, params, tokens)
    positions = torch.arange(L, device=x.device)
    specs = {st: _layer_specs(par.specs[st]) for st in ("dense_layers", "layers")
             if st in par.specs}
    for i, (stack, j, moe_layer, window, _) in enumerate(_layer_plan(cfg)):
        x, (entry, kv_local) = mesh_layer_fwd(par, x, _layer(params[stack], j), specs[stack],
                                              positions, window, moe_layer)
        for key, t in zip(_cache_keys(cfg), entry):
            out[key][i] = t if kv_local else local_block(t, (None,) + tuple(cache_specs[key][2:]),
                                                         par.mesh, key)
    x = rms_norm(_last_token(par, x), params["final_norm"], cfg.norm_eps)
    return _mesh_logits(par, params, x)[:, 0], out


# -------------------------- decode on a mesh --------------------------------

def _write(cache, new, pos, off: int, dim: int):
    """``cache[b, ..., pos[b] - off, ...] = new[b]`` along ``dim`` for each
    row whose position falls in this block of ``cache.shape[dim]``
    positions from ``off`` (the others keep their entry; no host sync)."""
    n = cache.shape[dim]
    rows = torch.arange(cache.shape[0], device=cache.device)
    p = pos - off
    mine = (p >= 0) & (p < n)
    p = p.clamp(0, n - 1)
    view = cache.movedim(dim, 1)                      # [B, n, ...]
    shape = (-1,) + (1,) * (new.dim() - 1)
    view[rows, p] = torch.where(mine.view(shape), new, view[rows, p])


def _flash_combine(s, v, g, out_dtype):
    """Softmax-attention over keys split across the ranks of ``g``: s [..., T]
    this rank's fp32 scores (masked -inf), v [..., T, Dv] its values.  The
    max over the group, the sum of exponentials reduced over it, ``p``
    rounded to v's dtype before each rank's PV product, the products
    reduced in fp32."""
    from repro_torch.dist import comm
    e = torch.exp(s - _pmax(s.amax(dim=-1, keepdim=True), g))
    p = e / _sum_at_least_tiny(e, g)
    return comm.psum(p.to(v.dtype).float() @ v.float(), g).to(out_dtype)


def _sum_at_least_tiny(e, g):
    """The sum of ``e`` over its last dim and the group, at least fp32's
    smallest normal: the rank that holds the max adds exp(0) = 1, so only a
    shape-only group (its other ranks' terms zeros) can sum to 0, where every
    ``e`` is 0 too."""
    from repro_torch.dist import comm
    return comm.psum(e.sum(dim=-1, keepdim=True), g).clamp_min(torch.finfo(torch.float32).tiny)


def _one_rank_none(spec, mesh) -> tuple:
    """``spec`` with each entry over axes of one rank in all made None."""
    from repro_torch.dist.sharding import axis_size
    return tuple(None if axis_size(e, mesh.shape) == 1 else e for e in spec)


def _mesh_decode_gqa(par: MeshPlan, z, ap, s, cache, spec, pos, window: int):
    """One decode layer's GQA attention on a mesh, by the cache's layout
    (``lm_steps.cache_specs``): KV heads over ``model`` (the rank's q and KV
    heads), the head dim over ``model`` (the scores' partial sums reduced),
    or the sequence over ``model`` or the whole mesh (the softmax combined
    across the ranks).  Writes this token's k / v into the rank's block."""
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import spec_axes
    cfg = par.cfg
    B = z.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    spec = _one_rank_none(spec, par.mesh)
    heads = spec[2] is not None
    keep = par.cols if heads else ()
    Hq, Hk = (H // par.tp_size, Hkv // par.tp_size) if heads else (H, Hkv)
    q = rope((z @ par.w(ap["wq"], s["wq"], keep)).reshape(B, 1, Hq, dh).transpose(1, 2),
             pos[:, None, None], cfg.rope_theta)
    k = rope((z @ par.w(ap["wk"], s["wk"], keep)).reshape(B, 1, Hk, dh).transpose(1, 2),
             pos[:, None, None], cfg.rope_theta)
    v = (z @ par.w(ap["wv"], s["wv"], keep)).reshape(B, 1, Hk, dh).transpose(1, 2)
    ck, cv = cache["k"], cache["v"]
    if spec[3] is None and spec[4] is None:
        _write(ck, k[:, :, 0], pos, 0, 2)
        _write(cv, v[:, :, 0], pos, 0, 2)
        o = decode_attention(q, ck, cv, softcap=cfg.attn_softcap, window=window,
                             scale=cfg.attn_scale, kv_len=pos + 1)
    else:
        rep = H // Hkv
        kpos = torch.arange(ck.shape[2], device=z.device)
        if spec[4] is not None:              # the head dim over 'model'
            n = ck.shape[3]
            blk = slice(par.tp_index * n, (par.tp_index + 1) * n)
            _write(ck, k[:, :, 0, blk], pos, 0, 2)
            _write(cv, v[:, :, 0, blk], pos, 0, 2)
            qg = q[..., blk].reshape(B, Hkv, rep, n)
            sc = comm.psum(qg.float() @ ck.float().transpose(-1, -2), par.model)
            g = None
        else:                                # the sequence over spec[3]'s axes
            g = par.group(spec_axes(spec[3]))
            off = g.index * ck.shape[2]
            kpos = kpos + off
            _write(ck, k[:, :, 0], pos, off, 2)
            _write(cv, v[:, :, 0], pos, off, 2)
            sc = q.reshape(B, Hkv, rep, dh).float() @ ck.float().transpose(-1, -2)
        sc = sc * cfg.attn_scale
        if cfg.attn_softcap > 0:
            sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
        valid = kpos[None, :] < (pos + 1)[:, None]
        if window > 0:
            valid &= kpos[None, :] > pos[:, None] - window
        sc = torch.where(valid[:, None, None, :], sc, -torch.inf)
        if g is None:
            o = (_softmax(sc).to(cv.dtype).float() @ cv.float()).to(cv.dtype)
            o = comm.all_gather(o.movedim(-1, 0).contiguous(), par.model).movedim(0, -1)
        else:
            o = _flash_combine(sc, cv, g, cv.dtype)
        o = o.reshape(B, H, 1, dh)
    o = o.transpose(1, 2).reshape(B, 1, Hq * dh)
    if not heads:
        o = _o_block(par, o)
    return par.row(o, par.w(ap["wo"], s["wo"], par.cols))


def _mesh_decode_mla(par: MeshPlan, z, ap, s, cache, specs, pos):
    """The absorbed MLA decode on a mesh (fp32, as :func:`_mla_decode_attn`),
    every head on every rank: the latent cache over ``model`` (each rank's
    latent block; the scores' and the context's partial sums reduced) or
    the sequence over the whole mesh (the softmax combined across it)."""
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import spec_axes
    cfg = par.cfg
    B = z.shape[0]
    H, nope, rd = cfg.n_heads, cfg.qk_nope, cfg.qk_rope
    c_new, kr_new = (z @ par.w(ap["wkv_a"], s["wkv_a"])).split([cfg.kv_lora, rd], dim=-1)
    c_new = rms_norm(c_new, ap["kv_norm"], cfg.norm_eps)[:, 0]
    kr_new = rope(kr_new, pos[:, None], cfg.rope_theta)[:, 0]
    cq = rms_norm(z @ par.w(ap["wq_a"], s["wq_a"]), ap["q_norm"], cfg.norm_eps)
    q_nope, q_rope = (cq @ par.w(ap["wq_b"], s["wq_b"])).reshape(B, H, nope + rd).split(
        [nope, rd], dim=-1)
    q_rope = rope(q_rope[:, :, None, :], pos[:, None, None], cfg.rope_theta)[:, :, 0].float()
    wkv_b = par.w(ap["wkv_b"], s["wkv_b"]).reshape(cfg.kv_lora, H, nope + cfg.v_head).float()
    specs = {k: _one_rank_none(v, par.mesh) for k, v in specs.items()}
    ckv, krc = cache["c_kv"], cache["k_rope"]
    T = ckv.shape[1]
    kpos = torch.arange(T, device=z.device)
    if specs["c_kv"][2] is None:             # the latent dim over 'model' (or whole)
        n = ckv.shape[2]
        blk = slice(par.tp_index * n, (par.tp_index + 1) * n)
        _write(ckv, c_new[:, blk], pos, 0, 1)
        kr_sharded = specs["k_rope"][3] is not None
        nr = krc.shape[2]
        _write(krc, kr_new[:, par.tp_index * nr:(par.tp_index + 1) * nr] if kr_sharded
               else kr_new, pos, 0, 1)
        wk, wv = wkv_b[blk, :, :nope], wkv_b[blk, :, nope:]
        q_eff = torch.einsum("bhn,lhn->bhl", q_nope.float(), wk)
        sc = torch.einsum("bhl,btl->bht", q_eff, ckv.float())
        sr = torch.einsum("bhr,btr->bht", q_rope[..., par.tp_index * nr:(par.tp_index + 1) * nr]
                          if kr_sharded else q_rope, krc.float())
        sc = comm.psum(sc + sr, par.model) if kr_sharded else comm.psum(sc, par.model) + sr
        sc = sc * cfg.attn_scale
        sc = torch.where(kpos[None, None, :] < pos[:, None, None] + 1, sc, -torch.inf)
        ctx = torch.einsum("bht,btl->bhl", _softmax(sc), ckv.float())
        o = comm.psum(torch.einsum("bhl,lhv->bhv", ctx, wv), par.model)
    else:                                    # the sequence over the whole mesh
        g = par.group(spec_axes(specs["c_kv"][2]))
        off = g.index * T
        _write(ckv, c_new, pos, off, 1)
        _write(krc, kr_new, pos, off, 1)
        wk, wv = wkv_b[:, :, :nope], wkv_b[:, :, nope:]
        q_eff = torch.einsum("bhn,lhn->bhl", q_nope.float(), wk)
        sc = (torch.einsum("bhl,btl->bht", q_eff, ckv.float())
              + torch.einsum("bhr,btr->bht", q_rope, krc.float())) * cfg.attn_scale
        sc = torch.where((kpos + off)[None, None, :] < pos[:, None, None] + 1, sc, -torch.inf)
        e = torch.exp(sc - _pmax(sc.amax(dim=-1, keepdim=True), g))
        p = e / _sum_at_least_tiny(e, g)
        ctx = comm.psum(torch.einsum("bht,btl->bhl", p, ckv.float()), g)
        o = torch.einsum("bhl,lhv->bhv", ctx, wv)
    o = _o_block(par, o.reshape(B, 1, H * cfg.v_head).to(z.dtype))
    return par.row(o, par.w(ap["wo"], s["wo"], par.cols))


def mesh_decode_step(par: MeshPlan, params, cache, tokens, pos, cache_specs: dict):
    """:func:`decode_step` on a mesh: tokens / pos the rank's rows (all rows
    where the batch does not cover the data axes), ``cache`` the rank's
    blocks under ``cache_specs``, written in place.  Returns logits [b,
    V / tp] (the rank's vocabulary block) and the cache.  The residual is
    whole on every rank of ``model`` (one token: no sequence to shard)."""
    cfg = par.cfg
    par = dataclasses.replace(par, sp=False)
    pos = pos.long()
    x = _mesh_embed(par, params, tokens[:, None])
    specs = {st: _layer_specs(par.specs[st]) for st in ("dense_layers", "layers")
             if st in par.specs}
    for i, (stack, j, moe_layer, _, w) in enumerate(_layer_plan(cfg)):
        lp, ls = _layer(params[stack], j), specs[stack]
        layer_cache = {k: c[i] for k, c in cache.items()}
        z = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.mla:
            h = _mesh_decode_mla(par, z, lp["attn"], ls["attn"], layer_cache, cache_specs, pos)
        else:
            h = _mesh_decode_gqa(par, z, lp["attn"], ls["attn"], layer_cache, cache_specs["k"],
                                 pos, w if w > 0 else 1 << 30)
        x = x + h
        z2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if moe_layer:
            x = x + mesh_moe_block(par, z2, lp["moe"], ls["moe"])
        else:
            x = x + mesh_swiglu(par, z2, lp["mlp"], ls["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mesh_logits(par, params, x)[:, 0], cache
