"""Transformer LM serving and training (twin of ``repro/models/transformer.py``).

The reference covers five architectures, and the port serves and trains
all of them on one card: :func:`prefill` and :func:`decode_step` for dense
GQA (internlm2, gemma2's local/global layers and soft-caps, phi3), MoE
(qwen3-moe: :func:`moe_block`, the reference's per-sequence grouped top-k
dispatch with its capacity drops) and MLA (deepseek-v2: the latent cache and
the absorbed decode, with its first dense layers); :func:`lm_loss`, the
causal cross-entropy whose gradients ``models.lm_steps.make_lm_train_step``
takes.  The reference's sharding constraints are identity on one card and
have no twin; its expert FFN is its one-device (``not cfg.seq_shard``)
path.

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
                dtype: torch.dtype = torch.bfloat16, leaf=None) -> dict:
    """The reference's distributions: each projection ~ N(0, 1/s) with s
    its per-layer leaf's first dim (its fan-in; an expert stack's expert
    count, as the reference draws it), the embedding (and unembedding) ~
    N(0, 0.02²), the norms' weights 0; drawn in fp32 one matrix at a time
    and stored in ``dtype`` (bf16, as the serving step holds them; fp32 for
    a training state), each finished leaf mapped by ``leaf`` where given
    (``init_lm_state`` splits it there, one leaf at a time).  ``generator``
    must live on ``device``; the numbers differ from the reference's
    (``jax.random`` is not ported)."""
    dev = resolve_device(device)
    leaf = leaf or (lambda t: t)

    def normal(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in (out.flatten(0, -3) if len(shape) >= 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator, device=dev) * scale)
        return leaf(out)

    def zeros(shape):
        return leaf(torch.zeros(shape, dtype=dtype, device=dev))

    def draw(tree):   # a stack: every leaf of rank 2 is a norm ([n, width])
        return {k: draw(s) if isinstance(s, dict) else
                normal(s, s[1] ** -0.5) if len(s) >= 3 else zeros(s) for k, s in tree.items()}

    shapes = param_shapes(cfg)
    params = {"embed": normal(shapes["embed"], 0.02), "layers": draw(shapes["layers"])}
    if "dense_layers" in shapes:
        params["dense_layers"] = draw(shapes["dense_layers"])
    params["final_norm"] = zeros(shapes["final_norm"])
    if "unembed" in shapes:
        params["unembed"] = normal(shapes["unembed"], 0.02)
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
