"""Dense GQA transformer LM serving (twin of ``repro/models/transformer.py``).

The reference covers five architectures; the port has the dense GQA ones
(internlm2, gemma2's local/global layers and soft-caps, phi3) for serving:
:func:`prefill` and :func:`decode_step` on one card.  MoE and MLA are refused
(``ROADMAP.md`` queues them), as is training (``lm_loss``).  The
reference's sharding constraints are identity on one card and have no twin.

Parameters keep the reference's stacked layout: ``{"embed" [V, d],
"layers": {"ln1", "ln2" [n, d], "attn": {"wq", "wk", "wv", "wo"}, "mlp":
{"wg", "wu", "wd"}} (each [n, ...]), "final_norm" [d], "unembed" [d, V]
(untied only)}``; serving holds them in bf16.  The layers run in a plain
Python loop, layer ``i`` reading slice ``i`` of each stacked leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import attention, decode_attention, rms_norm, rope


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


def check_supported(cfg: TransformerConfig) -> None:
    """Raises for what the port does not serve yet."""
    if cfg.moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet (ROADMAP.md, "
                                  "queue 1)")
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA is not ported yet (ROADMAP.md, queue 1); with attn_impl='pallas' the "
            "reference cannot run it either (ROADMAP.md, queue 3)")


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree's leaf shapes, stacked over the layers."""
    check_supported(cfg)
    n, d, H, Hkv, dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {"embed": (cfg.vocab, d),
              "layers": {"ln1": (n, d), "ln2": (n, d),
                         "attn": {"wq": (n, d, H * dh), "wk": (n, d, Hkv * dh),
                                  "wv": (n, d, Hkv * dh), "wo": (n, H * dh, d)},
                         "mlp": {"wg": (n, d, cfg.d_ff), "wu": (n, d, cfg.d_ff),
                                 "wd": (n, cfg.d_ff, d)}},
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab)
    return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator, device="cuda") -> dict:
    """The reference's distributions: each projection ~ N(0, 1/fan_in) with
    fan_in its per-layer input width, the embedding (and unembedding) ~ N(0,
    0.02²), the norms' weights 0; drawn in fp32 one layer at a time and
    stored in bf16, as the serving step holds them.  ``generator`` must live
    on ``device``; the numbers differ from the reference's (``jax.random``
    is not ported)."""
    dev = resolve_device(device)

    def normal(shape, scale):
        out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator, device=dev) * scale)
        return out

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    shapes = param_shapes(cfg)
    lay = shapes["layers"]
    params = {"embed": normal(shapes["embed"], 0.02),
              "layers": {"ln1": zeros(lay["ln1"]), "ln2": zeros(lay["ln2"]),
                         **{blk: {k: normal(s, s[1] ** -0.5) for k, s in lay[blk].items()}
                            for blk in ("attn", "mlp")}},
              "final_norm": zeros(shapes["final_norm"])}
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


def _gqa_qkv(x, ap, cfg: TransformerConfig, positions):
    B, L, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ ap["wq"]).reshape(B, L, H, dh).transpose(1, 2)
    kk = (x @ ap["wk"]).reshape(B, L, Hkv, dh).transpose(1, 2)
    vv = (x @ ap["wv"]).reshape(B, L, Hkv, dh).transpose(1, 2)
    q = rope(q, positions[None, None, :], cfg.rope_theta)
    kk = rope(kk, positions[None, None, :], cfg.rope_theta)
    return q.contiguous(), kk.contiguous(), vv.contiguous()


def attn_block(x, ap, cfg: TransformerConfig, positions, window: int):
    """Returns the block's output and its (k, v) cache entry [B, Hkv, L,
    dh]."""
    B, L, _ = x.shape
    q, k, v = _gqa_qkv(x, ap, cfg, positions)
    o = attention(q, k, v, causal=True, softcap=cfg.attn_softcap, window=window,
                  scale=cfg.attn_scale, impl=cfg.attn_impl, bq=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(B, L, cfg.n_heads * cfg.d_head)
    return (o @ ap["wo"]).to(x.dtype), (k, v)


def _layer(lp: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked parameter tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in lp.items()}


def layer_fwd(x, lp, cfg: TransformerConfig, positions, window: int):
    h, cache = attn_block(rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg, positions,
                          window)
    x = x + h
    z = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    return x, cache


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
# Serving: prefill and decode
# ---------------------------------------------------------------------------

def prefill(params, tokens, cfg: TransformerConfig):
    """Last-token logits [B, V] fp32 and the KV cache {'k', 'v'} [n_layers,
    B, Hkv, L, dh] of tokens [B, L]."""
    check_supported(cfg)
    B, L = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(L, device=x.device)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, L, cfg.d_head)
    cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
             "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for i, window in enumerate(cfg.layer_windows()):
        x, (k, v) = layer_fwd(x, _layer(params["layers"], i), cfg, positions, window)
        cache["k"][i] = k
        cache["v"][i] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x[:, -1:], cfg)[:, 0], cache


def _decode_layer(x, lp, cache_k, cache_v, cfg: TransformerConfig, pos, window: int):
    """One decode layer; writes this token's k and v into the cache slices
    at each row's ``pos``, in place."""
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    z = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (z @ lp["attn"]["wq"]).reshape(B, 1, H, dh).transpose(1, 2)
    kk = (z @ lp["attn"]["wk"]).reshape(B, 1, Hkv, dh).transpose(1, 2)
    vv = (z @ lp["attn"]["wv"]).reshape(B, 1, Hkv, dh).transpose(1, 2)
    q = rope(q, pos[:, None, None], cfg.rope_theta)
    kk = rope(kk, pos[:, None, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, :, pos] = kk[:, :, 0]
    cache_v[rows, :, pos] = vv[:, :, 0]
    o = decode_attention(q, cache_k, cache_v, softcap=cfg.attn_softcap, window=window,
                         scale=cfg.attn_scale, kv_len=pos + 1)
    h = o.transpose(1, 2).reshape(B, 1, H * dh)
    x = x + (h @ lp["attn"]["wo"]).to(x.dtype)
    z2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(z2, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def decode_step(params, cache, tokens, pos, cfg: TransformerConfig):
    """One serving decode step.  tokens [B] int; pos [B] int = the number of
    valid cache entries (where this token is written).  Returns (logits [B,
    V] fp32, cache); the cache is updated IN PLACE, where the reference
    donates it."""
    check_supported(cfg)
    pos = pos.long()
    x = _embed(params, tokens[:, None], cfg)                    # [B, 1, d]
    for i, w in enumerate(cfg.layer_windows()):
        # a global layer's window is 2^30: every cached key is in reach
        x = _decode_layer(x, _layer(params["layers"], i), cache["k"][i], cache["v"][i], cfg, pos,
                          w if w > 0 else 1 << 30)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x, cfg)[:, 0], cache
