"""Serving step factories for the LM family on one card (twin of the serving
half of ``repro/models/lm_steps.py``).

The reference jits its steps over a mesh; on one card there is no mesh and
nothing to shard, so a step is a plain function over tensors on ``device``.
Parameters are held in bf16, as the reference's serving steps hold them.
Training (``make_lm_train_step`` and its state) is not ported.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tf


def param_structs(cfg: tf.TransformerConfig) -> dict:
    """The serving parameters' ``{leaf: (shape, dtype)}`` tree (bf16)."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (v, torch.bfloat16)
                for k, v in tree.items()}
    return walk(tf.param_shapes(cfg))


def cache_structs(cfg: tf.TransformerConfig, B: int, Lmax: int) -> dict:
    """The cache's ``(shape, dtype)`` by key, bf16: GQA {'k', 'v'} [n_layers,
    B, Hkv, Lmax, dh]; MLA {'c_kv' [n_layers, B, Lmax, kv_lora], 'k_rope'
    [n_layers, B, Lmax, qk_rope]}."""
    tf.check_supported(cfg)
    return {k: (s, torch.bfloat16) for k, s in tf.cache_shapes(cfg, B, Lmax).items()}


def _check(name: str, t: torch.Tensor, shape: tuple, dev: torch.device) -> None:
    if tuple(t.shape) != tuple(shape) or t.device.type != dev.type:
        raise ValueError(f"{name}: need {tuple(shape)} on {dev}, got {tuple(t.shape)} on "
                         f"{t.device}")


def make_prefill_step(cfg: tf.TransformerConfig, B: int, L: int, device="cuda"):
    """``(fn, (param_structs, token_struct))``; ``logits, cache = fn(params,
    tokens)`` with tokens [B, L] int on ``device``: logits [B, V] fp32 of
    the last token, the cache of :func:`cache_structs` at ``Lmax = L``.
    With ``cfg.prefill_microbatch`` > 1 the batch runs in that many
    sequential chunks (the largest divisor of B not above it), each writing
    its rows of one cache."""
    tf.check_supported(cfg)
    dev = resolve_device(device)
    mb = max(1, min(cfg.prefill_microbatch, B))
    while B % mb:
        mb -= 1

    def run(params: dict, tokens: torch.Tensor):
        _check("tokens", tokens, (B, L), dev)
        if mb == 1:
            return tf.prefill(params, tokens, cfg)
        cache = {k: torch.empty(s, dtype=d, device=dev)
                 for k, (s, d) in cache_structs(cfg, B, L).items()}
        n = B // mb
        logits = [tf.prefill(params, tokens[i:i + n], cfg,
                             out={k: c[:, i:i + n] for k, c in cache.items()})[0]
                  for i in range(0, B, n)]
        return torch.cat(logits), cache

    return run, (param_structs(cfg), ((B, L), torch.int32))


def make_decode_step(cfg: tf.TransformerConfig, B: int, Lmax: int, device="cuda"):
    """``(fn, (param_structs, cache_structs, token_struct, pos_struct))``;
    ``logits, cache = fn(params, cache, tokens, pos)`` with tokens and pos
    [B] int on ``device`` (pos: each row's count of valid cache entries):
    logits [B, V] fp32; the cache is written IN PLACE at each row's pos,
    where the reference donates it."""
    cstructs = cache_structs(cfg, B, Lmax)
    dev = resolve_device(device)

    def run(params: dict, cache: dict, tokens: torch.Tensor, pos: torch.Tensor):
        for k, (shape, dtype) in cstructs.items():
            _check(f"cache[{k!r}]", cache[k], shape, dev)
            if cache[k].dtype != dtype:
                raise TypeError(f"cache[{k!r}] is {cache[k].dtype}, need {dtype}")
        _check("tokens", tokens, (B,), dev)
        _check("pos", pos, (B,), dev)
        return tf.decode_step(params, cache, tokens, pos, cfg)

    return run, (param_structs(cfg), cstructs, ((B,), torch.int32), ((B,), torch.int32))
