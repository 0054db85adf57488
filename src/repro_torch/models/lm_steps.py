"""Train, prefill and decode step factories for the LM family on one card
(twin of ``repro/models/lm_steps.py``).

The reference jits its steps over a mesh; on one card there is no mesh and
nothing to shard, so a step is a plain function over tensors on ``device``
(the steps on a mesh: ROADMAP queue 1, item 8).  The mesh's placement is
``dist.sharding``'s (the parameters) and :func:`cache_specs` (the decode
cache), which the dry run reads for the per-rank bytes.  Serving holds
the parameters in bf16, as the reference's serving steps hold them.
Training holds the Split-SGD state ``{"hi" bf16, "lo" int16 (the
reference's uint16 bits), "mom" fp32}``, takes the gradients of
``transformer.lm_loss`` with respect to ``hi`` (bf16, as the reference's
are) and steps each leaf in place with ``optim.split_sgd.update_leaf``:
one launch of the split_sgd kernel a leaf on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import split_sgd
from repro_torch.optim.data_parallel import tree_leaves, tree_map


def param_structs(cfg: tf.TransformerConfig) -> dict:
    """The serving parameters' ``{leaf: (shape, dtype)}`` tree (bf16)."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (v, torch.bfloat16)
                for k, v in tree.items()}
    return walk(tf.param_shapes(cfg))


def lm_state_structs(cfg: tf.TransformerConfig, momentum: bool = True) -> dict:
    """The training state's ``{"hi", "lo"[, "mom"]}`` trees of ``(shape,
    dtype)``: bf16, int16 (the reference's uint16) and fp32."""
    def walk(tree, dtype):
        return {k: walk(v, dtype) if isinstance(v, dict) else (v, dtype)
                for k, v in tree.items()}
    shapes = tf.param_shapes(cfg)
    out = {"hi": walk(shapes, torch.bfloat16), "lo": walk(shapes, torch.int16)}
    if momentum:
        out["mom"] = walk(shapes, torch.float32)
    return out


def init_lm_state(cfg: tf.TransformerConfig, generator: torch.Generator, device="cuda",
                  momentum: bool = True) -> dict:
    """A training state from fp32 weights drawn by ``transformer.init_params``
    (``generator`` on ``device``), each leaf split as it is drawn: ``hi``
    its upper 16 bits (truncated, not a bf16 rounding), ``lo`` its lower;
    ``mom`` zeros."""
    halves = tf.init_params(cfg, generator, device, dtype=torch.float32,
                            leaf=split_sgd.split_fp32)
    state = {"hi": _map_pairs(halves, 0), "lo": _map_pairs(halves, 1)}
    if momentum:
        state["mom"] = tree_map(lambda h: torch.zeros(h.shape, dtype=torch.float32,
                                                      device=h.device), state["hi"])
    return state


def _map_pairs(tree: dict, i: int) -> dict:
    return {k: _map_pairs(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def make_lm_train_step(cfg: tf.TransformerConfig, B: int, L: int, lr: float = 1e-2,
                       beta: float = 0.9, momentum: bool = True, device="cuda"):
    """``(fn, (state_structs, batch_structs))``; ``state, loss = fn(state,
    batch)`` with ``batch`` ``{"tokens", "labels"}`` [B, L] int (tensors or
    numpy): the loss (fp32 0-d, the mean over the batch's tokens) and the
    state stepped IN PLACE, where the reference donates it.

    With ``cfg.microbatch`` = M > 1 the batch runs in M chunks of B / M
    rows, as the reference's scan: the losses summed in fp32, the bf16
    gradients accumulated as ``(acc + g)`` rounded to bf16, both divided by
    M at the end (the gradients in bf16).  Then each leaf's Split-SGD step
    (``optim.split_sgd.update_leaf``, with momentum ``beta`` unless
    ``momentum`` is False)."""
    tf.check_trainable(cfg)
    dev = resolve_device(device)
    mb = max(1, cfg.microbatch)
    if B % mb:
        raise ValueError(f"batch {B} does not split into {mb} microbatches")
    structs = lm_state_structs(cfg, momentum)
    bstructs = {"tokens": ((B, L), torch.int32), "labels": ((B, L), torch.int32)}

    def value_and_grad(hi: dict, tokens, labels):
        params = tree_map(lambda t: t.detach().requires_grad_(), hi)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss = tf.lm_loss(params, tokens, labels, cfg)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def grads_of(hi: dict, tokens, labels):
        if mb == 1:
            return value_and_grad(hi, tokens, labels)
        n = B // mb
        loss, acc = None, None
        for i in range(0, B, n):
            li, g = value_and_grad(hi, tokens[i:i + n], labels[i:i + n])
            if acc is None:
                loss, acc = li, g
            else:
                loss = loss + li
                for a, gg in zip(acc, g):
                    a.add_(gg)      # bf16: (a + g) rounded once, as the reference's
        for a in acc:
            a.div_(mb)
        return loss / mb, acc

    def step(state: dict, batch: dict):
        tokens, labels = (torch.as_tensor(batch[k], device=dev) for k in ("tokens", "labels"))
        for name, t in (("tokens", tokens), ("labels", labels)):
            _check(name, t, (B, L), dev)
        loss, grads = grads_of(state["hi"], tokens, labels)
        moms = tree_leaves(state["mom"]) if momentum else [None] * len(grads)
        with torch.no_grad():
            for h, lo, g, m in zip(tree_leaves(state["hi"]), tree_leaves(state["lo"]), grads,
                                   moms):
                split_sgd.update_leaf(h, lo, g, lr, m, beta)
        return state, loss

    return step, (structs, bstructs)


def cache_structs(cfg: tf.TransformerConfig, B: int, Lmax: int) -> dict:
    """The cache's ``(shape, dtype)`` by key, bf16: GQA {'k', 'v'} [n_layers,
    B, Hkv, Lmax, dh]; MLA {'c_kv' [n_layers, B, Lmax, kv_lora], 'k_rope'
    [n_layers, B, Lmax, qk_rope]}."""
    tf.check_supported(cfg)
    return {k: (s, torch.bfloat16) for k, s in tf.cache_shapes(cfg, B, Lmax).items()}


def cache_specs(cfg: tf.TransformerConfig, mesh, B: int) -> dict:
    """How a mesh holds the decode cache of :func:`cache_structs`, by key
    (``dist.sharding``'s spec tuples; the reference's choice, HC2).  Decode
    writes one position a step, and a sequence-sharded cache turns that
    write into a reshard, so where the batch covers the data axes the heads
    go over ``model`` when they divide it, else the head dim (MLA: the
    latent dim, and ``k_rope`` where ``qk_rope`` divides); only the B = 1
    long-context cell shards the sequence, over the whole mesh."""
    from repro_torch.dist import sharding as shd
    bdp = shd.batch_axes(mesh)
    ndp = math.prod(mesh.shape[a] for a in bdp)
    tp = mesh.shape[shd.MODEL]
    batch_ok = B % ndp == 0
    whole = shd.all_axes(mesh)
    if cfg.mla:
        if batch_ok:
            return {"c_kv": (None, bdp, None, shd.MODEL),
                    "k_rope": (None, bdp, None, shd.MODEL if cfg.qk_rope % tp == 0 else None)}
        return {"c_kv": (None, None, whole, None), "k_rope": (None, None, whole, None)}
    if batch_ok and cfg.n_kv_heads % tp == 0:
        spec = (None, bdp, shd.MODEL, None, None)
    elif batch_ok and cfg.d_head % tp == 0:
        spec = (None, bdp, None, None, shd.MODEL)
    elif batch_ok:
        spec = (None, bdp, None, shd.MODEL, None)
    else:
        spec = (None, None, None, whole, None)
    return {"k": spec, "v": spec}


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
