"""Train, prefill and decode step factories for the LM family (twin of
``repro/models/lm_steps.py``), on one card or on a mesh.

Each factory takes a ``launch.mesh.Mesh`` where the reference takes its
mesh: ``make_lm_train_step(cfg, mesh, B, L, ...)``,
``init_lm_state(cfg, generator, mesh, ...)``, ``make_prefill_step(cfg,
mesh, B, L)``, ``make_decode_step(cfg, mesh, B, Lmax)``.  The one-card form
(``make_lm_train_step(cfg, B, L, device=...)``, and a one-rank mesh) is a
plain function over whole tensors on the device.  On a mesh of N ranks each
rank holds its block of every leaf (``dist.sharding.lm_param_specs``; the
decode cache by :func:`cache_specs`) and its rows of the batch
(:func:`local_batch`), and the steps are ``models.transformer``'s mesh path
(FSDP, Megatron TP with sequence parallelism, the MoE's expert-parallel
all-to-all): the reference's GSPMD function up to the order of sums.
Serving holds the parameters in bf16, as the reference's serving steps
hold them.  Training holds the Split-SGD state ``{"hi" bf16, "lo" int16
(the reference's uint16 bits), "mom" fp32}``, takes the gradients of the
loss with respect to ``hi`` (bf16, as the reference's are) and steps each
leaf (a rank's block of it) in place with ``optim.split_sgd.update_leaf``:
one launch of the split_sgd kernel a leaf-shard on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.dist import comm
from repro_torch.dist import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.optim import split_sgd
from repro_torch.optim.data_parallel import tree_leaves, tree_map, tree_unflatten


def _mesh_of(arg):
    """``arg`` where it is a ``launch.mesh.Mesh`` of more than one rank,
    else None (one card: the plain steps)."""
    from repro_torch.launch.mesh import Mesh
    return arg if isinstance(arg, Mesh) and arg.size > 1 else None


def _one_card(mesh, rest: tuple, device):
    """The factories' arguments after ``cfg``: ``(mesh, *rest)`` or the
    one-card form ``(*rest)``; returns ``(mesh or None, rest, device)``, a
    one-rank mesh giving its device."""
    from repro_torch.launch.mesh import Mesh, resolve_mesh
    if isinstance(mesh, Mesh):
        resolve_mesh(mesh)   # a shape-only mesh: the dry run's alone
        return _mesh_of(mesh), rest, (mesh.device if mesh.size == 1 else device)
    return None, ((mesh,) + rest)[:len(rest)], device


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
    ``mom`` zeros.  ``device`` may be a mesh (the reference's argument):
    each rank draws every global leaf in turn and keeps its block, so the
    state is the one-rank state cut by ``dist.sharding.lm_state_specs``, and
    no rank holds more than one whole leaf at a time."""
    from repro_torch.launch.mesh import Mesh
    mesh = _mesh_of(device)
    if isinstance(device, Mesh):
        device = device.device
    halves = tf.init_params(cfg, generator, device, dtype=torch.float32,
                            leaf=split_sgd.split_fp32,
                            cut=None if mesh is None else shd.lm_leaf_cut(cfg, mesh))
    state = {"hi": _map_pairs(halves, 0), "lo": _map_pairs(halves, 1)}
    if momentum:
        state["mom"] = tree_map(lambda h: torch.zeros(h.shape, dtype=torch.float32,
                                                      device=h.device), state["hi"])
    return state


def _map_pairs(tree: dict, i: int) -> dict:
    return {k: _map_pairs(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def local_batch(cfg: tf.TransformerConfig, mesh, batch: dict) -> dict:
    """This rank's rows of a global train batch ``{"tokens", "labels"}`` [B,
    L], cut over ``cfg.dp_axes``: with ``cfg.microbatch`` = M, microbatch
    ``i`` of the reference (global rows ``i B / M`` on) gives each data
    rank its block of rows, and the rank's rows are its blocks of the M
    microbatches in order (one block of B / N rows where M is 1)."""
    mesh = _mesh_of(mesh)
    if mesh is None:
        return batch
    mb = max(1, cfg.microbatch)
    g = mesh.group(tuple(a for a in mesh.axis_names if a in cfg.dp_axes))
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (mb * g.size):
            raise ValueError(f"{k}: {B} rows do not split into {mb} microbatches over "
                             f"{g.size} data ranks")
        v = v.reshape((mb, g.size, B // (mb * g.size)) + tuple(v.shape[1:]))[:, g.index]
        out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
    return out


def _spec_leaves(specs: dict) -> list:
    """A spec tree's spec tuples in pytree order (the leaves' order)."""
    return [x for k in sorted(specs) for x in
            (_spec_leaves(specs[k]) if isinstance(specs[k], dict) else [specs[k]])]


def _leaf_names(specs: dict) -> list:
    """Each leaf's key, in pytree order."""
    return [x for k in sorted(specs) for x in
            (_leaf_names(specs[k]) if isinstance(specs[k], dict) else [k])]


def _read_as_fp32(name: str) -> bool:
    """Whether the model reads the leaf ``name`` through ``.float()`` alone
    (the norms' weights and the router)."""
    return name == "router" or "norm" in name or name.startswith("ln")


def _grad_axes(spec, mesh) -> tuple:
    """The mesh axes (of more than one rank) that a leaf's spec does not
    shard: its gradient is summed over them."""
    used = {a for e in spec for a in shd.spec_axes(e)}
    return tuple(a for a in mesh.axis_names if a not in used and mesh.shape[a] > 1)


def make_lm_train_step(cfg: tf.TransformerConfig, mesh, B: int = None, L: int = None,
                       lr: float = 1e-2, beta: float = 0.9, momentum: bool = True,
                       device="cuda"):
    """``make_lm_train_step(cfg, mesh, B, L, ...)``, or on one card
    ``make_lm_train_step(cfg, B, L, ..., device=...)``: ``(fn, (state_structs,
    batch_structs))``; ``state, loss = fn(state, batch)``.  On one card the
    batch is the whole ``{"tokens", "labels"}`` [B, L] and the state whole;
    on a mesh both are the rank's (:func:`local_batch`, the blocks of
    :func:`init_lm_state`), the structs global (their specs:
    ``dist.sharding.lm_state_specs``, the batch over ``cfg.dp_axes``)."""
    mesh, (B, L), device = _one_card(mesh, (B, L), device)
    if mesh is not None:
        return _make_mesh_train_step(cfg, mesh, B, L, lr, beta, momentum)
    return _make_train_step(cfg, B, L, lr, beta, momentum, device)


def _make_mesh_train_step(cfg, mesh, B: int, L: int, lr: float, beta: float, momentum: bool):
    """The train step on a mesh: each microbatch's loss and gradients
    (``transformer.mesh_lm_loss``: the FSDP gathers' backward reduce-scatter
    each gradient onto the rank's block), each leaf's gradient summed over
    the axes its spec does not shard, accumulated as ``(acc + g)`` in bf16
    and divided by M; then ``update_leaf`` on every block; the loss summed
    over the mesh (the reference's global mean)."""
    tf.check_trainable(cfg)
    par = tf.mesh_plan(cfg, mesh, cfg.dp_axes)
    mb = max(1, cfg.microbatch)
    if B % (mb * par.n_batch):
        raise ValueError(f"batch {B} does not split into {mb} microbatches over "
                         f"{par.n_batch} data ranks")
    b = B // par.n_batch
    dev = mesh.device
    structs = lm_state_structs(cfg, momentum)
    bstructs = {"tokens": ((B, L), torch.int32), "labels": ((B, L), torch.int32)}
    groups = [mesh.group(axes) if axes else None
              for axes in (_grad_axes(sp, mesh) for sp in _spec_leaves(par.specs))]
    everyone = mesh.group(mesh.axis_names)

    # the replicated norms and routers, read through .float(), take fp32 leaves: their
    # per-rank gradients are summed in fp32 and rounded to bf16 once
    wide = [grp is not None and _read_as_fp32(name)
            for name, grp in zip(_leaf_names(par.specs), groups)]

    def value_and_grad(hi: dict, tokens, labels):
        leaves = [t.detach().float().requires_grad_() if f else t.detach().requires_grad_()
                  for t, f in zip(tree_leaves(hi), wide)]
        with torch.enable_grad():
            loss = tf.mesh_lm_loss(par, tree_unflatten(hi, leaves), tokens, labels,
                                   (B // mb) * L)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g if grp is None else comm.psum(g, grp).to(torch.bfloat16)
                               for g, grp in zip(grads, groups)]

    def step(state: dict, batch: dict):
        tokens, labels = (torch.as_tensor(batch[k], device=dev) for k in ("tokens", "labels"))
        for name, t in (("tokens", tokens), ("labels", labels)):
            _check(name, t, (b, L), dev)
        n = b // mb
        loss, acc = None, None
        for i in range(0, b, n):
            li, g = value_and_grad(state["hi"], tokens[i:i + n], labels[i:i + n])
            if acc is None:
                loss, acc = li, g
            else:
                loss = loss + li
                for a, gg in zip(acc, g):
                    a.add_(gg)      # bf16: (a + g) rounded once, as the reference's
        if mb > 1:
            for a in acc:
                a.div_(mb)
            loss = loss / mb
        moms = tree_leaves(state["mom"]) if momentum else [None] * len(acc)
        with torch.no_grad():
            for h, lo, g, m in zip(tree_leaves(state["hi"]), tree_leaves(state["lo"]), acc, moms):
                split_sgd.update_leaf(h, lo, g.contiguous(), lr, m, beta)
        return state, comm.psum(loss, everyone)

    return step, (structs, bstructs)


def _make_train_step(cfg: tf.TransformerConfig, B: int, L: int, lr: float, beta: float,
                     momentum: bool, device):
    """The one-card train step: ``state, loss = fn(state, batch)`` with
    ``batch`` ``{"tokens", "labels"}`` [B, L] int (tensors or numpy): the
    loss (fp32 0-d, the mean over the batch's tokens) and the state stepped
    IN PLACE, where the reference donates it.

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


def cache_structs(cfg: tf.TransformerConfig, mesh, B: int = None, Lmax: int = None) -> dict:
    """``cache_structs(cfg, mesh, B, Lmax)`` or ``cache_structs(cfg, B,
    Lmax)``: the (global) cache's ``(shape, dtype)`` by key, bf16: GQA {'k',
    'v'} [n_layers, B, Hkv, Lmax, dh]; MLA {'c_kv' [n_layers, B, Lmax,
    kv_lora], 'k_rope' [n_layers, B, Lmax, qk_rope]}; a mesh holds it by
    :func:`cache_specs`."""
    _, (B, Lmax), _ = _one_card(mesh, (B, Lmax), None)
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


def _serving_plan(cfg: tf.TransformerConfig, mesh) -> tf.MeshPlan:
    """The serving steps' plan: the batch over the mesh's data axes; a
    ``model`` axis of more than one rank must be the config's TP width."""
    tf.check_supported(cfg)
    if mesh.shape[shd.MODEL] > 1 and cfg.tp_size != mesh.shape[shd.MODEL]:
        raise ValueError(f"{cfg.name}: serving on {mesh.shape} needs tp_size "
                         f"{mesh.shape[shd.MODEL]}, the config has {cfg.tp_size}")
    return tf.mesh_plan(cfg, mesh, shd.batch_axes(mesh))


def local_shapes(structs: dict, specs: dict, mesh) -> dict:
    """The rank's ``(shape, dtype)`` of each struct under its spec (the
    sharded dims must divide)."""
    out = {}
    for k, (shape, dtype) in structs.items():
        if any(d % shd.axis_size(e, mesh.shape) for d, e in zip(shape, specs[k])):
            raise ValueError(f"{k}: {shape} does not divide under {specs[k]} on {mesh.shape}")
        out[k] = (shd.shard_shape(shape, specs[k], mesh.shape), dtype)
    return out


def make_prefill_step(cfg: tf.TransformerConfig, mesh, B: int = None, L: int = None,
                      device="cuda"):
    """``make_prefill_step(cfg, mesh, B, L)``, or on one card
    ``make_prefill_step(cfg, B, L, device=...)``: ``(fn, (param_structs,
    token_struct))``; ``logits, cache = fn(params, tokens)``.  On one card
    tokens [B, L] int on ``device``: logits [B, V] fp32 of the last token,
    the cache of :func:`cache_structs` at ``Lmax = L``.  On a mesh the
    rank's blocks of the parameters and its rows of the tokens (over the
    mesh's data axes, which B must divide): logits of its rows and its
    block of the vocabulary (the reference's ``P(bdp, model)``), the rank's
    blocks of the cache (:func:`cache_specs`).  With
    ``cfg.prefill_microbatch`` > 1 the rows run in that many sequential
    chunks (the reference's rule: the largest count not above it, at most
    the rows of a rank, that splits B and each chunk over the data axes),
    each writing its rows of one cache."""
    mesh, (B, L), device = _one_card(mesh, (B, L), device)
    if mesh is None:
        return _make_prefill_step(cfg, B, L, device)
    par = _serving_plan(cfg, mesh)
    ndp = par.n_batch
    if B % ndp:
        raise ValueError(f"prefill batch {B} does not split over {ndp} data ranks")
    mb = max(1, min(cfg.prefill_microbatch, B // ndp))
    while B % mb or (B // mb) % ndp:
        mb -= 1
    b, dev = B // ndp, mesh.device
    cspecs = cache_specs(cfg, mesh, B)
    cshapes = local_shapes(cache_structs(cfg, B, L), cspecs, mesh)

    def run(params: dict, tokens: torch.Tensor):
        _check("tokens", tokens, (b, L), dev)
        cache = {k: torch.empty(s, dtype=d, device=dev) for k, (s, d) in cshapes.items()}
        n = b // mb
        logits = [tf.mesh_prefill(par, params, tokens[i:i + n], cspecs,
                                  {k: c[:, i:i + n] for k, c in cache.items()})[0]
                  for i in range(0, b, n)]
        return torch.cat(logits), cache

    return run, (param_structs(cfg), ((B, L), torch.int32))


def _make_prefill_step(cfg: tf.TransformerConfig, B: int, L: int, device):
    """The one-card prefill step (:func:`make_prefill_step`)."""
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


def decode_rows(B: int, mesh) -> bool:
    """Whether a decode batch of B rows is cut over the mesh's data axes (B
    divides them), else every rank holds every row."""
    return B % math.prod(mesh.shape[a] for a in shd.batch_axes(mesh)) == 0


def make_decode_step(cfg: tf.TransformerConfig, mesh, B: int = None, Lmax: int = None,
                     device="cuda"):
    """``make_decode_step(cfg, mesh, B, Lmax)``, or on one card
    ``make_decode_step(cfg, B, Lmax, device=...)``: ``(fn, (param_structs,
    cache_structs, token_struct, pos_struct))``; ``logits, cache = fn(params,
    cache, tokens, pos)`` with tokens and pos [B] int (pos: each row's count
    of valid cache entries): logits [B, V] fp32; the cache is written IN
    PLACE at each row's pos, where the reference donates it.  On a mesh the
    rank's rows (all of them where B does not divide the data axes, the
    long-context cell) and blocks (:func:`cache_specs`): logits of its rows
    and its block of the vocabulary."""
    mesh, (B, Lmax), device = _one_card(mesh, (B, Lmax), device)
    cstructs = cache_structs(cfg, B, Lmax)
    if mesh is None:
        return _make_decode_step(cfg, B, Lmax, cstructs, device)
    par = _serving_plan(cfg, mesh)
    b = B // par.n_batch if decode_rows(B, mesh) else B
    dev = mesh.device
    cspecs = cache_specs(cfg, mesh, B)
    cshapes = local_shapes(cstructs, cspecs, mesh)

    def run(params: dict, cache: dict, tokens: torch.Tensor, pos: torch.Tensor):
        _check_cache(cache, cshapes, dev)
        _check("tokens", tokens, (b,), dev)
        _check("pos", pos, (b,), dev)
        return tf.mesh_decode_step(par, params, cache, tokens, pos, cspecs)

    return run, (param_structs(cfg), cstructs, ((B,), torch.int32), ((B,), torch.int32))


def _check_cache(cache: dict, shapes: dict, dev) -> None:
    for k, (shape, dtype) in shapes.items():
        _check(f"cache[{k!r}]", cache[k], shape, dev)
        if cache[k].dtype != dtype:
            raise TypeError(f"cache[{k!r}] is {cache[k].dtype}, need {dtype}")


def _make_decode_step(cfg: tf.TransformerConfig, B: int, Lmax: int, cstructs: dict, device):
    """The one-card decode step (:func:`make_decode_step`)."""
    dev = resolve_device(device)

    def run(params: dict, cache: dict, tokens: torch.Tensor, pos: torch.Tensor):
        _check_cache(cache, cstructs, dev)
        _check("tokens", tokens, (B,), dev)
        _check("pos", pos, (B,), dev)
        return tf.decode_step(params, cache, tokens, pos, cfg)

    return run, (param_structs(cfg), cstructs, ((B,), torch.int32), ((B,), torch.int32))
