"""Where a serving snapshot's weights come from.

* :func:`snapshot_from_numpy` and :func:`state_to_snapshot` carry the JAX
  package's weights across, bit for bit, from numpy copies of its arrays
  (``jax.tree.map(np.asarray, ...)``): the ``snapshot_state(...)`` pytree,
  or a whole train state.  The tests use them so that both sides score with
  the same weights; the JAX random generator is not ported.
* :func:`init_snapshot` draws a port-native snapshot from a
  ``torch.Generator``, with the reference's distributions.
* :func:`state_from_numpy` and :func:`state_to_numpy` carry a whole train
  state across, both ways, bit for bit: the embedding store with its
  optimizer's state slabs (bf16 ones too), the dense ``hi`` tree, the dense
  ``lo`` vector, the dense error feedback's ``err``, the seed ``sr``, the
  hot-row cache's ``cnt`` slab and replicated ``cache``, and the step
  ``metrics`` where the config has them.  :func:`state_to_global` and :func:`state_from_global`
  do the same with CPU tensors and need no ``ml_dtypes``: the run loop's
  checkpoint of a sharded state (:func:`global_like` is its restore
  target), and :func:`reshard_global` lays it out for another mesh (an
  elastic restart).  :func:`state_to` copies a train state to another
  device.
* :func:`lm_params_from_numpy`, :func:`init_lm_params` and
  :func:`lm_params_to` do the same for an LM's serving parameters (bf16,
  in the reference's stacked layout); :func:`lm_state_from_numpy` and
  :func:`lm_state_to_numpy` carry an LM training state (``{"hi", "lo",
  "mom"?}``) across both ways, bit for bit; with ``mesh=`` the first two
  keep the rank's block of each leaf (``dist.sharding.lm_param_specs``).
  :func:`lm_state_to_global` gathers a mesh's LM state into whole CPU
  tensors (every rank calls it: the run loop's checkpoint) and
  :func:`lm_state_from_global` cuts them for a mesh of any shape.
* :func:`egnn_params_from_numpy`, :func:`egnn_state_from_numpy` and
  :func:`egnn_state_to_numpy` carry the EGNN's fp32 parameter tree and its
  Split-SGD state (``{"hi", "lo"}``) across, bit for bit, always as
  copies.
* :func:`params_from_numpy`, :func:`split_state_from_numpy` and
  :func:`split_state_to_numpy` carry a plain parameter tree and the
  reference's ``SplitSGDState`` across (the Fig. 16 convergence run).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sharded_embedding as se
from repro_torch.dist.exchange import resolve_exchange
from repro_torch.models import lm_steps
from repro_torch.models import transformer as tf
from repro_torch.optim import data_parallel as dp
from repro_torch.optim import row as row_optim
from repro_torch.optim.split_sgd import split_fp32


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy -> torch, bit for bit.  ``torch.from_numpy`` refuses the
    ``ml_dtypes`` bf16 dtype that JAX hands out, so bf16 goes through an
    int16 view; a uint16 array (a Split-SGD ``lo`` slab) comes out as its
    int16 bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device)
    return torch.from_numpy(a).to(device)


# init_snapshot's table draw, in fp32 elements a call (4 GiB)
_DRAW_ELEMENTS = 1 << 30


def _check_dense(dense_hi, mdef) -> None:
    """``dense_hi`` has the structure and the shapes of the model's
    ``init_dense`` tree (``core.hybrid.dense_tree``)."""
    from repro_torch.core.hybrid import dense_tree

    def walk(got, want, where):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"{where} holds "
                                 f"{sorted(got) if isinstance(got, dict) else type(got).__name__}"
                                 f", the model needs {sorted(want)}")
            for k in want:
                walk(got[k], want[k], f"{where}[{k!r}]")
        elif isinstance(want, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"{where} is not a list of {len(want)}")
            for i, (g, w) in enumerate(zip(got, want)):
                walk(g, w, f"{where}[{i}]")
        elif tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{where} is {tuple(got.shape)}, the model needs "
                             f"{tuple(want.shape)}")
    walk(dense_hi, dense_tree(mdef), "dense_hi")


def _check(snap: dict, mdef, mesh=None) -> dict:
    from repro_torch.core.hybrid import make_layout
    rows = make_layout(mdef, mesh).total_rows
    if tuple(snap["emb_w"].shape) != (rows, mdef.spec.dim):
        raise ValueError(f"emb_w is {tuple(snap['emb_w'].shape)}, the config needs "
                         f"{(rows, mdef.spec.dim)}")
    _check_dense(snap["dense_hi"], mdef)
    return snap


def snapshot_from_numpy(snap_np: dict, cfg, device="cuda", mesh=None) -> dict:
    """The reference's ``snapshot_state`` pytree, as numpy arrays (``emb_w``
    bf16-hi or fp32, the global slab of its mesh; ``dense_hi`` bf16, any
    tree the model's ``init_dense`` gives), -> this rank's snapshot state
    on ``device``: its shard of ``emb_w`` on ``mesh`` (None: one rank;
    ``serve.snapshot.snapshot_specs``) and the whole ``dense_hi``.
    ``cfg``: a ``core.hybrid.HybridDef`` or a ``core.dlrm.DLRMConfig``, as
    everywhere in this module."""
    from repro_torch.core.hybrid import as_hybrid
    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.serve.snapshot import snapshot_specs
    cfg = as_hybrid(cfg)
    mesh = resolve_mesh(mesh, device)
    _check(snap_np, cfg, mesh)
    emb = snapshot_specs(cfg, mesh)["emb_w"].cut(np.asarray(snap_np["emb_w"]))
    return {"emb_w": to_torch(emb, mesh.device),
            "dense_hi": dp.tree_map(lambda a: to_torch(a, mesh.device), snap_np["dense_hi"])}


def state_to_snapshot(state_np: dict, cfg, device="cuda", mesh=None) -> dict:
    """A full JAX train state as numpy arrays (``emb`` store, ``dense.hi``;
    global) -> this rank's snapshot state on ``device`` and ``mesh``.  Only
    the forward slabs cross."""
    fwd = row_optim.fwd_weights(row_optim.resolve(cfg), state_np["emb"])
    return snapshot_from_numpy({"emb_w": fwd, "dense_hi": state_np["dense"]["hi"]}, cfg, device,
                               mesh)


def init_snapshot(cfg, generator: torch.Generator, device="cuda") -> dict:
    """A port-native snapshot state: table rows ~ U(-a, a) with
    a = 1 / sqrt(mean table rows), dense weights from the model's
    ``init_dense``, each fp32 master split and its bf16 ``hi`` half kept (the
    ``w`` slab itself for ``sgd``).  ``generator`` must live on ``device``.
    The table is drawn ``_DRAW_ELEMENTS`` at a time, so that no more than
    that is held in fp32 beside the slab (dlrm-mlperf's 48.07 GB ``hi``
    slab fits an 80 GB card, its fp32 table, 96.1 GB, does not); a table of
    no more than that draws in one call."""
    from repro_torch.core.hybrid import as_hybrid
    cfg = as_hybrid(cfg)
    dev = resolve_device(device)
    rows = se.make_layout(cfg.spec, 1, cfg.emb_mode).total_rows
    a = 1.0 / float(np.sqrt(np.mean(cfg.spec.table_rows)))
    split = row_optim.resolve(cfg).split
    emb_w = torch.empty((rows, cfg.spec.dim), dtype=torch.bfloat16 if split else torch.float32,
                        device=dev)
    chunk = max(1, _DRAW_ELEMENTS // cfg.spec.dim)
    for r0 in range(0, rows, chunk):
        W = torch.empty((min(chunk, rows - r0), cfg.spec.dim), device=dev).uniform_(
            -a, a, generator=generator)
        emb_w[r0:r0 + W.shape[0]] = split_fp32(W)[0] if split else W
        del W
    dense = cfg.init_dense(generator, dev)
    return {"emb_w": emb_w, "dense_hi": dp.tree_map(lambda t: split_fp32(t)[0], dense)}


def state_from_numpy(state_np: dict, cfg, mesh=None, *, device="cuda") -> dict:
    """A JAX train state as numpy arrays (``jax.tree.map(np.asarray,
    state)``: ``emb`` {hi bf16, lo uint16} or {w fp32} and the optimizer's
    state slabs (``mom``, ``acc``, ``cnt``; bf16 ones as ``ml_dtypes``
    arrays), ``dense`` {hi tree bf16, lo [padded] uint16, err [padded] fp32
    or None} and, where the config has it, ``sr`` 0-d int32), the
    reference's GLOBAL arrays of a ``mesh`` of the same shape -> this rank's
    train state on its device (``mesh`` None: one rank on ``device``), bit
    for bit: :func:`state_from_global` of the arrays as tensors."""
    from repro_torch.launch.mesh import resolve_mesh
    mesh = resolve_mesh(mesh, device)
    err = state_np["dense"].get("err")
    tensors = {"emb": {k: to_torch(v) for k, v in state_np["emb"].items()},
               "dense": {"hi": dp.tree_map(to_torch, state_np["dense"]["hi"]),
                         "lo": to_torch(state_np["dense"]["lo"]),
                         "err": None if err is None else to_torch(err)}}
    if "sr" in state_np:
        tensors["sr"] = to_torch(np.asarray(state_np["sr"], np.int32))
    for key in REPLICATED:
        if key in state_np:
            tensors[key] = dp.tree_map(lambda a: to_torch(a).reshape(np.shape(a)), state_np[key])
    return state_from_global(tensors, cfg, mesh)


def state_from_global(glob: dict, cfg, mesh=None, *, device="cuda") -> dict:
    """The reference's global train state of a ``mesh`` of the same shape, as
    CPU tensors (what :func:`state_to_global` gives and a checkpoint restores:
    16-bit ``lo`` slabs as their int16 bits, bf16 as bf16) -> this rank's
    train state on its device (``mesh`` None: one rank on ``device``), bit
    for bit, laid out as ``core.hybrid.init_state`` lays it out: the rank's
    rows of the embedding store (its row window, or its bin of tables), its
    chunks of the bucketed ``lo`` and ``err``, the dense ``hi`` leaves as
    views of one flat buffer."""
    from repro_torch.core import hybrid
    from repro_torch.launch.mesh import resolve_mesh

    cfg = hybrid.as_hybrid(cfg)
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    opt = row_optim.resolve(cfg)
    layout = hybrid.make_layout(cfg, mesh)
    R, s = layout.rows_per_shard, hybrid.emb_shard(cfg, mesh)
    struct = opt.store_struct(layout.total_rows, cfg.spec.dim, counters=hybrid.hot_rows(cfg) > 0)
    if set(glob["emb"]) != set(struct):
        raise ValueError(f"the {opt.name} store holds {sorted(struct)}, got "
                         f"{sorted(glob['emb'])}")
    emb = {}
    for k, (shape, dtype) in struct.items():
        a = glob["emb"][k]
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"emb[{k!r}] is {a.dtype} {tuple(a.shape)}, the config needs "
                             f"{dtype} {shape}")
        emb[k] = a[s * R:(s + 1) * R].to(dev)
    _check_dense(glob["dense"]["hi"], cfg)
    padded = hybrid.padded_dense(cfg, mesh)
    lo = glob["dense"]["lo"]
    if lo.numel() != padded:
        raise ValueError(f"dense lo holds {lo.numel()} values, the config needs {padded}")
    chunk = padded // mesh.size
    lo = lo[mesh.rank * chunk:(mesh.rank + 1) * chunk].to(dev)
    err = glob["dense"].get("err")
    if (err is not None) != resolve_exchange(cfg).needs_err:
        raise ValueError(f"the config's dense state {'has no' if err is not None else 'needs'} "
                         "the error feedback's slab 'err'")
    if err is not None:
        if tuple(err.shape) != (padded,) or err.dtype != torch.float32:
            raise ValueError(f"dense err is {err.dtype} {tuple(err.shape)}, the config needs "
                             f"torch.float32 {(padded,)}")
        err = err[mesh.rank * chunk:(mesh.rank + 1) * chunk].to(dev)
    hi_tree = dp.tree_map(lambda t: t.to(dev), glob["dense"]["hi"])
    _, hi = dp.pack_hi(hi_tree, padded)
    state = {"emb": emb, "dense": {"hi": hi, "lo": lo, "err": err}}
    sr = hybrid.needs_sr(cfg)
    if ("sr" in glob) != sr:
        raise ValueError(f"the {opt.name} state {'needs' if sr else 'has no'} the stochastic "
                         "rounding's seed 'sr'")
    if sr:
        state["sr"] = glob["sr"].to(device=dev, dtype=torch.int32).reshape(())
    want = hybrid.state_struct(cfg, mesh)
    for key in REPLICATED:
        if (key in glob) != (key in want):
            raise ValueError(f"the config's state {'needs' if key in want else 'has no'} "
                             f"{key!r}")
        if key in want:
            state[key] = _replicated(glob[key], want[key], key, dev)
    return state


#: the replicated subtrees of a train state beside ``sr``: the hot-row
#: cache and the step metrics, whole on every rank
REPLICATED = ("cache", "metrics")


def _replicated(tree, struct, key: str, dev):
    """A replicated subtree of CPU tensors, checked against its ``(shape,
    dtype)`` struct, on ``dev``."""
    if isinstance(struct, dict):
        if set(tree) != set(struct):
            raise ValueError(f"{key} holds {sorted(tree)}, the config needs {sorted(struct)}")
        return {k: _replicated(tree[k], struct[k], f"{key}[{k!r}]", dev) for k in struct}
    shape, dtype = struct
    if tuple(tree.shape) != tuple(shape) or tree.dtype != dtype:
        raise ValueError(f"{key} is {tree.dtype} {tuple(tree.shape)}, the config needs {dtype} "
                         f"{tuple(shape)}")
    return tree.to(dev, copy=True)


def state_to_global(state: dict, mesh=None, cfg=None) -> dict:
    """The port's train state -> the reference's global arrays as CPU tensors
    (copies: the step updates the state in place).  On a ``mesh`` of more
    than one rank (every rank calls it, with ``cfg``: it is a collective)
    the shards are all-gathered: the embedding slabs over the embedding
    axes, ``lo`` and ``err`` over the mesh; a gloo group gathers the shards' host
    copies, which its payloads cross anyway.  :func:`state_from_global` of
    the result gives the state back, bit for bit."""
    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True).contiguous()

    err = state["dense"].get("err")
    if mesh is None or mesh.size == 1:
        emb = {k: host(v) for k, v in state["emb"].items()}
        lo = host(state["dense"]["lo"])
        err = None if err is None else host(err)
    else:
        from repro_torch.core import pipeline
        from repro_torch.dist import comm
        if cfg is None:
            raise ValueError("gathering a sharded state needs its config")

        def gather(t: torch.Tensor, g) -> torch.Tensor:
            # a group of one rank hands its operand back: gather a copy then
            t = t.detach().contiguous()
            return comm.all_gather(host(t) if g.stages(t) or g.pg is None else t, g).cpu()

        g_emb = mesh.group(pipeline.emb_axes(cfg, mesh)[0])
        emb = {k: gather(v, g_emb) for k, v in state["emb"].items()}
        lo = gather(state["dense"]["lo"], mesh.group(mesh.axis_names))
        err = None if err is None else gather(err, mesh.group(mesh.axis_names))
    out = {"emb": emb, "dense": {"hi": dp.tree_map(host, state["dense"]["hi"]), "lo": lo,
                                 "err": err}}
    if "sr" in state:
        out["sr"] = host(state["sr"])
    for key in REPLICATED:
        if key in state:
            out[key] = dp.tree_map(host, state[key])
    return out


def global_like(cfg, mesh=None) -> dict:
    """``meta`` tensors of the shapes and dtypes of the reference's global
    train state of ``cfg`` on ``mesh`` (None: one rank), the tree
    :func:`state_to_global` gives: a checkpoint's restore target."""
    from repro_torch.core import hybrid
    from repro_torch.launch.mesh import resolve_mesh

    cfg = hybrid.as_hybrid(cfg)
    mesh = resolve_mesh(mesh, "cpu")
    struct = hybrid.state_struct(cfg, mesh)
    struct["emb"] = row_optim.resolve(cfg).store_struct(hybrid.make_layout(cfg, mesh).total_rows,
                                                        cfg.spec.dim,
                                                        counters=hybrid.hot_rows(cfg) > 0)
    struct["dense"]["lo"] = ((hybrid.padded_dense(cfg, mesh),), torch.int16)
    if struct["dense"]["err"] is not None:
        struct["dense"]["err"] = ((hybrid.padded_dense(cfg, mesh),), torch.float32)

    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        if isinstance(t, list):
            return [meta(v) for v in t]
        return None if t is None else torch.empty(t[0], dtype=t[1], device="meta")
    return meta(struct)


def reshard_global(glob: dict, cfg, old_mesh, new_mesh) -> dict:
    """The global train state of ``old_mesh`` (CPU tensors or numpy arrays,
    as a checkpoint restores them) laid out for ``new_mesh``: the embedding
    store by ``checkpoint.reshard_store`` between the two meshes' layouts,
    the dense ``lo`` by ``checkpoint.reshard_dense``; ``sr`` as it is.  An
    elastic restart (``examples/elastic_restart_torch.py``): every value
    keeps its bits.  The hot-row cache and the step metrics are keyed on
    gids, not on positions, and go across as they are.  A mesh here stands for its shape alone; a
    ``launch.mesh.Mesh`` of the old shape with no process group does."""
    from repro_torch.checkpoint.manager import reshard_dense, reshard_store
    from repro_torch.core import hybrid
    from repro_torch.dist.exchange import resolve_exchange

    out = dict(glob)
    out["emb"] = reshard_store(hybrid.make_layout(cfg, old_mesh), hybrid.make_layout(cfg, new_mesh),
                               glob["emb"])
    out["dense"] = reshard_dense(glob["dense"], old_mesh.size, new_mesh.size,
                                 resolve_exchange(cfg).num_buckets)
    return out


def state_to_numpy(state: dict, mesh=None, cfg=None) -> dict:
    """:func:`state_to_global` as numpy arrays in the JAX package's types:
    bf16 slabs as ``ml_dtypes.bfloat16`` (the type JAX hands out), int16
    ``lo`` slabs as uint16, fp32 as fp32.  ``state_from_numpy`` of the
    result gives the state back, bit for bit."""
    import ml_dtypes

    def to_np(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if t.dtype == torch.int16:
            return t.numpy().view(np.uint16)
        return t.numpy()

    return dp.tree_map(to_np, state_to_global(state, mesh, cfg))


def state_to(state: dict, device) -> dict:
    """A copy of a train state on ``device``, laid out as
    ``core.hybrid.init_state`` lays it out."""
    dev = resolve_device(device)
    lo = state["dense"]["lo"].to(dev, copy=True)
    leaves = dp.tree_leaves(state["dense"]["hi"])
    hi = dp.tree_unflatten(state["dense"]["hi"], [t.to(dev) for t in leaves])
    # the flat buffer's length: a rank's lo is 1 / ranks of it
    base = leaves[0]._base
    padded = base.numel() if base is not None and base.dtype == torch.bfloat16 else lo.numel()
    err = state["dense"].get("err")
    out = {"emb": {k: v.to(dev, copy=True) for k, v in state["emb"].items()},
           "dense": {"hi": dp.pack_hi(hi, padded)[1], "lo": lo,
                     "err": None if err is None else err.to(dev, copy=True)}}
    if "sr" in state:
        out["sr"] = state["sr"].to(dev, copy=True)
    for key in REPLICATED:
        if key in state:
            out[key] = dp.tree_map(lambda t: t.to(dev, copy=True), state[key])
    return out


def _cut_lm(tree: dict, cfg: tf.TransformerConfig, mesh) -> dict:
    """Each leaf of a parameter-shaped tree (or a state's ``{"hi", "lo",
    "mom"}`` of them) cut to the rank's block, as contiguous copies."""
    from repro_torch.dist import sharding as shd
    cut = shd.lm_leaf_cut(cfg, mesh)

    def walk(t, keys):
        if isinstance(t, dict):
            return {k: walk(v, keys + (k,)) for k, v in t.items()}
        return cut(t, keys)

    if set(tree) <= {"hi", "lo", "mom"}:
        return {k: walk(v, ()) for k, v in tree.items()}
    return walk(tree, ())


def lm_params_from_numpy(params_np: dict, cfg: tf.TransformerConfig, device="cuda",
                         mesh=None) -> dict:
    """The reference's LM parameter tree as numpy arrays, in bf16
    (``jax.tree.map(np.asarray, params)`` of the serving step's params) ->
    the port's serving parameters on ``device``, bit for bit; with a
    ``mesh`` of more than one rank the rank's block of each leaf on the
    mesh's device."""
    if mesh is not None and mesh.size > 1:
        whole = lm_params_from_numpy(params_np, cfg, "cpu")
        return dp.tree_map(lambda t: t.to(mesh.device), _cut_lm(whole, cfg, mesh))
    dev = resolve_device(device)

    def walk(tree, structs, path):
        if set(tree) != set(structs):
            raise ValueError(f"params{path} holds {sorted(tree)}, the config needs "
                             f"{sorted(structs)}")
        out = {}
        for k, want in structs.items():
            if isinstance(want, dict):
                out[k] = walk(tree[k], want, f"{path}[{k!r}]")
                continue
            t = to_torch(tree[k], dev)
            if tuple(t.shape) != want[0] or t.dtype != want[1]:
                raise ValueError(f"params{path}[{k!r}] is {t.dtype} {tuple(t.shape)}, the "
                                 f"config needs {want[1]} {want[0]}")
            out[k] = t
        return out

    return walk(params_np, lm_steps.param_structs(cfg), "")


def lm_state_from_numpy(state_np: dict, cfg: tf.TransformerConfig, device="cuda",
                        mesh=None) -> dict:
    """The reference's LM training state as numpy arrays
    (``jax.tree.map(np.asarray, state)`` of ``init_lm_state``'s or a train
    step's: ``hi`` bf16, ``lo`` uint16, ``mom`` fp32 where present) -> the
    port's on ``device``, bit for bit, ``lo`` as its int16 bits; with a
    ``mesh`` of more than one rank the rank's blocks (copies) on the mesh's
    device."""
    if mesh is not None and mesh.size > 1:
        return lm_state_from_global(lm_state_from_numpy(state_np, cfg, "cpu"), cfg, mesh)
    dev = resolve_device(device)
    want = lm_steps.lm_state_structs(cfg, momentum="mom" in state_np)

    def walk(tree, structs, path):
        if set(tree) != set(structs):
            raise ValueError(f"state{path} holds {sorted(tree)}, the config needs "
                             f"{sorted(structs)}")
        out = {}
        for k, w in structs.items():
            if isinstance(w, dict):
                out[k] = walk(tree[k], w, f"{path}[{k!r}]")
                continue
            t = to_torch(tree[k], dev)
            if tuple(t.shape) != w[0] or t.dtype != w[1]:
                raise ValueError(f"state{path}[{k!r}] is {t.dtype} {tuple(t.shape)}, the config "
                                 f"needs {w[1]} {w[0]}")
            out[k] = t
        return out

    return walk(state_np, want, "")


def lm_state_to_numpy(state: dict) -> dict:
    """A port LM training state -> numpy trees in the reference's types
    (``hi`` as ``ml_dtypes.bfloat16``, ``lo`` as uint16, ``mom`` fp32)."""
    import ml_dtypes

    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if t.dtype == torch.int16:
            return t.numpy().view(np.uint16)
        return t.numpy()

    return dp.tree_map(to_np, state)


def lm_state_to_global(state: dict, mesh, cfg: tf.TransformerConfig) -> dict:
    """A mesh's LM training state (the rank's blocks) -> the whole state as
    CPU tensors of the same types, gathered by each leaf's spec: every rank
    of the mesh must call it, and every rank gets the whole state.  A
    one-rank state is copied."""
    from repro_torch.dist import sharding as shd
    if mesh is None or mesh.size == 1:
        return dp.tree_map(lambda t: t.detach().to("cpu", copy=True), state)
    specs = shd.lm_config_specs(cfg)

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(v, spec[k]) for k, v in t.items()}
        return shd.gather_block(t.detach(), spec, mesh).to("cpu", copy=True)

    return {k: walk(v, specs) for k, v in state.items()}


def lm_global_like(cfg: tf.TransformerConfig, momentum: bool = True) -> dict:
    """Zeros of the whole LM training state's shapes and types on the CPU:
    a checkpoint's restore target on a mesh."""
    return {k: _zeros_like_structs(tree)
            for k, tree in lm_steps.lm_state_structs(cfg, momentum).items()}


def _zeros_like_structs(tree: dict) -> dict:
    return {k: _zeros_like_structs(v) if isinstance(v, dict) else torch.zeros(v[0], dtype=v[1])
            for k, v in tree.items()}


def lm_state_from_global(glob: dict, cfg: tf.TransformerConfig, mesh=None, *,
                         device="cuda") -> dict:
    """The whole LM training state (CPU tensors, :func:`lm_state_to_global`'s
    or a checkpoint's) -> the rank's blocks on the mesh's device (a mesh of
    any shape: an elastic restore cuts again), or the whole state on
    ``device`` where ``mesh`` is None or one rank; always copies."""
    if mesh is None or mesh.size == 1:
        dev = mesh.device if mesh is not None else resolve_device(device)
        return dp.tree_map(lambda t: t.to(dev, copy=True), glob)
    return dp.tree_map(lambda t: t.to(mesh.device), _cut_lm(glob, cfg, mesh))


def init_lm_params(cfg: tf.TransformerConfig, generator: torch.Generator, device="cuda",
                   mesh=None) -> dict:
    """Port-native serving parameters in bf16, drawn on ``device``
    (``generator`` must live there) by
    :func:`repro_torch.models.transformer.init_params`; with a ``mesh`` of
    more than one rank each leaf is cut to the rank's block as it is drawn
    (the one-rank draw's blocks, no rank holding the whole model)."""
    if mesh is None or mesh.size == 1:
        return tf.init_params(cfg, generator, device)
    from repro_torch.dist import sharding as shd
    return tf.init_params(cfg, generator, mesh.device, cut=shd.lm_leaf_cut(cfg, mesh))


def lm_params_to(params: dict, device) -> dict:
    """A copy of an LM parameter tree on ``device``."""
    dev = resolve_device(device)
    return dp.tree_map(lambda t: t.to(dev, copy=True), params)


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of numpy arrays (fp32, bf16 or uint16) -> the same
    tree of tensors on ``device``, bit for bit."""
    dev = resolve_device(device)
    return dp.tree_map(lambda a: to_torch(a, dev), tree)


def split_state_from_numpy(state_np, device="cuda"):
    """The reference's ``optim.split_sgd.SplitSGDState`` as numpy arrays
    (``jax.tree.map(np.asarray, state)``: ``params.hi`` bf16 and
    ``params.lo`` uint16 trees, ``momentum`` an fp32 tree or None) -> the
    port's ``SplitSGDState`` on ``device`` (``lo`` as its int16 bits)."""
    from repro_torch.optim import split_sgd
    mom = state_np.momentum
    return split_sgd.SplitSGDState(
        split_sgd.SplitParams(params_from_numpy(state_np.params.hi, device),
                              params_from_numpy(state_np.params.lo, device)),
        None if mom is None else params_from_numpy(mom, device))


def split_state_to_numpy(state) -> dict:
    """A port ``SplitSGDState`` -> ``{"hi", "lo", "momentum"}`` numpy trees
    in the reference's types (bf16 as ``ml_dtypes.bfloat16``, ``lo`` as
    uint16, ``momentum`` fp32 or None)."""
    import ml_dtypes

    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if t.dtype == torch.int16:
            return t.numpy().view(np.uint16)
        return t.numpy()

    return {"hi": dp.tree_map(to_np, state.params.hi), "lo": dp.tree_map(to_np, state.params.lo),
            "momentum": dp.tree_map(to_np, state.momentum)}


def _egnn_walk(tree, structs, path: str, dev, dtype=None):
    """``tree`` (numpy leaves) checked against ``structs`` (``(shape,
    dtype)`` leaves; ``dtype`` in place of theirs where given) and copied to
    ``dev``."""
    if isinstance(structs, (dict, list)):
        keys = sorted(structs) if isinstance(structs, dict) else range(len(structs))
        have = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        if list(keys) != list(have):
            raise ValueError(f"{path} holds {list(have)}, the config needs {list(keys)}")
        out = {k: _egnn_walk(tree[k], structs[k], f"{path}[{k!r}]", dev, dtype) for k in keys}
        return out if isinstance(structs, dict) else [out[i] for i in keys]
    shape, want = structs
    t = to_torch(np.array(tree, copy=True), dev)
    if tuple(t.shape) != tuple(shape) or t.dtype != (dtype or want):
        raise ValueError(f"{path} is {t.dtype} {tuple(t.shape)}, the config needs "
                         f"{dtype or want} {tuple(shape)}")
    return t


def egnn_params_from_numpy(params_np: dict, cfg, device="cuda") -> dict:
    """The reference's fp32 EGNN parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, init_egnn_params(key, cfg))``) -> the same
    tree on ``device``, bit for bit."""
    from repro_torch.models import egnn_steps
    return _egnn_walk(params_np, egnn_steps.egnn_state_structs(cfg)["hi"], "params",
                      resolve_device(device), torch.float32)


def egnn_state_from_numpy(state_np: dict, cfg, device="cuda") -> dict:
    """The reference's EGNN train state as numpy arrays (``hi`` bf16, ``lo``
    uint16) -> the port's ``{"hi", "lo"}`` on ``device``, bit for bit, ``lo``
    as its int16 bits; copies, so that the port's in-place steps leave
    ``state_np`` as it was."""
    from repro_torch.models import egnn_steps
    return _egnn_walk(state_np, egnn_steps.egnn_state_structs(cfg), "state",
                      resolve_device(device))


def egnn_state_to_numpy(state: dict) -> dict:
    """A port EGNN state -> numpy trees in the reference's types (``hi`` as
    ``ml_dtypes.bfloat16``, ``lo`` as uint16)."""
    return lm_state_to_numpy(state)
