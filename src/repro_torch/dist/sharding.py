"""Placement policy: Megatron-style TP + FSDP specs for LM trees (twin of
``repro/dist/sharding.py``).

Mesh convention (shared with ``core.hybrid`` and ``core.pipeline``): the
LAST mesh axis is ``model``; every other axis is data-parallel.  Policies:

* ``tp``: Megatron tensor parallel.  Column-parallel projections shard the
  OUTPUT dim over ``model`` (wq/wk/wv/wg/wu, unembed), row-parallel ones the
  INPUT dim (wo, wd), so each pair needs one collective.  The embedding is
  vocab-parallel (``model`` on the vocab dim).
* ``fsdp``: ZeRO-3 style weight sharding over the DATA axes (over the FULL
  mesh when tp is off), on the matmul input dim.
* MoE expert weights keep expert-parallel placement over the data axes and
  TP over the FFN dim whatever the dense policy.
* Norm/bias vectors and routers are replicated.

A spec is a plain tuple, one entry a dim: an axis name, a tuple of axis
names (their product shards the dim, first axis major), or None
(replicated); a spec shorter than its leaf leaves the remaining dims
replicated.  The reference's ``PartitionSpec`` trees become these tuples;
there is no ``NamedSharding``: a rank holds its block of each leaf
(:func:`local_block`), and the collectives that compute with the blocks
are ``dist.comm``'s (``models/transformer.py``'s mesh path);
:func:`gather_block` puts a leaf back together.  :func:`shard_shape` gives a
leaf's per-rank shape under a spec, each sharded dim rounded up as XLA pads
a dim that does not divide (the dry run's byte counts); a block that is cut
or gathered must divide.

Leaves are classified by their dict key (``wq``/``wo``/``embed``/...);
leading stack dims (layers, experts) stay unsharded.
"""

from __future__ import annotations

import math

import torch

MODEL = "model"

_ROW = frozenset({"wo", "wd"})           # row-parallel: model on input dim
_REPLICATED = frozenset({"router"})


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def batch_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: every mesh axis except ``model``."""
    return tuple(a for a in mesh.axis_names if a != MODEL)


def leaf_shape(leaf) -> tuple:
    """The shape of a tree's leaf: a tensor, a ``(shape, dtype)`` struct or
    a shape."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if len(leaf) == 2 and isinstance(leaf[0], tuple) and isinstance(leaf[1], torch.dtype):
        return leaf[0]
    return tuple(leaf)


def lm_param_specs(params, fsdp: bool = True, tp: bool = True):
    """The spec tree of an LM param tree (module docstring): ``params`` a
    nested dict whose leaves are tensors, ``(shape, dtype)`` structs or
    shapes (``models.transformer.param_shapes``)."""
    def spec(keys: list, leaf) -> tuple:
        n = len(leaf_shape(leaf))
        name = keys[-1] if keys else ""
        if name in _REPLICATED or "norm" in name or name.startswith("ln"):
            return (None,) * n
        if name == "embed":                      # (vocab, d): vocab-parallel
            return (MODEL if tp else None, _fsdp_axis(fsdp, tp) if fsdp else None)
        moe = "moe" in keys and "shared" not in keys
        if moe and name in ("wg", "wu"):         # (..., E, d, f): EP + TP
            return (None,) * (n - 3) + ("data", None, MODEL)
        if moe and name == "wd":                 # (..., E, f, d)
            return (None,) * (n - 3) + ("data", MODEL, None)
        if n < 2:
            return (None,) * n
        lead = (None,) * (n - 2)
        if name in _ROW and tp:
            return lead + (MODEL, "data" if fsdp else None)
        return lead + (_fsdp_axis(fsdp, tp) if fsdp else None, MODEL if tp else None)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [str(k)]) for k, v in tree.items()}
        return spec(keys, tree)

    return walk(params, [])


def lm_config_specs(cfg) -> dict:
    """:func:`lm_param_specs` of an LM config's parameters under its own
    policy (``fsdp``, TP where ``tp_size`` > 1), as the reference's steps
    take them."""
    from repro_torch.models import transformer as tf
    return lm_param_specs(tf.param_shapes(cfg), fsdp=cfg.fsdp, tp=cfg.tp_size > 1)


def lm_state_specs(cfg, momentum: bool = True) -> dict:
    """The spec trees of an LM training state ``{"hi", "lo"[, "mom"]}``, each
    :func:`lm_config_specs` (the reference's ``lm_state_structs``)."""
    specs = lm_config_specs(cfg)
    return {k: specs for k in (("hi", "lo", "mom") if momentum else ("hi", "lo"))}


def lm_leaf_cut(cfg, mesh):
    """``cut(t, keys)``: the rank's block of the LM parameter leaf at path
    ``keys`` (a contiguous copy), for ``models.transformer.init_params``."""
    specs = lm_config_specs(cfg)

    def cut(t, keys):
        spec = specs
        for k in keys:
            spec = spec[k]
        return local_block(t, spec, mesh, "/".join(keys)).clone(
            memory_format=torch.contiguous_format)
    return cut


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _padded(spec, n: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > n:
        raise ValueError(f"spec {spec} has more entries than the leaf has dims ({n})")
    return spec + (None,) * (n - len(spec))


def local_block(t: torch.Tensor, spec, mesh, name: str = "leaf") -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` on
    ``mesh`` (a ``launch.mesh.Mesh``): each sharded dim cut into as many
    blocks as its axes hold ranks, the block at the rank's combined index
    over them (first axis major).  A view where the cut allows; raises
    naming ``name`` where a dim does not divide."""
    from repro_torch.dist.comm import combined_axis_index
    coords = mesh.coords
    for dim, entry in enumerate(_padded(spec, t.dim())):
        n = axis_size(entry, mesh.shape)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not divide over "
                             f"{spec_axes(entry)} ({n} ranks)")
        c = t.shape[dim] // n
        t = t.narrow(dim, combined_axis_index(coords, spec_axes(entry), mesh.shape) * c, c)
    return t


def gather_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of which ``t`` is this rank's block under ``spec``
    (the inverse of :func:`local_block`): one ``dist.comm.all_gather`` over
    each sharded dim's axes.  Every rank of the mesh must call it."""
    from repro_torch.dist import comm
    for dim, entry in enumerate(_padded(spec, t.dim())):
        if axis_size(entry, mesh.shape) == 1:
            continue
        g = mesh.group(spec_axes(entry))
        t = comm.all_gather(t.movedim(dim, 0).contiguous(), g).movedim(0, dim)
    return t.contiguous()


def _fsdp_axis(fsdp: bool, tp: bool):
    """FSDP spans the data axes, or the FULL mesh when TP is off (ZeRO-3
    over every device)."""
    return "data" if tp else ("data", MODEL)


def axis_size(entry, mesh_shape: dict) -> int:
    """The ranks a spec entry shards its dim over (1 for None)."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(mesh_shape[a] for a in names)


def shard_shape(shape, spec, mesh_shape: dict) -> tuple:
    """A leaf's per-rank shape under ``spec`` on a mesh of ``mesh_shape``
    (axis name -> size): each sharded dim divided by its ranks and rounded
    up, as XLA pads a dim that does not divide."""
    shape, spec = tuple(shape), tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape} has dims")
    spec = spec + (None,) * (len(shape) - len(spec))
    return tuple(-(-d // axis_size(e, mesh_shape)) for d, e in zip(shape, spec))


def shard_bytes(shape, dtype: torch.dtype, spec, mesh_shape: dict) -> int:
    """The bytes of one rank's shard of a ``shape`` ``dtype`` leaf."""
    return math.prod(shard_shape(shape, spec, mesh_shape)) * torch.empty((), dtype=dtype).element_size()
