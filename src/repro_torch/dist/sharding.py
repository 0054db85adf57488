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
there is no ``NamedSharding``: the collectives that apply the specs are
``dist.comm``'s (ROADMAP queue 1 item 8).  :func:`shard_shape` gives a
leaf's per-rank shape under a spec, each sharded dim rounded up as XLA pads
a dim that does not divide.

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
