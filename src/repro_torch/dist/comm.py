"""The collectives of the hybrid step over ``torch.distributed`` (the port's
counterpart of the ``jax.lax`` collectives the reference calls inside
``shard_map``).

Each collective runs over a :class:`Group`: the ranks of one mesh axis, or
of a tuple of axes, that share the other coordinates.  A rank's position in
its group is its combined index over the group's axes, first axis major
(:func:`combined_axis_index`), so blocks land where ``jax.lax``'s tiled
collectives put them:

    all_gather(x, g)          jax.lax.all_gather(x, axes, axis=0, tiled=True)
    all_to_all(x, g, s, c)    jax.lax.all_to_all(x, axes, s, c, tiled=True)
    psum_scatter(x, g)        jax.lax.psum_scatter(x, axes, scatter_dimension=0, tiled=True)
    psum(x, g)                jax.lax.psum(x, axes)
    ppermute(x, g)            jax.lax.ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])

No reduction is left to the backend: ``psum_scatter`` is an all-to-all of
the blocks followed by a local sum, and ``psum`` an all-gather followed by
one, each in the order XLA's CPU collectives take on the reference's side
(rank 0's block first, each next rank's added in fp32, the sum rounded to
the payload's type once at the end; bf16 and fp32 payloads alike, held bit
for bit in ``tests/test_torch_comm.py``).  Integer payloads are summed in
their own type, exactly.

Payloads of 16 bits cross as a ``uint8`` view of their bytes (gloo refuses
``int16``), so their bits are kept.  A group whose backend is gloo moves no
CUDA tensor: the payload is copied through pinned host buffers, explicitly,
and :class:`CollectiveStats` times those copies (``staging_s``) apart from
the collective itself (``wire_s``).  What stages is decided by the group's
backend alone.  A group of one rank with no process group (the one-rank
mesh, :func:`local_group`) runs every collective as the identity, with no
copy.

Every call adds its operand's bytes (``bytes_in``, what a rank hands in)
and its result's (``bytes_out``, what the reference's HLO count reads) to
its kind in :class:`CollectiveStats`.

A shape-only group (:func:`shape_group`, the dry run's production meshes of
256 and 512 ranks, ``launch.mesh.make_shape_mesh``) has no process group:
its ``pg`` is the sentinel :data:`SHAPE_ONLY`, never ``None`` (which stays
the one-rank identity of :func:`local_group`).  A collective over it counts
its bytes as a real one does and reaches no backend: it returns what the
collective would if every other rank of the group held zeros.  So a
gather's or an all-to-all's other blocks are zeros (other shards' index
exchanges come back as row 0, the reference's clip row for other shards'
lookups), a sum is this rank's own term, and a ring shift receives zeros.

Under autograd (the EGNN steps, ``models/egnn_steps.py``), the ``_ad``
forms carry the transposes JAX takes inside the reference's
``shard_map(check_vma=False)``: :func:`all_gather_ad`'s backward is
``psum_scatter``, :func:`psum_scatter_ad`'s is ``all_gather``,
:func:`psum_ad`'s is ``psum`` (each summing as above, in XLA's order) and
:func:`all_to_all_ad`'s the inverse ``all_to_all``.
Every rank must run the backward's collectives in one order: the ranks
build the same graph, which the autograd engine walks alike.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-to-all", "reduce-scatter", "all-reduce", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    """Per collective kind: ``calls``, ``bytes_in`` and ``bytes_out``; and
    the host clock spent copying staged payloads (``staging_s``) and in the
    staged collectives (``wire_s``)."""

    calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    bytes_in: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    bytes_out: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    staging_s: float = 0.0
    wire_s: float = 0.0

    def reset(self) -> None:
        for d in (self.calls, self.bytes_in, self.bytes_out):
            for k in d:
                d[k] = 0
        self.staging_s = self.wire_s = 0.0

    def add(self, kind: str, x: torch.Tensor, out: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.bytes_in[kind] += x.numel() * x.element_size()
        self.bytes_out[kind] += out.numel() * out.element_size()

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes_in": dict(self.bytes_in),
                "bytes_out": dict(self.bytes_out), "staging_s": self.staging_s,
                "wire_s": self.wire_s}


class _ShapeOnly:
    """The ``pg`` of a shape-only group: no process group behind it."""

    def __repr__(self) -> str:
        return "SHAPE_ONLY"


SHAPE_ONLY = _ShapeOnly()


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks of the mesh axes ``axes`` that share the other coordinates:
    ``size`` of them, this rank at ``index``; ``pg`` their process group, or
    None for a group of one rank that runs its collectives locally, or
    :data:`SHAPE_ONLY` for a group of a shape-only mesh."""

    axes: tuple
    size: int
    index: int
    pg: Optional[object]
    stats: CollectiveStats

    @property
    def shape_only(self) -> bool:
        return self.pg is SHAPE_ONLY

    @property
    def backend(self) -> Optional[str]:
        if self.pg is None or self.shape_only:
            return None
        return str(dist.get_backend(self.pg))

    def stages(self, x: torch.Tensor) -> bool:
        """Whether a collective of ``x`` goes through pinned host buffers:
        a gloo group and a CUDA tensor."""
        return x.is_cuda and self.backend == "gloo"


def local_group() -> Group:
    """A group of this rank alone with no process group: every collective
    over it is the identity."""
    return Group((), 1, 0, None, CollectiveStats())


def shape_group(axes: tuple, size: int, index: int, stats: CollectiveStats) -> Group:
    """A group of ``size`` ranks, this one at ``index``, with no process
    group: its collectives count their bytes and return what they would if
    every other rank held zeros (module docstring)."""
    return Group(tuple(axes), size, index, SHAPE_ONLY, stats)


def _own_block(shape: tuple, x: torch.Tensor, dim: int, index: int) -> torch.Tensor:
    """Zeros of ``shape`` (``x``'s type and device) with ``x`` as block
    ``index`` along ``dim``: a gather's result where every other rank held
    zeros."""
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    c = x.shape[dim]
    out.narrow(dim, index * c, c).copy_(x)
    return out


def combined_axis_index(coords: dict, axes, shape: dict) -> int:
    """The index of a rank at ``coords`` over the mesh axes ``axes`` (a name
    or a tuple of names), first axis major: the order in which a ``P(axes)``
    sharding lays out blocks (``repro/optim/data_parallel.py``)."""
    idx = 0
    for a in (tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)):
        idx = idx * shape[a] + int(coords[a])
    return idx


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat view of a contiguous tensor, 16-bit types as ``uint8``."""
    flat = t.reshape(-1)
    return flat.view(torch.uint8) if t.element_size() == 2 else flat


def _gather_fn():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _run(fn, out: torch.Tensor, x: torch.Tensor, g: Group) -> torch.Tensor:
    """``fn(out, x, group=g.pg)`` on the byte views of contiguous ``out`` and
    ``x``, staged through pinned host memory when ``g`` says so."""
    if not g.stages(x):
        fn(_bytes(out), _bytes(x), group=g.pg)
        return out
    torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    h_in = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h_in.copy_(x)
    h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    t1 = time.perf_counter()
    fn(_bytes(h_out), _bytes(h_in), group=g.pg)
    t2 = time.perf_counter()
    out.copy_(h_out)
    t3 = time.perf_counter()
    g.stats.staging_s += (t1 - t0) + (t3 - t2)
    g.stats.wire_s += t2 - t1
    return out


def _check(x: torch.Tensor, g: Group, dim: int = 0) -> None:
    if x.dim() <= dim or x.shape[dim] % g.size:
        raise ValueError(f"a tiled collective over {g.size} ranks needs dim {dim} of "
                         f"{tuple(x.shape)} divisible by {g.size}")


def all_gather(x: torch.Tensor, g: Group, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group order, into
    ``out`` (contiguous, ``[size * x.shape[0], ...]``) where given.  At one
    rank without a process group ``out`` may be ``x``'s own memory, and
    nothing is copied."""
    x = x.contiguous()
    shape = (g.size * x.shape[0],) + tuple(x.shape[1:])
    if out is not None and (tuple(out.shape) != shape or out.dtype != x.dtype
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x.dtype} {shape}")
    if g.shape_only:
        got = _own_block(shape, x, 0, g.index)
        out = got if out is None else out.copy_(got)
    else:
        if out is None:
            out = x if g.pg is None else torch.empty(shape, dtype=x.dtype, device=x.device)
        if g.pg is not None:
            _run(_gather_fn(), out, x, g)
        elif out.data_ptr() != x.data_ptr():
            out.copy_(x)
    g.stats.add("all-gather", x, out)
    return out


def _exchange_blocks(blocks: torch.Tensor, g: Group) -> torch.Tensor:
    """``blocks`` [size, ...]: block ``j`` goes to rank ``j``; returns
    [size, ...] with rank ``j``'s block for this rank at ``j``."""
    return _run(dist.all_to_all_single, torch.empty_like(blocks), blocks, g)


def all_to_all(x: torch.Tensor, g: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``x`` cut into ``size`` blocks along ``split_axis``, block ``j`` sent
    to rank ``j``, the blocks received concatenated along ``concat_axis`` in
    group order."""
    _check(x, g, split_axis)
    if g.pg is None:
        out = x
    elif g.shape_only:
        mine = x.chunk(g.size, dim=split_axis)[g.index]
        shape = list(mine.shape)
        shape[concat_axis] *= g.size
        out = _own_block(tuple(shape), mine, concat_axis, g.index)
    else:
        got = _exchange_blocks(torch.stack(x.chunk(g.size, dim=split_axis)).contiguous(), g)
        out = torch.cat(got.unbind(0), dim=concat_axis) if g.size > 1 else got[0]
    g.stats.add("all-to-all", x, out)
    return out


def _ordered_sum(blocks: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``blocks[0] + blocks[1] + ...`` in that order: floats in fp32, rounded
    to ``dtype`` once; integers in their own type, exactly (wrapping as
    ``jax.lax.psum`` of int32 does), since fp32 holds no integer above 2^24
    (the hot-row cache sums the bit patterns of float rows)."""
    exact = not (dtype.is_floating_point or dtype.is_complex)
    acc = blocks[0].clone() if exact else blocks[0].float()
    for j in range(1, blocks.shape[0]):
        acc = acc + (blocks[j] if exact else blocks[j].float())
    return acc.to(dtype)


def psum_scatter(x: torch.Tensor, g: Group) -> torch.Tensor:
    """The sum over the group of ``x``, cut along dim 0 into ``size`` blocks,
    this rank's block returned: an all-to-all of the blocks, then their sum
    in group order (:func:`_ordered_sum`)."""
    _check(x, g)
    if g.pg is None:
        out = x
    elif g.shape_only:
        out = x.contiguous().chunk(g.size)[g.index].clone()
    else:
        got = _exchange_blocks(x.contiguous().view((g.size, x.shape[0] // g.size)
                                                   + tuple(x.shape[1:])), g)
        out = _ordered_sum(got, x.dtype)
    g.stats.add("reduce-scatter", x, out)
    return out


def psum(x: torch.Tensor, g: Group) -> torch.Tensor:
    """The sum over the group of ``x``, on every rank: an all-gather, then
    the sum in group order (:func:`_ordered_sum`)."""
    x = x.contiguous()
    if g.pg is None:
        out = x
    elif g.shape_only:
        out = x.clone()
    else:
        stacked = torch.empty((g.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        _run(_gather_fn(), stacked, x[None], g)
        out = _ordered_sum(stacked, x.dtype)
    g.stats.add("all-reduce", x, out)
    return out


def _shift(g: Group):
    """``fn(out, x, group)``: ``x`` sent to the next rank of ``g`` (index + 1,
    cyclically) and the previous rank's received into ``out``, one batched
    isend / irecv."""
    nxt = dist.get_global_rank(g.pg, (g.index + 1) % g.size)
    prv = dist.get_global_rank(g.pg, (g.index - 1) % g.size)

    def fn(out, x, group):
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt, group),
                                           dist.P2POp(dist.irecv, out, prv, group)]):
            req.wait()
    return fn


def ppermute(x: torch.Tensor, g: Group) -> torch.Tensor:
    """A shift of one along the group's ring: ``x`` goes to the rank at
    index + 1 (the last to the first), and the rank at index - 1's comes
    back."""
    x = x.contiguous()
    if g.pg is None:
        out = x
    elif g.shape_only:
        out = torch.zeros_like(x)
    else:
        out = _run(_shift(g), torch.empty_like(x), x, g)
    g.stats.add("collective-permute", x, out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_gather(x, g)

    @staticmethod
    def backward(ctx, gy):
        return psum_scatter(gy.contiguous(), ctx.g), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return psum_scatter(x, g)

    @staticmethod
    def backward(ctx, gy):
        return all_gather(gy.contiguous(), ctx.g), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_axis, concat_axis):
        ctx.g, ctx.axes = g, (split_axis, concat_axis)
        return all_to_all(x, g, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, gy):
        split_axis, concat_axis = ctx.axes
        return all_to_all(gy.contiguous(), ctx.g, concat_axis, split_axis), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return psum(x, g)

    @staticmethod
    def backward(ctx, gy):
        return psum(gy.contiguous(), ctx.g), None


def all_gather_ad(x: torch.Tensor, g: Group) -> torch.Tensor:
    """:func:`all_gather` under autograd, its backward :func:`psum_scatter`."""
    return _AllGather.apply(x, g)


def psum_scatter_ad(x: torch.Tensor, g: Group) -> torch.Tensor:
    """:func:`psum_scatter` under autograd, its backward :func:`all_gather`."""
    return _PsumScatter.apply(x, g)


def all_to_all_ad(x: torch.Tensor, g: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """:func:`all_to_all` under autograd, its backward the inverse
    ``all_to_all`` (``concat_axis`` split, ``split_axis`` concatenated): the
    transpose of ``jax.lax.all_to_all`` in the reference's MoE
    ``shard_map``."""
    return _AllToAll.apply(x, g, split_axis, concat_axis)


def psum_ad(x: torch.Tensor, g: Group) -> torch.Tensor:
    """:func:`psum` under autograd, its backward :func:`psum`: the transpose
    JAX takes of ``psum`` under ``shard_map(check_vma=False)``, which makes
    a step whose every rank seeds the same psum'd loss apply N times its
    one-rank gradient at N ranks (``models/egnn_steps.py::grad_psum``)."""
    return _Psum.apply(x, g)
