"""Dense data-parallel Split-SGD (twin of ``repro/optim/data_parallel.py``).

The dense state of a rank is ``{"hi": tree, "lo": [padded / ranks] int16,
"err": [padded / ranks] fp32 or None}``: the bf16 upper halves as the
parameter tree the forward reads, replicated, this rank's shard of the lower
halves, and with the ``"bf16"`` dense wire's error feedback this rank's
residual of the last step's rounding (``err``, laid out as ``lo``).  The global
``lo`` is one flat vector in the reference's raveled order, padded to a
multiple of ``ranks * num_buckets`` and laid out bucket-major within each
rank's shard (``to_bucketed_layout``): rank ``s``'s shard is
``[s * padded / ranks, (s + 1) * padded / ranks)``, and holds its chunk of
each bucket in turn.  The port keeps the ``hi`` leaves as views into one
flat bf16 buffer of the padded length, in which bucket ``b``'s chunk of
rank ``s`` sits at natural position ``(b, s)``; the step updates it in
place.

The raveled order is JAX's pytree order: dict keys sorted, list items in
order, so for a DLRM ``bot.b[...]``, ``bot.w[...]``, ``top.b[...]``,
``top.w[...]``.
"""

from __future__ import annotations

import torch

from repro_torch.dist import comm
from repro_torch.dist import exchange
from repro_torch.kernels import ops
from repro_torch.optim.split_sgd import split_fp32


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in JAX's pytree order
    (``None`` is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to each leaf of a tree of dicts, lists and tuples, the
    structure kept (``None`` is an empty subtree and stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves) -> object:
    """A tree shaped like ``tree`` holding ``leaves`` (pytree order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    return build(tree)


def ravel_size(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))


def padded_size(n: int, ranks: int = 1, num_buckets: int = 4) -> int:
    m = ranks * num_buckets
    return -(-n // m) * m


def to_bucketed_layout(flat: torch.Tensor, ns: int, nb: int) -> torch.Tensor:
    """Natural flat layout -> bucket-major-within-shard layout, zero-padded
    to a multiple of ``ns * nb`` (at ``ns = 1``: the padding alone)."""
    padded = torch.cat([flat, flat.new_zeros(padded_size(flat.numel(), ns, nb) - flat.numel())])
    bchunk = padded.numel() // (ns * nb)
    return padded.view(nb, ns, bchunk).transpose(0, 1).reshape(-1)


def _views(flat: torch.Tensor, tree) -> object:
    """``tree`` rebuilt as consecutive views of ``flat``, in pytree order."""
    views, pos = [], 0
    for leaf in tree_leaves(tree):
        views.append(flat[pos:pos + leaf.numel()].view(leaf.shape))
        pos += leaf.numel()
    return tree_unflatten(tree, views)


def pack_hi(hi_tree, padded: int) -> tuple[torch.Tensor, object]:
    """(flat bf16 [padded], the tree as views into it): the leaves copied in
    pytree order, the padding zero."""
    leaves = tree_leaves(hi_tree)
    flat = torch.zeros(padded, dtype=torch.bfloat16, device=leaves[0].device)
    flat[:ravel_size(hi_tree)] = torch.cat([t.reshape(-1).to(torch.bfloat16) for t in leaves])
    return flat, _views(flat, hi_tree)


def flat_hi(hi_tree, padded: int) -> torch.Tensor | None:
    """The flat buffer behind a tree that :func:`pack_hi` made, or None when
    the leaves are not consecutive views of one such buffer."""
    leaves = tree_leaves(hi_tree)
    base = leaves[0]._base
    if base is None or base.dtype != torch.bfloat16 or base.shape != (padded,):
        return None
    pos = 0
    for leaf in leaves:
        if leaf._base is not base or not leaf.is_contiguous() \
                or leaf.data_ptr() != base.data_ptr() + 2 * pos:
            return None
        pos += leaf.numel()
    return base


def dp_global_arrays(params_fp32, ns: int = 1, num_buckets: int = 4,
                     error_feedback: bool = False) -> dict:
    """The reference's global dense arrays from fp32 parameters: ``{"hi":
    tree of bf16 views, "lo": [padded] int16 in the bucketed layout of ``ns``
    ranks, "err": [padded] fp32 zeros with ``error_feedback``, else None}``.
    At ``ns = 1`` this is the one rank's state."""
    flat = torch.cat([t.float().reshape(-1) for t in tree_leaves(params_fp32)])
    hi_flat, lo_flat = split_fp32(flat)
    hi_buf = torch.zeros(padded_size(flat.numel(), ns, num_buckets), dtype=torch.bfloat16,
                         device=flat.device)
    hi_buf[:flat.numel()] = hi_flat
    hi = _views(hi_buf, params_fp32)
    lo = to_bucketed_layout(lo_flat, ns, num_buckets)
    return {"hi": hi, "lo": lo,
            "err": torch.zeros(lo.shape, dtype=torch.float32, device=lo.device)
            if error_feedback else None}


def init_dp_state(params_fp32, ns: int, shard: int, num_buckets: int = 4,
                  error_feedback: bool = False) -> dict:
    """Rank ``shard``'s dense state of ``ns`` ranks: the ``hi`` tree and its
    chunks of :func:`dp_global_arrays`' ``lo`` and ``err``."""
    arrays = dp_global_arrays(params_fp32, ns, num_buckets, error_feedback)
    chunk = arrays["lo"].numel() // ns

    def mine(t):
        return None if t is None else t[shard * chunk:(shard + 1) * chunk].clone()
    return {"hi": arrays["hi"], "lo": mine(arrays["lo"]), "err": mine(arrays["err"])}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where the kernel's 16-byte alignment fails."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rs_ag_split_sgd(state: dict, grads, lr: float, num_buckets: int = 4,
                    group: comm.Group | None = None, wire_dtype: str = "fp32",
                    error_feedback: bool = True, seed=None) -> dict:
    """One dense Split-SGD step over the ranks of ``group`` (None: this rank
    alone), in place.  ``g`` is the raveled gradient in fp32, zero on the
    padding; the reference's ``mean=False``: each rank's gradient is its
    share of the batch's mean loss, so the reduce-scatter sums them.

    ``wire_dtype`` is the reduce-scatter's payload (``dist.exchange``):
    ``"fp32"``; ``"bf16"``, each rank's gradient rounded to nearest, and with
    ``error_feedback`` and an ``err`` slab the fp32 residual of the rank's
    own slice (``own - bf16(own)``) kept in ``err`` and the last step's
    added after the reduce-scatter; ``"bf16_sr"``, rounded under the dither
    of ``seed`` (the state's ``sr``) tagged ``wire_tag(TAG_DENSE, bucket,
    rank)``.  A bf16 payload is summed in fp32 and rounded once
    (``comm.psum_scatter``).

    Bucket by bucket (one bucket at one rank): the reduce-scatter of the
    bucket's gradient (``comm.psum_scatter``, the reference's summation
    order), the Split-SGD kernel on this rank's chunk of ``hi`` and ``lo``,
    and the bf16 all-gather of the new chunks straight into the bucket's
    slice of the flat ``hi`` buffer.  At one rank without a process group
    that is one flat Split-SGD pass over the padded vector, in place (the
    ``bf16_sr`` dither is drawn bucket by bucket all the same).
    ``state["hi"]`` is updated in place when it is :func:`pack_hi`'s views
    (else it is packed first), and ``err`` in place; returns the new state."""
    group = comm.local_group() if group is None else group
    ns = group.size
    lo, err = state["lo"], state.get("err")
    padded = lo.numel() * ns
    want = padded_size(ravel_size(state["hi"]), ns, num_buckets)
    if padded != want:
        raise ValueError(f"lo holds {lo.numel()} values of {ns} ranks, the parameters need "
                         f"{want // ns}")
    ef = wire_dtype == "bf16" and error_feedback and err is not None
    flat = flat_hi(state["hi"], padded)
    hi = state["hi"]
    if flat is None:
        flat, hi = pack_hi(hi, padded)
    n = ravel_size(hi)
    g = torch.cat([t.reshape(-1).float() for t in tree_leaves(grads)]
                  + [torch.zeros(padded - n, dtype=torch.float32, device=lo.device)])
    s = group.index
    if wire_dtype == "bf16_sr":  # each of the reference's buckets its own dither stream
        rlen = padded // num_buckets
        wire = torch.cat([exchange.wire_encode(g[b * rlen:(b + 1) * rlen], wire_dtype, seed,
                                               exchange.wire_tag(exchange.TAG_DENSE, b, s))
                          for b in range(num_buckets)])
    else:
        wire = exchange.wire_encode(g, wire_dtype)
    nb = num_buckets if ns > 1 else 1
    blen = padded // nb
    bchunk = blen // ns
    for b in range(nb):
        gsh = exchange.wire_decode(comm.psum_scatter(wire[b * blen:(b + 1) * blen], group))
        if ef:
            own = g[b * blen + s * bchunk:b * blen + (s + 1) * bchunk]
            eb = err[b * bchunk:(b + 1) * bchunk]
            gsh = gsh + eb
            eb.copy_(own - own.to(torch.bfloat16).float())
        hib = flat[b * blen + s * bchunk:b * blen + (s + 1) * bchunk]
        if group.pg is not None:
            hib = hib.clone()  # the all-gather's source must not lie in its destination
        lob = lo[b * bchunk:(b + 1) * bchunk]
        lob_k = _aligned(lob)
        ops.split_sgd(hib, lob_k, gsh, lr)
        if lob_k is not lob:
            lob.copy_(lob_k)
        comm.all_gather(hib, group, out=flat[b * blen:(b + 1) * blen])
    return {"hi": hi, "lo": lo, "err": err}
