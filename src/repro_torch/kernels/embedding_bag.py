"""EmbeddingBag-sum forward on Hopper (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``repro/kernels/embedding_bag.py::_kernel`` (via
``embedding_bag_pallas``), extended by the validity mask of the reference's
``_partial_bag_masked`` (``repro/core/sharded_embedding.py``) so that the
serving forward runs on it: a lookup outside ``[0, rows_per_shard)`` adds
zero; by the reference's per-lookup weights (``weighted=True``): a weighted
variant adds ``w_p * W[g_p]``; and, in :func:`embedding_bag_stage`, by the
rest of the reference's row-mode bag stage (``row_sharded_bag_fwd``): the
per-slot row offset added to the table-local ids, and each sum rounded to
bf16 as the reduce-scatter wire rounds it, both inside the one launch.

What bounds it: on a skewed stream, the instructions a bag takes, most of
all the shared-memory, shuffle and match instructions (one pipe of the SM).
Zipf(1.05) ids send half of a table's lookups to its row 0, so a bag of 50
lookups holds about 11 distinct rows, and a batch's 3.3 M lookups touch
some 7,700 rows, which L1 and L2 hold: an earlier kernel that read and added
every lookup's row in order (one warp a bag, its rows spread over four lane
groups whose sums met in shuffles) took as long with every row read from
row 0, and 0.63 times as long with no row read at all
(``tools/ablate_bag.py``).  On uniform ids nearly every row is distinct and
the kernel is bound by device-memory bytes: random 128-byte rows.

Design: bags go in slot-major order, so the warps at work at one time read
one table (an SM's L1 holds its hot rows; a shared-memory carve-out hint
that left L1 more room measured neither faster nor slower, and went).  A
row is read by E/8 lanes (bf16; E/4 fp32) with 16-byte loads, at least 8
(a narrower row leaves lanes idle), so at E = 64 a warp has four groups of
8 lanes, and a warp sums four bags, one a group: no sum crosses lanes.
The warp loads its bags' ids 64 a bag at a time (all loads in flight before any is used), adds the
slot's row offset, drops ids outside the row space, and lists each bag's
distinct rows in shared memory a 32-id word at a time: ``__match_any_sync``
finds the equal ids, and the lowest lane of each set enters its row once
with the set's size (or the sum of its weights, in lane order, every lane
reading the word's 32 weights back as eight float4s) as coefficient.  A row
in both words of a bag enters twice: a search across the words cost more
than the extra row read.  Then each group reads its bag's listed rows once,
four loads in flight a lane, and adds ``coef * row`` with one FMA a value.
A small batch (fewer than 32 warps an SM at four bags a warp) runs one bag a
warp instead, its entries spread over the four groups, whose sums meet in a
butterfly of shuffles: the shortest chain (at dlrm-small's buckets 0.62
times the time of four bags a warp; at B = 8192 1.4 times).  Each sum is optionally rounded
to bf16 (to nearest even, as ``Tensor.to(torch.bfloat16)``) and written once
with 16-byte stores.  Row addresses are computed in int64.  The launcher
asks the runtime for the SM count once a device.

Any width.  A row that is no whole number of 16-byte chunks (the recsys
archetypes' E = 11, 18, 50 in bf16) or a table that starts off a 16-byte
boundary (a view) takes a narrow path, each bag's lookups added in order as
the plain version adds them (a bag of one lookup, the archetypes' P = 1,
gives its bits).  Its first version, one thread a value of the output, was
bound by integer work and loads a value, not by bytes: a 64-bit ``t / E``
and ``j % S`` a value and E threads loading each bag's id and slot offset
(without the id and offset loads it took 0.57 times as long at E = 11,
without any stores 0.97 times; ``tools/ablate_bag.py --only narrow``).  The
narrow path now gives a warp 32 consecutive bags: lane t loads bag t's ids,
weights and slot offset (one 32-bit ``j % S`` a bag) and hands them on by
shuffle to a group of lanes that reads the bag's rows, two bf16 values (or
one fp32) a lane, so that at E = 11 four bags share a warp in each of eight
rounds, four rounds' loads in flight.  A bf16 row starts on a 2-byte
boundary: a lane reads the aligned 4-byte word that holds its first value
and, where the row starts odd, the next, and shifts its pair out of them
(every word read holds a byte of the row: no read leaves the table).  The
round's outputs, one run of G * E floats, go out through shuffles so that
consecutive lanes write consecutive addresses.  No division a value; index
arithmetic in 32 bits but the row address.  The store is never padded: a
padded copy of FM's 4.1 GB ``hi`` slab a step would cost more than the
bags.

Numbers: the sum of a bag is now ``sum_r coef_r * W[r]`` in list order and
not the lookups' in-order sum, so it rounds differently from the plain
version (within the tolerances held on the card).  The weighted and the
unweighted kernel share the arithmetic and the order, and all-ones weights
sum to the exact counts, so they give the unweighted kernel's bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

plain = ref.embedding_bag
plain_stage = ref.embedding_bag_stage

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                 ctypes.c_void_p]


def _check(W: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor | None) -> None:
    if weights is not None and (weights.shape != idx.shape or weights.dtype != torch.float32
                                or weights.device != idx.device):
        raise ValueError(f"need fp32 weights of the shape of the ids {tuple(idx.shape)} on their "
                         f"device, got {weights.dtype} {tuple(weights.shape)} on {weights.device}")
    if W.ndim != 2 or idx.ndim != 3:
        raise ValueError(f"need W [rows, E] and ids [B, S, P], got {tuple(W.shape)}, "
                         f"{tuple(idx.shape)}")
    if W.dtype not in (torch.bfloat16, torch.float32) or idx.dtype != torch.int32:
        raise TypeError(f"need a bf16 or fp32 table and int32 rows, got {W.dtype}, {idx.dtype}")
    if W.device != idx.device:
        raise ValueError(f"W on {W.device}, ids on {idx.device}")


def _launch(W, idx, offsets, weights, rows_per_shard: int, round_bf16: bool,
            layout_bags: int | None = None) -> torch.Tensor:
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    B, S, P = idx.shape
    E = W.shape[1]
    if rows_per_shard > W.shape[0]:
        raise ValueError(f"rows_per_shard {rows_per_shard} exceeds the table's {W.shape[0]} rows")
    if not (W.is_contiguous() and idx.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("W, the ids and the weights must be contiguous")
    if B * S >= 2 ** 31:
        raise ValueError(f"the kernel numbers bags in 32 bits: {B} x {S} bags are too many")
    out = torch.empty((B, S, E), dtype=torch.float32, device=W.device)
    if B * S == 0:
        return out
    fn = build.function("embedding_bag", "embedding_bag_fwd", _ARGS)
    with torch.cuda.device(W.device):
        err = fn(W.data_ptr(), idx.data_ptr(), None if offsets is None else offsets.data_ptr(),
                 None if weights is None else weights.data_ptr(), out.data_ptr(), B, S, P, E,
                 rows_per_shard, int(W.dtype == torch.bfloat16), int(round_bf16),
                 layout_bags or 0, torch.cuda.current_stream().cuda_stream)
        embedding_bag.launches += 1
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed with CUDA error {err}")
    return out


def embedding_bag(W: torch.Tensor, gidx: torch.Tensor, rows_per_shard: int,
                  weights: torch.Tensor | None = None,
                  layout_bags: int | None = None) -> torch.Tensor:
    """Bag sums ``out[b, s] = sum_p W[gidx[b, s, p]]`` in fp32, or with
    ``weights`` [B, S, P] fp32 ``sum_p weights[b, s, p] * W[gidx[b, s, p]]``.

    ``W`` [rows, E] bf16 (the Split-SGD ``hi`` slab) or fp32; ``gidx``
    [B, S, P] int32 rows of ``W``; a row outside ``[0, rows_per_shard)`` adds
    zero, whatever its weight.  ``layout_bags``: sum in the kernel layout a
    launch of that many bags takes (a bag's rows are added in another order
    in each of the two layouts), so that these bags are another launch's bit
    for bit (the hot-row cache's, ``core.cache.hot_bag_local``).  CUDA
    tensors launch the kernel; CPU tensors run the plain version.
    """
    _check(W, gidx, weights)
    if W.device.type == "cpu":
        return plain(W, gidx, rows_per_shard, weights)
    return _launch(W, gidx, None, weights, rows_per_shard, False, layout_bags)


def embedding_bag_stage(W: torch.Tensor, idx: torch.Tensor, row_offsets: torch.Tensor,
                        rows_per_shard: int, weights: torch.Tensor | None = None,
                        round_bf16: bool = True) -> torch.Tensor:
    """The bag stage in one launch: the bag sums of rows
    ``idx[b, s, p] + row_offsets[s]`` (``idx`` [B, S, P] int32 table-local
    ids, ``row_offsets`` [S] int32: a slot's first row in ``W``, negative
    where a row shard's window starts past it), masked and weighted as
    :func:`embedding_bag`, each rounded to bf16 with ``round_bf16`` (the
    row-mode wire; table mode's is fp32) and returned as fp32 [B, S, E].
    Counts as a launch of :func:`embedding_bag`.  CUDA tensors launch the
    kernel; CPU tensors run the plain pieces (offset add,
    ``ref.embedding_bag``, bf16 round)."""
    _check(W, idx, weights)
    S = idx.shape[1]
    if row_offsets.shape != (S,) or row_offsets.dtype != torch.int32 \
            or row_offsets.device != idx.device:
        raise ValueError(f"need int32 row_offsets [{S}] on {idx.device}, got {row_offsets.dtype} "
                         f"{tuple(row_offsets.shape)} on {row_offsets.device}")
    if W.device.type == "cpu":
        return plain_stage(W, idx, row_offsets, rows_per_shard, weights, round_bf16)
    return _launch(W, idx, row_offsets.contiguous(), weights, rows_per_shard, round_bf16)


embedding_bag.launches = 0
