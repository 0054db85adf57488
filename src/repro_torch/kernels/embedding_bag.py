"""EmbeddingBag-sum forward on Hopper (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``repro/kernels/embedding_bag.py::_kernel`` (via
``embedding_bag_pallas``), extended by the validity mask of the reference's
``_partial_bag_masked`` (``repro/core/sharded_embedding.py``) so that the
serving forward runs on it: a lookup outside ``[0, rows_per_shard)`` adds
zero; and by the reference's per-lookup weights (``weighted=True``): a
weighted variant adds ``w_p * W[g_p]``, the product and the add each rounded
on their own, as the reference's ``rows * weights`` followed by ``.sum``
round them (``__fmul_rn`` then ``__fadd_rn``: nvcc would otherwise contract
the two into one FMA).  A weight of 1 multiplies exactly and the order of
the adds is the unweighted kernel's, so all-ones weights give the unweighted
bits.

What bounds it: device-memory bytes.  Each lookup reads one row (128 bytes
at E = 64 in bf16) at a data-dependent address and does one add per value,
far below the card's operations-per-byte balance.  Rows that many bags share
(a skewed index stream) come from the 50 MB L2 instead.

Design: one warp per (sample, slot) bag; the warp loads the bag's P indices
itself (the TPU kernel's scalar prefetch) and hands them round with
shuffles, the weighted variant its P weights beside them.  A row is read
with 16-byte loads by E/8 neighbouring lanes, so at E = 64 one warp has 4
rows in flight per step and 4 steps unrolled: 16
independent 128-byte rows per warp, which is what hides the latency of
random reads.  Sums stay in fp32 registers and are written once, with
16-byte stores.  Row addresses are computed in int64.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

plain = ref.embedding_bag

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
_ARGS_WEIGHTED = _ARGS[:2] + [ctypes.c_void_p] + _ARGS[2:]


def embedding_bag(W: torch.Tensor, gidx: torch.Tensor, rows_per_shard: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bag sums ``out[b, s] = sum_p W[gidx[b, s, p]]`` in fp32, or with
    ``weights`` [B, S, P] fp32 ``sum_p weights[b, s, p] * W[gidx[b, s, p]]``.

    ``W`` [rows, E] bf16 (the Split-SGD ``hi`` slab) or fp32; ``gidx``
    [B, S, P] int32 rows of ``W``; a row outside ``[0, rows_per_shard)`` adds
    zero, whatever its weight.  CUDA tensors launch the kernel; CPU tensors
    run the plain version.
    """
    if weights is not None and (weights.shape != gidx.shape or weights.dtype != torch.float32
                                or weights.device != gidx.device):
        raise ValueError(f"need fp32 weights of the shape of gidx {tuple(gidx.shape)} on its "
                         f"device, got {weights.dtype} {tuple(weights.shape)} on {weights.device}")
    if W.ndim != 2 or gidx.ndim != 3:
        raise ValueError(f"need W [rows, E] and gidx [B, S, P], got {tuple(W.shape)}, "
                         f"{tuple(gidx.shape)}")
    if W.dtype not in (torch.bfloat16, torch.float32) or gidx.dtype != torch.int32:
        raise TypeError(f"need a bf16 or fp32 table and int32 rows, got {W.dtype}, {gidx.dtype}")
    if W.device != gidx.device:
        raise ValueError(f"W on {W.device}, gidx on {gidx.device}")
    if W.device.type == "cpu":
        return plain(W, gidx, rows_per_shard, weights)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    B, S, P = gidx.shape
    E = W.shape[1]
    vec = 16 // W.element_size()
    if E % vec:
        raise ValueError(f"the kernel reads rows in 16-byte chunks: E={E} is not a multiple of {vec}")
    if rows_per_shard > W.shape[0]:
        raise ValueError(f"rows_per_shard {rows_per_shard} exceeds the table's {W.shape[0]} rows")
    if not (W.is_contiguous() and gidx.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("W, gidx and the weights must be contiguous")
    if W.data_ptr() % 16:
        raise ValueError("W must be 16-byte aligned")
    out = torch.empty((B, S, E), dtype=torch.float32, device=W.device)
    if B * S == 0:
        return out.zero_()
    tail = (out.data_ptr(), B * S, P, E, rows_per_shard, int(W.dtype == torch.bfloat16))
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        if weights is None:
            fn = build.function("embedding_bag", "embedding_bag_fwd", _ARGS)
            err = fn(W.data_ptr(), gidx.data_ptr(), *tail, stream)
        else:
            fn = build.function("embedding_bag", "embedding_bag_weighted_fwd", _ARGS_WEIGHTED)
            err = fn(W.data_ptr(), gidx.data_ptr(), weights.data_ptr(), *tail, stream)
        embedding_bag.launches += 1
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed with CUDA error {err}")
    return out


embedding_bag.launches = 0
