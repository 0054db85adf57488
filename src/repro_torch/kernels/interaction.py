"""DLRM dot interaction on Hopper (``csrc/interaction.cu``).

Replaces the TPU kernel ``repro/kernels/interaction.py::_kernel`` (via
``interaction_pallas``), which writes the full batched self-dot
``Z Z^T [B, F, F]`` and leaves the triangle extraction to fuse on top.  This
kernel fuses it, together with the concatenations of ``dot_interaction``
(``repro/core/interaction.py``): it reads ``dense`` and ``emb`` once and
writes ``[dense, tril(Z Z^T, -1)]`` once; every product it computes is one
that is kept.

What bounds it: device-memory bytes.  At F = 9, E = 64 a sample reads 2.3 KB
and writes 400 bytes, and does 36 dot products of length 64 (4.6 KFLOP),
about 2 operations per byte.

Design: a block owns tiles of T consecutive samples, whose ``dense`` [T, E]
and ``emb`` [T, S, E] are contiguous slabs and whose output [T, E + F(F-1)/2]
is one contiguous slab too.  The grid is resident and each block walks its
tiles through a ring of two shared-memory stages: one thread a row issues
the TMA's 1-D bulk copy of that row (``cp.async.bulk``, no tensor map) into
its stage, completing on the stage's mbarrier, so the next tile's rows land
while this tile's products run (where E is not a multiple of 4, or an input
is not 16-byte aligned, the block loads a tile with plain loads at its
turn).  A row of Z sits at a stride of an odd number of float4s, so that the
float4 reads of one column of eight consecutive rows fall in eight
different bank groups.  The T x F(F-1)/2 pairs are spread over the 256
threads in output order, each pair (i, j) taken from a table in shared
memory, each pair four fp32 FMA chains (one a float4 lane) added at the end
(no tensor cores: TF32 would lose the 1e-5 tolerance, and the kernel is
bound by bytes).  The output tile, dense pass-through included, is gathered
in shared memory and written with coalesced 16-byte stores.  The launcher
picks T and the ring's depth per (F, E, B) from the kernel's own
shared-memory layout: two stages of the largest T that leaves room for two
blocks an SM, T no larger than the batch spread over the SMs (a small batch
gets tiles of one sample on many SMs); where one sample's two stages do not
fit two blocks an SM, one block; where they do not fit a block, one stage.
The SM count and the kernel's shared-memory opt-in are asked of the runtime
once a device.

Measured (``tools/ablate_bag.py``, H100): without the TMA copies (plain
loads) the kernel took 2.4 times as long at dlrm-small's B = 8192, with one
stage 1.07 times; tiles of 8 to 32 samples came within 15 % of each other;
the products cost some 4 us over the copies alone.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

plain = ref.dot_interaction

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


def dot_interaction(dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """dense [B, E] fp32, emb [B, S, E] fp32 -> [B, E + F(F-1)/2] fp32 with
    F = S + 1.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if dense.ndim != 2 or emb.ndim != 3 or emb.shape[0] != dense.shape[0] \
            or emb.shape[2] != dense.shape[1]:
        raise ValueError(f"need dense [B, E] and emb [B, S, E], got {tuple(dense.shape)}, "
                         f"{tuple(emb.shape)}")
    if dense.dtype != torch.float32 or emb.dtype != torch.float32:
        raise TypeError(f"need fp32 inputs, got {dense.dtype}, {emb.dtype}")
    if dense.device != emb.device:
        raise ValueError(f"dense on {dense.device}, emb on {emb.device}")
    if dense.device.type == "cpu":
        return plain(dense, emb)
    if dense.device.type != "cuda":
        raise ValueError(f"unsupported device {dense.device}")
    if not (dense.is_contiguous() and emb.is_contiguous()):
        raise ValueError("dense and emb must be contiguous")
    B, S, E = emb.shape
    F = S + 1
    out = torch.empty((B, E + F * (F - 1) // 2), dtype=torch.float32, device=dense.device)
    if B == 0:
        return out
    fn = build.function("interaction", "dot_interaction_fwd", _ARGS)
    with torch.cuda.device(dense.device):
        err = fn(dense.data_ptr(), emb.data_ptr(), out.data_ptr(), B, S, E,
                 torch.cuda.current_stream().cuda_stream)
        dot_interaction.launches += 1
    if err:
        raise RuntimeError(f"dot_interaction kernel launch failed with CUDA error {err}")
    return out


dot_interaction.launches = 0
