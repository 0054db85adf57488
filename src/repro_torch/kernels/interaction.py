"""DLRM dot interaction on Hopper (``csrc/interaction.cu``).

Replaces the TPU kernel ``repro/kernels/interaction.py::_kernel`` (via
``interaction_pallas``), which writes the full batched self-dot
``Z Z^T [B, F, F]`` and leaves the triangle extraction to fuse on top.  This
kernel fuses it, together with the concatenations of ``dot_interaction``
(``repro/core/interaction.py``): it reads ``dense`` and ``emb`` once and
writes ``[dense, tril(Z Z^T, -1)]`` once; every product it computes is one
that is kept.

What bounds it: device-memory bytes.  At F = 9, E = 64 a sample reads 2.3 KB
and does 36 dot products of length 64 (4.6 KFLOP), about 2 operations per
byte.

Design: one warp per sample; the warp stages Z (F x E fp32) in shared
memory with an odd row stride, so that lanes reading one column of
different rows do not collide on a bank, then each lane computes whole
pairs with fp32 FMAs.  Eight samples per 256-thread block.
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
