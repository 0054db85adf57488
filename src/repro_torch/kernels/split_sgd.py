"""Flat Split-SGD step on Hopper (``csrc/split_sgd.cu``).

Replaces the TPU kernel ``repro/kernels/split_sgd.py::_kernel`` (via
``split_sgd_pallas``): recombine ``w = (hi << 16) | lo``, step
``w - lr * g``, re-split, in place.  The port runs its dense update on it,
where the reference writes the same function inline
(``repro/optim/data_parallel.py::rs_ag_split_sgd``).

What bounds it: device-memory bytes.  Per parameter it reads 2 + 2 + 4 bytes
and writes 2 + 2, with one FMA: far below the card's operations-per-byte
balance.

Design: a grid-stride loop of eight elements a thread, with 16-byte loads
and stores of ``hi`` and ``lo`` and two of ``g``; the step is one ``fmaf``,
as jitted JAX contracts ``w - lr * g``.  The last ``n % 8`` elements go one
a thread, so any length is taken.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
         ctypes.c_void_p]


def split_sgd(hi: torch.Tensor, lo: torch.Tensor, g: torch.Tensor,
              lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """In place on ``hi`` [n] bf16 / ``lo`` [n] int16 with ``g`` [n] fp32:
    ``w = fmaf(-lr, g, combine(hi, lo))``, re-split.  CUDA tensors launch the
    kernel; CPU tensors run the plain version.  Returns ``(hi, lo)``."""
    if hi.ndim != 1 or hi.shape != lo.shape or hi.shape != g.shape:
        raise ValueError(f"need flat hi, lo and g of one length, got {tuple(hi.shape)}, "
                         f"{tuple(lo.shape)}, {tuple(g.shape)}")
    if hi.dtype != torch.bfloat16 or lo.dtype != torch.int16 or g.dtype != torch.float32:
        raise TypeError(f"need hi bf16, lo int16 and g fp32, got {hi.dtype}, {lo.dtype}, "
                        f"{g.dtype}")
    if not (hi.device == lo.device == g.device):
        raise ValueError(f"hi on {hi.device}, lo on {lo.device}, g on {g.device}")
    if hi.device.type == "cpu":
        return ref.split_sgd(hi, lo, g, lr)
    if hi.device.type != "cuda":
        raise ValueError(f"unsupported device {hi.device}")
    if not (hi.is_contiguous() and lo.is_contiguous() and g.is_contiguous()):
        raise ValueError("hi, lo and g must be contiguous")
    if any(t.data_ptr() % 16 for t in (hi, lo, g)):
        raise ValueError("hi, lo and g must be 16-byte aligned")
    fn = build.function("split_sgd", "split_sgd_step", _ARGS)
    with torch.cuda.device(hi.device):
        err = fn(hi.data_ptr(), lo.data_ptr(), g.data_ptr(), hi.shape[0], float(np.float32(lr)),
                 torch.cuda.current_stream().cuda_stream)
        split_sgd.launches += 1
    if err:
        raise RuntimeError(f"split_sgd kernel launch failed with CUDA error {err}")
    return hi, lo


split_sgd.launches = 0
