"""Flat Split-SGD step on Hopper (``csrc/split_sgd.cu``).

Replaces the TPU kernel ``repro/kernels/split_sgd.py::_kernel`` (via
``split_sgd_pallas``): recombine ``w = (hi << 16) | lo``, step
``w - lr * g``, re-split, in place.  The port runs its dense update on it,
where the reference writes the same function inline
(``repro/optim/data_parallel.py::rs_ag_split_sgd``), and the LM step's
update with momentum, where the reference writes ``mom = beta * mom + g``
and the step by ``mom`` (``repro/optim/split_sgd.py::update_leaf``).

What bounds it: device-memory bytes.  Per parameter it reads 2 + 2 bytes of
``hi`` and ``lo`` and 4 (fp32) or 2 (bf16) of ``g``, and writes 2 + 2, with
one FMA; with momentum it also reads and writes the 4 bytes of ``mom``, with
a second FMA: far below the card's operations-per-byte balance.

Design: a grid-stride loop of eight elements a thread, with 16-byte loads
and stores of ``hi``, ``lo`` and a bf16 ``g`` and two of an fp32 ``g`` and
of ``mom``; each step is one ``fmaf``, as jitted JAX contracts
``beta * mom + g`` and ``w - lr * g``.  The momentum variant is one launch,
so the momentum never crosses device memory between its FMA and the
step's.  The last ``n % 8`` elements go one a thread, so any length is
taken.  One C launcher serves the four instances (``g`` fp32 or bf16, with
or without momentum).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def split_sgd(hi: torch.Tensor, lo: torch.Tensor, g: torch.Tensor, lr: float,
              mom: torch.Tensor | None = None, beta: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """In place on ``hi`` [n] bf16 / ``lo`` [n] int16 with ``g`` [n] fp32 or
    bf16: ``w = fmaf(-lr, g, combine(hi, lo))``, re-split; with ``mom`` [n]
    fp32, ``mom = fmaf(beta, mom, g)`` first, in place, and the step by
    ``mom``.  CUDA tensors launch the kernel; CPU tensors run the plain
    version.  Returns ``(hi, lo)``."""
    flat = (hi, lo, g) if mom is None else (hi, lo, g, mom)
    if any(t.ndim != 1 or t.shape != hi.shape for t in flat):
        raise ValueError("need flat hi, lo, g (and mom) of one length, got "
                         f"{[tuple(t.shape) for t in flat]}")
    if (hi.dtype != torch.bfloat16 or lo.dtype != torch.int16
            or g.dtype not in (torch.float32, torch.bfloat16)
            or (mom is not None and mom.dtype != torch.float32)):
        raise TypeError(f"need hi bf16, lo int16, g fp32 or bf16 and mom fp32, got "
                        f"{[t.dtype for t in flat]}")
    if any(t.device != hi.device for t in flat):
        raise ValueError(f"hi, lo, g and mom on {[str(t.device) for t in flat]}")
    if hi.device.type == "cpu":
        return ref.split_sgd(hi, lo, g, lr, mom, beta)
    if hi.device.type != "cuda":
        raise ValueError(f"unsupported device {hi.device}")
    if not all(t.is_contiguous() for t in flat):
        raise ValueError("hi, lo, g and mom must be contiguous")
    if any(t.data_ptr() % 16 for t in flat):
        raise ValueError("hi, lo, g and mom must be 16-byte aligned")
    fn = build.function("split_sgd", "split_sgd_run", _ARGS)
    with torch.cuda.device(hi.device):
        err = fn(hi.data_ptr(), lo.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
                 None if mom is None else mom.data_ptr(), hi.shape[0], float(np.float32(lr)),
                 float(np.float32(beta)), torch.cuda.current_stream().cuda_stream)
        split_sgd.launches += 1
    if err:
        raise RuntimeError(f"split_sgd kernel launch failed with CUDA error {err}")
    return hi, lo


split_sgd.launches = 0
