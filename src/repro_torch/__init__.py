"""PyTorch + CUDA port of the DLRM system in :mod:`repro`, for NVIDIA Hopper.

Module paths mirror the JAX package (``repro_torch/core/dlrm.py`` is the twin
of ``repro/core/dlrm.py``), so each piece has one reference to be held
against.  The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Kernels are built lazily, at their first launch, so importing
the package needs no CUDA toolkit.

Every public entry point takes ``device="cuda"`` by default and raises when
no CUDA device is present: the CPU (the kernels' plain versions) is used only
when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no CUDA device (there is no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
