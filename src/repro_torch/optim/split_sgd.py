"""Split-SGD-BF16 storage (twin of the split part of ``repro/optim/split_sgd.py``).

An fp32 master weight is stored as two 16-bit halves: ``hi``, its upper 16
bits, which IS a bf16 number and is all the forward pass reads, and ``lo``,
its lower 16 bits.  ``combine_split(*split_fp32(w)) == w`` bit for bit.

``lo`` is a uint16 slab in the reference; the port holds the same bits as
``torch.int16``, since PyTorch has no arithmetic on uint16.
"""

from __future__ import annotations

import torch


def split_fp32(w32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi: bf16, lo: int16 bit pattern).  A pure bit partition
    (truncation, not rounding)."""
    bits = w32.to(torch.float32).contiguous().view(torch.int32)
    hi = (bits >> 16).to(torch.int16).view(torch.bfloat16)
    lo = (bits & 0xFFFF).to(torch.int16)
    return hi, lo


def combine_split(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi: bf16, lo: int16 bit pattern) -> the exact fp32."""
    h = hi.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    l16 = lo.to(torch.int64) & 0xFFFF
    return ((h << 16) | l16).to(torch.int32).view(torch.float32)
