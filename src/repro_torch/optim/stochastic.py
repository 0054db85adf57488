"""Seeded stochastic rounding to bf16 (the port's copy of
``repro/optim/stochastic.py``).

The compressed-state optimizers (``momentum_bf16``, ``adagrad_bf16``) keep
their state slab as bf16 and round each new value stochastically: a uniform
16-bit dither added to the fp32 bits before they are cut to their upper
half, so that the stored value is unbiased.  The dither is a pure function
of ``(seed, row, column)``, the ``lowbias32`` hash, with no sampler state:
the row kernel (``csrc/embedding_update.cuh``) and the plain versions
(``kernels/ref.py``) add the same dither to the same value.  The ``bf16_sr``
wire of the hybrid step's collectives (``dist/exchange.py``) rounds its
payloads the same way, with a dither that is a pure function of ``(seed,
tag, flat element index)`` (:func:`wire_noise`), so a run resumed from a
checkpoint of ``sr`` replays it.

PyTorch on the CPU has no ``>>`` and no ``+`` for ``uint32`` tensors, and
``int32``'s ``>>`` is arithmetic.  So the hash runs on ``int64`` tensors
holding the 32-bit values, masked back to 32 bits after every add, and each
product is taken in 16-bit halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

# lowbias32 multipliers
MIX1 = 0x7FEB352D
MIX2 = 0x846CA68B
# Weyl / stream constants decorrelating the (seed, row, column) counters
GOLD = 0x9E3779B1
ROWC = 0x85EBCA6B
# the wire payloads' stream constant: keeps their dither off the row streams
# even where a tag equals a row id
WIREC = 0xB5297A4D

MASK32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """The 32-bit pattern of an integer tensor (or int) as int64 in
    [0, 2^32): what ``.astype(uint32)`` gives (negative int32 wraps)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m`` mod 2^32 for ``x`` in [0, 2^32), in int64 without
    overflow: ``m``'s low and high 16-bit halves apart (each product below
    2^48)."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x) -> torch.Tensor:
    """The lowbias32 avalanche (xor-shift / multiply) of 32-bit values, as
    int64 in [0, 2^32)."""
    x = _u32(x)
    x = _mul32(x ^ (x >> 16), MIX1)
    x = _mul32(x ^ (x >> 15), MIX2)
    return x ^ (x >> 16)


def sr_noise(seed, rows: torch.Tensor, width: int) -> torch.Tensor:
    """The dither: 32-bit noise of shape ``rows.shape + (width,)`` as int64,
    a pure function of ``(seed, rows[...], column)``.  ``seed`` is an int
    or a 0-d integer tensor (int32, wrapping as ``uint32``), ``rows`` (local)
    row ids of any integer type.  On ``rows``' device."""
    rows = _u32(rows)
    seed = _u32(seed).to(rows.device)
    base = mix32(_mul32(seed, GOLD) ^ _mul32(rows, ROWC))
    col = torch.arange(width, dtype=torch.int64, device=rows.device)
    ctr = (_mul32(col, GOLD) + 1) & MASK32
    return mix32(base[..., None] ^ ctr)


def sr_round_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16, rounded stochastically: the low 16 bits of ``noise``
    added to ``x``'s bits (the carry runs into the exponent, as the uint32
    add does), then the upper half kept.  A value bf16 holds exactly passes
    unchanged."""
    bits = _u32(x.float().contiguous().view(torch.int32))
    top = (((bits + (noise & 0xFFFF)) & MASK32) >> 16)
    return torch.where(top >= 0x8000, top - 0x10000, top).to(torch.int16).view(torch.bfloat16)


def wire_noise(seed, tag, shape: tuple, device=None) -> torch.Tensor:
    """The dither of one wire payload: 32-bit noise of ``shape`` as int64, a
    pure function of ``(seed, tag, flat element index)``.  ``seed`` is an
    int or a 0-d integer tensor (the state's ``sr``), ``tag`` the payload's
    uint32 stream tag (``dist.exchange.wire_tag``).  On ``device`` (else
    ``seed``'s)."""
    # the stream's base where the seed lives: a 0-d tensor on the host (an int
    # seed) enters the payload's elementwise ops as a scalar, with no copy
    seed = _u32(seed)
    base = mix32(_mul32(seed, GOLD) ^ ((_mul32(_u32(tag), WIREC) + 1) & MASK32))
    n = 1
    for d in shape:
        n *= int(d)
    ctr = torch.arange(n, dtype=torch.int64, device=base.device if device is None else device)
    return mix32(base ^ ((_mul32(ctr.reshape(tuple(shape)), ROWC) + GOLD) & MASK32))


def sr_round_bf16_wire(x: torch.Tensor, seed, tag) -> torch.Tensor:
    """fp32 -> bf16 of a wire payload, rounded stochastically under
    :func:`wire_noise`.  A value bf16 holds exactly (zero too) passes
    unchanged: its discarded half is zero and the dither stays below it."""
    return sr_round_bf16(x, wire_noise(seed, tag, tuple(x.shape), x.device))
