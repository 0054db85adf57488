"""``kernels.ref.fma32`` and ``kernels.ref.sqrt32``, the one-rounding fp32
FMA and the correctly rounded fp32 root that every plain row and dense
update builds on.  On the CPU both take a fast path: blocks of
``CPU_BLOCK`` values, and the exact check only where the f64 result lies
on (fma32) or near (sqrt32) an fp32 midpoint.  Each case holds the fast path bit for bit to the
full check on every value (the path CUDA tensors take) and to an exact
rational oracle on SAMPLE of its values (in the midpoint cases every value
is built on a midpoint); the arrays are longer than one block."""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

N = ref.CPU_BLOCK + 12_345   # two blocks, the second short
SAMPLE = 4000


def f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bit for bit, but a NaN matches any NaN: the sign of the NaN that
    ``inf - inf`` makes depends on whether a vector or a scalar loop ran it."""
    nan = torch.isnan(x)
    return torch.equal(nan, torch.isnan(y)) and torch.equal(
        x[~nan].contiguous().view(torch.int32), y[~nan].contiguous().view(torch.int32))


def nearest32(q: Fraction) -> np.float32:
    """``q`` rounded to fp32, to nearest, ties to the even pattern."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    gaps = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(gaps)
    ties = [c for c, g in zip(cands, gaps) if g == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


def sqrt_exact32(x: np.float32) -> np.float32:
    """The correctly rounded fp32 root of ``x`` >= 0: the candidate between
    whose midpoints (squared exactly) ``x`` lies."""
    up, dn = np.float32(np.inf), np.float32(-np.inf)
    X = Fraction(float(x))
    r = np.float32(math.sqrt(float(x)))
    while X > ((Fraction(float(r)) + Fraction(float(np.nextafter(r, up)))) / 2) ** 2:
        r = np.nextafter(r, up)
    while r > 0 and X < ((Fraction(float(r)) + Fraction(float(np.nextafter(r, dn)))) / 2) ** 2:
        r = np.nextafter(r, dn)
    return r


def full_fma32(a, b, c) -> torch.Tensor:
    p = a.double() * b.double()
    c64 = c.double()
    return ref._to_odd(p, c64, p + c64).float()


def fma_cases():
    rng = np.random.default_rng(0)
    c = f32(rng.standard_normal(N))
    ulp = torch.nextafter(c, torch.tensor(np.inf)) - c
    half = f32(np.full(N, 0.5))
    one_up = torch.tensor(np.float32(1 + 2 ** -23))
    special = f32(np.resize([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, 1e-45,
                             -1e-45, 1.0], N))
    return {
        # the row updates' shape: -lr * acc + w
        "step": (torch.tensor(np.float32(-0.01)), f32(rng.standard_normal(N) * 1e-3), c),
        # a product exactly half an ulp of c: every sum a midpoint, the tie to even
        "midpoint": (half, ulp, c),
        "midpoint_negative": (-half, ulp, c),
        "past_midpoint": (half, ulp * f32(np.float32(1 + 2 ** -23)), c),
        # a product 2^-46 of itself short of half an ulp (away from and toward zero): the
        # f64 sum rounds onto the midpoint, and only its exact error says which way
        "under_midpoint": (one_up, ulp * f32(np.float32(0.5 - 2 ** -24)), c),
        "under_midpoint_negative": (-one_up, ulp * f32(np.float32(0.5 - 2 ** -24)), c),
        "products_of_few_bits": (f32(rng.integers(1, 1 << 24, N) * 2.0 ** -24),
                                 f32(rng.standard_normal(N)) * c.abs() * 2 ** -20, c),
        "cancellation": (c, c, -(c * c)),
        "subnormal": (f32(rng.standard_normal(N) * 1e-20), f32(rng.standard_normal(N) * 1e-20),
                      f32(rng.standard_normal(N) * 1e-40)),
        # as under_midpoint among the fp32 subnormals: 2^-150 (1 - 2^-46) onto k 2^-149
        "subnormal_under_midpoint": (torch.tensor(np.float32(2.0 ** -100 * (1 + 2 ** -23))),
                                     torch.tensor(np.float32(2.0 ** -50 * (1 - 2 ** -23))),
                                     f32(rng.integers(1 << 10, 1 << 23, N) * 2.0 ** -149)),
        "zero_products": (torch.tensor(np.float32(-0.01)), torch.zeros(N), c),
        "special": (special, special.flip(0), special.roll(3)),
    }


FMA = fma_cases()


@pytest.mark.parametrize("case", sorted(FMA))
def test_fma32_fast_path_is_exact(case):
    a, b, c = FMA[case]
    got = ref.fma32(a, b, c)
    assert same(got, full_fma32(a, b, c))
    A, B, C = (t.expand(got.shape).numpy() for t in (a, b, c))
    rng = np.random.default_rng(1)
    for i in rng.choice(N, SAMPLE, replace=False):
        if not all(np.isfinite(v) for v in (A[i], B[i], C[i])):
            continue
        want = nearest32(Fraction(float(A[i])) * Fraction(float(B[i])) + Fraction(float(C[i])))
        assert np.float32(got[i]).view(np.int32) == want.view(np.int32), (i, A[i], B[i], C[i])


def sqrt_cases():
    rng = np.random.default_rng(2)
    c = f32(rng.standard_normal(N))
    r = f32(1 + rng.random(N)).double()
    mid = (r + torch.nextafter(r.float(), torch.tensor(np.inf)).double()) / 2
    return {
        "normal": c.abs(),
        # roots within an ulp's fraction of an fp32 midpoint
        "near_midpoint": (mid * mid).float(),
        "squares": c * c,
        "integers": f32(rng.integers(0, 1 << 24, N)),
        "subnormal": f32(np.abs(rng.standard_normal(N)) * 1e-40),
        "special": f32(np.resize([0.0, -0.0, np.inf, np.nan, -1.0, 3.4e38, 1e-45], N)),
        "rows": f32(rng.random((N // 64, 64))),
    }


SQRT = sqrt_cases()


@pytest.mark.parametrize("case", sorted(SQRT))
def test_sqrt32_fast_path_is_exact(case):
    x = SQRT[case]
    got = ref.sqrt32(x)
    assert got.shape == x.shape
    full = ref._sqrt32_check(x.reshape(-1), torch.sqrt(x.reshape(-1).double()).float())
    assert same(got.reshape(-1), full)
    X, G = x.reshape(-1).numpy(), got.reshape(-1).numpy()
    rng = np.random.default_rng(3)
    for i in rng.choice(X.size, SAMPLE, replace=False):
        if not (np.isfinite(X[i]) and X[i] >= 0):
            continue
        assert G[i].view(np.int32) == sqrt_exact32(X[i]).view(np.int32), (i, X[i])
