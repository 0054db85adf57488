"""Parity helpers for the tests that hold the port against the JAX package.

Both sides take their inputs as numpy arrays; ``to_torch`` carries a bf16
numpy array (the ``ml_dtypes.bfloat16`` arrays that JAX hands out) across bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.weights import to_torch  # noqa: F401  (the bitwise numpy -> torch hand-off)


def has_cuda() -> bool:
    return torch.cuda.is_available()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bf16 is widened to fp32 exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def assert_close(actual, expected, *, rtol: float, atol: float, what: str = "") -> None:
    """``|actual - expected| <= atol + rtol * |expected|`` elementwise, on fp32
    copies of tensors or arrays."""
    a = to_numpy(actual) if isinstance(actual, torch.Tensor) else np.asarray(actual, np.float32)
    e = to_numpy(expected) if isinstance(expected, torch.Tensor) else np.asarray(expected, np.float32)
    np.testing.assert_allclose(a.astype(np.float32), e.astype(np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


def bf16_ulps(actual, expected) -> np.ndarray:
    """Distance in bf16 units in the last place between two arrays of
    bf16-representable values (fp32 arrays whose low 16 bits are zero)."""
    def ordered(x):
        bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(actual) - ordered(expected))


def dense_master(dense: dict, ranks: int = 1, rank: int = 0, buckets: int = 4) -> torch.Tensor:
    """The fp32 master values of a rank's shard of the dense state, padding
    included: its ``lo`` and its chunk of each of the ``buckets`` buckets of
    the flat ``hi`` (at one rank: the whole vector)."""
    from repro_torch.optim import data_parallel as dp
    from repro_torch.optim.split_sgd import combine_split
    flat = dp.flat_hi(dense["hi"], dense["lo"].numel() * ranks)
    bl = flat.numel() // buckets
    bc = bl // ranks
    hi = torch.cat([flat[b * bl + rank * bc:b * bl + (rank + 1) * bc] for b in range(buckets)])
    return combine_split(hi, dense["lo"])
