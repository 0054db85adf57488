"""The port's attention (``repro_torch.models.attention`` and the flash
kernel's plain version) against the JAX package's, on the same numpy inputs.

The plain flash attention is held against the Pallas kernel run in
interpret mode, not against ``repro.kernels.ref.flash_attention``: the
kernel rounds ``p`` to bf16 against the running max of each 128-key tile,
and the plain version follows that recurrence; the reference's ``ref`` runs
PV in fp32 and is up to 7.8e-3 away from the kernel in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as ja
from repro_torch.kernels import ops
from repro_torch.models import attention as ta
from repro_torch.testing import assert_close, bf16_ulps, to_numpy, to_torch

RNG = np.random.default_rng(0)

# the four configs of tests/test_kernels.py::test_flash_attention, and one
# that spans three 128-key tiles
FLASH_CFGS = [
    dict(B=2, H=8, Hkv=2, Lq=100, Lk=100, D=64, causal=True),
    dict(B=1, H=4, Hkv=4, Lq=1, Lk=300, D=64, causal=True, window=128, softcap=50.0),
    dict(B=1, H=2, Hkv=2, Lq=64, Lk=64, D=128, causal=False),
    dict(B=2, H=4, Hkv=1, Lq=33, Lk=65, D=32, causal=True, window=16),
    dict(B=1, H=2, Hkv=1, Lq=300, Lk=300, D=64, causal=True),
]


def _qkv(B, H, Hkv, Lq, Lk, D, dtype, **_):
    return tuple(jnp.asarray(RNG.standard_normal(s).astype(np.float32), dtype)
                 for s in ((B, H, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))


def _both(arrays):
    return [to_torch(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", FLASH_CFGS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_flash_attention_plain_matches_interpret_kernel(cfg, dtype):
    """fp32: within 2e-6 (the same recurrence, fp32 sums in another
    order).  bf16: at most 1 value in 1000 differs, each by at most
    2^-7 · max|v|: the score sums and the exponentials differ in their last
    fp32 bits, so a ``p`` may round to its bf16 neighbour (one ulp, at most
    2^-7 relative), which moves its row's outputs by at most that share of
    one value of v; the other values are equal."""
    kw = dict(causal=cfg.get("causal", True), window=cfg.get("window", 0),
              softcap=cfg.get("softcap", 0.0))
    q, k, v = _qkv(**cfg, dtype=getattr(jnp, dtype))
    want = np.asarray(jops.flash_attention(q, k, v, interpret=True, **kw)).astype(np.float32)
    got = ops.flash_attention(*_both((q, k, v)), **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    got = to_numpy(got)
    if dtype == "float32":
        assert_close(got, want, rtol=0, atol=2e-6)
        return
    assert (bf16_ulps(got, want) > 0).mean() <= 1e-3
    vmax = float(np.abs(np.asarray(v).astype(np.float32)).max())
    assert_close(got, want, rtol=0, atol=2 ** -7 * vmax)


def test_flash_attention_tile_split_fixes_the_bf16_bits():
    """The plain version's ``bk`` is the kernel's key tile: 128 follows the
    interpret-mode kernel; another split of the same keys gives other bf16
    bits (p is rounded against another running max)."""
    q, k, v = _qkv(1, 2, 1, 256, 256, 64, jnp.bfloat16)
    want = np.asarray(jops.flash_attention(q, k, v, interpret=True)).astype(np.float32)
    qt, kt, vt = _both((q, k, v))
    from repro_torch.kernels import ref
    same = to_numpy(ref.flash_attention(qt, kt, vt, bk=128))
    other = to_numpy(ref.flash_attention(qt, kt, vt, bk=32))
    assert (same != want).mean() <= 1e-3
    assert (other != want).mean() > 10 * max((same != want).mean(), 1e-4)


def test_flash_attention_row_without_keys_is_zero():
    """Queries left of every key (Lq > Lk, causal) see nothing: l == 0
    reads as 1 and the output is 0, not NaN, as in the kernel."""
    q, k, v = _qkv(1, 2, 2, 40, 16, 32, jnp.float32)
    want = np.asarray(jops.flash_attention(q, k, v, interpret=True))
    got = to_numpy(ops.flash_attention(*_both((q, k, v))))
    assert (got[:, :, :24] == 0).all() and np.isfinite(got).all()
    assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=24),
                                dict(causal=True, softcap=30.0), dict(causal=False)],
                         ids=["causal", "window", "softcap", "full"])
def test_chunked_attention_matches_jax(kw, dtype):
    """Within 1e-6 in fp32; in bf16 at most 1 value in 1000 a bf16 ulp
    apart (a softmax sum in another order may round ``p`` the other way)."""
    q, k, v = _qkv(2, 4, 2, 96, 96, 32, getattr(jnp, dtype))
    want = np.asarray(ja.chunked_attention(q, k, v, bq=32, **kw)).astype(np.float32)
    got = to_numpy(ta.chunked_attention(*_both((q, k, v)), bq=32, **kw))
    if dtype == "float32":
        assert_close(got, want, rtol=0, atol=1e-6)
    else:
        assert (bf16_ulps(got, want) > 0).mean() <= 1e-3
        assert_close(got, want, rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(window=8), dict(softcap=50.0)],
                         ids=["global", "window", "softcap"])
def test_decode_attention_matches_jax(kw, dtype):
    """One query against a cache with per-row valid lengths (50, 17, 1):
    within 1e-6 in fp32; bf16 within a bf16 ulp."""
    q = jnp.asarray(RNG.standard_normal((3, 4, 1, 32)), getattr(jnp, dtype))
    k, v = (jnp.asarray(RNG.standard_normal((3, 2, 50, 32)), getattr(jnp, dtype))
            for _ in range(2))
    kv_len = np.array([50, 17, 1], np.int32)
    want = np.asarray(ja.decode_attention(q, k, v, kv_len=jnp.asarray(kv_len), **kw)
                      ).astype(np.float32)
    got = to_numpy(ta.decode_attention(*_both((q, k, v)), kv_len=torch.from_numpy(kv_len), **kw))
    if dtype == "float32":
        assert_close(got, want, rtol=0, atol=1e-6)
    else:
        assert bf16_ulps(got, want).max() <= 1


def test_attention_dispatch():
    """Lq == 1 takes the decode path whatever the impl; "pallas" the flash
    wrapper (its launch count does not move on the CPU); else chunked."""
    q, k, v = _both(_qkv(1, 2, 1, 1, 20, 16, jnp.float32))
    before = ops.flash_attention.launches
    assert torch.equal(ta.attention(q, k, v, impl="pallas"), ta.decode_attention(q, k, v))
    q2, k2, v2 = _both(_qkv(1, 2, 1, 20, 20, 16, jnp.float32))
    assert torch.equal(ta.attention(q2, k2, v2, impl="pallas"), ops.flash_attention(q2, k2, v2))
    assert torch.equal(ta.attention(q2, k2, v2), ta.chunked_attention(q2, k2, v2))
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos0,theta", [(0, 1e4), (4000, 1e6)])
def test_rope_matches_jax(pos0, theta, dtype):
    """Angles in fp32 from the same frequencies (equal bits here): within
    two fp32 ulps (at position 4000 cos and sin of the same angle differ by
    an ulp), equal in bf16 at these positions.  XLA's and PyTorch's pow, cos
    and sin may differ by an ulp elsewhere, which at positions of a few
    thousand can flip a bf16 rounding; the model tests allow for it."""
    x = jnp.asarray(RNG.standard_normal((2, 4, 64, 32)), getattr(jnp, dtype))
    pos = np.arange(pos0, pos0 + 64)
    want = np.asarray(ja.rope(x, jnp.asarray(pos)[None, None, :], theta)).astype(np.float32)
    got = to_numpy(ta.rope(to_torch(np.asarray(x)), torch.from_numpy(pos)[None, None, :], theta))
    tol = (1e-6, 3e-7) if dtype == "float32" else (0, 0)
    assert_close(got, want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """Within 1e-6 in fp32 (the mean sums in another order); equal in bf16."""
    x = jnp.asarray(RNG.standard_normal((2, 64, 32)), getattr(jnp, dtype))
    w = jnp.asarray(RNG.standard_normal(32) * 0.1, getattr(jnp, dtype))
    want = np.asarray(ja.rms_norm(x, w)).astype(np.float32)
    got = to_numpy(ta.rms_norm(*_both((x, w))))
    assert_close(got, want, rtol=0, atol=1e-6 if dtype == "float32" else 0)


def test_repeat_kv_is_jnp_repeat():
    x = jnp.asarray(RNG.standard_normal((2, 3, 5, 4)), jnp.float32)
    assert np.array_equal(to_numpy(ta.repeat_kv(to_torch(np.asarray(x)), 2)),
                          np.asarray(ja.repeat_kv(x, 2)))
