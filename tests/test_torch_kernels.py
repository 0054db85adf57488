"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold those plain versions (and the wrappers' checks) against the
Pallas kernels in interpret mode (``repro.kernels.ops``) and the pure-jnp
oracles (``repro.kernels.ref``), over the shapes of tests/test_kernels.py.
On the card, chip_smoke.py and tests/test_torch_cuda.py hold each CUDA
kernel against the same plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interaction as j_interaction
from repro.core import sharded_embedding as j_se
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import ops
from repro_torch.testing import assert_close, to_numpy, to_torch

RNG = np.random.default_rng(0)


def _jnp(a, dtype):
    return jnp.asarray(a, dtype)


# ------------------------------------------------------------ fused_mlp --

@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (100, 300, 120), (256, 512, 256), (33, 77, 129)])
@pytest.mark.parametrize("act", ["relu", "none", "sigmoid"])
def test_fused_mlp_plain_matches_pallas(m, k, n, act):
    """bf16 x and w, bf16 bias (as dense_hi holds it).  Tolerance 2e-2, the
    bf16 tolerance of tests/test_kernels.py: both sides accumulate exact bf16
    products in fp32, in different orders.  The bf16 output (what mlp_forward
    hands between layers) is the fp32 output cast to bf16, and is held to
    the reference's cast with the same tolerance."""
    x = _jnp(RNG.standard_normal((m, k)), jnp.bfloat16)
    w = _jnp(RNG.standard_normal((k, n)) * 0.05, jnp.bfloat16)
    b = _jnp(RNG.standard_normal((n,)), jnp.bfloat16)
    got_pallas = np.asarray(j_ops.fused_mlp_layer(x, w, b, act, interpret=True))
    got_ref = np.asarray(j_ref.fused_mlp_layer(x, w, b, act))
    xt, wt, bt = (to_torch(np.asarray(a)) for a in (x, w, b))
    out32 = ops.fused_mlp_layer(xt, wt, bt, act, out_dtype=torch.float32)
    assert out32.dtype == torch.float32 and out32.shape == (m, n)
    assert_close(out32, got_pallas, rtol=2e-2, atol=2e-2, what="vs Pallas")
    assert_close(out32, got_ref, rtol=2e-2, atol=2e-2, what="vs jnp oracle")
    out16 = ops.fused_mlp_layer(xt, wt, bt, act, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))
    assert_close(out16, got_ref.astype(jnp.bfloat16), rtol=2e-2, atol=2e-2, what="bf16 out")


@pytest.mark.parametrize("m,k,n,want", [
    (8192, 512, 512, "wgmma"), (1, 8, 64, "wgmma"), (200, 520, 200, "wgmma"),
    (8, 1024, 1024, "wgmma"), (8192, 100, 1024, "mma_sync"), (8192, 1024, 1, "mma_sync"),
    (33, 77, 129, "mma_sync"), (4, 12, 16, "mma_sync"), (4, 16, 12, "mma_sync"),
    (4, 0, 8, "mma_sync")])
def test_fused_mlp_route(m, k, n, want):
    """A layer goes to the wgmma kernel where a TMA tensor map can describe
    x and w (K and N multiples of 8, K > 0), else to the mma.sync kernel."""
    from repro_torch.kernels import fused_mlp
    assert fused_mlp.route(m, k, n) == want


def test_fused_mlp_routes_of_dlrm_small():
    """dlrm-small's 8 layers: all but the top MLP's first (K = 100) and last
    (N = 1) take the wgmma route, at the config's batch and every bucket."""
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.kernels import fused_mlp
    cfg = dlrm_small()
    layers = [(k, n) for sizes in (cfg.bottom_sizes, cfg.top_sizes)
              for k, n in zip(sizes, sizes[1:])]
    assert layers[3] == (100, 1024) and layers[-1] == (1024, 1)
    for m in (cfg.batch, 8, 32, 128):
        assert [fused_mlp.route(m, k, n) for k, n in layers] == \
            ["wgmma"] * 3 + ["mma_sync"] + ["wgmma"] * 3 + ["mma_sync"]


def test_fused_mlp_fp32_bias_and_checks():
    x = torch.from_numpy(RNG.standard_normal((5, 7)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(RNG.standard_normal((7, 3)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(RNG.standard_normal(3).astype(np.float32))
    want = j_ref.fused_mlp_layer(_jnp(to_numpy(x), jnp.bfloat16), _jnp(to_numpy(w), jnp.bfloat16),
                                 _jnp(b.numpy(), jnp.float32), "relu")
    assert_close(ops.fused_mlp_layer(x, w, b), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        ops.fused_mlp_layer(x.float(), w, b)            # the kernel takes bf16 only
    with pytest.raises(ValueError):
        ops.fused_mlp_layer(x, w.t(), b)                # K mismatch
    with pytest.raises(ValueError):
        ops.fused_mlp_layer(x, w, b, activation="gelu")


# -------------------------------------------------------- embedding_bag --

@pytest.mark.parametrize("rows,e,n,p", [(500, 96, 40, 7), (1000, 128, 16, 1), (64, 64, 128, 33),
                                        (200, 17, 8, 4)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_embedding_bag_plain_matches_pallas(rows, e, n, p, dtype):
    """One bag per sample (S = 1).  fp32 sums of the same rows in different
    orders: 1e-5 for an fp32 table, 1e-2 for bf16 (tests/test_kernels.py)."""
    W = _jnp(RNG.standard_normal((rows, e)), dtype)
    idx = RNG.integers(0, rows, (n, p)).astype(np.int32)
    got_pallas = np.asarray(j_ops.embedding_bag(W, jnp.asarray(idx), bags_per_block=8,
                                                interpret=True))
    got_ref = np.asarray(j_ref.embedding_bag(W, jnp.asarray(idx)))
    out = ops.embedding_bag(to_torch(np.asarray(W)), torch.from_numpy(idx)[:, None, :], rows)
    assert out.dtype == torch.float32 and out.shape == (n, 1, e)
    tol = 1e-2 if dtype == jnp.bfloat16 else 1e-5
    assert_close(out[:, 0], got_pallas, rtol=tol, atol=tol, what="vs Pallas")
    assert_close(out[:, 0], got_ref, rtol=tol, atol=tol, what="vs jnp oracle")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_embedding_bag_out_of_range_rows_add_zero(dtype):
    """Rows outside [0, rows_per_shard) add nothing, as in the reference's
    _partial_bag_masked (which clips, then masks).  A table with more rows
    than the shard owns shows that the mask, not the table size, decides."""
    rows_per_shard, E = 40, 16
    W = _jnp(RNG.standard_normal((rows_per_shard + 8, E)), dtype)
    g = RNG.integers(-30, rows_per_shard + 30, (6, 3, 5)).astype(np.int32)
    g[0, 0] = -1                       # a bag with no valid row at all
    valid = (g >= 0) & (g < rows_per_shard)
    want = np.asarray(j_se._partial_bag_masked(W, jnp.asarray(g), jnp.asarray(valid)))
    got = ops.embedding_bag(to_torch(np.asarray(W)), torch.from_numpy(g), rows_per_shard)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[0, 0].any()


def test_embedding_bag_checks():
    W = torch.zeros((10, 8), dtype=torch.bfloat16)
    g = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.embedding_bag(W, g.long(), 10)
    with pytest.raises(ValueError):
        ops.embedding_bag(W, g[0], 10)
    with pytest.raises(ValueError):
        ops.embedding_bag(W, g, 10, weights=torch.ones(2, 3, 5))
    with pytest.raises(ValueError):
        ops.embedding_bag(W, g, 10, weights=torch.ones(2, 3, 4, dtype=torch.float64))


# ------------------------------------------------------------ interaction --

@pytest.mark.parametrize("b,f,e", [(20, 9, 64), (8, 27, 128), (5, 65, 32)])
def test_interaction_plain_matches_pallas(b, f, e):
    """fp32 dense and bags (the dtypes of the serving path).  The reference
    side is dot_interaction (einsum + triangle gather) and the Pallas self-dot
    with the same triangle taken; fp32 dot products of length E summed in
    different orders: rtol 1e-5, atol 1e-4."""
    dense = RNG.standard_normal((b, e)).astype(np.float32)
    emb = RNG.standard_normal((b, f - 1, e)).astype(np.float32)
    want = np.asarray(j_interaction.dot_interaction(jnp.asarray(dense), jnp.asarray(emb)))
    z = np.concatenate([dense[:, None], emb], axis=1)
    zz = np.asarray(j_ops.interaction_self_dot(jnp.asarray(z), interpret=True))
    li, lj = np.tril_indices(f, -1)
    want_pallas = np.concatenate([dense, zz[:, li, lj]], axis=1)
    got = ops.dot_interaction(torch.from_numpy(dense), torch.from_numpy(emb))
    assert got.shape == (b, e + f * (f - 1) // 2)
    assert_close(got, want, rtol=1e-5, atol=1e-4, what="vs dot_interaction")
    assert_close(got, want_pallas, rtol=1e-5, atol=1e-4, what="vs Pallas self-dot")


def test_interaction_checks():
    with pytest.raises(TypeError):
        ops.dot_interaction(torch.zeros(2, 4, dtype=torch.bfloat16), torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        ops.dot_interaction(torch.zeros(2, 4), torch.zeros(2, 3, 5))


def test_cpu_tensors_launch_nothing():
    """The counters count kernel launches only: CPU calls run the plain
    versions and leave them alone."""
    ops.reset_launches()
    ops.embedding_bag(torch.zeros(4, 8), torch.zeros(1, 1, 2, dtype=torch.int32), 4)
    ops.dot_interaction(torch.zeros(1, 4), torch.zeros(1, 2, 4))
    ops.fused_mlp_layer(torch.zeros(1, 4, dtype=torch.bfloat16),
                        torch.zeros(4, 2, dtype=torch.bfloat16), torch.zeros(2))
    stream = (torch.zeros(2, dtype=torch.int32),) * 3 + (torch.ones(2),)
    dY = torch.zeros(1, 8, dtype=torch.bfloat16)
    ops.fused_update_split(torch.zeros(4, 8, dtype=torch.bfloat16),
                           torch.zeros(4, 8, dtype=torch.int16), *stream, dY, 0.1)
    ops.fused_update_fp32(torch.zeros(4, 8), *stream, dY, 0.1)
    ops.fused_update_momentum(torch.zeros(4, 8), torch.zeros(4, 8), *stream, dY, 0.1, 0.9)
    ops.fused_update_adagrad(torch.zeros(4, 8), torch.zeros(4, 8), *stream, dY, 0.1, 1e-8)
    ops.fused_update_adagrad_rowwise(torch.zeros(4, 8), torch.zeros(4, 1), *stream, dY, 0.1, 1e-8)
    ops.fused_update_freq(torch.zeros(4, 8), torch.zeros(4, 1, dtype=torch.int32), *stream, dY,
                          0.1, 1e-8)
    seed = torch.tensor(3, dtype=torch.int32)
    for fn, hp in ((ops.fused_update_momentum_bf16, 0.9), (ops.fused_update_adagrad_bf16, 1e-8)):
        fn(torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.bfloat16), *stream, dY, 0.1, hp, seed)
    ops.embedding_bag(torch.zeros(4, 8), torch.zeros(1, 1, 2, dtype=torch.int32), 4,
                      torch.ones(1, 1, 2))
    ops.split_sgd(torch.zeros(3, dtype=torch.bfloat16), torch.zeros(3, dtype=torch.int16),
                  torch.zeros(3), 0.1)
    ops.flash_attention(torch.zeros(1, 2, 5, 8, dtype=torch.bfloat16),
                        *(torch.zeros(1, 1, 5, 8, dtype=torch.bfloat16),) * 2)
    assert ops.launches() == {name: 0 for name in ops.KERNELS}
    assert ops.fused_mlp_layer.route_launches == {"wgmma": 0, "mma_sync": 0}
    assert set(ops.KERNELS) == {"embedding_bag", "dot_interaction", "fused_mlp",
                                "embedding_update", "embedding_update_fp32", "split_sgd",
                                "embedding_update_momentum", "embedding_update_adagrad",
                                "embedding_update_adagrad_rowwise", "embedding_update_freq",
                                "embedding_update_momentum_bf16", "embedding_update_adagrad_bf16",
                                "flash_attention"}
