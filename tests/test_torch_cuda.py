"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  On a machine with
one (no JAX needed), run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes are small and ragged (odd M, K = 100, N = 1, out-of-range rows),
the cases the full-size run of chip_smoke.py does not reach.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.testing import assert_close, has_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not has_cuda():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products in full fp32
    return torch.device("cuda")


def _randn(*shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,P", [(16, 3), (64, 50), (128, 1), (256, 33), (512, 7)])
def test_embedding_bag_kernel_matches_plain(dev, dtype, E, P):
    """The same fp32 sums in another order: rtol = atol = 1e-5."""
    gen = torch.Generator().manual_seed(E * 100 + P)
    rows, rows_per_shard = 300, 290
    W = _randn(rows, E, gen=gen).to(dtype)
    g = torch.randint(-20, rows + 20, (7, 5, P), generator=gen, dtype=torch.int32)
    want = ref.embedding_bag(W, g, rows_per_shard)
    before = ops.embedding_bag.launches
    got = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard)
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 1
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,f,e", [(20, 9, 64), (8, 27, 128), (5, 65, 32), (3, 2, 16)])
def test_interaction_kernel_matches_plain(dev, b, f, e):
    """fp32 dot products of length E in another order: rtol 1e-5, atol 1e-4."""
    gen = torch.Generator().manual_seed(b * f * e)
    dense, emb = _randn(b, e, gen=gen), _randn(b, f - 1, e, gen=gen)
    want = ref.dot_interaction(dense, emb)
    got = ops.dot_interaction(dense.to(dev), emb.to(dev))
    torch.cuda.synchronize()
    assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (100, 300, 120), (256, 512, 256), (33, 77, 129),
                                   (5, 100, 1), (130, 1024, 64), (129, 32, 1024)])
@pytest.mark.parametrize("act", ["relu", "none", "sigmoid"])
def test_fused_mlp_kernel_matches_plain(dev, m, k, n, act):
    """Exact bf16 products summed in fp32 in another order (the tensor
    cores' order): rtol = atol = 1e-4 for an fp32 output; a bf16 output may
    round to the neighbouring bf16 value, so rtol 2^-7 there."""
    gen = torch.Generator().manual_seed(m * k + n)
    x = _randn(m, k, gen=gen).to(torch.bfloat16)
    w = _randn(k, n, gen=gen, scale=0.05).to(torch.bfloat16)
    for b in (_randn(n, gen=gen), _randn(n, gen=gen).to(torch.bfloat16)):
        for out_dtype, rtol, atol in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2 ** -7, 1e-4)):
            want = ref.fused_mlp_layer(x, w, b, act, out_dtype)
            got = ops.fused_mlp_layer(x.to(dev), w.to(dev), b.to(dev), act, out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype
            assert_close(got, want, rtol=rtol, atol=atol, what=f"{b.dtype} bias, {out_dtype} out")


def test_serving_step_on_card_matches_cpu(dev):
    """The whole slice at a small size: the same snapshot scored on the card
    (kernels) and on the CPU (plain versions), within the bf16 tolerance
    2e-2; each kernel launched, fused_mlp once per layer."""
    from repro_torch import weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.serve import make_snapshot_score_step

    cfg = dataclasses.replace(dlrm_small(batch=64), table_rows=(1000, 37, 250, 13),
                              num_dense=16, bottom=(32, 64), top=(32, 16), mlp_impl="pallas")
    snap = weights.init_snapshot(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, m, (64, cfg.pooling)) for m in cfg.table_rows], 1)
    batch = {"idx": torch.from_numpy(idx.astype(np.int32)),
             "dense_x": torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)
                                         ).to(torch.bfloat16)}
    want = make_snapshot_score_step(cfg, device="cpu")[0](snap, batch)
    to_dev = {"emb_w": snap["emb_w"].to(dev),
              "dense_hi": {p: {k: [t.to(dev) for t in v] for k, v in d.items()}
                           for p, d in snap["dense_hi"].items()}}
    ops.reset_launches()
    got = make_snapshot_score_step(cfg, device=dev)[0](to_dev, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ops.launches() == {"embedding_bag": 1, "dot_interaction": 1, "fused_mlp": 5}
    assert_close(got, want, rtol=2e-2, atol=2e-2)
