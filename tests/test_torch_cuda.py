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
@pytest.mark.parametrize("E,P", [(16, 3), (64, 50), (128, 1), (256, 33), (256, 100), (512, 7)])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,P", [(16, 3), (64, 50), (128, 1), (256, 33)])
def test_weighted_bag_kernel_matches_plain(dev, dtype, E, P):
    """The weighted variant against its plain version: the same rounded
    products summed in another order, rtol = atol = 1e-5; an out-of-range
    row adds nothing whatever its weight; all-ones weights give the
    unweighted kernel's bits."""
    gen = torch.Generator().manual_seed(E * 10 + P)
    rows, rows_per_shard = 300, 290
    W = _randn(rows, E, gen=gen).to(dtype)
    g = torch.randint(-20, rows + 20, (7, 5, P), generator=gen, dtype=torch.int32)
    w = torch.rand(g.shape, generator=gen) * 4 - 2
    w[0, 0] = 0.0
    g[1, 1, 0], w[1, 1, 0] = rows + 3, float("inf")
    want = ref.embedding_bag(W, g, rows_per_shard, w)
    before = ops.embedding_bag.launches
    got = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard, w.to(dev))
    ones = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard, torch.ones(g.shape, device=dev))
    plain = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard)
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 3
    assert bool(torch.isfinite(got).all()) and not bool(got[0, 0].any())
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(ones.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("b,f,e", [(20, 9, 64), (8, 27, 128), (5, 65, 32), (3, 2, 16)])
def test_interaction_kernel_matches_plain(dev, b, f, e):
    """fp32 dot products of length E in another order: rtol 1e-5, atol 1e-4."""
    gen = torch.Generator().manual_seed(b * f * e)
    dense, emb = _randn(b, e, gen=gen), _randn(b, f - 1, e, gen=gen)
    want = ref.dot_interaction(dense, emb)
    got = ops.dot_interaction(dense.to(dev), emb.to(dev))
    torch.cuda.synchronize()
    assert_close(got, want, rtol=1e-5, atol=1e-4)


def _bag_ids(kind: str, B: int, S: int, P: int, rows: int, gen) -> torch.Tensor:
    """[B, S, P] int32 ids: ``random`` in [-20, rows + 20) (some masked),
    ``repeated`` one row a bag, ``distinct`` P different rows a bag."""
    if kind == "random":
        return torch.randint(-20, rows + 20, (B, S, P), generator=gen, dtype=torch.int32)
    if kind == "repeated":
        return torch.randint(0, rows, (B, S, 1), generator=gen, dtype=torch.int32).expand(
            B, S, P).contiguous()
    return torch.argsort(torch.rand(B, S, rows, generator=gen), dim=2)[..., :P].to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,P,E", [(1, 50, 64), (7, 1, 512), (7, 200, 16), (9, 200, 64),
                                   (5, 50, 512), (8193, 33, 16), (8193, 1, 64)])
@pytest.mark.parametrize("kind", ["random", "repeated", "distinct"])
def test_embedding_bag_kernel_shapes_and_repeats(dev, dtype, B, P, E, kind):
    """Batches of 1 to 8193 samples, pooling 1 to 200 (more than one list of
    64 a bag), rows of 16 to 512 values, bags of one repeated row (one list
    entry of count P) and of P distinct rows: the kernel sums each distinct
    row once times its count, so its sums round apart from the plain in-order
    sum; rtol = atol = 1e-5."""
    gen = torch.Generator().manual_seed(B * 1000 + P * 10 + E)
    rows, rows_per_shard = 300, 290
    W = _randn(rows, E, gen=gen).to(dtype)
    g = _bag_ids(kind, B, 3, P, rows, gen)
    want = ref.embedding_bag(W, g, rows_per_shard)
    got = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard)
    torch.cuda.synchronize()
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("P,E", [(1, 16), (50, 64), (200, 512)])
def test_weighted_bag_masked_inf_and_all_ones(dev, dtype, P, E):
    """Half of the lookups repeat one row, so a row's weights are summed
    across the list's two 32-id words; every masked lookup (negative or past
    the shard) carries an inf or nan weight and adds nothing; the valid
    weights are signed, U[-2, 2).  The kernel sums each distinct row's
    weights before it multiplies, and the plain version sums the products
    in order: where signed sums of 200 terms cancel to near zero, the two
    differ by the rounding of the terms' magnitudes, so each sum is held
    within 4 fp32 eps of the sum of |w * row| over its valid lookups (a sum
    of n terms in any order errs by at most (n - 1) / 2 eps of it, and on
    random data by a small multiple of eps / 2).  All-ones weights give the
    unweighted kernel's bits, repeats included."""
    gen = torch.Generator().manual_seed(P * 100 + E)
    rows, rows_per_shard = 300, 290
    W = _randn(rows, E, gen=gen).to(dtype)
    g = torch.randint(-40, rows + 40, (9, 4, P), generator=gen, dtype=torch.int32)
    g = torch.where(torch.rand(g.shape, generator=gen) < 0.5, g, torch.full_like(g, 3))
    w = torch.rand(g.shape, generator=gen) * 4 - 2
    masked = (g < 0) | (g >= rows_per_shard)
    w[masked] = torch.where(torch.rand(w.shape, generator=gen) < 0.5, float("inf"),
                            float("nan"))[masked]
    want = ref.embedding_bag(W, g, rows_per_shard, w)
    magnitude = ref.embedding_bag(W.abs(), g, rows_per_shard, torch.where(masked, 0.0, w.abs()))
    got = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard, w.to(dev))
    ones = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard, torch.ones(g.shape, device=dev))
    plain = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    err = (got.cpu() - want).abs()
    bound = 4 * torch.finfo(torch.float32).eps * magnitude
    assert bool((err <= bound).all()), float((err / bound.clamp_min(1e-30)).max())
    assert torch.equal(ones.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("dtype,E", [(torch.bfloat16, 16), (torch.bfloat16, 32),
                                     (torch.float32, 16)])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_kernel_narrow_rows_at_large_batches(dev, dtype, E, weighted):
    """Rows narrower than 128 bytes (one to four 16-byte chunks) at 16,384
    samples x 3 slots, a batch large enough for the four-bags-a-warp layout
    on any card of up to 384 SMs: every bag is summed and written (the
    output is not zeroed before the launch), within rtol = atol = 1e-5 of
    the plain version; all-ones weights give the unweighted kernel's bits."""
    gen = torch.Generator().manual_seed(E * 10 + weighted)
    rows, rows_per_shard = 300, 290
    W = _randn(rows, E, gen=gen).to(dtype)
    g = torch.randint(-20, rows + 20, (16384, 3, 5), generator=gen, dtype=torch.int32)
    w = torch.rand(g.shape, generator=gen) + 0.5 if weighted else None
    want = ref.embedding_bag(W, g, rows_per_shard, w)
    got = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard, None if w is None else w.to(dev))
    ones = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard, torch.ones(g.shape, device=dev))
    plain = ops.embedding_bag(W.to(dev), g.to(dev), rows_per_shard)
    torch.cuda.synchronize()
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(ones.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_stage_kernel_within_one_bf16_ulp(dev, dtype, weighted):
    """The fused stage (offset add, bag, bf16 round in one launch) against
    its plain composition: every sum bf16-representable and within one bf16
    ulp of the plain one (the fp32 sums differ in order, so a round may fall
    the other way); one launch of the bag kernel."""
    from repro_torch.testing import bf16_ulps
    gen = torch.Generator().manual_seed(11 + weighted)
    offsets = torch.tensor([0, 100, 150, 290], dtype=torch.int32)
    rows_per_shard = 300
    W = _randn(rows_per_shard + 8, 64, gen=gen).to(dtype)
    idx = torch.randint(-5, 120, (513, 4, 50), generator=gen, dtype=torch.int32)
    idx = torch.where(torch.rand(idx.shape, generator=gen) < 0.5, idx, torch.zeros_like(idx))
    w = torch.rand(idx.shape, generator=gen) + 0.5 if weighted else None
    want = ref.embedding_bag_stage(W, idx, offsets, rows_per_shard, w)
    before = ops.embedding_bag.launches
    got = ops.embedding_bag_stage(W.to(dev), idx.to(dev), offsets.to(dev), rows_per_shard,
                                  None if w is None else w.to(dev))
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 1
    assert not bool((got.cpu().view(torch.int32) & 0xFFFF).any())
    assert int(bf16_ulps(got.cpu().numpy(), want.numpy()).max()) <= 1


@pytest.mark.parametrize("b", [1, 17, 1000])
@pytest.mark.parametrize("f,e", [(2, 16), (9, 64), (9, 512), (27, 128), (65, 32), (65, 512),
                                 (9, 100), (5, 18)])
def test_interaction_kernel_tiles_and_widths(dev, b, f, e):
    """Batches that leave a ragged last tile (1, 17 and 1000 samples), F 2 to
    65, E 16 to 512 (100 and 18: rows not 16-byte multiples, read with 4-byte
    copies where E is not a multiple of 4): rtol 1e-5, atol 1e-4."""
    gen = torch.Generator().manual_seed(b * f + e)
    dense, emb = _randn(b, e, gen=gen), _randn(b, f - 1, e, gen=gen)
    want = ref.dot_interaction(dense, emb)
    before = ops.dot_interaction.launches
    got = ops.dot_interaction(dense.to(dev), emb.to(dev))
    torch.cuda.synchronize()
    assert ops.dot_interaction.launches == before + 1
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


def _fused_mlp_case(dev, m, k, n, act, path):
    """One layer against its plain version (tolerances as above), with the
    launch counted on route ``path`` and on no other."""
    from repro_torch.kernels import fused_mlp
    assert fused_mlp.route(m, k, n) == path
    gen = torch.Generator().manual_seed(m * k + n)
    x = _randn(m, k, gen=gen).to(torch.bfloat16)
    w = _randn(k, n, gen=gen, scale=0.05).to(torch.bfloat16)
    for b in (_randn(n, gen=gen), _randn(n, gen=gen).to(torch.bfloat16)):
        for out_dtype, rtol, atol in ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2 ** -7, 1e-4)):
            before = dict(ops.fused_mlp_layer.route_launches)
            want = ref.fused_mlp_layer(x.to(dev), w.to(dev), b.to(dev), act, out_dtype)
            got = ops.fused_mlp_layer(x.to(dev), w.to(dev), b.to(dev), act, out_dtype)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype and got.shape == (m, n)
            assert ops.fused_mlp_layer.route_launches == {
                **before, path: before[path] + 1}
            assert_close(got, want, rtol=rtol, atol=atol,
                         what=f"{path} [{m}x{k}]@[{k}x{n}], {b.dtype} bias, {out_dtype} out")


@pytest.mark.parametrize("n", [64, 200, 1024])
@pytest.mark.parametrize("k", [8, 520, 1024])
@pytest.mark.parametrize("m", [1, 8, 200, 8192])
def test_fused_mlp_wgmma_route_matches_plain(dev, m, k, n):
    """The TMA + wgmma kernel at the edges of its 128 x 128 tile and its
    64-deep K slices (K = 8 is one ragged slice, 520 ends 8 into one), at
    the serving buckets' M and at the batch; the plain version runs on the
    card too (fp32 products of bf16 values, exact)."""
    _fused_mlp_case(dev, m, k, n, "relu", "wgmma")


@pytest.mark.parametrize("m,k,n", [(8192, 64, 264), (4000, 72, 1000), (8192, 1024, 512)])
def test_fused_mlp_wide_tile_matches_plain(dev, m, k, n):
    """Grids with a tile for about every SM take 128 x 256 output tiles
    (wgmma m64n256k16), here with ragged M and N."""
    _fused_mlp_case(dev, m, k, n, "relu", "wgmma")


@pytest.mark.parametrize("m,k,n", [(8192, 100, 1024), (200, 100, 64), (8192, 1024, 1), (8, 100, 1),
                                   (129, 36, 12)])
@pytest.mark.parametrize("act", ["none", "sigmoid"])
def test_fused_mlp_mma_sync_route_matches_plain(dev, m, k, n, act):
    """Shapes a tensor map cannot take (K = 100, dlrm-small's first top
    layer; N = 1, its last) go to the mma.sync kernel."""
    _fused_mlp_case(dev, m, k, n, act, "mma_sync")


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
    assert ops.launches() == {**{k: 0 for k in ops.KERNELS}, "embedding_bag": 1,
                              "dot_interaction": 1, "fused_mlp": 5}
    assert_close(got, want, rtol=2e-2, atol=2e-2)


def _split_table(M, E, gen):
    from repro_torch.optim.split_sgd import split_fp32
    return split_fp32(torch.rand((M, E), generator=gen) - 0.5)


def _row_stream(case, M, P, gen):
    """(tgt [L] int32, valid [L] bool) for a case: ragged runs, one run of
    10^5 lookups, all runs of length 1, an all-masked tail, or no lookups."""
    if case == "empty":
        return torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.bool)
    if case == "long_run":
        tgt = torch.randint(0, M, (100_000 + 3 * P,), generator=gen, dtype=torch.int32)
        tgt[: 100_000] = 7
    elif case == "distinct":
        tgt = torch.randperm(M, generator=gen)[: (M // P) * P].to(torch.int32)
    else:
        tgt = torch.randint(-3, M + 3, (40 * P,), generator=gen, dtype=torch.int32)
    valid = torch.rand(tgt.shape, generator=gen) > 0.1
    if case == "masked_tail":
        valid[:] = False
    return tgt, valid


@pytest.mark.parametrize("E", [16, 64, 128])
@pytest.mark.parametrize("case", ["ragged", "long_run", "distinct", "masked_tail", "empty"])
def test_row_update_kernels_bitwise_to_plain(dev, E, case):
    """Both row kernels (split and fp32 store) against their plain versions,
    bit for bit: the sums run in the same sorted order, the step is one
    FMA on both sides."""
    from repro_torch.kernels import embedding_update as eu
    gen = torch.Generator().manual_seed(E)
    M, P, lr = 300, 5, 0.1
    tgt, valid = _row_stream(case, M, P, gen)
    dY = torch.randn((max(tgt.numel() // P, 1), E), generator=gen).to(torch.bfloat16)
    hi, lo = _split_table(M, E, gen)
    W = torch.rand((M, E), generator=gen)
    stream = eu.sort_lookups(tgt, valid, M, P)
    want_h, want_l = ref.fused_update_split(hi.clone(), lo.clone(), *stream, dY, lr)
    want_w = ref.fused_update_fp32(W.clone(), *stream, dY, lr)
    d_stream = eu.sort_lookups(tgt.to(dev), valid.to(dev), M, P)
    for a, b in zip(d_stream, stream):
        assert torch.equal(a.cpu(), b)
    before = ops.launches()
    got_h, got_l = ops.fused_update_split(hi.to(dev), lo.to(dev), *d_stream, dY.to(dev), lr)
    got_w = ops.fused_update_fp32(W.to(dev), *d_stream, dY.to(dev), lr)
    torch.cuda.synchronize()
    after = ops.launches()
    assert after["embedding_update"] == before["embedding_update"] + 1
    assert after["embedding_update_fp32"] == before["embedding_update_fp32"] + 1
    for got, want in ((got_h, want_h), (got_l, want_l), (got_w, want_w)):
        assert torch.equal(got.cpu().view(torch.int16 if got.element_size() == 2 else torch.int32),
                           want.view(torch.int16 if want.element_size() == 2 else torch.int32))


# the stateful row kernels: (wrapper, state width (0 = E), state dtype, hp)
STATEFUL = {"momentum": ("fused_update_momentum", 0, torch.float32, 0.9),
            "adagrad": ("fused_update_adagrad", 0, torch.float32, 1e-8),
            "adagrad_rowwise": ("fused_update_adagrad_rowwise", 1, torch.float32, 1e-8),
            "adagrad_freq": ("fused_update_freq", 1, torch.int32, 1e-8),
            "momentum_bf16": ("fused_update_momentum_bf16", 0, torch.bfloat16, 0.9),
            "adagrad_bf16": ("fused_update_adagrad_bf16", 0, torch.bfloat16, 1e-8)}


def _seed_args(name, seed, device):
    """The seed argument of a compressed-state kernel (none for the others)."""
    if STATEFUL[name][2] != torch.bfloat16:
        return ()
    return (torch.tensor(seed, dtype=torch.int32, device=device),)


def _stateful_stream(case, M, P, gen):
    """(tgt [L] int32, valid [L] bool): a run of 300 lookups (ten segments)
    amid ragged ones, with out-of-range ids and masked lookups; the last
    row's live run followed by the masked tail; or every lookup masked."""
    tgt = torch.randint(-3, M + 3, (60 * P,), generator=gen, dtype=torch.int32)
    valid = torch.rand(tgt.shape, generator=gen) > 0.1
    if case == "long_run":
        tgt[:300] = 11
    elif case == "live_tail":
        tgt[-2 * P:] = M - 1
        valid[-2 * P:] = True
        valid[: 4 * P] = False
    else:
        valid[:] = False
    return tgt, valid


def _state(name, M, E, gen):
    _, width, dtype, _ = STATEFUL[name]
    shape = (M, width or E)
    if dtype == torch.int32:
        return torch.randint(0, 50, shape, generator=gen, dtype=torch.int32)
    if name.startswith("momentum"):
        return (torch.randn(shape, generator=gen) * 0.1).to(dtype)
    return (torch.rand(shape, generator=gen) * 0.05).to(dtype)


@pytest.mark.parametrize("E", [64, 128, 96])
@pytest.mark.parametrize("case", ["long_run", "live_tail", "all_masked"])
@pytest.mark.parametrize("name", list(STATEFUL))
def test_stateful_row_kernels_bitwise_to_plain(dev, name, case, E):
    """The six stateful row kernels against their plain versions, bit for
    bit on the weights and the state, at E = 64, 128 and 96 (a ragged last
    block of columns): a run longer than one segment, the last row's live
    run that holds the masked tail, and an all-masked stream (nothing
    written).  The counts of ``adagrad_freq`` are bumped first, as
    ``optim.row.apply_sparse`` does; the compressed-state kinds round at a
    seed near 2^31."""
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.optim.row import bump_counters
    wrapper, _, _, hp = STATEFUL[name]
    gen = torch.Generator().manual_seed(E + len(case))
    M, P, lr = 200, 5, 0.1
    tgt, valid = _stateful_stream(case, M, P, gen)
    dY = torch.randn((tgt.numel() // P, E), generator=gen).to(torch.bfloat16)
    W, S = torch.rand((M, E), generator=gen) - 0.5, _state(name, M, E, gen)
    stream = eu.sort_lookups(tgt, valid, M, P)
    if name == "adagrad_freq":
        bump_counters(S, stream[0], stream[2])
    want_w, want_s = getattr(ref, wrapper)(W.clone(), S.clone(), *stream, dY, lr, hp,
                                           *_seed_args(name, 2 ** 31 - 3, "cpu"))
    before = getattr(ops, wrapper).launches
    got_w, got_s = getattr(ops, wrapper)(W.to(dev), S.to(dev), *(t.to(dev) for t in stream),
                                         dY.to(dev), lr, hp, *_seed_args(name, 2 ** 31 - 3, dev))
    torch.cuda.synchronize()
    assert getattr(ops, wrapper).launches == before + 1
    assert torch.equal(got_w.cpu().view(torch.int32), want_w.view(torch.int32))
    bits = torch.int16 if S.element_size() == 2 else torch.int32
    assert torch.equal(got_s.cpu().view(bits), want_s.view(bits))
    if case == "all_masked":
        assert torch.equal(want_w, W) and torch.equal(want_s, S)
    else:
        assert not torch.equal(want_w, W)


@pytest.mark.parametrize("name", ["momentum_bf16", "adagrad_bf16"])
def test_compressed_state_kernels_follow_the_seed(dev, name):
    """Two seeds on one stream: each bitwise to its plain version, the
    same weights, a different stored state; the seed is read on the card,
    so the launch makes no host sync."""
    from repro_torch.kernels import embedding_update as eu
    wrapper, _, _, hp = STATEFUL[name]
    gen = torch.Generator().manual_seed(7)
    M, P, E = 200, 5, 64
    tgt, valid = _stateful_stream("long_run", M, P, gen)
    dY = torch.randn((tgt.numel() // P, E), generator=gen).to(torch.bfloat16)
    W, S = torch.rand((M, E), generator=gen) - 0.5, _state(name, M, E, gen)
    stream = eu.sort_lookups(tgt, valid, M, P)
    d_stream = tuple(t.to(dev) for t in stream)
    out = {}
    for seed in (1, -5):
        want = getattr(ref, wrapper)(W.clone(), S.clone(), *stream, dY, 0.1, hp,
                                     torch.tensor(seed, dtype=torch.int32))
        args = (W.clone().to(dev), S.clone().to(dev), *d_stream, dY.to(dev), 0.1, hp,
                torch.tensor(seed, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = getattr(ops, wrapper)(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            bits = torch.int16 if w.element_size() == 2 else torch.int32
            assert torch.equal(g.cpu().view(bits), w.view(bits))
        out[seed] = [t.cpu().clone() for t in got]
    assert torch.equal(out[1][0], out[-5][0])
    assert not torch.equal(out[1][1].view(torch.int16), out[-5][1].view(torch.int16))


def _weighted_stream(M, P, gen):
    """(tgt, valid, wgt) [L]: runs of 40 lookups of a row in one bag group
    whose weights change inside the group, ragged runs, masked lookups,
    zero and negative weights."""
    tgt = torch.randint(-3, M + 3, (60 * P,), generator=gen, dtype=torch.int32)
    tgt[:40] = 11
    tgt[100:200] = 5
    valid = torch.rand(tgt.shape, generator=gen) > 0.1
    wgt = torch.rand(tgt.shape, generator=gen) + 0.5
    wgt[:20] = 0.75
    wgt[20:40] = 1.25
    wgt[100:130] = 0.0
    wgt[130:140] = -0.5
    return tgt, valid, wgt


@pytest.mark.parametrize("E", [64, 96])
@pytest.mark.parametrize("name", ["split_sgd", "sgd", *STATEFUL])
def test_row_kernels_bitwise_to_plain_on_weighted_stream(dev, name, E):
    """Rows 5-12 on a stream with weights other than 1 (groups of equal bag
    whose weight changes, zero and negative weights), bit for bit against
    their plain versions on the weights and the state."""
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.optim.row import bump_counters
    gen = torch.Generator().manual_seed(E + len(name))
    M, P, lr = 200, 5, 0.1
    tgt, valid, wgt = _weighted_stream(M, P, gen)
    dY = torch.randn((tgt.numel() // P, E), generator=gen).to(torch.bfloat16)
    stream = eu.sort_lookups(tgt, valid, M, P, wgt)
    assert len(set(stream[3].tolist())) > 2
    d_stream = tuple(t.to(dev) for t in stream)
    if name == "split_sgd":
        store = _split_table(M, E, gen)
        wrapper, extra = "fused_update_split", ()
    elif name == "sgd":
        store = (torch.rand((M, E), generator=gen) - 0.5,)
        wrapper, extra = "fused_update_fp32", ()
    else:
        store = (torch.rand((M, E), generator=gen) - 0.5, _state(name, M, E, gen))
        wrapper, _, _, hp = STATEFUL[name]
        extra = (hp,)
        if name == "adagrad_freq":
            bump_counters(store[1], stream[0], stream[2])
    want = getattr(ref, wrapper)(*(t.clone() for t in store), *stream, dY, lr, *extra,
                                 *(_seed_args(name, 9, "cpu") if name in STATEFUL else ()))
    want = want if isinstance(want, tuple) else (want,)
    got = getattr(ops, wrapper)(*(t.clone().to(dev) for t in store), *d_stream, dY.to(dev), lr,
                                *extra,
                                *(_seed_args(name, 9, dev) if name in STATEFUL else ()))
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        bits = torch.int16 if w.element_size() == 2 else torch.int32
        assert torch.equal(g.cpu().view(bits), w.view(bits))
    assert not torch.equal(want[0], store[0])



def _row_store(name, M, E, gen):
    """(wrapper, store slabs, extra args before the seed) of a row kind."""
    if name == "split_sgd":
        return "fused_update_split", _split_table(M, E, gen), ()
    if name == "sgd":
        return "fused_update_fp32", (torch.rand((M, E), generator=gen) - 0.5,), ()
    wrapper, _, _, hp = STATEFUL[name]
    return wrapper, (torch.rand((M, E), generator=gen) - 0.5, _state(name, M, E, gen)), (hp,)


def _row_kernel_bitwise(dev, name, E, tgt, valid, wgt, P, dtype, gen, M, offset=0):
    """Run one row kind's kernel and its plain version on one stream (the
    counts of ``adagrad_freq`` bumped first), assert them bit for bit on
    every slab, and return (wrapper, store, plain result, sorted stream).
    The card's ``dY`` starts ``offset`` values into its allocation."""
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.optim.row import bump_counters
    dY = (torch.randn((max(tgt.numel() // P, 1), E), generator=gen) * 0.5).to(dtype)
    stream = eu.sort_lookups(tgt, valid, M, P, wgt)
    wrapper, store, extra = _row_store(name, M, E, gen)
    if name == "adagrad_freq":
        bump_counters(store[1], stream[0], stream[2])
    seed = _seed_args(name, 2 ** 31 - 3, "cpu") if name in STATEFUL else ()
    want = getattr(ref, wrapper)(*(t.clone() for t in store), *stream, dY, 0.1, *extra, *seed)
    want = want if isinstance(want, tuple) else (want,)
    before = getattr(ops, wrapper).launches
    d_dY = torch.empty(offset + dY.numel(), dtype=dtype, device=dev)[offset:].view(dY.shape)
    d_dY.copy_(dY)
    got = getattr(ops, wrapper)(*(t.clone().to(dev) for t in store), *(t.to(dev) for t in stream),
                                d_dY, 0.1, *extra,
                                *(_seed_args(name, 2 ** 31 - 3, dev) if seed else ()))
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert getattr(ops, wrapper).launches == before + 1
    for g, w in zip(got, want):
        bits = torch.int16 if w.element_size() == 2 else torch.int32
        assert torch.equal(g.cpu().view(bits), w.view(bits))
    return getattr(ops, wrapper), store, want, stream


def _edge_stream(case, M, P, gen):
    """(tgt, valid, wgt or None, long rows): ragged short runs of random rows
    (none of the long runs' rows 7 and 9) beside the case's long runs, each
    half a block of whole bags in flat order (groups of P equal lookups:
    segments summed group by group) and half scattered (a group a lookup)."""
    from repro_torch.kernels import embedding_update as eu
    T = eu.long_run()
    lengths = {"none": [], "T-1": [T - 1], "T": [T], "T+1": [T + 1],
               "ring": [4 * 8 * 32],  # four turns of the 8-stage ring, its last segment full
               "wrap": [50_000], "two": [T + 37, 3 * T], "weighted": [4 * T + 5],
               "masked_tail": [], "all_masked": []}[case]
    n_rest = 40 * P + sum(lengths)  # room for the scattered halves
    rest = torch.randint(-3, M + 3, (n_rest,), generator=gen, dtype=torch.int32)
    rest[(rest == 7) | (rest == 9)] = 11
    parts, scattered = [], []
    for r, n in zip((7, 9), lengths):
        block = (n // 2) // P * P
        parts.append(torch.full((block,), r, dtype=torch.int32))
        scattered += [r] * (n - block)
    tgt = torch.cat(parts + [rest]) if parts else rest
    valid = torch.rand(tgt.shape, generator=gen) > 0.1
    head = sum(p.numel() for p in parts)
    valid[:head] = True
    if scattered:
        where = head + torch.randperm(n_rest, generator=gen)[: len(scattered)]
        tgt[where] = torch.tensor(scattered, dtype=torch.int32)
        valid[where] = True
    if case == "masked_tail":  # the last row's 300 valid lookups, then T masked ones
        tgt = torch.cat([tgt, torch.full((300,), M - 1, dtype=torch.int32),
                         torch.randint(0, M, (T,), generator=gen, dtype=torch.int32)])
        valid = torch.cat([valid, torch.ones(300, dtype=torch.bool),
                           torch.zeros(T, dtype=torch.bool)])
    elif case == "all_masked":
        tgt = torch.randint(0, M, (2 * T,), generator=gen, dtype=torch.int32)
        valid = torch.zeros(tgt.shape, dtype=torch.bool)
    pad = -tgt.numel() % P  # whole bags
    tgt = torch.cat([tgt, torch.full((pad,), 11, dtype=torch.int32)])
    valid = torch.cat([valid, torch.full((pad,), case != "all_masked", dtype=torch.bool)])
    wgt = None
    if case == "weighted":  # every weight differs
        wgt = torch.randperm(tgt.numel(), generator=gen).float() / tgt.numel() + 0.5
    return tgt, valid, wgt


EDGE_CASES = ["none", "T-1", "T", "T+1", "ring", "wrap", "two", "weighted", "masked_tail",
              "all_masked"]
ROW_KINDS = ["split_sgd", "sgd", *STATEFUL]


@pytest.mark.parametrize("E", [64, 128])
@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("name", ROW_KINDS)
def test_row_walk_edges_bitwise_to_plain(dev, name, case, E):
    """The two schedules of the run walk, every kind, bit for bit against
    the plain versions on every slab: a run of T - 1 (the short walk), T and
    T + 1 positions (the long one), a run of whole turns of the ring, one
    that wraps it some 200 times, two long runs in one launch, a weighted
    long run whose every weight differs, a long run that ends in the masked
    tail, an all-masked stream of 2T lookups (one dead long run: nothing
    written, state included), none; at E = 64 and 128 (row-wise Adagrad's
    second walk).  The launch's list holds exactly the runs of T or more."""
    from repro_torch.kernels import embedding_update as eu
    gen = torch.Generator().manual_seed(E + 7 * EDGE_CASES.index(case))
    M, P = 300, 20
    tgt, valid, wgt = _edge_stream(case, M, P, gen)
    wrapper, store, want, stream = _row_kernel_bitwise(dev, name, E, tgt, valid, wgt, P,
                                                       torch.bfloat16, gen, M)
    _, counts = torch.unique_consecutive(stream[0], return_counts=True)
    assert int(wrapper.long_runs) == int((counts >= eu.long_run()).sum())
    if case == "all_masked":
        assert int(wrapper.long_runs) == 1
        for w, s in zip(want, store):
            assert torch.equal(w, s)


@pytest.mark.parametrize("case", ["wrap", "weighted", "none"])
@pytest.mark.parametrize("name", ROW_KINDS)
def test_row_kernels_fp32_cotangent_bitwise_to_plain(dev, name, case):
    """Every kind with an fp32 cotangent (the reference's own type, values
    bf16 cannot hold), bit for bit against its plain version, on both
    schedules: a long run amid short ones, a weighted one, short runs only."""
    gen = torch.Generator().manual_seed(31 + len(name))
    M, P = 300, 20
    tgt, valid, wgt = _edge_stream(case, M, P, gen)
    _, store, want, _ = _row_kernel_bitwise(dev, name, 96, tgt, valid, wgt, P, torch.float32,
                                            gen, M)
    assert not torch.equal(want[0], store[0])

NARROW = {"bf16 E36": (torch.bfloat16, 36, 0), "bf16 E100": (torch.bfloat16, 100, 0),
          "fp32 E34": (torch.float32, 34, 0), "bf16 dY 8 bytes in": (torch.bfloat16, 64, 4),
          "fp32 dY 8 bytes in": (torch.float32, 64, 2)}


@pytest.mark.parametrize("layout", list(NARROW))
@pytest.mark.parametrize("name", ROW_KINDS)
def test_row_walk_narrow_copies_bitwise_to_plain(dev, name, layout):
    """The long schedule's producers copy a lane's two columns of a row
    (4 or 8 bytes) where 16-byte chunks do not fit: a row width that is no
    whole number of chunks (bf16 at E = 36 and 100, fp32 at 34) or a ``dY``
    that starts 8 bytes past a 16-byte boundary.  Every kind, bit for bit
    against its plain version, on two long runs amid short ones."""
    from repro_torch.kernels import embedding_update as eu
    dtype, E, offset = NARROW[layout]
    gen = torch.Generator().manual_seed(53 + len(name) + E)
    M, P = 300, 20
    tgt, valid, wgt = _edge_stream("two", M, P, gen)
    wrapper, store, want, stream = _row_kernel_bitwise(dev, name, E, tgt, valid, wgt, P, dtype,
                                                       gen, M, offset)
    _, counts = torch.unique_consecutive(stream[0], return_counts=True)
    assert int(wrapper.long_runs) == 2 == int((counts >= eu.long_run()).sum())
    assert not torch.equal(want[0], store[0])


def test_row_kernel_launches_from_two_threads_bitwise_to_plain(dev):
    """Two threads launch the row update at once, each on a stream of its
    own and on its own table, five times each: the side stream and its
    events, which a device's callers share, keep each launch's short runs
    after its own inputs and before its caller's next launch.  Each table
    bit for bit its plain version's after the five updates."""
    import threading
    from repro_torch.kernels import embedding_update as eu
    gen = torch.Generator().manual_seed(77)
    M, P, E = 300, 20, 64
    jobs = []
    for _ in range(2):
        tgt, valid, wgt = _edge_stream("two", M, P, gen)
        stream = eu.sort_lookups(tgt, valid, M, P, wgt)
        dY = (torch.randn((tgt.numel() // P, E), generator=gen) * 0.5).to(torch.bfloat16)
        W = torch.rand((M, E), generator=gen) - 0.5
        want = W.clone()
        for _ in range(5):
            want = ref.fused_update_fp32(want, *stream, dY, 0.1)
        jobs.append((W.to(dev), tuple(t.to(dev) for t in stream), dY.to(dev), want))
    torch.cuda.synchronize()
    errors = []

    def run(W, stream, dY):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for _ in range(5):
                    ops.fused_update_fp32(W, *stream, dY, 0.1)
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=job[:3]) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for W, _, _, want in jobs:
        assert torch.equal(W.cpu(), want)


def test_stateful_row_kernels_refuse_bad_state(dev):
    """A state slab of the wrong width or type raises before any launch."""
    from repro_torch.kernels import embedding_update as eu
    W = torch.zeros(8, 16, device=dev)
    stream = eu.sort_lookups(torch.zeros(4, dtype=torch.int32, device=dev), None, 8, 2)
    dY = torch.zeros(2, 16, dtype=torch.bfloat16, device=dev)
    before = ops.launches()
    with pytest.raises(TypeError):
        ops.fused_update_adagrad_rowwise(W, torch.zeros(8, 16, device=dev), *stream, dY, 0.1, 1e-8)
    with pytest.raises(TypeError):
        ops.fused_update_freq(W, torch.zeros(8, 1, device=dev), *stream, dY, 0.1, 1e-8)
    with pytest.raises(TypeError):
        ops.fused_update_momentum(W, torch.zeros(8, 1, device=dev), *stream, dY, 0.1, 0.9)
    assert ops.launches() == before


@pytest.mark.parametrize("n", [1, 7, 8, 1001, 4096 * 3 + 5, 3_811_396])
def test_split_sgd_kernel_bitwise_to_plain(dev, n):
    """The flat Split-SGD kernel against its plain version, bit for bit, at
    odd lengths (the tail of n % 8 elements) and at dlrm-small's padded
    dense size."""
    from repro_torch.optim.split_sgd import split_fp32
    gen = torch.Generator().manual_seed(n)
    hi, lo = split_fp32(torch.randn(n, generator=gen))
    g = torch.randn(n, generator=gen) * 1e-2
    want_h, want_l = ref.split_sgd(hi.clone(), lo.clone(), g, 0.1)
    before = ops.split_sgd.launches
    got_h, got_l = ops.split_sgd(hi.to(dev), lo.to(dev), g.to(dev), 0.1)
    torch.cuda.synchronize()
    assert ops.split_sgd.launches == before + 1
    assert torch.equal(got_h.cpu().view(torch.int16), want_h.view(torch.int16))
    assert torch.equal(got_l.cpu(), want_l)


def test_new_kernels_refuse_bad_inputs(dev):
    """A non-contiguous input, a wrong dtype or a cotangent that is neither
    bf16 nor fp32 raises before any launch."""
    from repro_torch.kernels import embedding_update as eu
    hi = torch.zeros(8, 16, dtype=torch.bfloat16, device=dev)
    lo = torch.zeros(8, 16, dtype=torch.int16, device=dev)
    stream = eu.sort_lookups(torch.zeros(4, dtype=torch.int32, device=dev), None, 8, 2)
    dY = torch.zeros(2, 16, dtype=torch.bfloat16, device=dev)
    before = ops.launches()
    with pytest.raises(TypeError):
        ops.fused_update_split(hi, lo, *stream, dY.double(), 0.1)
    with pytest.raises(ValueError):
        ops.fused_update_split(hi.t().contiguous().t(), lo, *stream, dY, 0.1)
    with pytest.raises(ValueError):
        ops.fused_update_fp32(torch.zeros(16, 8, device=dev).t(), *stream, dY, 0.1)
    with pytest.raises(ValueError):
        ops.split_sgd(hi[:, 0], lo[:, 0], torch.zeros(8, device=dev), 0.1)
    with pytest.raises(TypeError):
        ops.split_sgd(hi.view(-1), lo.view(-1), torch.zeros(128, device=dev, dtype=torch.float64),
                      0.1)
    assert ops.launches() == before


def _small_train_cfg(**over):
    from repro_torch.configs.dlrm_paper import dlrm_small
    return dataclasses.replace(dlrm_small(batch=64), table_rows=(1000, 37, 250, 13), num_dense=16,
                               bottom=(32, 64), top=(32, 16), **over)


def _small_batches(cfg, n, dev):
    """n zipf batches on ``dev``; with ``cfg.weighted``, weights U[0.5, 1.5)."""
    from repro_torch.data.synthetic import dlrm_stream
    rng = np.random.default_rng(1)
    out = []
    for b, _ in zip(dlrm_stream(0, cfg, 1.05), range(n)):
        out.append({"idx": torch.from_numpy(b["idx"]).to(dev),
                    "dense_x": torch.from_numpy(b["dense_x"]).to(dev).to(torch.bfloat16),
                    "labels": torch.from_numpy(b["labels"]).to(dev)})
        if cfg.weighted:
            w = rng.uniform(0.5, 1.5, b["idx"].shape).astype(np.float32)
            out[-1]["weights"] = torch.from_numpy(w).to(dev)
    return out


ROW_KERNEL = {"split_sgd": "embedding_update", "sgd": "embedding_update_fp32",
              "momentum": "embedding_update_momentum", "adagrad": "embedding_update_adagrad",
              "adagrad_rowwise": "embedding_update_adagrad_rowwise",
              "adagrad_freq": "embedding_update_freq",
              "momentum_bf16": "embedding_update_momentum_bf16",
              "adagrad_bf16": "embedding_update_adagrad_bf16"}


@pytest.mark.parametrize("opt", list(ROW_KERNEL))
def test_train_step_on_card_matches_cpu_and_does_not_sync(dev, opt):
    """Two steps on the card (kernels) against the same steps on the CPU
    (plain versions) from one state: losses within 1e-4 relative, the fp32
    master rows of the store within 1e-2 of the second step's largest
    update (the matmuls and the interaction sum in other orders on the
    card, so a bf16 cotangent may round to its neighbour, 2^-8 relative,
    and the row sums carry that into the update).  Each step launches the bag, the
    interaction, the row update and the dense update once, fused_mlp never,
    and makes no host sync (``set_sync_debug_mode("error")``)."""
    from repro_torch import weights
    from repro_torch.core import dlrm
    cfg = _small_train_cfg(sparse_optimizer=opt, weighted=opt.endswith("bf16"))
    cpu_state = dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = weights.state_to(cpu_state, dev)
    batches = _small_batches(cfg, 2, dev)
    step, cpu_step = dlrm.make_train_step(cfg, device=dev), dlrm.make_train_step(cfg, device="cpu")
    step(state, batches[0])  # builds the kernels before the sync check
    torch.cuda.synchronize()
    cpu_state, _ = cpu_step(cpu_state, {k: v.cpu() for k, v in batches[0].items()})
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = ops.launches()
    assert counts == {**{k: 0 for k in counts}, "embedding_bag": 1, "dot_interaction": 1,
                      ROW_KERNEL[opt]: 1, "split_sgd": 1}
    if "sr" in state:  # two steps from sr_seed 0, each adding one on the card
        assert int(state["sr"]) == 2
    from repro_torch.optim.split_sgd import combine_split

    def master(store):
        return store["w"] if "w" in store else combine_split(store["hi"], store["lo"])

    old = master(cpu_state["emb"]).clone()
    cpu_state, cpu_loss = cpu_step(cpu_state, {k: v.cpu() for k, v in batches[1].items()})
    assert_close(loss.cpu(), cpu_loss, rtol=1e-4, atol=0)
    want = master(cpu_state["emb"])
    largest = float((want - old).abs().max())
    assert largest > 0
    assert_close(master(state["emb"]).cpu(), want, rtol=0, atol=1e-2 * largest)


@pytest.mark.parametrize("tensor_source", [False, True])
def test_prefetch_to_card_keeps_order_and_values(dev, tensor_source):
    """Batches of numpy arrays (or CPU tensors) copied to the card ahead of
    the consumer on a side stream come out in order with their values, also
    when the consumer keeps every batch while later ones are copied (the
    allocator must not hand a batch's memory to the next copy); other leaves
    pass through."""
    from repro_torch.train import prefetch_to_device
    rng = np.random.default_rng(3)
    src = [{"idx": rng.integers(0, 100, (256, 8, 50)).astype(np.int32),
            "dense_x": rng.standard_normal((256, 512)).astype(np.float32), "n": i}
           for i in range(12)]
    feed = ([{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
             for b in src] if tensor_source else src)
    it = prefetch_to_device(iter(feed), size=3, device=dev)
    got = []
    for b in it:
        assert b["idx"].device.type == "cuda" and b["n"] == len(got)
        got.append({k: v * 1 if isinstance(v, torch.Tensor) else v for k, v in b.items()})
        got[-1]["raw"] = b
    torch.cuda.synchronize()
    assert len(got) == 12 and it.stats["batches"] == 12
    for want, b in zip(src, got):
        for k in ("idx", "dense_x"):
            np.testing.assert_array_equal(b[k].cpu().numpy(), want[k])
            np.testing.assert_array_equal(b["raw"][k].cpu().numpy(), want[k])


def test_checkpoint_on_card_restores_bitwise_and_trains_on(dev, tmp_path):
    """An async save of a train state on the card while the step goes on
    updating it in place; a restore into a state drawn from another seed
    gives the saved state bit for bit, on the card, its dense ``hi`` leaves
    views of one flat buffer (so the dense update runs in place), and a step
    from it equals the same step from the saved state, loss and weights."""
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dlrm
    from repro_torch.optim import data_parallel as dp
    cfg = _small_train_cfg(sparse_optimizer="momentum_bf16", weighted=True)
    state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = dlrm.make_train_step(cfg, device=dev)
    batches = _small_batches(cfg, 4, dev)
    for b in batches[:2]:
        state, _ = step(state, b)
    saved = weights.state_to(state, dev)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, state)
    state, _ = step(state, batches[2])          # in place, while the writer runs
    mgr.wait()
    other = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    at, back = mgr.restore(other, device=dev)
    assert at == 2
    for a, b in zip(dp.tree_leaves(back), dp.tree_leaves(saved)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
    lo = back["dense"]["lo"]
    flat = dp.flat_hi(back["dense"]["hi"], lo.numel())
    assert flat is not None and flat.device.type == "cuda"
    back, loss = step(back, batches[2])
    assert dp.flat_hi(back["dense"]["hi"], lo.numel()) is flat   # updated in place
    saved, want = step(saved, batches[2])
    torch.cuda.synchronize()
    assert float(loss) == float(want)
    for a, b in zip(dp.tree_leaves(back), dp.tree_leaves(saved)):
        assert torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_eval_step_on_card_matches_cpu(dev, impl):
    """``make_eval_step`` on the card (bag, interaction and, with ``pallas``,
    fused_mlp kernels) against the CPU (plain versions) on one state, the
    logits within the serving gate's 3e-3 (the scores sit near 0.5, where a
    tolerance on them would pass an eval step that ignores its inputs); its
    kernels launched once each (fused_mlp a layer)."""
    from repro_torch import weights
    from repro_torch.core import dlrm
    cfg = _small_train_cfg(mlp_impl=impl)
    cpu_state = dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = _small_batches(cfg, 1, dev)[0]
    want = dlrm.make_eval_step(cfg, device="cpu")(cpu_state, {k: v.cpu() for k, v in b.items()})
    ev = dlrm.make_eval_step(cfg, device=dev)
    state = weights.state_to(cpu_state, dev)
    ev(state, b)
    ops.reset_launches()
    got = ev(state, b)
    torch.cuda.synchronize()
    layers = len(cfg.bottom_sizes) - 1 + len(cfg.top_sizes) - 1
    assert ops.launches() == {**{k: 0 for k in ops.KERNELS}, "embedding_bag": 1,
                              "dot_interaction": 1, "fused_mlp": layers if impl == "pallas" else 0}
    assert bool(((got > 0) & (got < 1)).all())
    assert_close(torch.logit(got.double()).cpu(), torch.logit(want.double()), rtol=0, atol=3e-3)


# the kernel phase's attention cases at a small size: (B, H, Hkv, Lq, Lk, D, causal, window,
# softcap); the last two rows have queries that see no key (Lq > Lk, causal)
FLASH_CASES = {
    "internlm2 prefill": (2, 4, 2, 300, 300, 128, True, 0, 0.0),
    "gemma2 local": (1, 4, 2, 700, 700, 128, True, 256, 50.0),
    "gemma2 global": (1, 4, 2, 700, 700, 128, True, 0, 50.0),
    "ragged": (1, 2, 1, 200, 200, 64, True, 0, 0.0),
    "right-aligned": (2, 4, 4, 70, 300, 128, True, 0, 0.0),
    "non-causal": (1, 4, 2, 100, 257, 64, False, 0, 0.0),
    "one query": (3, 4, 2, 1, 300, 128, True, 100, 0.0),
    "no visible key": (1, 2, 2, 150, 100, 128, True, 0, 0.0),
    "no visible key, window": (1, 2, 1, 300, 200, 64, True, 50, 30.0),
    # the edges of the kernel's 128-query block and its 64-row consumers
    "Lq 127": (1, 4, 2, 127, 127, 128, True, 0, 0.0),
    "Lq 128": (1, 4, 2, 128, 128, 64, True, 0, 0.0),
    "Lq 129": (2, 4, 2, 129, 129, 128, True, 0, 0.0),
    "Lq 257": (1, 4, 1, 257, 257, 64, True, 0, 0.0),
    "Lq 129, non-causal": (1, 2, 1, 129, 257, 64, False, 0, 0.0),
    "one query, 4096 keys": (2, 4, 2, 1, 4096, 128, True, 0, 0.0),
    "window ends inside a block": (1, 4, 2, 500, 500, 128, True, 100, 0.0),
    "window inside a block, softcap": (1, 4, 2, 300, 300, 64, True, 70, 30.0),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(dev, case):
    """The kernel against its plain version (the same 128-key tiles) on the
    same bf16 inputs on the card: rtol = atol = 2^-7.  Both round p to bf16
    against the running max, but the fp32 score sums and the exponentials
    differ in their last bits, so a p or an output may round to its bf16
    neighbour (2^-8 to 2^-7 relative); an output near 0 is a sum that
    cancels, so its error is a share of the v scale (about 1).  At most 2%
    of the outputs differ, and at most 0.25% by more than one bf16 ulp of
    their own value (chip_smoke's attention phase measured up to 1.02% and
    0.13%).  A query that sees no key gives exactly 0."""
    B, H, Hkv, Lq, Lk, D, causal, window, softcap = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(Lq * 7 + Lk)
    q, k, v = (_randn(B, h, n, D, gen=gen).to(torch.bfloat16)
               for h, n in ((H, Lq), (Hkv, Lk), (Hkv, Lk)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = ref.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert_close(got, want, rtol=2 ** -7, atol=2 ** -7, what=case)
    w = want.float().abs().clamp_min(2.0 ** -126)
    ulps = (got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(w)) - 7)
    assert float((got != want).float().mean()) <= 0.02, case
    assert float((ulps > 1).float().mean()) <= 0.0025, case
    if case.startswith("no visible key"):
        blind = want.float().abs().amax(dim=(0, 1, 3)) == 0
        assert blind.any() and (got[:, :, blind] == 0).all()


def test_flash_attention_refuses_bad_inputs(dev):
    """An fp32 or fp16 tensor, a head dim other than 64 or 128, a
    non-contiguous tensor or H % Hkv != 0 raises before any launch."""
    q = torch.zeros(1, 4, 16, 128, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16, device=dev)
    before = ops.flash_attention.launches
    with pytest.raises(TypeError):
        ops.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.half(), k)
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                            k[..., :96].contiguous())
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :3].contiguous(), k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k.cpu())
    assert ops.flash_attention.launches == before


def _small_lm(name):
    """A reduced LM at a head dim the kernel takes: 4 layers, d_model 256."""
    from repro_torch.configs import gemma2_27b, internlm2_1_8b
    base = {"internlm2-1.8b": internlm2_1_8b, "gemma2-27b": gemma2_27b}[name].config()
    return dataclasses.replace(base, n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                               d_head=64, d_ff=512, vocab=1000, window=48, attn_impl="pallas")


@pytest.mark.parametrize("name", ["internlm2-1.8b", "gemma2-27b"])
def test_lm_serving_on_card_matches_cpu(dev, name):
    """Prefill and one decode step of a reduced LM on the card (the flash
    kernel, cuBLAS) against the same on the CPU (the plain version): logits
    within 2e-2 and the cache (values of standard deviation about 1) within
    5e-2: the bf16 activations round apart when the sums run in another
    order, and the roundings carry through four layers; the decode step
    within 5e-2 of the CPU's prefill of L + 1 tokens, the tolerance of
    tests/test_models.py::test_decode_matches_prefill.  The kernel launched
    once a layer in the prefill and never in the decode."""
    from repro_torch import weights
    from repro_torch.models import lm_steps
    cfg = _small_lm(name)
    B, L = 2, 100
    params = weights.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, L + 1), generator=torch.Generator().manual_seed(1))
    prefill_cpu, _ = lm_steps.make_prefill_step(cfg, B, L, device="cpu")
    prefill, _ = lm_steps.make_prefill_step(cfg, B, L, device=dev)
    want, want_cache = prefill_cpu(params, toks[:, :L])
    gpu_params = weights.lm_params_to(params, dev)
    ops.reset_launches()
    got, cache = prefill(gpu_params, toks[:, :L].to(dev))
    torch.cuda.synchronize()
    assert ops.launches() == {**{k: 0 for k in ops.KERNELS}, "flash_attention": cfg.n_layers}
    assert_close(got, want, rtol=0, atol=2e-2, what="prefill logits")
    for k in ("k", "v"):
        assert_close(cache[k], want_cache[k], rtol=0, atol=5e-2, what=f"{k} cache")

    grown = {k: torch.zeros(v.shape[:-2] + (L + 4, v.shape[-1]), dtype=v.dtype, device=dev)
             for k, v in cache.items()}
    for k in grown:
        grown[k][..., :L, :] = cache[k]
    decode, _ = lm_steps.make_decode_step(cfg, B, L + 4, device=dev)
    pos = torch.full((B,), L, dtype=torch.int32, device=dev)
    ops.reset_launches()
    logits, grown = decode(gpu_params, grown, toks[:, L].to(dev), pos)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == 0
    want_next, _ = lm_steps.make_prefill_step(cfg, B, L + 1, device="cpu")[0](params, toks)
    assert_close(logits, want_next, rtol=0, atol=5e-2, what="decode logits")


# ---------------------------------------------------------------------------
# The rest of the step's exchange surface: the host pre-sort, the wires and
# microbatches, on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed,tag", [((7,), 0, 0), ((33, 8, 64), -3, 0xDE100001),
                                            ((1000, 129), 2 ** 31 - 1, 12345)])
def test_wire_dither_on_card_is_the_cpu_s(dev, shape, seed, tag):
    """``wire_noise`` and ``sr_round_bf16_wire`` on the card bit for bit
    the CPU's, the seed a 0-d tensor on the card or an int, with no host
    sync."""
    from repro_torch.optim import stochastic
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 3
    sd = torch.tensor(seed, dtype=torch.int32)
    want = stochastic.sr_round_bf16_wire(x, sd, tag)
    x_dev, sd_dev = x.to(dev), sd.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [stochastic.sr_round_bf16_wire(x_dev, s, tag) for s in (sd_dev, seed)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g in got:
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu().view(torch.int16), want.view(torch.int16))
    assert torch.equal(stochastic.wire_noise(sd.to(dev), tag, shape).cpu(),
                       stochastic.wire_noise(sd, tag, shape))


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_presort_is_the_card_s_sort(dev, mode, shards):
    """``presort_batch`` on the host bit for bit each shard's
    ``_row_sorted_streams`` on the card, weights in."""
    from repro_torch.core import sharded_embedding as se
    from repro_torch.core.embedding import EmbeddingSpec
    from repro_torch.data.pipeline import PSORT_KEYS, presort_batch
    layout = se.make_layout(EmbeddingSpec((1000, 37, 250, 13), 16), shards, mode)
    rng = np.random.default_rng(shards)
    idx = np.stack([rng.zipf(1.3, (64, 3)) % m for m in (1000, 37, 250, 13)], 1).astype(np.int32)
    w = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    fields = presort_batch(layout, idx, w)
    ids, wt = torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)
    K = layout.slots_per_shard
    if mode == "table":
        ids, wt = (se.permute_indices(layout, t) for t in (ids, wt))
    for s in range(shards):
        mine, ws = (ids, wt) if mode == "row" else (ids[:, s * K:(s + 1) * K],
                                                    wt[:, s * K:(s + 1) * K])
        off = torch.as_tensor(se.local_offsets(layout, s), dtype=torch.int32, device=dev)
        got = se._row_sorted_streams(layout, (mine + off[None, :, None]).reshape(-1), 3,
                                     ws.reshape(-1), s)
        for k, t in zip(PSORT_KEYS, got):
            assert t.device.type == "cuda"
            np.testing.assert_array_equal(t.cpu().numpy(), fields[k][s])


@pytest.mark.parametrize("over", [{}, {"emb_mode": "table", "weighted": True}])
def test_presorted_step_on_card_is_the_device_sorted_step(dev, over):
    """Two ``host_presort`` steps on the card bit for bit two device-sorted
    ones (losses and state), one launch a step of each training kernel."""
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.pipeline import presort_batch
    from repro_torch.optim import data_parallel as dp
    cfg = _small_train_cfg(**over)
    layout = se.make_layout(cfg.spec, 1, cfg.emb_mode)
    state = dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    a, b = weights.state_to(state, dev), weights.state_to(state, dev)
    batches = _small_batches(cfg, 2, dev)
    step = dlrm.make_train_step(cfg, device=dev)
    p_step = dlrm.make_train_step(dataclasses.replace(cfg, host_presort=True), device=dev)
    la, lb = [], []
    for bt in batches:
        fields = presort_batch(layout, bt["idx"].cpu().numpy(),
                               bt["weights"].cpu().numpy() if cfg.weighted else None)
        # table mode's replicated stream: the step reads padded-slot order
        fed = ({**bt, **{k: se.permute_indices(layout, bt[k])
                         for k in ("idx", "weights") if k in bt}}
               if cfg.emb_mode == "table" else bt)
        a, l1 = step(a, fed)
        ops.reset_launches()
        b, l2 = p_step(b, {**fed, **{k: torch.from_numpy(v).to(dev) for k, v in fields.items()}})
        torch.cuda.synchronize()
        counts = ops.launches()
        assert counts == {**{k: 0 for k in counts}, "embedding_bag": 1, "dot_interaction": 1,
                          "embedding_update": 1, "split_sgd": 1}
        la.append(l1)
        lb.append(l2)
    assert torch.equal(torch.stack(la).view(torch.int32), torch.stack(lb).view(torch.int32))
    for x, y in zip(dp.tree_leaves(weights.state_to_global(a)),
                    dp.tree_leaves(weights.state_to_global(b))):
        assert torch.equal(_bit_view(x), _bit_view(y))


@pytest.mark.parametrize("M", [2, 4])
def test_microbatched_step_on_card_matches_cpu(dev, M):
    """Two M-steps on the card against the same steps on the CPU: losses
    within 1e-4 relative, the store's fp32 master within 1e-2 of the
    largest update; the bag and the interaction launched M times a step,
    the row and dense updates once, no host sync."""
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.optim.split_sgd import combine_split
    cfg = _small_train_cfg(microbatches=M)
    cpu_state = dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = weights.state_to(cpu_state, dev)
    old = combine_split(cpu_state["emb"]["hi"], cpu_state["emb"]["lo"]).clone()
    batches = _small_batches(cfg, 2, dev)
    step, cpu_step = dlrm.make_train_step(cfg, device=dev), dlrm.make_train_step(cfg, device="cpu")
    state, _ = step(state, batches[0])  # builds the kernels before the sync check
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = ops.launches()
    assert counts == {**{k: 0 for k in counts}, "embedding_bag": M, "dot_interaction": M,
                      "embedding_update": 1, "split_sgd": 1}
    for b in batches:
        cpu_state, cpu_loss = cpu_step(cpu_state, {k: v.cpu() for k, v in b.items()})
    assert_close(loss.cpu(), cpu_loss, rtol=1e-4, atol=0)
    want = combine_split(cpu_state["emb"]["hi"], cpu_state["emb"]["lo"])
    largest = float((want - old).abs().max())
    assert largest > 0
    assert_close(combine_split(state["emb"]["hi"], state["emb"]["lo"]).cpu(), want, rtol=0,
                 atol=1e-2 * largest)


@pytest.mark.parametrize("wire", ["bf16", "bf16_sr"])
def test_dense_wire_on_card_is_the_cpu_s(dev, wire):
    """One rank's dense Split-SGD step on the ``bf16`` wire (the error
    feedback's slab nonzero at the start) and on ``bf16_sr``, fp32
    gradients bf16 does not hold: ``hi``, ``lo`` and ``err`` on the card bit
    for bit the CPU's."""
    from repro_torch.optim import data_parallel as dp
    gen = torch.Generator().manual_seed(2)
    params = {"w": torch.randn(3001, generator=gen), "b": torch.randn(77, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    out = []
    for d in ("cpu", dev):
        st = dp.init_dp_state({k: v.to(d) for k, v in params.items()}, 1, 0, 4, wire == "bf16")
        if st["err"] is not None:
            st["err"].copy_(torch.randn(st["err"].shape, generator=gen.manual_seed(3)).to(d) * 1e-2)
        new = dp.rs_ag_split_sgd(st, {k: v.to(d) for k, v in grads.items()}, 0.5, 4,
                                 wire_dtype=wire, seed=torch.tensor(9, dtype=torch.int32,
                                                                    device=d))
        out.append([t.cpu() for t in dp.tree_leaves(new["hi"])] + [new["lo"].cpu()]
                   + ([new["err"].cpu()] if new["err"] is not None else []))
    for a, b in zip(*out):
        assert torch.equal(_bit_view(a), _bit_view(b))


def _bit_view(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as integers (16- and 32-bit types)."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


# ---------------------------------------------------------------------------
# The hybrid step at two ranks sharing the card (gloo, payloads staged through
# host memory) against the same two ranks on the CPU
# ---------------------------------------------------------------------------

HYBRID_SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
                    table_rows=(1000, 370, 2500, 130, 600, 210), emb_dim=16, pooling=3,
                    batch=64, lr=0.1)
HYBRID_CASES = {"row-replicated": {}, "row-sharded": {"idx_input": "sharded"},
                "table-replicated": {"emb_mode": "table"},
                "table-sharded": {"emb_mode": "table", "idx_input": "sharded"},
                "row-adagrad_rowwise": {"sparse_optimizer": "adagrad_rowwise", "lr": 0.01},
                "row-sharded-ring": {"idx_input": "sharded", "exchange": {"impl": "ring"}},
                "table-bf16": {"emb_mode": "table", "exchange_dtype": "bf16"},
                "row-bf16_sr-M2": {"exchange_dtype": "bf16_sr", "microbatches": 2}}


@pytest.fixture(scope="module")
def two_ranks_on_card(tmp_path_factory):
    if not has_cuda():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.local import run_ranks
    from _torch_ranks import card_cpu_cases_rank
    cases = [({**HYBRID_SMALL, **over}, 3) for over in HYBRID_CASES.values()]
    ranks = run_ranks(card_cpu_cases_rank, 2, (cases, "cuda:0"), timeout_s=300,
                      store_dir=str(tmp_path_factory.mktemp("ranks")))
    return dict(zip(HYBRID_CASES, zip(*ranks)))


@pytest.mark.parametrize("case", list(HYBRID_CASES))
def test_two_ranks_on_card_match_cpu_ranks(two_ranks_on_card, case):
    """Two processes on one card over gloo train as the same two ranks on
    the CPU: losses within 1e-4 relative, each rank's embedding shard
    (Split-SGD) and dense shard within 1e-2 of the largest update, and the
    card's collectives staged through host memory."""
    for rank, res in enumerate(two_ranks_on_card[case]):
        np.testing.assert_allclose(res["losses"]["card"], res["losses"]["cpu"], rtol=1e-4)
        parts = [(1, "dense")] + ([(0, "embedding")] if "adagrad" not in case else [])
        for i, what in parts:
            upd = np.abs(res["cpu"][i] - res["start"][i]).max()
            assert upd > 0
            np.testing.assert_allclose(res["card"][i], res["cpu"][i], rtol=0, atol=1e-2 * upd,
                                       err_msg=f"rank {rank} {what}")
        assert res["stats"]["staging_s"] > 0 and res["stats"]["calls"]["all-gather"] > 0


# ---------------------------------------------------------------------------
# The hot-row cache on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_in_another_launchs_layout_is_bitwise(dev, dtype, weighted):
    """``layout_bags``: a launch sums in the kernel layout of a launch of
    that many bags (one bag a warp below the launcher's threshold, four a
    warp above), bit for bit: a small batch in the large layout is the large
    launch's rows, a large batch in the small layout the small launch's; the
    two layouts round differently."""
    gen = torch.Generator().manual_seed(7)
    W = _randn(5000, 64, gen=gen).to(dtype).to(dev)
    ids = (torch.rand((4096, 8, 50), generator=gen) ** 4 * 5000).to(torch.int32).to(dev)
    wgt = (torch.rand(ids.shape, generator=gen) + 0.5).to(dev) if weighted else None
    big = ops.embedding_bag(W, ids, 5000, wgt)
    small = ops.embedding_bag(W, ids[:64].contiguous(), 5000,
                              None if wgt is None else wgt[:64].contiguous())
    as_big = ops.embedding_bag(W, ids[:64].contiguous(), 5000,
                               None if wgt is None else wgt[:64].contiguous(), layout_bags=4096 * 8)
    as_small = ops.embedding_bag(W, ids, 5000, wgt, layout_bags=64 * 8)
    torch.cuda.synchronize()
    assert torch.equal(as_big.view(torch.int32), big[:64].view(torch.int32))
    assert torch.equal(as_small[:64].view(torch.int32), small.view(torch.int32))
    assert (small != big[:64]).any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B", [64, 8192])
def test_hot_bag_from_the_kernel_is_the_owners_bag(dev, weighted, B):
    """Table mode at one shard: the hit bags of ``hot_bag_local`` (one launch
    of the bag kernel over the mirror) bit for bit the owner's bags (the
    kernel over the store), at a batch in each kernel layout, weighted too."""
    from repro_torch.core import cache, sharded_embedding as se
    from repro_torch.core.embedding import EmbeddingSpec
    spec = EmbeddingSpec((3000, 2000, 1000, 500), 64)
    layout = se.make_layout(spec, 1, "table")
    gen = torch.Generator().manual_seed(B)
    W = _randn(layout.total_rows, 64, gen=gen).to(torch.bfloat16).to(dev)
    idx = torch.stack([(torch.rand((B, 5), generator=gen) ** 12 * m).to(torch.int32)
                       for m in spec.table_rows], 1).to(dev)
    wgt = (torch.rand(idx.shape, generator=gen) + 0.5).to(dev) if weighted else None
    l2g, g2l = se.layout_gid_maps(layout)
    g = (idx + torch.as_tensor(spec.row_offsets, device=dev, dtype=torch.int32)[None, :, None])
    cnt_gid = torch.bincount(g.reshape(-1).long(), minlength=spec.total_rows)
    cnt = torch.where(torch.as_tensor(l2g >= 0, device=dev),
                      cnt_gid[torch.as_tensor(l2g, device=dev).clamp_min(0).long()], 0)
    ids = cache.select_hot(layout, cnt.to(torch.int32), 64, 0)
    g2l_t = torch.as_tensor(g2l, device=dev)
    hot_w = cache.refresh_hot_slab(layout, W, ids, g2l_t, cache.comm.local_group())
    hot_pos = cache.hot_positions(spec.total_rows, ids)
    maps = se.slot_maps(layout, dev)
    owner = se.table_sharded_bag_fwd(layout, W, se.permute_indices(layout, idx, maps), None,
                                     None if wgt is None else se.permute_indices(layout, wgt, maps),
                                     maps=maps)
    before = ops.embedding_bag.launches
    hit, bag = cache.hot_bag_local(layout, hot_w, hot_pos, idx, wgt,
                                   layout_bags=B * layout.slots_per_shard)
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 1
    assert 0.05 < float(hit.float().mean()) < 1.0
    assert torch.equal(bag[hit].view(torch.int32), owner[hit].view(torch.int32))


@pytest.mark.parametrize("over", [{}, {"sparse_optimizer": "momentum_bf16", "weighted": True},
                                  {"microbatches": 2}])
def test_cached_step_on_card_is_the_cold_step(dev, over):
    """Table mode, the sharded stream, ``hot_rows`` 16 under ``allreduce``
    with the metrics: 4 steps on the card bit for bit the cold steps (losses
    and every other leaf), bags hitting, two launches of the bag kernel a
    microbatch, and a step with no host sync."""
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.optim import data_parallel as dp
    cfg = _small_train_cfg(emb_mode="table", idx_input="sharded", **over)
    hot = dataclasses.replace(cfg, hot_rows=16, promote_every=2, step_metrics=True)
    a = weights.state_to(dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu"), dev)
    b = weights.state_to(dlrm.init_state(hot, torch.Generator().manual_seed(0), device="cpu"), dev)
    batches = _small_batches(cfg, 4, dev)
    step, h_step = dlrm.make_train_step(cfg, device=dev), dlrm.make_train_step(hot, device=dev)
    la, lb = [], []
    for i, bt in enumerate(batches):
        a, l1 = step(a, bt)
        ops.reset_launches()
        if i == 3:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            b, l2 = h_step(b, bt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert ops.launches()["embedding_bag"] == 2 * cfg.microbatches
        la.append(l1)
        lb.append(l2)
    assert torch.equal(torch.stack(la).view(torch.int32), torch.stack(lb).view(torch.int32))
    ga, gb = weights.state_to_global(a), weights.state_to_global(b)
    gb["emb"].pop("cnt")
    for x, y in zip(dp.tree_leaves(ga), dp.tree_leaves({k: gb[k] for k in ga})):
        assert torch.equal(_bit_view(x), _bit_view(y))
    m = gb["metrics"].tolist()
    assert m[0] == 4 and m[2] > 0 and m[3] == 4 * cfg.batch * len(cfg.table_rows)


def test_counter_bump_on_card_is_index_add(dev):
    """The touch counts' bump from the sorted stream's runs on the card,
    bit for bit ``index_add_`` of the masks (a zipf stream: one run holds
    half the lookups)."""
    from repro_torch.optim import row as row_optim
    gen = torch.Generator().manual_seed(3)
    srows = torch.sort((torch.rand(200_000, generator=gen) ** 8 * 50_000).to(torch.int32))[0]
    smsk = (torch.rand(200_000, generator=gen) < 0.9).to(torch.int32)
    start = torch.randint(0, 9, (50_000, 1), generator=gen, dtype=torch.int32)
    got = row_optim.bump_counters(start.to(dev), srows.to(dev), smsk.to(dev))
    assert torch.equal(got.cpu(), start.clone().index_add_(0, srows, smsk[:, None]))


def test_integer_psum_on_one_nccl_rank_is_exact(dev, tmp_path):
    """``comm.psum`` of int32 past 2^24 over a one-rank NCCL group: the
    operand, bit for bit (an fp32 sum would change it)."""
    from repro_torch.launch.local import run_ranks
    from _torch_ranks import int_psum_rank
    (res,) = run_ranks(int_psum_rank, 1, ("cuda:0",), backend="nccl", timeout_s=120,
                       store_dir=str(tmp_path))
    assert res["backend"] == "nccl"
    np.testing.assert_array_equal(res["out"], res["x"])
    assert (res["x"].astype(np.float32).astype(np.int64) != res["x"]).any()


# ---------------------------------------------------------------------------
# Packed ingestion, the launcher and publishing on the card
# ---------------------------------------------------------------------------


def test_packed_loop_first_step_is_the_in_memory_step(dev, tmp_path):
    """A ``TrainLoop`` on the card over ``HostPipeline(ShardedReader)``
    (prefetch 2, the reader's read-only views copied into pinned memory):
    its first step bit for bit (loss and every slab) a bare step on the same
    batch, staged by hand, from the same start state."""
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.data import HostPipeline, ShardedReader
    from repro_torch.data.format import pack_synthetic
    from repro_torch.optim import data_parallel as dp
    from repro_torch.train import TrainLoop, TrainLoopConfig
    cfg = _small_train_cfg()
    pack_synthetic(tmp_path / "ds", cfg.table_rows, cfg.pooling, 4 * cfg.batch,
                   num_dense=cfg.num_dense, alpha=1.05, samples_per_shard=96)
    start = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = dlrm.make_train_step(cfg, device=dev)
    first = next(iter(ShardedReader(tmp_path / "ds", batch=cfg.batch, seed=3)))
    bare, bare_loss = step(weights.state_to(start, dev),
                           {k: torch.from_numpy(np.array(v)).to(dev) for k, v in first.items()})
    loop = TrainLoop(TrainLoopConfig(steps=1, prefetch=2, log_every=100), step,
                     weights.state_to(start, dev),
                     HostPipeline(ShardedReader(tmp_path / "ds", batch=cfg.batch, seed=3)),
                     device=dev)
    state = loop.run()
    assert loop.losses == [float(bare_loss)]
    for x, y in zip(dp.tree_leaves(state), dp.tree_leaves(bare)):
        assert torch.equal(_bit_view(x), _bit_view(y))


def test_launcher_on_card_at_dlrm_smoke(dev, tmp_path):
    """``launch.train.main`` at ``dlrm-smoke`` on the card over a packed
    dataset with the host pre-sort, publishing and the serving smoke: finite
    losses, the row kernel and the Split-SGD kernel once a step, the bag
    kernel once a step plus the served batches, scores in (0, 1)."""
    from repro_torch.data.format import pack_synthetic
    from repro_torch.launch import train as launch
    pack_synthetic(tmp_path / "ds", (5000,) * 8, 10, 512, num_dense=64, alpha=1.05,
                   samples_per_shard=128)
    ops.reset_launches()
    out = launch.main(["--arch", "dlrm-smoke", "--steps", "6", "--batch", "64", "--data-dir",
                       str(tmp_path / "ds"), "--host-presort", "--publish-every", "3",
                       "--serve-smoke"])
    torch.cuda.synchronize()
    n = ops.launches()
    assert len(out["losses"]) == 6 and bool(np.isfinite(out["losses"]).all())
    assert n["embedding_update"] == 6 and n["split_sgd"] == 6
    served = sum(p["n"] for p in out["serve"]["percentiles"].values())
    assert served == 64 and n["embedding_bag"] > 6
    scores = out["serve"]["scores"]
    assert bool(((scores > 0) & (scores < 1)).all())
    assert out["serve"]["freshness"]["version"] == 3


def test_published_clone_survives_in_place_steps_on_card(dev):
    """A snapshot published from a state on the card keeps its bytes
    through three in-place steps that change the state's table."""
    from repro_torch.core import dlrm
    from repro_torch.optim import data_parallel as dp
    from repro_torch.serve import SnapshotPublisher
    cfg = _small_train_cfg()
    state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = dlrm.make_train_step(cfg, device=dev)
    pub = SnapshotPublisher(cfg, publish_every=10)
    snap = pub.publish(0, state)
    before = [t.clone() for t in dp.tree_leaves(snap.state)]
    hi0 = state["emb"]["hi"].clone()
    for b in _small_batches(cfg, 3, dev):
        state, _ = step(state, b)
    torch.cuda.synchronize()
    assert not torch.equal(state["emb"]["hi"], hi0)
    for a, b in zip(dp.tree_leaves(snap.state), before):
        assert torch.equal(_bit_view(a), _bit_view(b))


# the recsys archetypes' embedding widths: FM 11, DIN 18, SASRec 50
RECSYS_E = [11, 18, 50]


def _at_offset(t: torch.Tensor, dev, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``dev`` that starts ``offset`` values into
    its allocation (0: on the allocator's own alignment)."""
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=dev)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("E", RECSYS_E)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bag_at_recsys_widths_bitwise_to_plain(dev, dtype, E, weighted, view):
    """Row 1 at the archetypes' widths (rows no whole number of 16-byte
    chunks: the narrow path), on a table the allocator aligned and on one
    that starts a value past it: bags of one lookup (the archetypes' P = 1)
    bit for bit against the plain stage (offset add, mask, bf16 round) and
    the plain bag, weighted or not; bags of five lookups within the plain
    version's 1e-5 (the CPU's sum of five may pair them otherwise)."""
    gen = torch.Generator().manual_seed(E + 7 * weighted)
    rows, rows_per_shard = 300, 290
    off = 1 if view == "offset" else 0
    W = _randn(rows, E, gen=gen).to(dtype)
    dW = _at_offset(W, dev, off)
    assert (dW.data_ptr() % 16 != 0) == (view == "offset")
    for P in (1, 5):
        idx = torch.randint(-20, 120, (33, 7, P), generator=gen, dtype=torch.int32)
        offsets = torch.randint(0, 170, (7,), generator=gen, dtype=torch.int32)
        w = (torch.rand(idx.shape, generator=gen) + 0.5) if weighted else None
        dw = None if w is None else w.to(dev)
        want = ref.embedding_bag_stage(W, idx, offsets, rows_per_shard, w)
        want_bag = ref.embedding_bag(W, idx + offsets[None, :, None], rows_per_shard, w)
        before = ops.embedding_bag.launches
        got = ops.embedding_bag_stage(dW, idx.to(dev), offsets.to(dev), rows_per_shard, dw)
        got_bag = ops.embedding_bag(dW, (idx + offsets[None, :, None]).to(dev), rows_per_shard,
                                    dw)
        torch.cuda.synchronize()
        assert ops.embedding_bag.launches == before + 2
        if P == 1:
            assert torch.equal(got.cpu(), want) and torch.equal(got_bag.cpu(), want_bag)
        else:
            assert_close(got_bag, want_bag, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("E", RECSYS_E)
@pytest.mark.parametrize("name", ROW_KINDS)
def test_row_kernels_at_recsys_widths_bitwise_to_plain(dev, name, E, view):
    """Rows 5-12 at the archetypes' widths, on slabs the allocator aligned
    and on slabs (and a cotangent) that start a value past it: an odd E, or
    a pair of columns off one access's alignment, takes the narrow path.
    Two long runs (on the narrow path the producers' own loads and stores)
    amid short ones, every kind bit for bit against its plain version on
    every slab; row-wise Adagrad averages over the E real columns."""
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.optim.row import bump_counters
    gen = torch.Generator().manual_seed(97 + E + len(name))
    M, P = 300, 2
    off = 1 if view == "offset" else 0
    tgt, valid, wgt = _edge_stream("two", M, P, gen)
    dY = (torch.randn((tgt.numel() // P, E), generator=gen) * 0.5).to(torch.bfloat16)
    stream = eu.sort_lookups(tgt, valid, M, P, wgt)
    wrapper, store, extra = _row_store(name, M, E, gen)
    if name == "adagrad_freq":
        bump_counters(store[1], stream[0], stream[2])
    seed = _seed_args(name, 2 ** 31 - 3, "cpu") if name in STATEFUL else ()
    want = getattr(ref, wrapper)(*(t.clone() for t in store), *stream, dY, 0.1, *extra, *seed)
    want = want if isinstance(want, tuple) else (want,)
    before = getattr(ops, wrapper).launches
    got = getattr(ops, wrapper)(*(_at_offset(t, dev, off) for t in store),
                                *(t.to(dev) for t in stream), _at_offset(dY, dev, off), 0.1,
                                *extra, *(_seed_args(name, 2 ** 31 - 3, dev) if seed else ()))
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert getattr(ops, wrapper).launches == before + 1
    _, counts = torch.unique_consecutive(stream[0], return_counts=True)
    assert int(getattr(ops, wrapper).long_runs) == int((counts >= eu.long_run()).sum()) == 2
    for g, w in zip(got, want):
        bits = torch.int16 if w.element_size() == 2 else torch.int32
        assert torch.equal(g.cpu().view(bits), w.view(bits))
    assert not torch.equal(want[0], store[0])


# odd widths that reach every layout of the narrow paths: one value a row, a
# group of lanes narrower than, as wide as and past a warp's 32 units, and rows
# of more than 64 columns (the bag's second pass, the row update's second walk)
NARROW_E = [1, 3, 7, 9, 13, 63, 65, 129]


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("E", NARROW_E)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_narrow_bag_at_more_widths_bitwise_to_plain(dev, dtype, E, view):
    """Row 1's narrow path at widths 1 to 129, on a table the allocator
    aligned and on one a value past it, the table's last value the last of
    its allocation: a third of the bags of one lookup, and every bag of three
    as its last lookup, read the table's last row (where a read of a word
    past the row would leave the allocation).  Bags of one lookup bit for bit
    against the plain stage and the plain bag, weighted or not; bags of
    three within 1e-5 (the CPU may pair a bag's sums otherwise)."""
    gen = torch.Generator().manual_seed(3 * E + (dtype == torch.float32) + 5 * (view == "offset"))
    rows = 200
    W = _randn(rows, E, gen=gen).to(dtype)
    dW = _at_offset(W, dev, 1 if view == "offset" else 0)
    for P in (1, 3):
        offsets = torch.randint(0, 50, (5,), generator=gen, dtype=torch.int32)
        idx = torch.randint(-5, rows - 45, (37, 5, P), generator=gen, dtype=torch.int32)
        last = (rows - 1 - offsets)[None, :].expand(37, 5)
        if P == 1:
            idx[::3, :, 0] = last[::3]
        else:
            idx[:, :, P - 1] = last
        gidx = idx + offsets[None, :, None]
        for w in (None, torch.rand(idx.shape, generator=gen) + 0.5):
            dw = None if w is None else w.to(dev)
            want = ref.embedding_bag_stage(W, idx, offsets, rows, w)
            want_bag = ref.embedding_bag(W, gidx, rows, w)
            got = ops.embedding_bag_stage(dW, idx.to(dev), offsets.to(dev), rows, dw)
            got_bag = ops.embedding_bag(dW, gidx.to(dev), rows, dw)
            torch.cuda.synchronize()
            if P == 1:
                assert torch.equal(got.cpu(), want) and torch.equal(got_bag.cpu(), want_bag)
            else:
                assert_close(got_bag, want_bag, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("E", NARROW_E)
@pytest.mark.parametrize("name", ROW_KINDS)
def test_row_kernels_at_more_widths_bitwise_to_plain(dev, name, E, view):
    """Rows 5-12's narrow instances at widths 1 to 129, on a bf16 cotangent
    the allocator aligned and on one a value past it, whose last row ends
    its allocation and is read by a long run (the last bag's lookups are
    rows of the two long runs): every kind bit for bit against its plain
    version on every slab."""
    from repro_torch.kernels import embedding_update as eu
    gen = torch.Generator().manual_seed(11 * E + len(name) + (view == "offset"))
    M, P = 300, 4
    tgt, valid, wgt = _edge_stream("two", M, P, gen)
    tgt[-P:] = torch.tensor([7, 9] * (P // 2), dtype=torch.int32)
    valid[-P:] = True
    wrapper, store, want, stream = _row_kernel_bitwise(dev, name, E, tgt, valid, wgt, P,
                                                       torch.bfloat16, gen, M,
                                                       1 if view == "offset" else 0)
    _, counts = torch.unique_consecutive(stream[0], return_counts=True)
    assert int(wrapper.long_runs) == 2 == int((counts >= eu.long_run()).sum())


@pytest.mark.parametrize("dy_offset", [0, 1])
@pytest.mark.parametrize("E", [11, 13, 18])
@pytest.mark.parametrize("name", ROW_KINDS)
def test_narrow_long_runs_alternate_start_parity(dev, name, E, dy_offset):
    """Two long runs of a narrow walk: row 7 read by every bag in turn
    (consecutive bags, so at an odd E the rows of the cotangent start on
    alternate halves of a word, segment after segment) and row 9 by the odd
    bags only (every row on one half; at E = 18 on the half ``dy_offset``
    puts them), the even bags' second lookups short runs: every kind bit for
    bit against its plain version on every slab."""
    from repro_torch.kernels import embedding_update as eu
    gen = torch.Generator().manual_seed(E + len(name) + 100 * dy_offset)
    M, P, n = 300, 2, 3 * eu.long_run() + 17
    tgt = torch.empty((n, P), dtype=torch.int32)
    tgt[:, 0] = 7
    tgt[:, 1] = torch.randint(10, M, (n,), generator=gen, dtype=torch.int32)
    tgt[1::2, 1] = 9
    tgt = tgt.reshape(-1)
    valid = torch.ones(tgt.shape, dtype=torch.bool)
    wgt = torch.rand(tgt.shape, generator=gen) + 0.5
    wrapper, store, want, stream = _row_kernel_bitwise(dev, name, E, tgt, valid, wgt, P,
                                                       torch.bfloat16, gen, M, dy_offset)
    assert int(wrapper.long_runs) == 2
    assert not torch.equal(want[0], store[0])


# ---------------------------------------------------------------------------
# dlrm-mlperf's shapes (rows 1, 2, 3) and the Fig. 16 run's (rows 1, 4)
# ---------------------------------------------------------------------------

MLPERF_LAYERS = [(13, 512, "relu"), (512, 256, "relu"), (256, 128, "relu"), (479, 512, "relu"),
                 (512, 512, "relu"), (512, 256, "relu"), (256, 1, "none")]


@pytest.mark.parametrize("B", [8, 128, 8192])
def test_bag_at_mlperf_shape_past_two_to_the_31_elements(dev, B):
    """Row 1 at dlrm-mlperf's shape (26 slots, P 1, E 128, bf16) on a table of
    17,000,000 rows (2.18e9 elements, past 2^31), the ids in its last rows:
    the row addresses are int64.  The bags of one lookup are the rows
    themselves: bit for bit the plain version, and the bag stage's too."""
    rows, E, S = 17_000_000, 128, 26
    W = torch.zeros((rows, E), dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(B)
    ids = torch.randint(rows - 4096, rows, (B, S, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0, 0, 0] = rows - 1
    W[ids.view(-1).long()] = torch.randn((B * S, E), generator=gen, device=dev).to(torch.bfloat16)
    assert ids.max().item() * E >= 2 ** 31
    before = ops.embedding_bag.launches
    got = ops.embedding_bag(W, ids, rows)
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 1
    assert torch.equal(got, ref.embedding_bag(W, ids, rows))
    offsets = torch.zeros(S, dtype=torch.int32, device=dev)
    assert torch.equal(ops.embedding_bag_stage(W, ids, offsets, rows),
                       ref.embedding_bag_stage(W, ids, offsets, rows))


@pytest.mark.parametrize("b", [8, 32, 128, 8192])
def test_interaction_at_mlperf_shape(dev, b):
    """Row 2 at dlrm-mlperf's F 27 (26 tables and the dense vector), E 128: a
    479-wide output, rtol 1e-5, atol 1e-4 against the plain version."""
    gen = torch.Generator().manual_seed(b)
    dense, emb = _randn(b, 128, gen=gen), _randn(b, 26, 128, gen=gen)
    want = ref.dot_interaction(dense, emb)
    got = ops.dot_interaction(dense.to(dev), emb.to(dev))
    torch.cuda.synchronize()
    assert got.shape == (b, 479)
    assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [8, 128, 8192])
@pytest.mark.parametrize("k,n,act", MLPERF_LAYERS, ids=[f"{k}x{n}" for k, n, _ in MLPERF_LAYERS])
def test_fused_mlp_at_mlperf_layers(dev, m, k, n, act):
    """Row 3 at every layer of dlrm-mlperf's bottom (13 -> 512 -> 256 -> 128)
    and top (479 -> 512 -> 512 -> 256 -> 1) MLPs: K 13 and 479 and N 1 on
    the mma.sync route (K 13 rows of 26 bytes), the rest on wgmma; the
    tolerances of ``test_fused_mlp_kernel_matches_plain``."""
    from repro_torch.kernels import fused_mlp
    _fused_mlp_case(dev, m, k, n, act, fused_mlp.route(m, k, n))
    if k in (13, 479) or n == 1:
        assert fused_mlp.route(m, k, n) == "mma_sync"


def test_split_sgd_on_fig16_leaves(dev):
    """Row 4 on every leaf of the Fig. 16 example's parameters (the 8,000 x 16
    table, the MLPs' weights and biases; lengths 16 to 128,000), bit for bit
    the plain version, as ``optim.split_sgd.apply_updates`` launches it."""
    import importlib.util
    from pathlib import Path
    from repro_torch.optim import split_sgd as S
    from repro_torch.optim.data_parallel import tree_leaves
    path = Path(__file__).resolve().parents[1] / "examples" / "split_sgd_convergence_torch.py"
    spec = importlib.util.spec_from_file_location("fig16", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    state = S.init(ex.init_params(ex.config(), dev))
    gen = torch.Generator(device=dev).manual_seed(16)
    grads = [torch.randn(h.shape, generator=gen, device=dev).to(torch.bfloat16)
             for h in tree_leaves(state.params.hi)]
    want = [ref.split_sgd(h.reshape(-1).clone(), lo.reshape(-1).clone(), g.float().reshape(-1),
                          0.05)
            for h, lo, g in zip(tree_leaves(state.params.hi), tree_leaves(state.params.lo),
                                grads)]
    before = ops.split_sgd.launches
    S.apply_updates(state, _unflatten(state.params.hi, grads), 0.05)
    torch.cuda.synchronize()
    assert ops.split_sgd.launches == before + len(grads)
    for h, lo, (wh, wl) in zip(tree_leaves(state.params.hi), tree_leaves(state.params.lo), want):
        assert torch.equal(h.reshape(-1).view(torch.int16), wh.view(torch.int16))
        assert torch.equal(lo.reshape(-1), wl)


def _unflatten(tree, leaves):
    from repro_torch.optim.data_parallel import tree_unflatten
    return tree_unflatten(tree, leaves)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ids", ["distinct", "repeated"])
def test_bag_lookup_autograd_on_card(dev, dtype, ids):
    """``core.embedding.bag_lookup`` on the card (row 1 forward, the
    ``index_add_`` backward) against its plain version on the CPU: the bags
    rtol = atol = 1e-5; the table's gradient in the table's dtype, bit for
    bit where every id is distinct (each row gets one rounded cotangent).
    With repeated ids (128 rows, each looked up exactly n = 8 times, spread
    over bags and slots) the card's atomics add a row's cotangents in
    another order than the CPU's flat order, each add rounded to the dtype,
    so both are held to the exact (fp64) sum of the rounded cotangents,
    within the bound of n - 1 rounded adds in any order:
    gamma = (n - 1) u / (1 - (n - 1) u) times the sum of their magnitudes,
    u the unit roundoff (2^-8 bf16, 2^-24 fp32).  A card gradient with one
    lookup dropped, or one added twice, must break that bound."""
    from repro_torch.core import embedding as E
    gen = torch.Generator().manual_seed(7)
    rows, B, S, P, Ed = 4000, 64, 4, 4, 16
    W = _randn(rows, Ed, gen=gen).to(dtype)
    if ids == "distinct":
        g = torch.randperm(rows, generator=gen)[:B * S * P].to(torch.int32).view(B, S, P)
    else:
        n_rows = B * S * P // 8
        hit = torch.randperm(rows, generator=gen)[:n_rows].repeat(8)
        g = hit[torch.randperm(hit.numel(), generator=gen)].to(torch.int32).view(B, S, P)
    dY = _randn(B, S, Ed, gen=gen)
    grads = []
    for d in ("cpu", dev):
        Wd = W.to(d).requires_grad_()
        Y = E.bag_lookup(Wd, g.to(d))
        (dW,) = torch.autograd.grad((Y * dY.to(d)).sum(), [Wd])
        grads.append((Y.detach().cpu(), dW.cpu()))
    (y_cpu, g_cpu), (y_dev, g_dev) = grads
    assert g_dev.dtype == dtype
    assert_close(y_dev, y_cpu, rtol=1e-5, atol=1e-5)
    if ids == "distinct":
        assert torch.equal(g_dev, g_cpu)
        return
    upd = dY[:, :, None, :].expand(B, S, P, Ed).to(dtype).double().reshape(-1, Ed)
    at = g.reshape(-1).long()
    exact = torch.zeros(rows, Ed, dtype=torch.float64).index_add_(0, at, upd)
    mag = torch.zeros(rows, Ed, dtype=torch.float64).index_add_(0, at, upd.abs())
    n = torch.bincount(at, minlength=rows).double()[:, None]
    assert set(n.unique().tolist()) == {0.0, 8.0}
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    bound = (n - 1).clamp_min(0) * u / (1 - (n - 1).clamp_min(0) * u) * mag

    def within(got):
        return bool(((got.double() - exact).abs() <= bound).all())
    assert within(g_dev) and within(g_cpu)
    for sign in (-1.0, 1.0):             # the first lookup dropped, or added twice
        faulty = g_dev.double().clone()
        faulty[at[0]] += sign * upd[0]
        assert not within(faulty)


# ---------------------------------------------------------------------------
# dlrm-large's shapes (rows 2 and 3) and the LM family's MoE block and MLA decode
# ---------------------------------------------------------------------------

LARGE_LAYERS = [(2048, 2048, "relu"), (2048, 256, "relu"), (2336, 4096, "relu"),
                (4096, 4096, "relu"), (4096, 1, "none")]


@pytest.mark.parametrize("b", [8, 128, 1024])
def test_interaction_at_large_shape(dev, b):
    """Row 2 at dlrm-large's F 65 (64 tables and the dense vector), E 256:
    one sample's Z takes 152,880 bytes of shared memory in two stages, so a
    block holds one sample; a 2336-wide output, rtol 1e-5, atol 1e-4."""
    gen = torch.Generator().manual_seed(b)
    dense, emb = _randn(b, 256, gen=gen), _randn(b, 64, 256, gen=gen)
    want = ref.dot_interaction(dense, emb)
    got = ops.dot_interaction(dense.to(dev), emb.to(dev))
    torch.cuda.synchronize()
    assert got.shape == (b, 2336)
    assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("k,n,act", LARGE_LAYERS, ids=[f"{k}x{n}" for k, n, _ in LARGE_LAYERS])
def test_fused_mlp_at_large_layers(dev, m, k, n, act):
    """Row 3 at dlrm-large's layer shapes (bottom 2048 -> 2048 x 7 -> 256,
    top 2336 -> 4096 x 16 -> 1): wgmma but for N 1 (mma.sync); the
    tolerances of ``test_fused_mlp_kernel_matches_plain``."""
    from repro_torch.kernels import fused_mlp
    _fused_mlp_case(dev, m, k, n, act, fused_mlp.route(m, k, n))
    assert fused_mlp.route(m, k, n) == ("mma_sync" if n == 1 else "wgmma")


def _small_moe_lm(**over):
    from repro_torch.models.transformer import TransformerConfig
    base = dict(name="small", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                d_ff=128, vocab=256, n_experts=8, top_k=2, moe_d_ff=32, capacity_factor=1.0,
                tie_embeddings=False)
    return TransformerConfig(**{**base, **over})


def _bf16_close(got, want, what):
    """Within 2^-7 of each value and of the output's largest (a bf16
    rounding between cuBLAS's and the CPU's sums may fall the other way)."""
    scale = float(want.float().abs().max())
    assert_close(got.float().cpu(), want.float(), rtol=2 ** -7, atol=2 ** -7 * scale, what=what)


def test_moe_block_on_the_card_matches_the_cpu(dev):
    """``moe_block`` at capacity factor 1.0, where pairs drop (B 2, L 64, 8
    experts, top 2, C 16, a shared expert): the card keeps the CPU's pairs
    in the CPU's slots (the router's fp32 logits agree), and its output is
    the CPU's within a bf16 step."""
    from repro_torch.models import transformer as tf
    cfg = _small_moe_lm(n_shared_experts=1)
    p = tf._layer(tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["layers"],
                  0)["moe"]
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    pd = {k: v.to(dev) if torch.is_tensor(v) else {kk: vv.to(dev) for kk, vv in v.items()}
          for k, v in p.items()}
    want = tf.moe_route(x, p["router"], cfg)
    got = tf.moe_route(x.to(dev), pd["router"], cfg)
    assert not bool(want[3].all())          # some pairs drop
    for i, name in ((1, "experts"), (2, "slots"), (3, "kept"), (4, "dest")):
        assert torch.equal(got[i].cpu(), want[i]), name
    _bf16_close(tf.moe_block(x.to(dev), pd, cfg), tf.moe_block(x, p, cfg), "moe_block")


def test_mla_decode_on_the_card_matches_the_cpu(dev):
    """deepseek-v2's shape at small size (a dense first layer, then MoE
    layers with a shared expert, MLA's latent cache): one decode step from
    a random latent cache at ragged positions, on the card and on the CPU.
    The absorbed attention is fp32 on both; the bf16 projections round
    apart (cuBLAS sums in another order), so the logits agree within 2e-2
    (the port's tolerance against the JAX package) and the written cache
    entries within a bf16 step."""
    from repro_torch import weights
    from repro_torch.models import lm_steps
    cfg = _small_moe_lm(first_dense_layers=1, n_shared_experts=1, mla=True, q_lora=32, kv_lora=32,
                    qk_nope=16, qk_rope=8, v_head=16)
    params = weights.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, Lmax = 3, 40
    _, (_, cstructs, _, _) = lm_steps.make_decode_step(cfg, B, Lmax, device="cpu")
    gen = torch.Generator().manual_seed(2)
    cache = {k: torch.randn(s, generator=gen).to(d) for k, (s, d) in cstructs.items()}
    toks = torch.randint(0, cfg.vocab, (B,), generator=gen, dtype=torch.int32)
    pos = torch.tensor([5, 39, 17], dtype=torch.int32)
    outs = []
    for d in ("cpu", dev):
        step, _ = lm_steps.make_decode_step(cfg, B, Lmax, device=d)
        c = {k: v.to(d) for k, v in cache.items()}
        logits, c = step(weights.lm_params_to(params, d), c, toks.to(d), pos.to(d))
        outs.append((logits.cpu(), {k: v.cpu() for k, v in c.items()}))
    (want, wc), (got, gc) = outs
    assert_close(got, want, rtol=0, atol=2e-2, what="logits")
    rows = torch.arange(B)
    for k in cache:
        _bf16_close(gc[k][:, rows, pos.long()], wc[k][:, rows, pos.long()], f"{k} written")
        keep = torch.ones(B, Lmax, dtype=torch.bool)
        keep[rows, pos.long()] = False
        assert torch.equal(gc[k][:, keep], cache[k][:, keep])


@pytest.mark.parametrize("n,layers", [(1, 1), (7, 1), (8, 1), (1001, 1), (4096 * 3 + 5, 1),
                                      (5 * 7, 3), (64 * 33, 4)])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_split_sgd_momentum_kernel_bitwise_to_plain(dev, n, layers, gdtype):
    """The split_sgd kernel with momentum (one launch: ``mom = fmaf(beta,
    mom, g)``, the step by ``mom``) and without, the gradient fp32 or bf16,
    against the plain version, bit for bit on ``hi``, ``lo`` and ``mom``: at
    odd lengths (the tail of n % 8) and on a stacked leaf through
    ``update_leaf`` (one launch for the whole stack on the card, a layer at
    a time on the CPU)."""
    from repro_torch.optim.split_sgd import split_fp32, update_leaf
    gen = torch.Generator().manual_seed(n + layers)
    shape = (layers, 1, n) if layers > 1 else (n,)
    hi, lo = split_fp32(torch.randn(shape, generator=gen))
    g = (torch.randn(shape, generator=gen) * 1e-2).to(gdtype)
    mom = torch.randn(shape, generator=gen) * 1e-2
    for m in (mom, None):
        want = [t.clone() for t in (hi, lo)] + ([] if m is None else [m.clone()])
        update_leaf(*want[:2], g, 0.1, want[2] if m is not None else None, 0.9)
        got = [t.to(dev) for t in (hi, lo)] + ([] if m is None else [m.to(dev)])
        before = ops.split_sgd.launches
        update_leaf(*got[:2], g.to(dev), 0.1, got[2] if m is not None else None, 0.9)
        torch.cuda.synchronize()
        assert ops.split_sgd.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().view(torch.int16) if a.dtype == torch.bfloat16 else a.cpu(),
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_moe_functions_backward_deterministic_and_plain(dev):
    """The MoE dispatch and combine Functions' backward on the card: two runs
    bit for bit, and bit for bit the CPU's (gathers, and a sum of the k = 2
    ranks rounded once), with pairs dropped; a dropped pair's cotangent is
    zero."""
    from repro_torch.models import transformer as tf
    cfg = _small_moe_lm()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 64, cfg.d_model), generator=gen).to(torch.bfloat16)
    router = (torch.randn((cfg.d_model, cfg.n_experts), generator=gen) * 0.2).to(torch.bfloat16)
    _, _, _, keep, dest, C = tf.moe_route(x, router, cfg)
    assert not bool(keep.all())
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    d_buf = torch.randn((E, 2 * C, d), generator=gen).to(torch.bfloat16)
    out = torch.randn((E, 2 * C, d), generator=gen).to(torch.bfloat16)
    d_y = torch.randn((2, 64 * k, d), generator=gen).to(torch.bfloat16)
    runs = []
    for device in ("cpu", dev, dev):
        idx = [t.to(device) for t in tf.moe_slots(dest.to(device), 64, k, E, C)]
        rows, filled, at, src_row = idx
        xx = x.to(device).requires_grad_()
        buf = tf._Dispatch.apply(xx, rows, filled, at, keep.to(device), k)
        (dx,) = torch.autograd.grad(buf, [xx], d_buf.to(device))
        oo = out.to(device).requires_grad_()
        y = tf._Combine.apply(oo, at, keep.to(device), src_row, filled)
        (dout,) = torch.autograd.grad(y, [oo], d_y.to(device))
        runs.append([t.cpu() for t in (buf, dx, y, dout)])
    for a, b, c in zip(*runs):
        assert torch.equal(b, c) and torch.equal(a, b)
    assert not runs[0][2][~keep].any()


def test_chunked_attention_remat_grads_on_the_card(dev):
    """``chunked_attention``'s gradients with per-chunk checkpointing equal
    those without it on the card, bit for bit (a local window, the
    soft-cap, GQA; 4 chunks)."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen).to(torch.bfloat16).to(dev)
               for s in ((2, 8, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64)))
    ct = torch.randn((2, 8, 256, 64), generator=gen).to(torch.bfloat16).to(dev)
    out = []
    for remat in (True, False):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = attention.chunked_attention(qq, kk, vv, window=100, softcap=50.0, bq=64, remat=remat)
        out.append((o, *torch.autograd.grad(o, [qq, kk, vv], ct)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _egnn_plain_collectives(world: int) -> dict:
    """What ``egnn_collectives_rank`` must return at each rank: the inputs
    and cotangents of every rank redrawn, the forwards and their transposes
    summed in rank order in fp32 and rounded once (``comm._ordered_sum``)."""
    out = [{} for _ in range(world)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, rows, ct_rows in (("all_gather", 4, 4 * world),
                                    ("psum_scatter", 4 * world, 4), ("psum", 4, 4)):
            xs, cts = [], []
            for r in range(world):
                gen = torch.Generator().manual_seed(100 + r)
                xs.append(torch.randn(rows, 3, generator=gen).to(dtype))
                cts.append(torch.randn(ct_rows, 3, generator=gen).to(dtype))

            def ordered(ts):
                acc = ts[0].float()
                for t in ts[1:]:
                    acc = acc + t.float()
                return acc.to(dtype).float().numpy()
            for r in range(world):
                if name == "all_gather":
                    y = torch.cat(xs).float().numpy()
                    dx = ordered([c[4 * r:4 * r + 4] for c in cts])
                elif name == "psum_scatter":
                    y = ordered([x[4 * r:4 * r + 4] for x in xs])
                    dx = torch.cat(cts).float().numpy()
                else:
                    y, dx = ordered(xs), ordered(cts)
                out[r][(name, str(dtype))] = (y, dx)
    return out


def test_egnn_collectives_backward_on_card_is_the_transpose(dev):
    """The autograd collectives of the EGNN steps on two processes sharing
    the card (gloo, staged through host memory): each forward, and each
    backward the reference's transpose (``all_gather`` <-> ``psum_scatter``,
    ``psum`` -> ``psum``), bit for bit the sums in rank order."""
    from _torch_ranks import egnn_collectives_rank
    from repro_torch.launch.local import run_ranks
    got = run_ranks(egnn_collectives_rank, 2, ("cuda:0",), timeout_s=300)
    want = _egnn_plain_collectives(2)
    for r in range(2):
        for key, (y, dx) in want[r].items():
            gy, gdx = got[r][key]
            assert np.array_equal(gy, y) and np.array_equal(gdx, dx), (r, key)


def _egnn_layer_run(device, N, E, seed):
    from repro_torch.models import egnn
    cfg = egnn.EGNNConfig("t", n_layers=1, d_hidden=64, d_feat=8)
    gen = torch.Generator().manual_seed(seed)
    lp = egnn.unstack_layers(egnn.init_egnn_params(cfg, gen, "cpu")["layers"], 1)[0]
    lp = {k: {p: [t.to(torch.bfloat16).to(device).requires_grad_() for t in v[p]]
              for p in ("w", "b")} for k, v in lp.items()}
    h = torch.randn((N, 64), generator=gen).to(torch.bfloat16).to(device).requires_grad_()
    x = torch.randn((N, 3), generator=gen).to(device).requires_grad_()
    src = torch.randint(0, N, (E,), generator=gen, dtype=torch.int32).to(device)
    dst = torch.randint(0, N, (E,), generator=gen, dtype=torch.int32).to(device)
    mask = (torch.arange(E) < E - 37).float().to(device)
    outs = egnn.egnn_layer(h, x, src, dst, lp, mask, num_nodes=N)
    h2 = egnn.egnn_node_update(h, outs[0], lp)
    cts = [torch.randn(t.shape, generator=gen).to(device) for t in (outs[0], outs[1], h2)]
    leaves = [h, x] + [t for v in lp.values() for p in ("w", "b") for t in v[p]]
    grads = torch.autograd.grad([outs[0], outs[1], h2], leaves, [cts[0], cts[1], cts[2].to(h2.dtype)])
    return [t.detach().float().cpu() for t in list(outs) + [h2] + list(grads)]


def test_egnn_layer_on_card_matches_cpu(dev):
    """One EGNN layer (``egnn_layer`` and ``egnn_node_update``, hidden 64,
    37 masked edges) forward and backward on the card against the CPU: each
    output and gradient within 1e-2 of its largest magnitude (bf16 values
    between the MLP's layers and bf16 gradients summed by atomics in no
    fixed order), the degree exactly."""
    got = _egnn_layer_run(dev, 300, 2000, 0)
    want = _egnn_layer_run("cpu", 300, 2000, 0)
    assert torch.equal(got[2], want[2])
    for i, (a, b) in enumerate(zip(got, want)):
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max()), i


def test_row4_on_the_egnn_leaves_bitwise_to_plain(dev):
    """Row 4 on the 18 leaves of cora's EGNN state (``configs/egnn_arch.py``
    widths), bf16 gradients: one launch a leaf through ``update_leaf``, bit
    for bit the plain version."""
    from repro_torch.configs import egnn_arch
    from repro_torch.models import egnn_steps
    from repro_torch.optim import split_sgd
    from repro_torch.optim.data_parallel import tree_leaves
    cfg = egnn_arch.config("full_graph_sm")
    state = egnn_steps.init_egnn_state(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    his, los = tree_leaves(state["hi"]), tree_leaves(state["lo"])
    assert len(his) == 18
    before = ops.split_sgd.launches
    for h, lo in zip(his, los):
        g = (torch.randn(h.shape, generator=gen) * 1e-2).to(torch.bfloat16)
        want_h, want_l = ref.split_sgd(h.clone().view(-1), lo.clone().view(-1), g.view(-1), 1e-2)
        ch, cl = h.to(dev), lo.to(dev)
        split_sgd.update_leaf(ch, cl, g.to(dev), 1e-2)
        assert torch.equal(ch.cpu().view(-1).view(torch.int16), want_h.view(torch.int16))
        assert torch.equal(cl.cpu().view(-1), want_l)
    assert ops.split_sgd.launches == before + 18


@pytest.mark.parametrize("kind", ["full graph", "minibatch"])
def test_egnn_step_on_card_matches_cpu(dev, kind):
    """One EGNN step (2 layers, hidden 64) on the card against the CPU's
    from one state and batch: the loss within 1e-4 relative, each leaf's
    update within 3e-2 of its largest (chip_smoke 33a's rule)."""
    from repro_torch.data import graph
    from repro_torch.models import egnn, egnn_steps
    from repro_torch.optim.data_parallel import tree_leaves, tree_map
    from repro_torch.optim.split_sgd import combine_split
    cfg = egnn.EGNNConfig("t", n_layers=2, d_hidden=64, d_feat=24, n_classes=5)
    rng = np.random.default_rng(0)
    if kind == "full graph":
        N, E = 400, 3000
        make = lambda d: egnn_steps.make_fullgraph_train_step(cfg, None, N, E, 1e-2, device=d)
        batch = {"feats": rng.standard_normal((N, 24)).astype(np.float32),
                 "coords": rng.standard_normal((N, 3)).astype(np.float32),
                 "src": rng.integers(0, N, E).astype(np.int32),
                 "dst": rng.integers(0, N, E).astype(np.int32),
                 "edge_mask": (np.arange(E) < E - 50).astype(np.float32),
                 "labels": rng.integers(0, 5, N).astype(np.int32),
                 "label_mask": (rng.random(N) < 0.8).astype(np.float32)}
    else:
        g = graph.random_powerlaw_graph(2000, 20_000, seed=0)
        s = graph.NeighborSampler(g, fanout=(5, 3), n_pad=24, e_pad=24, seed=0)
        make = lambda d: egnn_steps.make_minibatch_train_step(cfg, None, 32, 24, 24, 1e-2,
                                                              device=d)
        batch = s.sample_batch(rng.choice(np.flatnonzero(np.diff(g.indptr)), 32, replace=False),
                               rng.standard_normal((2000, 24)).astype(np.float32),
                               rng.integers(0, 5, 2000))
    start = egnn_steps.init_egnn_state(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = []
    for d in ("cpu", dev):
        state = tree_map(lambda t: t.to(d, copy=True), start)
        _, loss = make(d)[0](state, batch)
        runs.append((float(loss), state))
    (l_cpu, s_cpu), (l_card, s_card) = runs
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for h0, l0, h1, l1, h2, l2 in zip(*(tree_leaves(s[k]) for s in (start, s_cpu, s_card)
                                        for k in ("hi", "lo"))):
        w0 = combine_split(h0, l0)
        d_cpu, d_card = combine_split(h1, l1) - w0, combine_split(h2.cpu(), l2.cpu()) - w0
        assert float((d_card - d_cpu).abs().max()) <= 3e-2 * float(d_cpu.abs().max())
