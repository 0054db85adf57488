"""The fused bag stage and the interaction's plain path, on the CPU.

``ops.embedding_bag_stage`` is the row-mode bag stage in one launch of the
embedding_bag kernel: the slot's row offset added to the table-local ids,
the masked (and weighted) bag, each sum rounded to bf16.  Its plain path,
which the CPU runs and the card holds the kernel to, is held here bit for bit
to the JAX package's pieces: the offset add, ``_partial_bag_masked``, the
round of the reduce-scatter wire.  The dot interaction's plain path, which
the card holds the kernel to, is held to the JAX package's at the widths the
kernel's tiles are tested at on the card (F 2 to 65, E 16 to 512).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded_embedding as j_se
from repro_torch.core import sharded_embedding as t_se
from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.kernels import interaction, ops
from repro_torch.testing import to_torch

# table sizes that are not multiples of the row padding, so the offsets matter
TABLE_ROWS = (100, 37, 250, 13)
CASES = ("unweighted", "weighted", "out of range", "negative")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _inputs(case: str, dtype, seed: int = 3):
    """A table over the layout's row space, table-local ids [B, S, P] and,
    for the weighted cases, weights U[-2, 2) with inf and nan on masked
    lookups.  ``out of range``: ids past their table, some past the shard's
    rows; ``negative``: negative ids, some before the shard's first row."""
    rng = np.random.default_rng(seed)
    layout = t_se.make_layout(EmbeddingSpec(table_rows=TABLE_ROWS, dim=16), 1)
    B, P, E = 6, 7, 16
    W = jnp.asarray(rng.standard_normal((layout.total_rows + 8, E)), dtype)
    idx = np.stack([rng.integers(0, m, (B, P)) for m in TABLE_ROWS], axis=1)
    if case == "out of range":
        idx += rng.integers(0, 2, idx.shape) * rng.integers(0, 600, idx.shape)
    elif case == "negative":
        idx -= rng.integers(0, 2, idx.shape) * rng.integers(0, 400, idx.shape)
    idx = idx.astype(np.int32)
    g = idx + layout.row_offsets[None, :, None].astype(np.int32)
    valid = (g >= 0) & (g < layout.rows_per_shard)
    weights = None
    if case != "unweighted":
        weights = rng.uniform(-2, 2, idx.shape).astype(np.float32)
        bad = np.flatnonzero(~valid)
        weights.flat[bad[::2]] = np.inf
        weights.flat[bad[1::2]] = np.nan
    return layout, W, idx, g, valid, weights


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("case", CASES)
def test_bag_stage_plain_path_bitwise_to_reference(case, dtype):
    """The plain path of the fused stage against the reference's offset add,
    ``_partial_bag_masked`` and bf16 round, bit for bit; through
    ``row_sharded_bag_fwd`` too."""
    layout, W, idx, g, valid, weights = _inputs(case, dtype)
    j_w = None if weights is None else jnp.asarray(weights)
    want = np.asarray(j_se._partial_bag_masked(W, jnp.asarray(g), jnp.asarray(valid), j_w)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    assert valid.all() == (case in ("unweighted", "weighted"))
    W_t = to_torch(np.asarray(W))
    w_t = None if weights is None else torch.from_numpy(weights)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32)
    got = ops.embedding_bag_stage(W_t, torch.from_numpy(idx), offsets, layout.rows_per_shard, w_t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    fwd = t_se.row_sharded_bag_fwd(layout, W_t, torch.from_numpy(idx), weights=w_t)
    np.testing.assert_array_equal(_bits(fwd), want.view(np.int32))


def test_bag_stage_checks():
    """The stage refuses offsets of the wrong type, shape or device before
    any work, and the wrapper's checks of the bag hold for it too."""
    W = torch.zeros((10, 8))
    idx = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.embedding_bag_stage(W, idx, torch.zeros(3, dtype=torch.int64), 10)
    with pytest.raises(ValueError):
        ops.embedding_bag_stage(W, idx, torch.zeros(4, dtype=torch.int32), 10)
    with pytest.raises(TypeError):
        ops.embedding_bag_stage(W, idx.long(), torch.zeros(3, dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        ops.embedding_bag_stage(W, idx, torch.zeros(3, dtype=torch.int32), 10,
                                weights=torch.ones(2, 3, 5))


@pytest.mark.parametrize("F,E", [(2, 16), (3, 17), (9, 64), (17, 100), (27, 128), (33, 256),
                                 (65, 512)])
def test_interaction_plain_path_at_kernel_widths(F, E):
    """F 2 to 65 and E 16 to 512 (17 and 100: rows that are not 16-byte
    multiples), 3 samples: the plain path against the reference's
    ``dot_interaction`` and its Pallas self-dot (interpret mode) with the
    triangle taken; fp32 dot products of length E in other orders: rtol
    1e-5, atol 1e-4."""
    from repro.core import interaction as j_interaction
    from repro.kernels import ops as j_ops
    from repro_torch.testing import assert_close
    rng = np.random.default_rng(F * 1000 + E)
    dense = rng.standard_normal((3, E)).astype(np.float32)
    emb = rng.standard_normal((3, F - 1, E)).astype(np.float32)
    want = np.asarray(j_interaction.dot_interaction(jnp.asarray(dense), jnp.asarray(emb)))
    z = np.concatenate([dense[:, None], emb], axis=1)
    zz = np.asarray(j_ops.interaction_self_dot(jnp.asarray(z), interpret=True))
    li, lj = np.tril_indices(F, -1)
    got = interaction.dot_interaction(torch.from_numpy(dense), torch.from_numpy(emb))
    assert got.shape == (3, E + F * (F - 1) // 2)
    assert_close(got, want, rtol=1e-5, atol=1e-4, what="vs dot_interaction")
    assert_close(got, np.concatenate([dense, zz[:, li, lj]], axis=1), rtol=1e-5, atol=1e-4,
                 what="vs Pallas self-dot")


def _tool(name: str):
    """``tools/<name>.py`` imported as a module."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(name, root / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool, root / "src" / "repro_torch" / "csrc"


def test_ablation_variants_apply_to_the_sources():
    """Every text substitution of ``tools/ablate_bag.py``, the narrow path's
    copies included, finds its text in this checkout's
    ``csrc/embedding_bag.cu`` and ``interaction.cu`` (the tool fails on the
    card otherwise), and each variant changes its source."""
    tool, csrc = _tool("ablate_bag")
    for table in (tool.VARIANTS, tool.NARROW):
        texts = tool.substituted(csrc, table)
        for (stem, name), text in texts.items():
            assert (text == (csrc / f"{stem}.cu").read_text()) == (name == "as is"), (stem, name)


def test_row_update_ablation_variants_apply_to_the_source():
    """Every text substitution of ``tools/ablate_row_update.py`` (the run
    walk's copies and the narrow instances') finds its text in this
    checkout's row update (``csrc/embedding_update.cuh`` and its launcher
    sources, as the tool compiles them), and each variant changes it."""
    tool, csrc = _tool("ablate_row_update")
    src = tool.whole_source(csrc)
    for table in (tool.VARIANTS, tool.NARROW):
        for name, text in tool.variant_sources(table).items():
            assert (text == src) == (name == "as is"), name
