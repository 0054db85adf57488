"""The elastic restart's re-layouts against the JAX package, on the CPU:
``checkpoint.reshard_store`` (and ``reshard_embedding``) against
``repro.checkpoint.manager.reshard_store`` for every slab of the eight
optimizers' stores, in row and table mode, between 8 and 4, 4 and 2, and 2
and 8 shards; ``checkpoint.reshard_dense`` against the dense re-layout of
``examples/elastic_restart.py`` (fp32 masters from ``hi`` and the old ``lo``,
then ``dp_global_arrays`` for the new rank count).  Bit for bit, on numpy
arrays (bf16 as ``ml_dtypes``' type, ``lo`` as uint16, as the reference's
checkpoints restore them) and on CPU tensors (as the port's restore gives
them).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import reshard_embedding as j_reshard_embedding
from repro.checkpoint.manager import reshard_store as j_reshard_store
from repro.core import sharded_embedding as j_se
from repro.core.embedding import EmbeddingSpec as JSpec
from repro.optim import data_parallel as j_dp
from repro.optim.split_sgd import combine_split
from repro_torch import weights
from repro_torch.checkpoint import reshard_dense, reshard_embedding, reshard_store
from repro_torch.core import sharded_embedding as t_se
from repro_torch.core.embedding import EmbeddingSpec as TSpec
from repro_torch.optim import row as t_row

TABLES = (100, 37, 250, 13, 60, 21)
E = 16
SHARDS = [(8, 4), (4, 2), (2, 8)]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _tensor_bits(t: torch.Tensor) -> np.ndarray:
    return _bits(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy())


def _store(opt_name: str, rows: int, seed: int) -> dict:
    """A store of ``opt_name`` over ``rows`` rows, every slab drawn, as the
    reference's numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in t_row.get(opt_name).store_struct(rows, E).items():
        if dtype == torch.int32:
            out[k] = rng.integers(0, 100, shape).astype(np.int32)
        elif dtype == torch.int16:  # a Split-SGD lo half: the reference's uint16
            out[k] = rng.integers(0, 2 ** 16, shape).astype(np.uint16)
        elif dtype == torch.bfloat16:
            out[k] = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        else:
            out[k] = rng.standard_normal(shape).astype(np.float32)
    return out


@pytest.mark.parametrize("mode", ["row", "table"])
@pytest.mark.parametrize("old,new", SHARDS, ids=[f"{a}to{b}" for a, b in SHARDS])
@pytest.mark.parametrize("opt", sorted(t_row.OPTIMIZERS))
def test_reshard_store_matches_reference(mode, old, new, opt):
    t_old, t_new = (t_se.make_layout(TSpec(TABLES, E), n, mode) for n in (old, new))
    j_old, j_new = (j_se.make_layout(JSpec(TABLES, E), n, mode) for n in (old, new))
    assert t_old.total_rows == j_old.total_rows and t_new.total_rows == j_new.total_rows
    store = _store(opt, t_old.total_rows, seed=old * 10 + new)
    want = j_reshard_store(j_old, j_new, store)
    got = reshard_store(t_old, t_new, store)
    as_tensors = reshard_store(t_old, t_new, {k: weights.to_torch(v) for k, v in store.items()})
    assert set(got) == set(want) == set(as_tensors) == set(store)
    for k in store:
        assert got[k].dtype == want[k].dtype == store[k].dtype, k
        assert got[k].shape == want[k].shape == (t_new.total_rows,) + store[k].shape[1:], k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
        assert isinstance(as_tensors[k], torch.Tensor)
        np.testing.assert_array_equal(_tensor_bits(as_tensors[k]), _bits(want[k]), err_msg=k)
    # and back: the slab of the old layout again (zero where no table's rows lie)
    k = "w" if "w" in got else "hi"
    np.testing.assert_array_equal(_bits(reshard_embedding(t_new, t_old, got[k])),
                                  _bits(j_reshard_embedding(j_new, j_old, want[k])))


def _reference_dense(hi_tree, lo: np.ndarray, old: int, new: int, nb: int = 4) -> dict:
    """``examples/elastic_restart.py``'s dense re-layout."""
    flat_hi, _ = jax.flatten_util.ravel_pytree(hi_tree)
    n = flat_hi.size
    padded = lo.size
    lo_nat = lo.reshape(old, nb, padded // (old * nb)).transpose(1, 0, 2).reshape(-1)
    w32 = combine_split(
        jax.lax.bitcast_convert_type(
            jnp.pad(jax.lax.bitcast_convert_type(flat_hi, jnp.uint16), (0, padded - n)),
            jnp.bfloat16),
        jnp.asarray(lo_nat))
    dense_fp32 = j_dp.unravel_like(w32[:n], hi_tree)
    arrays = j_dp.dp_global_arrays(dense_fp32, new, num_buckets=nb)
    return {"hi": jax.tree.map(np.asarray, arrays["hi"]), "lo": np.asarray(arrays["lo"])}


@pytest.mark.parametrize("old,new", SHARDS + [(8, 1), (1, 8)],
                         ids=[f"{a}to{b}" for a, b in SHARDS + [(8, 1), (1, 8)]])
def test_reshard_dense_matches_the_reference_example(old, new):
    rng = np.random.default_rng(old * 10 + new)
    hi_tree = {"bot": {"w": [rng.standard_normal((16, 13)).astype(ml_dtypes.bfloat16)],
                       "b": [rng.standard_normal((13,)).astype(ml_dtypes.bfloat16)]},
               "top": {"w": [rng.standard_normal((13, 1)).astype(ml_dtypes.bfloat16)],
                       "b": [rng.standard_normal((1,)).astype(ml_dtypes.bfloat16)]}}
    n = 16 * 13 + 13 + 13 + 1
    lo = rng.integers(0, 2 ** 16, -(-n // (4 * old)) * 4 * old).astype(np.uint16)
    want = _reference_dense(hi_tree, lo, old, new)
    got = reshard_dense({"hi": hi_tree, "lo": lo, "err": None}, old, new)
    assert got["hi"] is hi_tree and got["err"] is None
    for a, b in zip(jax.tree.leaves(got["hi"]), jax.tree.leaves(want["hi"])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got["lo"].dtype == want["lo"].dtype == np.uint16
    np.testing.assert_array_equal(got["lo"], want["lo"])
    as_tensor = reshard_dense({"hi": hi_tree, "lo": weights.to_torch(lo), "err": None}, old, new)
    np.testing.assert_array_equal(as_tensor["lo"].numpy().view(np.uint16), want["lo"])
