"""The port's checkpoint manager against the JAX package's, on the CPU.

One on-disk format for both: a checkpoint that either package writes
restores in the other bit for bit, with verification on (so the treedef
strings, the key sets, the dtype tags and the CRC32s agree).  The states are
the reference's train states at the quickstart's size (eight tables, 58,800
rows of 32, batch 512) made by ``repro.core.hybrid.init_state`` on a (1, 1)
mesh, their optimizer slabs and ``sr`` filled with seeded values, carried to
the port with ``repro_torch.weights.state_from_numpy``.  The reference's own
checkpoint cases and drills run on both packages.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro import faults as j_faults
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.launch.mesh import make_mesh
from repro.optim import row as j_row
from repro_torch import checkpoint as t_ckpt
from repro_torch import faults as t_faults
from repro_torch import weights
from repro_torch.checkpoint.manager import treedef_str
from repro_torch.core import dlrm as t_dlrm
from repro_torch.data import synthetic as t_syn
from repro_torch.optim import data_parallel as t_dp
from repro_torch.testing import to_torch

QUICKSTART = dict(name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
                  table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100), emb_dim=32,
                  pooling=8, batch=512, lr=0.05)
OPTIMIZERS = ("split_sgd", "adagrad_rowwise", "momentum_bf16")


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy array or tensor, for bitwise comparisons."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        a = a.view(torch.int16) if a.element_size() == 2 else a
        return a.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _configs(name):
    kw = {**QUICKSTART, "sparse_optimizer": name}
    return j_dlrm.DLRMConfig(**kw, fused_update=False), t_dlrm.DLRMConfig(**kw)


@pytest.fixture(scope="module", params=OPTIMIZERS)
def carried(request):
    """(optimizer, jax config, port config, the state as numpy arrays, as
    JAX arrays and as the port's CPU state)."""
    j_cfg, t_cfg = _configs(request.param)
    mesh = make_mesh((1, 1), ("data", "model"))
    state, _ = j_hybrid.init_state(jax.random.PRNGKey(0), j_dlrm.as_hybrid_def(j_cfg), mesh)
    state_np = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(5)
    for k in state_np["emb"]:                       # the optimizer slabs: not all zero
        if k in ("hi", "lo", "w"):
            continue
        v = state_np["emb"][k]
        state_np["emb"][k] = np.asarray(jnp.asarray(rng.random(v.shape) * 1e-3,
                                                    v.dtype))
    if "sr" in state_np:
        state_np["sr"] = np.asarray(2 ** 31 - 5, np.int32)
    j_state = jax.tree.map(jnp.asarray, state_np)
    t_state = weights.state_from_numpy(state_np, t_cfg, device="cpu")
    return request.param, j_cfg, t_cfg, state_np, j_state, t_state


def _other_port_state(t_cfg):
    """A port state of the same structure with other values: a restore must
    replace every leaf."""
    return t_dlrm.init_state(t_cfg, torch.Generator().manual_seed(1), device="cpu")


def _assert_port_state_bitwise(got, want):
    assert treedef_str(got) == treedef_str(want)
    for a, b in zip(t_dp.tree_leaves(got), t_dp.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    lo = got["dense"]["lo"]
    assert t_dp.flat_hi(got["dense"]["hi"], lo.numel()) is not None  # one flat hi buffer


def test_jax_checkpoint_restores_into_the_port_bitwise(carried, tmp_path):
    """(a) JAX ``CheckpointManager.save`` -> port ``restore``: the port's
    state bit for bit (``sr`` and the bf16 slabs too), with the dense ``hi``
    leaves as views of one flat buffer."""
    _, _, t_cfg, _, j_state, t_state = carried
    j_ckpt.CheckpointManager(tmp_path).save(20, j_state, blocking=True)
    step, got = t_ckpt.CheckpointManager(tmp_path).restore(_other_port_state(t_cfg), device="cpu")
    assert step == 20
    _assert_port_state_bitwise(got, t_state)


def test_port_checkpoint_restores_into_jax_bitwise(carried, tmp_path):
    """(b) port ``save`` -> JAX ``restore(like=...)`` with verification on:
    JAX's state bit for bit, in its dtypes (bf16 as bf16, ``lo`` as uint16)."""
    _, _, _, state_np, j_state, t_state = carried
    t_ckpt.CheckpointManager(tmp_path).save(20, t_state, blocking=True)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j_state)
    step, got = j_ckpt.CheckpointManager(tmp_path).restore(like, verify=True)
    assert step == 20
    assert jax.tree.structure(got) == jax.tree.structure(state_np)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_meta_agrees_across_packages(carried, tmp_path):
    """(c) the two packages' ``meta.json`` for the same state agree on
    ``keys``, ``dtypes``, ``treedef`` and ``checksums``."""
    _, _, _, _, j_state, t_state = carried
    j_ckpt.CheckpointManager(tmp_path / "jax").save(3, j_state, blocking=True)
    t_ckpt.CheckpointManager(tmp_path / "torch").save(3, t_state, blocking=True)
    want = json.loads((tmp_path / "jax" / "step_3" / "meta.json").read_text())
    got = json.loads((tmp_path / "torch" / "step_3" / "meta.json").read_text())
    for field in ("format_version", "step", "keys", "dtypes", "treedef", "checksums"):
        assert got[field] == want[field], field


def test_state_treedef_string_is_jax_s(carried):
    """(d) for the train states."""
    _, _, _, _, j_state, t_state = carried
    assert treedef_str(t_state) == str(jax.tree_util.tree_structure(j_state))


TREES = {
    "int": 7,
    "list": [1, 2.0, np.zeros(3)],
    "tuple": (1, (2,), ()),
    "none leaves": {"a": None, "b": [None, 1], "c": (None,)},
    "empty containers": {"d": {}, "l": [], "t": ()},
    "nested": {"z": [{"y": (1, 2)}, None], "a": {"b": {"c": 3}}},
    "none": None,
}


@pytest.mark.parametrize("tree", list(TREES), ids=list(TREES))
def test_treedef_string_is_jax_s(tree):
    """(d) for an int, a list, a tuple, ``None`` leaves and nested mixes."""
    assert treedef_str(TREES[tree]) == str(jax.tree_util.tree_structure(TREES[tree]))


def test_dtype_tag_mismatch_is_refused_across_packages(tmp_path):
    """A leaf saved as one dtype does not restore as another, in either
    package: bf16 against fp32, uint16 bits against bf16."""
    t_ckpt.CheckpointManager(tmp_path).save(1, {"m": torch.ones(4, dtype=torch.bfloat16),
                                               "lo": torch.ones(4, dtype=torch.int16)},
                                            blocking=True)
    for like in ({"m": jax.ShapeDtypeStruct((4,), jnp.float32),
                  "lo": jax.ShapeDtypeStruct((4,), jnp.uint16)},
                 {"m": jax.ShapeDtypeStruct((4,), jnp.bfloat16),
                  "lo": jax.ShapeDtypeStruct((4,), jnp.bfloat16)}):
        with pytest.raises(ValueError, match="dtype mismatch"):
            j_ckpt.CheckpointManager(tmp_path).restore(like)
    j_ckpt.CheckpointManager(tmp_path / "j").save(1, {"m": jnp.ones(4, jnp.bfloat16)},
                                                  blocking=True)
    with pytest.raises(ValueError, match="dtype mismatch"):
        t_ckpt.CheckpointManager(tmp_path / "j").restore({"m": torch.ones(4)}, device="cpu")
    with pytest.raises(ValueError, match="dtype mismatch"):
        t_ckpt.CheckpointManager(tmp_path / "j").restore(
            {"m": torch.ones(4, dtype=torch.int16)}, device="cpu")


# ---------------------------------------------------------------------------
# The reference's checkpoint cases and drills, on both packages
# ---------------------------------------------------------------------------


class _Pkg:
    """One package's checkpoint API and a small state of its own kind."""

    def __init__(self, name):
        self.name = name
        mod_ckpt, mod_faults = (j_ckpt, j_faults) if name == "jax" else (t_ckpt, t_faults)
        self.Manager = mod_ckpt.CheckpointManager
        self.CheckpointError = mod_ckpt.CheckpointError
        self.CheckpointCorruptError = mod_ckpt.CheckpointCorruptError
        self.Fault, self.FaultPlan = mod_faults.Fault, mod_faults.FaultPlan
        self.FailureLog, self.InjectedCrash = mod_faults.FailureLog, mod_faults.InjectedCrash
        self.corrupt = mod_faults.corrupt_checkpoint
        self.restore_kw = {} if name == "jax" else {"device": "cpu"}

    def state(self, seed=0):
        rng = np.random.default_rng(seed)
        tree = {"a": rng.standard_normal((16, 8)).astype(np.float32),
                "nested": {"b": np.arange(10, dtype=np.int32) + seed,
                           "c": [np.ones(3, np.float32) * seed, np.zeros(2, np.float32)],
                           "h": rng.standard_normal(6).astype(np.float32)}}
        if self.name == "jax":
            out = jax.tree.map(jnp.asarray, tree)
            out["nested"]["h"] = out["nested"]["h"].astype(jnp.bfloat16)
            return out
        out = jax.tree.map(torch.from_numpy, tree)
        out["nested"]["h"] = out["nested"]["h"].to(torch.bfloat16)
        return out

    def like(self, state):
        if self.name == "jax":
            return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
        return jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)

    def leaves(self, state) -> list:
        return [_bits(x) for x in jax.tree.leaves(state)]


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Pkg(request.param)


def test_roundtrip(pkg, tmp_path):
    mgr = pkg.Manager(tmp_path, keep=2)
    state = pkg.state()
    mgr.save(7, state, blocking=True)
    step, restored = mgr.restore(pkg.like(state), **pkg.restore_kw)
    assert step == 7
    for a, b in zip(pkg.leaves(state), pkg.leaves(restored)):
        np.testing.assert_array_equal(a, b)


def test_retention_and_latest(pkg, tmp_path):
    mgr = pkg.Manager(tmp_path, keep=2)
    state = pkg.state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save(pkg, tmp_path):
    mgr = pkg.Manager(tmp_path)
    mgr.save(1, pkg.state(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_save_copies_the_state_before_returning(tmp_path):
    """The port's step updates its state in place: what an async save
    writes is the state as it was when ``save`` returned."""
    mgr = t_ckpt.CheckpointManager(tmp_path)
    state = {"w": torch.zeros(1 << 16)}
    mgr.save(1, state, blocking=False)
    state["w"].add_(1.0)
    mgr.wait()
    _, got = mgr.restore({"w": torch.empty(1 << 16)}, device="cpu")
    assert not got["w"].any()


def test_restore_keeps_dtype_view_leaves_bitwise(tmp_path):
    """A leaf that is a bf16 view of an int16 or fp32 buffer restores bit for
    bit (copied alone: its offsets count the buffer's elements), while leaves
    that are bf16 views of one bf16 buffer still come back sharing one."""
    gen = torch.Generator().manual_seed(0)
    bits = torch.randint(-(1 << 15), 1 << 15, (64,), dtype=torch.int16, generator=gen)
    words = torch.randn(32, generator=gen)
    flat = torch.randn(48, generator=gen).to(torch.bfloat16)

    def state_of(bits, words, flat):
        return {"a": bits.view(torch.bfloat16)[8:40], "b": words.view(torch.bfloat16)[10:50],
                "c": [flat[:16], flat[16:]]}
    state = state_of(bits, words, flat)
    mgr = t_ckpt.CheckpointManager(tmp_path)
    mgr.save(1, state, blocking=True)
    like = state_of(torch.zeros_like(bits), torch.zeros_like(words), torch.zeros_like(flat))
    _, got = mgr.restore(like, device="cpu")
    for g, w in zip([got["a"], got["b"], *got["c"]], [state["a"], state["b"], *state["c"]]):
        assert g.dtype == torch.bfloat16 and torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert got["c"][0]._base is not None and got["c"][0]._base is got["c"][1]._base


def test_atomic_no_partial_dirs(pkg, tmp_path):
    mgr = pkg.Manager(tmp_path)
    mgr.save(5, pkg.state(), blocking=True)
    names = os.listdir(tmp_path)
    assert "step_5" in names
    assert not any(n.endswith(".tmp") for n in names)


def test_meta_carries_version_and_checksums(pkg, tmp_path):
    mgr = pkg.Manager(tmp_path)
    mgr.save(1, pkg.state(), blocking=True)
    meta = json.loads((tmp_path / "step_1" / "meta.json").read_text())
    assert meta["format_version"] == 2
    assert set(meta["checksums"]) == set(meta["keys"])
    assert meta["dtypes"]["nested/h"] == "bfloat16"
    mgr.verify(1)
    meta["format_version"] = 99
    (tmp_path / "step_1" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(pkg.CheckpointCorruptError, match="newer than this reader"):
        mgr.verify(1)


@pytest.mark.parametrize("mode", ["flip", "truncate", "no_meta", "meta_garbage"])
def test_latest_valid_step_skips_corruption(pkg, tmp_path, mode):
    log = pkg.FailureLog()
    mgr = pkg.Manager(tmp_path, event_log=log)
    for s in (2, 4, 6):
        mgr.save(s, pkg.state(s), blocking=True)
    pkg.corrupt(tmp_path, 6, mode)
    assert mgr.latest_step() == 6
    assert mgr.latest_valid_step() == 4
    step, got = mgr.restore(pkg.like(pkg.state()), **pkg.restore_kw)
    assert step == 4
    for a, b in zip(pkg.leaves(got), pkg.leaves(pkg.state(4))):
        np.testing.assert_array_equal(a, b)
    assert log.counts()["ckpt_corrupt_skipped"] >= 1
    with pytest.raises(pkg.CheckpointCorruptError):
        mgr.restore(pkg.like(pkg.state()), step=6, **pkg.restore_kw)


def test_restore_treedef_mismatch_refuses(pkg, tmp_path):
    mgr = pkg.Manager(tmp_path)
    state = pkg.state()
    mgr.save(1, state, blocking=True)
    with pytest.raises(pkg.CheckpointError, match="tree structure"):
        mgr.restore({"a": state["a"]}, **pkg.restore_kw)


def test_transient_write_retries_then_succeeds(pkg, tmp_path):
    log = pkg.FailureLog()
    plan = pkg.FaultPlan([pkg.Fault("ckpt.write.arrays", times=2,
                                    exc=lambda: OSError(28, "No space left on device"))])
    mgr = pkg.Manager(tmp_path, retries=2, backoff_s=0.001, faults=plan, event_log=log)
    mgr.save(5, pkg.state(), blocking=True)
    assert mgr.latest_valid_step() == 5
    assert log.counts()["ckpt_write_retry"] == 2


def test_exhausted_write_retries_raise(pkg, tmp_path):
    plan = pkg.FaultPlan([pkg.Fault("ckpt.write.meta", times=10,
                                    exc=lambda: OSError(28, "No space left on device"))])
    mgr = pkg.Manager(tmp_path, retries=1, backoff_s=0.001, faults=plan)
    with pytest.raises(pkg.CheckpointError, match="failed after 2 attempts"):
        mgr.save(5, pkg.state(), blocking=True)
    assert mgr.latest_valid_step() is None


def test_async_save_failure_surfaces_at_next_save_and_wait(pkg, tmp_path):
    plan = pkg.FaultPlan([pkg.Fault("ckpt.write.arrays", times=10,
                                    exc=lambda: OSError(5, "Input/output error"))])
    mgr = pkg.Manager(tmp_path, retries=0, faults=plan)
    mgr.save(1, pkg.state(), blocking=False)
    with pytest.raises(pkg.CheckpointError, match="background checkpoint save failed"):
        mgr.wait()
    mgr.wait()
    mgr.save(2, pkg.state(), blocking=False)
    with pytest.raises(pkg.CheckpointError, match="background checkpoint save failed"):
        mgr.save(3, pkg.state(), blocking=False)


def test_torn_commit_is_detected(pkg, tmp_path):
    """The torn-write drill: a committed, truncated ``arrays.npz`` that
    only the checksums catch."""
    plan = pkg.FaultPlan([pkg.Fault("ckpt.write.arrays", action="partial", step=4)])
    mgr = pkg.Manager(tmp_path, faults=plan)
    mgr.save(2, pkg.state(2), blocking=True)
    with pytest.raises(pkg.InjectedCrash):
        mgr.save(4, pkg.state(4), blocking=True)
    assert 4 in mgr.steps()
    assert not mgr.is_valid(4)
    assert mgr.latest_valid_step() == 2
    step, got = mgr.restore(pkg.like(pkg.state()), **pkg.restore_kw)
    assert step == 2
    for a, b in zip(pkg.leaves(got), pkg.leaves(pkg.state(2))):
        np.testing.assert_array_equal(a, b)


def test_crash_before_replace_leaves_tmp_only(pkg, tmp_path):
    plan = pkg.FaultPlan([pkg.Fault("ckpt.commit", action="crash")])
    mgr = pkg.Manager(tmp_path, faults=plan)
    with pytest.raises(pkg.InjectedCrash):
        mgr.save(3, pkg.state(), blocking=True)
    assert (tmp_path / "step_3.tmp").exists()
    assert mgr.steps() == []
    mgr.save(3, pkg.state(), blocking=True)
    assert mgr.latest_valid_step() == 3 and not (tmp_path / "step_3.tmp").exists()


# ---------------------------------------------------------------------------
# Training on from a checkpoint of the other package
# ---------------------------------------------------------------------------


def _batches(cfg, n: int) -> list[dict]:
    out = []
    for b, _ in zip(t_syn.dlrm_stream(11, cfg, 0.6), range(n)):
        b["dense_x"] = np.asarray(jnp.asarray(b["dense_x"], jnp.bfloat16))
        out.append(b)
    return out


def _fp32_slabs(emb: dict) -> dict:
    """The store's slabs as fp32 values: a split store's halves combined."""
    if "lo" in emb:
        return {"w": np.asarray(j_row.combine_split(emb["hi"], emb["lo"]))}
    return {k: np.asarray(v, np.float32) for k, v in emb.items()}


def _dense_master(dense: dict) -> np.ndarray:
    """The fp32 dense weights: the raveled ``hi`` leaves combined with
    ``lo`` (a bf16 ``hi`` alone flips by an ulp when its master sits near a
    rounding boundary)."""
    hi = np.concatenate([np.ravel(x) for x in jax.tree.leaves(dense["hi"])])
    return np.asarray(j_row.combine_split(hi, dense["lo"][:hi.size]))


def test_train_steps_after_a_cross_package_restore(carried, tmp_path):
    """(f) Each package restores the other's checkpoint of the same state and
    takes three steps on the same batches: the port's loss within 1e-6
    relative of the reference's each step; the touched rows' weights and
    state and the fp32 dense weights within 1e-3 relative plus 1e-5, untouched
    rows bit for bit (``tests/test_torch_train.py``'s tolerances: the dense
    network sums in other orders); ``sr`` equal."""
    name, j_cfg, t_cfg, state_np, j_state, t_state = carried
    mesh = make_mesh((1, 1), ("data", "model"))
    j_step, shardings, _, layout = j_dlrm.make_train_step(j_cfg, mesh)
    t_ckpt.CheckpointManager(tmp_path / "torch").save(9, t_state, blocking=True)
    j_ckpt.CheckpointManager(tmp_path / "jax").save(9, j_state, blocking=True)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j_state)
    _, j_run = j_ckpt.CheckpointManager(tmp_path / "torch").restore(like, shardings=shardings)
    _, t_run = t_ckpt.CheckpointManager(tmp_path / "jax").restore(_other_port_state(t_cfg),
                                                                  device="cpu")
    t_step = t_dlrm.make_train_step(t_cfg, device="cpu")
    touched = np.zeros(layout.total_rows, bool)
    for b in _batches(t_cfg, 3):
        j_run, want_loss = j_step(j_run, jax.tree.map(jnp.asarray, b))
        t_run, loss = t_step(t_run, {k: to_torch(v) for k, v in b.items()})
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6, atol=0)
        touched[(b["idx"] + layout.row_offsets[None, :, None]).reshape(-1)] = True
    want = jax.tree.map(np.asarray, j_run)
    got = weights.state_to_numpy(t_run)
    if "sr" in want:
        assert int(got["sr"]) == int(want["sr"]) == 2 ** 31 - 2
    for k in state_np["emb"]:
        np.testing.assert_array_equal(_bits(got["emb"][k][~touched]),
                                      _bits(state_np["emb"][k][~touched]), err_msg=k)
    got_f, want_f = _fp32_slabs(got["emb"]), _fp32_slabs(want["emb"])
    for k in got_f:
        np.testing.assert_allclose(got_f[k][touched], want_f[k][touched], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(_dense_master(got["dense"]), _dense_master(want["dense"]),
                               rtol=1e-3, atol=1e-5)
