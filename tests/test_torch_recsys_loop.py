"""The recsys archetypes beyond one step on one rank, on the CPU: BST in
table mode over two gloo ranks against the reference on two forced XLA
devices, a recsys train state through format-v2 checkpoints across the two
packages, and the launcher's recsys branch.

The two-rank case spawns one reference subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``) and, at the same
time, two gloo ranks (``launch.local.run_ranks``,
``_torch_ranks.recsys_table_rank``), from one start state: the port's draw
as the reference's global arrays.  Two steps of BST with its shared item
table (21 slots on table 0): the losses within 1e-5 relative (two ranks'
dense sums in another order), the rows no step touched bit for bit, the
fp32 masters of the touched rows and of the dense weights within 1e-3
relative plus 1e-5 (``tests/test_torch_hybrid.py``'s tolerances).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.core import hybrid as j_h
from repro.launch.mesh import make_mesh
from repro.models import recsys as j_rec
from repro_torch import checkpoint as t_ckpt
from repro_torch import weights
from repro_torch.checkpoint.manager import treedef_str
from repro_torch.core import hybrid as t_h
from repro_torch.core import sharded_embedding as t_se
from repro_torch.launch import train as t_launch
from repro_torch.launch.local import run_ranks
from repro_torch.models import recsys as t_rec
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import row as t_row
from _torch_cases import bits, dense_master, master
from _torch_ranks import recsys_table_rank

ROOT = Path(__file__).resolve().parents[1]
BST = dict(item_vocab=100, ctx_rows=(20,) * 8, batch=16)

REF = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.core import hybrid as H
from repro.launch.mesh import make_mesh
from repro.models import recsys as R
c = pickle.load(open(sys.argv[1], "rb"))
mdef = dataclasses.replace(R.make_bst(c["item_vocab"], c["ctx_rows"], batch=c["batch"]),
                           emb_mode="table", fused_update=False)
mesh = make_mesh((1, 2), ("data", "model"))
step, shardings, _, _ = H.make_train_step(mdef, mesh)
state = jax.device_put(jax.tree.map(jnp.asarray, c["start"]), shardings)
losses = []
for b in c["batches"]:
    state, loss = step(state, jax.tree.map(jnp.asarray, b))
    losses.append(float(loss))
pickle.dump({"losses": losses, "state": jax.tree.map(np.asarray, state)},
            open(sys.argv[2], "wb"))
"""


def _bst_table_case(seed: int = 0, steps: int = 2) -> tuple:
    """(the case, the layout): a global start state of BST in table mode on
    two shards (table rows ~ U(-a, a) from numpy, the dense tree the port's
    draw) and ``steps`` padded-slot batches."""
    tm = t_rec.make_bst(BST["item_vocab"], BST["ctx_rows"], batch=BST["batch"])
    layout = t_se.make_layout(tm.spec, 2, "table", slot_to_table=tm.slot_to_table)
    rng = np.random.default_rng(seed)
    a = 1.0 / np.sqrt(np.mean(tm.spec.table_rows))
    W = rng.uniform(-a, a, (layout.total_rows, tm.spec.dim)).astype(np.float32)
    state = {"emb": t_row.init_store("split_sgd", torch.from_numpy(W)),
             "dense": t_dp.dp_global_arrays(tm.init_dense(torch.Generator().manual_seed(seed),
                                                          "cpu"), 2)}
    batches = []
    rows = [tm.spec.table_rows[t] for t in tm.slot_to_table]
    for _ in range(steps):
        idx = np.stack([rng.zipf(1.3, (BST["batch"], 1)) % m for m in rows], 1).astype(np.int32)
        batches.append({"idx": t_se.permute_indices(layout, torch.from_numpy(idx)).numpy(),
                        "labels": rng.integers(0, 2, BST["batch"]).astype(np.float32)})
    return {**BST, "start": weights.state_to_numpy(state), "batches": batches}, layout


def _touched(layout, batches) -> np.ndarray:
    """The rows of the global store the steps read: each padded slot's ids
    at its shard's offset, and every shard's spare row (the dummy slots)."""
    out = np.zeros(layout.total_rows, bool)
    R = layout.rows_per_shard
    pos = np.arange(layout.num_padded_slots)
    base = (pos // layout.slots_per_shard) * R + layout.slot_local_offsets
    for b in batches:
        out[(b["idx"] + base[None, :, None]).reshape(-1)] = True
    out[np.arange(layout.num_shards) * R + R - 1] = True
    return out


def test_bst_table_mode_on_two_ranks_matches_reference(tmp_path):
    """BST in table mode, its 21 sequence slots on one shared item table,
    over two gloo ranks against the reference's two XLA devices: two steps
    (see the module's tolerances)."""
    c, layout = _bst_table_case()
    with open(tmp_path / "case.pkl", "wb") as f:
        pickle.dump(c, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(tmp_path / "case.pkl"),
                            str(tmp_path / "ref.pkl")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = run_ranks(recsys_table_rank, 2, (c,), timeout_s=180, store_dir=str(tmp_path))
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    assert port[0]["losses"] == port[1]["losses"]
    np.testing.assert_allclose(port[0]["losses"], want["losses"], rtol=1e-5)
    got = port[0]["state"]
    rows = _touched(layout, c["batches"])
    for k in want["state"]["emb"]:
        np.testing.assert_array_equal(bits(got["emb"][k])[~rows],
                                      bits(want["state"]["emb"][k])[~rows])
    np.testing.assert_allclose(master(got["emb"])[rows], master(want["state"]["emb"])[rows],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dense_master(got, 2), dense_master(want["state"], 2),
                               rtol=1e-3, atol=1e-5)


def _tbits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.element_size() == 2 else t).numpy()


def _start(name: str):
    """(the reference's (1, 1) start state of the smoke-size ``name``, as
    JAX arrays, as numpy arrays, and as the port's CPU state; the port's
    model)."""
    import test_torch_recsys as rs
    jm, tm = rs.make(name, j_rec), rs.make(name, t_rec)
    state, _ = j_h.init_state(jax.random.PRNGKey(0), jm, make_mesh((1, 1), ("data", "model")))
    state_np = jax.tree.map(np.asarray, state)
    return state, state_np, weights.state_from_numpy(state_np, tm, device="cpu"), tm


@pytest.mark.parametrize("name", ["fm", "bst", "sasrec", "din"])
def test_recsys_checkpoint_restores_across_packages(name, tmp_path):
    """A recsys train state in format v2, both ways, bit for bit: the
    reference's checkpoint restored by the port (into a state of another
    draw: every leaf replaced, the dense ``hi`` one flat buffer again), and
    the port's by the reference with verification on.  SASRec's stacked
    ``blocks`` nest three deep; the treedef strings agree."""
    j_state, state_np, t_state, tm = _start(name)
    j_ckpt.CheckpointManager(tmp_path / "j").save(7, j_state, blocking=True)
    other = t_h.init_state(tm, torch.Generator().manual_seed(1), device="cpu")
    step, got = t_ckpt.CheckpointManager(tmp_path / "j").restore(other, device="cpu")
    assert step == 7 and treedef_str(got) == treedef_str(t_state)
    for a, b in zip(t_dp.tree_leaves(got), t_dp.tree_leaves(t_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_tbits(a), _tbits(b))
    assert t_dp.flat_hi(got["dense"]["hi"], got["dense"]["lo"].numel()) is not None
    t_ckpt.CheckpointManager(tmp_path / "t").save(9, t_state, blocking=True)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j_state)
    step, back = j_ckpt.CheckpointManager(tmp_path / "t").restore(like, verify=True)
    assert step == 9 and jax.tree.structure(back) == jax.tree.structure(state_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("arch", ["fm", "bst", "sasrec", "din"])
def test_launcher_trains_each_archetype(arch, tmp_path, capsys):
    """``--arch fm|bst|sasrec|din --device cpu``: the reference's reduced
    archetype trains three steps on the synthetic stream through
    ``TrainLoop(model_cfg=HybridDef)``, every loss finite, a checkpoint at
    step 2 in format v2; a second run resumes from it to step 4."""
    argv = ["--arch", arch, "--device", "cpu", "--batch", "32", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    out = t_launch.main(argv + ["--steps", "3"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "[train] done" in capsys.readouterr().out
    assert t_ckpt.CheckpointManager(tmp_path / "ck").latest_valid_step() == 3
    again = t_launch.main(argv + ["--steps", "4"])
    assert again["start_step"] == 3 and len(again["losses"]) == 1


@pytest.mark.parametrize("arch,field", [("sasrec", "seq_mask"), ("din", "hist_mask")])
def test_launcher_refuses_packed_data_for_extras_it_cannot_carry(arch, field, tmp_path):
    """``--data-format packed`` for SASRec and DIN: their masks are not in the
    shard format, and the launcher says so (the reference's message) before
    it reads the directory."""
    with pytest.raises(SystemExit) as e:
        t_launch.main(["--arch", arch, "--device", "cpu", "--batch", "32", "--steps", "1",
                       "--data-dir", str(tmp_path / "none")])
    assert "cannot feed this arch" in str(e.value.code) and field in str(e.value.code)
