"""The port's run loop on a mesh against the reference's, on the CPU.

The quickstart's configuration on a (2, 4) mesh: the port's ``TrainLoop``
in one process group of 8 gloo ranks (``_torch_ranks.loop_mesh_rank``), the
reference's ``repro.train.TrainLoop`` with ``state_shardings=`` on 8 forced
XLA CPU devices in one subprocess, from one numpy start state on the same
global batches: 8 steps with a checkpoint every 4, a second loop that
restores step 8 and runs to 12.  The two processes meet halfway through
marker files (``port_ready``, ``ref_ready``): each then restores the other's
(2, 4) checkpoint and takes the next step.  Last, the elastic restart of
``examples/elastic_restart.py``: the elastic configuration trained on
(2, 4) and saved by each package, restored onto (1, 4) (the reference's
inline re-layout; the port's ``weights.reshard_global``, in 4 gloo ranks,
``_torch_ranks.elastic_rank``) and trained on.

Losses are held within 1e-5 relative over one to three steps from one
state, and within 1e-4 over the twelve steps of the loops: the two packages
sum the dense network in other orders, and the states drift apart step by
step (``tests/test_torch_train_loop.py`` holds the one-rank loop so).
The port's restart is held bit for bit to its uninterrupted run, and the
elastic restore of the reference's checkpoint bit for bit to the
reference's.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.data import synthetic as t_syn
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import row as t_row
from repro_torch.train import TrainLoop, TrainLoopConfig
from _torch_ranks import elastic_rank, loop_mesh_rank

ROOT = Path(__file__).resolve().parents[1]
QUICKSTART = dict(name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
                  table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100), emb_dim=32,
                  pooling=8, batch=512, lr=0.05)
ELASTIC = dict(name="elastic", num_dense=32, bottom=(64, 16), top=(64,),
               table_rows=(5000, 3000, 1000, 500), emb_dim=16, pooling=4, batch=64, lr=0.05)
STEPS, RESTART, EVERY = 12, 8, 4   # the loops: 8 steps, a checkpoint every 4, on to 12
K1, K2 = 4, 3                      # the elastic run: steps on (2, 4), then on (1, 4)
RTOL = 1e-5        # one step, or the first three, from one state
DRIFT_RTOL = 1e-4  # twelve steps (see test_losses_match_reference)

REF = """
import os, pickle, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import CheckpointManager
from repro.checkpoint.manager import reshard_store
from repro.core import dlrm
from repro.dist.exchange import resolve_exchange
from repro.launch.mesh import make_mesh
from repro.optim import data_parallel as dp
from repro.optim.split_sgd import combine_split
from repro.train import TrainLoop, TrainLoopConfig

c, tmp = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
tree = lambda b: jax.tree.map(jnp.asarray, b)
out = {}
try:
    big, small = make_mesh((2, 4), ("data", "model")), make_mesh((1, 4), ("data", "model"))
    cfg = dlrm.DLRMConfig(**c["qs_cfg"], fused_update=False)
    step, sh, _, _ = dlrm.make_train_step(cfg, big)
    state = jax.device_put(tree(c["qs_start"]), sh)
    stream = (tree(b) for b in c["qs_batches"])
    lcfg = lambda steps: TrainLoopConfig(steps=steps, ckpt_dir=os.path.join(tmp, "ref_qs"),
                                         ckpt_every=c["every"], log_every=100)
    first = TrainLoop(lcfg(c["restart"]), step, state, stream, state_shardings=sh)
    state = first.run()
    second = TrainLoop(lcfg(c["steps"]), step, state, stream, state_shardings=sh)
    state = second.run()
    out["losses"], out["start_step"] = first.losses + second.losses, second.start_step
    nxt = tree(c["qs_batches"][c["steps"]])
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
    out["next"] = float(step(state, nxt)[1])

    # the elastic restart, as examples/elastic_restart.py does it
    ecfg = dlrm.DLRMConfig(**c["el_cfg"], fused_update=False)
    _, layout_big = dlrm.init_state(jax.random.PRNGKey(0), ecfg, big)
    _, layout_small = dlrm.init_state(jax.random.PRNGKey(0), ecfg, small)
    estep, esh, _, _ = dlrm.make_train_step(ecfg, big)
    st = jax.device_put(tree(c["el_start"]), esh)
    el_big = []
    for b in c["el_batches"][:c["k1"]]:
        st, loss = estep(st, tree(b))
        el_big.append(float(loss))
    mgr = CheckpointManager(os.path.join(tmp, "ref_el"))
    mgr.save(c["k1"], st, blocking=True)
    _, restored = mgr.restore(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), st))
    restored["emb"] = {k: jnp.asarray(v) for k, v in reshard_store(
        layout_big, layout_small, restored["emb"]).items()}
    hi_tree = restored["dense"]["hi"]
    old_lo = np.asarray(restored["dense"]["lo"])
    flat_hi, _ = jax.flatten_util.ravel_pytree(hi_tree)
    n_real = flat_hi.size
    ns_old, nb = 8, resolve_exchange(ecfg).num_buckets
    padded = old_lo.size
    lo_nat = old_lo.reshape(ns_old, nb, padded // (ns_old * nb)).transpose(1, 0, 2).reshape(-1)
    w32 = combine_split(jax.lax.bitcast_convert_type(jnp.pad(jax.lax.bitcast_convert_type(
        flat_hi, jnp.uint16), (0, padded - n_real)), jnp.bfloat16), jnp.asarray(lo_nat))
    arrays = dp.dp_global_arrays(dp.unravel_like(w32[:n_real], hi_tree), 4, num_buckets=nb)
    restored["dense"]["hi"], restored["dense"]["lo"] = arrays["hi"], arrays["lo"]
    estep2, esh2, _, _ = dlrm.make_train_step(ecfg, small)
    st2 = jax.device_put(restored, esh2)
    out["el_restored"] = jax.tree.map(np.asarray, st2)
    el_small = []
    for b in c["el_batches"][c["k1"]:]:
        st2, loss = estep2(st2, tree(b))
        el_small.append(float(loss))
    out["el_big"], out["el_small"] = el_big, el_small
    open(os.path.join(tmp, "ref_ready"), "w").close()

    # the port's (2, 4) checkpoint, restored here
    deadline = time.monotonic() + 300
    while not os.path.exists(os.path.join(tmp, "port_ready")):
        if os.path.exists(os.path.join(tmp, "port_failed")) or time.monotonic() > deadline:
            raise SystemExit("the port's ranks wrote no checkpoint")
        time.sleep(0.1)
    at, theirs = CheckpointManager(os.path.join(tmp, "port_qs")).restore(like, shardings=sh)
    out["port_step"], out["on_port"] = at, float(step(theirs, nxt)[1])
except BaseException:
    open(os.path.join(tmp, "ref_failed"), "w").close()
    raise
pickle.dump(out, open(os.path.join(tmp, "ref.pkl"), "wb"))
"""


def _start(cfg, ranks: int, seed: int) -> dict:
    """A global Split-SGD start state of ``cfg`` at ``ranks`` row-mode shards
    as the reference's numpy arrays: table rows ~ U(-a, a) from numpy, dense
    weights drawn by the port."""
    layout = t_se.make_layout(cfg.spec, ranks, cfg.emb_mode)
    a = 1.0 / np.sqrt(np.mean(cfg.table_rows))
    W = np.random.default_rng(seed).uniform(-a, a, (layout.total_rows, cfg.emb_dim))
    return weights.state_to_numpy({
        "emb": t_row.init_store("split_sgd", torch.from_numpy(W.astype(np.float32))),
        "dense": t_dp.dp_global_arrays(
            t_dlrm.init_dense_params(cfg, torch.Generator().manual_seed(seed), "cpu"), ranks)})


def _batches(cfg, n: int, seed: int, alpha: float) -> list[dict]:
    out = []
    for b, _ in zip(t_syn.dlrm_stream(seed, cfg, alpha), range(n)):
        b["dense_x"] = b["dense_x"].astype(ml_dtypes.bfloat16)  # what both steps read
        out.append(b)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop_mesh")
    qs, el = t_dlrm.DLRMConfig(**QUICKSTART), t_dlrm.DLRMConfig(**ELASTIC)
    c = {"qs_cfg": QUICKSTART, "qs_start": _start(qs, 8, 0),
         "qs_batches": _batches(qs, STEPS + 1, 0, 0.6), "steps": STEPS, "restart": RESTART,
         "every": EVERY, "el_cfg": ELASTIC, "el_start": _start(el, 8, 1),
         "el_batches": _batches(el, K1 + K2, 1, 0.0), "k1": K1}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(c, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(tmp / "inputs.pkl"),
                            str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        try:
            port8 = run_ranks(loop_mesh_rank, 8, (c, str(tmp)), timeout_s=360, store_dir=str(tmp))
        except BaseException:
            (tmp / "port_failed").touch()
            raise
        port4 = run_ranks(elastic_rank, 4, (c, str(tmp)), timeout_s=120, store_dir=str(tmp))
        _, err = ref.communicate(timeout=360)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    return tmp, port8, port4, want


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _assert_trees_bitwise(a, b) -> None:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b) and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_losses_match_reference(runs):
    """The 12 losses of the two loops (8 steps, then 4 after the restore),
    the same on every rank, against the reference's loops: the first three
    within 1e-5, as ``tests/test_torch_hybrid.py`` holds three steps of this
    case; all twelve within 1e-4, as ``tests/test_torch_train_loop.py``
    holds the one-rank loop.  The states drift apart step by step, the two
    packages summing the dense network in other orders (measured: 7.6e-6
    at step 3, 2.04e-5 at step 7); one step from a shared state stays
    within 1e-5 (:func:`test_each_package_restores_the_others_checkpoint`)."""
    _, port8, _, want = runs
    for r in port8:
        assert r["losses"] == port8[0]["losses"] and r["start_step"] == RESTART
    assert want["start_step"] == RESTART
    np.testing.assert_allclose(port8[0]["losses"][:3], want["losses"][:3], rtol=RTOL, atol=0)
    np.testing.assert_allclose(port8[0]["losses"], want["losses"], rtol=DRIFT_RTOL, atol=0)


def test_restart_is_bit_for_bit_the_uninterrupted_run(runs):
    """The loop restored from the gathered checkpoint of step 8 (into a state
    drawn from another seed) ends where 12 steps without a checkpoint end:
    the losses and the gathered state bit for bit."""
    _, port8, _, _ = runs
    assert port8[0]["losses"] == port8[0]["whole_losses"]
    _assert_trees_bitwise(port8[0]["restarted"], port8[0]["uninterrupted"])


def test_checkpoint_files_agree(runs):
    """The (2, 4) checkpoints of both packages at each step hold the same
    keys (tree paths), dtype tags and treedef string, and arrays of the
    same shapes and dtypes: the port's rank 0 writes the reference's global
    arrays."""
    tmp, _, _, _ = runs
    for step in (EVERY, RESTART, STEPS):
        metas = [json.loads((tmp / d / f"step_{step}" / "meta.json").read_text())
                 for d in ("port_qs", "ref_qs")]
        for k in ("format_version", "step", "keys", "dtypes", "treedef"):
            assert metas[0][k] == metas[1][k], k
        with np.load(tmp / "port_qs" / f"step_{step}" / "arrays.npz") as p, \
                np.load(tmp / "ref_qs" / f"step_{step}" / "arrays.npz") as r:
            assert sorted(p.files) == sorted(r.files)
            for k in p.files:
                assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape, k


def test_each_package_restores_the_others_checkpoint(runs):
    """The port's loop restores the reference's step-12 checkpoint on its
    (2, 4) mesh and the reference restores the port's; the next step's loss
    in each matches the next step the writer takes from its own state."""
    _, port8, _, want = runs
    assert want["port_step"] == STEPS
    for r in port8:
        assert r["ref_start_step"] == STEPS and r["on_ref"] == port8[0]["on_ref"]
    np.testing.assert_allclose(port8[0]["on_ref"], want["next"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(want["on_port"], port8[0]["next"], rtol=RTOL, atol=0)


def test_elastic_restore_matches_reference(runs):
    """The reference's (2, 4) checkpoint of the elastic configuration,
    restored onto (1, 4) by the port (``weights.reshard_global``, then each
    rank's shard) and gathered back, is bit for bit the state the reference
    restores onto (1, 4)."""
    _, _, port4, want = runs
    assert port4[0]["ref_el"]["step"] == K1
    _assert_trees_bitwise(port4[0]["ref_el"]["restored"], want["el_restored"])


@pytest.mark.parametrize("src", ["ref_el", "port_el"])
def test_elastic_losses_match_reference(runs, src):
    """The (1, 4) steps after the restore of each package's (2, 4)
    checkpoint, against the reference's elastic run; and the port's (2, 4)
    steps before it."""
    _, port8, port4, want = runs
    np.testing.assert_allclose(port8[0]["el_big"], want["el_big"], rtol=RTOL, atol=0)
    for r in port4:
        assert r[src]["losses"] == port4[0][src]["losses"]
    np.testing.assert_allclose(port4[0][src]["losses"], want["el_small"], rtol=RTOL, atol=0)
    assert np.isfinite(port4[0][src]["losses"]).all()


def test_loop_on_a_mesh_drains_each_ranks_replicated_metrics():
    """A mesh's loop drains the rank's own replicated vector, with no
    collective: a (1, 1) mesh's loop over a step that adds to ``metrics``."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")

    def step(s, b):
        s["metrics"] = s["metrics"] + 1.0
        return s, 0.0
    from repro_torch.core.dlrm import DLRMConfig
    cfg = DLRMConfig(name="t", num_dense=4, bottom=(8, 8), top=(8,), table_rows=(10,), emb_dim=8,
                     pooling=1, batch=2)
    loop = TrainLoop(TrainLoopConfig(steps=3, metrics_every=2), step,
                     {"metrics": torch.zeros(6)}, iter([{}] * 3), mesh=mesh, model_cfg=cfg)
    loop.run()
    assert loop._metrics_prev["steps"] == 3.0 and loop._metrics_window["steps"] == 1.0


def test_loop_on_a_mesh_needs_the_model_config():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="model_cfg"):
        TrainLoop(TrainLoopConfig(steps=1), lambda s, b: (s, 0.0), {}, iter(()), mesh=mesh)
