"""The port's EGNN steps on a mesh of gloo ranks against the reference's on
a CPU mesh of forced XLA devices: the full-graph step at (1, 4) and the
minibatch step at (1, 2), two steps each from one numpy state
(``tests/test_torch_egnn.py``'s inputs and tolerances: the loss within
1e-4 relative, each leaf's update within 1e-2 of its largest).  One
reference process with 4 devices runs beside one ``run_ranks`` of 4 ranks.

The reference's steps run in ``shard_map(check_vma=False)``, where ``psum``
transposes to ``psum``: an N-rank step applies N times the update of the
one-rank step on the same batch.  The port keeps that factor
(``models/egnn_steps.py::grad_psum``); ``test_n_ranks_apply_n_times_the_update``
pins it in both packages.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.mesh import make_mesh
from repro.models import egnn_steps as RS
from repro_torch import weights
from repro_torch.launch.local import run_ranks
from repro_torch.models import egnn_steps as TS
from repro_torch.optim.data_parallel import tree_leaves
from test_torch_egnn import (LOSS_RTOL, SMALL, UPDATE_TOL, _fullgraph_case, _minibatch, cfgs,
                             master, update_gaps)

ROOT = Path(__file__).resolve().parents[1]
LR = 5e-3
# 203 real nodes and 782 real edges, given as 224 and 792 (a multiple of 4
# ranks x 8, and of 4): the padded nodes unlabelled, the padded edges masked,
# so that the one-rank step takes the same batch
FULL = dict(name="full", kind="full", ranks=4, n_nodes=224, n_edges=792)
MINI = dict(name="mini", kind="mini", ranks=2, n_graphs=8, n_pad=16, e_pad=16)

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import egnn, egnn_steps

out = {}
for c in pickle.load(open(sys.argv[1], "rb")):
    mesh = Mesh(np.array(jax.devices()[:c["ranks"]]).reshape(1, c["ranks"]), ("data", "model"))
    cfg = egnn.EGNNConfig(**c["cfg"])
    if c["kind"] == "full":
        step, _, (ssh, bsh) = egnn_steps.make_fullgraph_train_step(
            cfg, mesh, c["n_nodes"], c["n_edges"], lr=c["lr"])
    else:
        step, _, (ssh, bsh) = egnn_steps.make_minibatch_train_step(
            cfg, mesh, c["n_graphs"], c["n_pad"], c["e_pad"], lr=c["lr"])
    state = jax.device_put(jax.tree.map(jnp.asarray, c["start"]), ssh)
    losses, states = [], []
    for b in c["batches"]:
        state, loss = step(state, jax.device_put(jax.tree.map(jnp.asarray, b), bsh))
        losses.append(float(loss))
        states.append(jax.tree.map(np.array, state))  # copies: the next step donates
    out[c["name"]] = {"losses": losses, "states": states}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _cases() -> list:
    rcfg, _ = cfgs()
    rng = np.random.default_rng(23)
    mesh = make_mesh((1, 1), ("data", "model"))
    start = jax.tree.map(np.asarray, RS.init_egnn_state(jax.random.PRNGKey(4), rcfg, mesh))
    b = _fullgraph_case(rcfg, FULL["n_nodes"], FULL["n_edges"], 0, rng)
    b["label_mask"][203:] = 0
    b["src"] %= 203
    b["dst"] %= 203
    full = dict(FULL, cfg=SMALL, lr=LR, start=start, batches=[b, b])
    mini = dict(MINI, cfg=SMALL, lr=LR, start=start,
                batches=[_minibatch(rcfg, MINI["n_graphs"], rng, s) for s in (0, 1)])
    return [full, mini]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases, the reference's results and each port rank's."""
    tmp = tmp_path_factory.mktemp("egnn_mesh")
    cases = _cases()
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(tmp / "cases.pkl"),
                             str(tmp / "ref.pkl")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mine = run_ranks(_rank_fn(), 4, (cases,), timeout_s=240)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return {c["name"]: c for c in cases}, ref, mine


def _rank_fn():
    import _torch_ranks
    return _torch_ranks.egnn_mesh_rank


@pytest.mark.parametrize("name", ["full", "mini"])
def test_mesh_steps_match_the_reference(runs, name):
    cases, ref, mine = runs
    c, r = cases[name], ref[name]
    for rank in range(c["ranks"]):
        m = mine[rank][name]
        ref_prev = prev = c["start"]
        for i, (rl, ml) in enumerate(zip(r["losses"], m["losses"])):
            assert abs(ml - rl) <= LOSS_RTOL * abs(rl), (rank, i, ml, rl)
            gaps = update_gaps(ref_prev, r["states"][i], prev, m["states"][i])
            assert max(gaps) <= UPDATE_TOL, (rank, i, gaps)
            ref_prev, prev = r["states"][i], m["states"][i]


def test_ranks_end_with_one_state(runs):
    """Every rank of a mesh holds the same state, bit for bit, after each
    step (the (1, 2) meshes of both pairs too)."""
    _, _, mine = runs
    for name in ("full", "mini"):
        for m in mine[1:]:
            for a, b in zip(tree_leaves(mine[0][name]["states"]), tree_leaves(m[name]["states"])):
                assert np.array_equal(np.asarray(a).view(np.uint16), np.asarray(b).view(np.uint16))


def _one_rank_update(pkg: str, c: dict) -> dict:
    """The first step's fp32 update of every leaf on one rank."""
    rcfg, tcfg = cfgs()
    b = c["batches"][0]
    if pkg == "port":
        make = TS.make_fullgraph_train_step if c["kind"] == "full" else \
            TS.make_minibatch_train_step
        args = (c["n_nodes"], c["n_edges"]) if c["kind"] == "full" else \
            (c["n_graphs"], c["n_pad"], c["e_pad"])
        step, _ = make(tcfg, None, *args, LR, device="cpu")
        state = weights.egnn_state_from_numpy(c["start"], tcfg, "cpu")
        step(state, b)
        after = weights.egnn_state_to_numpy(state)
    else:
        mesh = make_mesh((1, 1), ("data", "model"))
        make = RS.make_fullgraph_train_step if c["kind"] == "full" else \
            RS.make_minibatch_train_step
        args = (c["n_nodes"], c["n_edges"]) if c["kind"] == "full" else \
            (c["n_graphs"], c["n_pad"], c["e_pad"])
        step, _, (ssh, bsh) = make(rcfg, mesh, *args, lr=LR)
        state = jax.device_put(jax.tree.map(jnp.asarray, c["start"]), ssh)
        state, _ = step(state, jax.device_put(jax.tree.map(jnp.asarray, b), bsh))
        after = jax.tree.map(np.array, state)
    return _updates(c["start"], after)


def _updates(start: dict, after: dict) -> list:
    return [master(h1, l1) - master(h0, l0) for h0, l0, h1, l1 in
            zip(*(tree_leaves(s[k]) for s in (start, after) for k in ("hi", "lo")))]


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("name", ["full", "mini"])
def test_n_ranks_apply_n_times_the_update(runs, name, pkg):
    """The first step at N ranks moves every leaf by N times the one-rank
    step's move on the same batch (each leaf within 1e-2 of its largest):
    4 times at (1, 4), 2 times at (1, 2)."""
    cases, ref, mine = runs
    c = cases[name]
    n_rank = (mine[0] if pkg == "port" else ref)[name]["states"][0]
    one = _one_rank_update(pkg, c)
    for d_n, d_1 in zip(_updates(c["start"], n_rank), one):
        want = c["ranks"] * d_1
        assert np.abs(d_n - want).max() <= UPDATE_TOL * np.abs(want).max()
