"""Train-to-serve publishing (``repro_torch.serve.publish``) against the
reference's ``repro.serve.publish``, on the CPU.

The reference's publisher cases (``tests/test_serve.py``: the cadence and
freshness, the loop's step hook and the heartbeat's ``serve`` record) run on
both packages, each with a small DLRM's state.  Then what the port's
in-place step makes necessary: a published snapshot keeps its bytes while
the loop trains on (three in-place steps), and the snapshot of a state with
the hot-row cache carries ``hot_w`` and ``hot_pos`` as the reference's does,
bit for bit from the same state.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro import serve as j_serve
from repro import train as j_train
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.launch.mesh import make_mesh as j_make_mesh
from repro_torch import serve as t_serve
from repro_torch import train as t_train
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.launch.mesh import make_mesh as t_make_mesh
from repro_torch.testing import to_torch

SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13), emb_dim=16, pooling=3, batch=16, lr=0.1)


class _Pkg:
    """One package's publisher, loop and a small DLRM state of its own."""

    def __init__(self, name):
        self.name = name
        self.serve = j_serve if name == "jax" else t_serve
        self.train = j_train if name == "jax" else t_train

    def model(self, **over):
        """``(model, state)``: the reference's hybrid def and its state, or
        the port's config and the same state carried across."""
        j_cfg = j_dlrm.DLRMConfig(**SMALL, **over)
        mdef = j_dlrm.as_hybrid_def(j_cfg)
        state, _ = j_hybrid.init_state(jax.random.PRNGKey(0), mdef,
                                       j_make_mesh((1, 1), ("data", "model")))
        if self.name == "jax":
            return mdef, state
        t_cfg = t_dlrm.DLRMConfig(**SMALL, **over)
        return t_cfg, weights.state_to(
            weights.state_from_numpy(jax.tree.map(np.asarray, state), t_cfg, device="cpu"), "cpu")

    def TrainLoop(self, cfg, step, state, batches, **kw):
        extra = {} if self.name == "jax" else {"device": "cpu"}
        return self.train.TrainLoop(cfg, step, state, batches, **extra, **kw)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Pkg(request.param)


def test_publisher_cadence_and_freshness(pkg):
    model, state = pkg.model()
    pub = pkg.serve.SnapshotPublisher(model, publish_every=2)
    assert pub.freshness() == {}
    snap = pub.publish(0, state)            # v1 before training starts
    # published snapshots own their slabs
    assert snap.state["emb_w"] is not state["emb"]["hi"]
    for step in range(1, 6):
        pub(step, state)                    # the TrainLoop step_hook shape
    assert pub.publishes == 3               # step 0, 2, 4
    assert pub.registry.current().version == 3
    f = pub.freshness()
    assert f["version"] == 3 and f["steps_behind"] == 1  # head 5, snap 4
    assert 0 <= f["seconds_behind"] < 60
    stats = pkg.serve.combined_serve_stats(pub)()
    assert stats["snapshot"]["publishes"] == 3
    assert stats["snapshot"]["versions"] == [2, 3]
    with pytest.raises(ValueError):
        pkg.serve.SnapshotPublisher(model, publish_every=0)


def test_trainloop_step_hook_and_serve_heartbeat(pkg, tmp_path):
    hooks = []

    def step(state, batch):
        return state + 1, float(state)

    hb = tmp_path / "hb.jsonl"
    loop = pkg.TrainLoop(pkg.train.TrainLoopConfig(steps=4, log_every=100, prefetch=0,
                                                   heartbeat_path=str(hb), heartbeat_every=2),
                         step, 0, iter(range(100)),
                         step_hook=lambda s, st: hooks.append(s),
                         serve_stats=lambda: {"snapshot": {"version": 7}})
    loop.run()
    assert hooks == [1, 2, 3, 4]            # every completed step, in order
    recs = [json.loads(ln) for ln in hb.read_text().splitlines()]
    assert recs
    assert all(r["serve"] == {"snapshot": {"version": 7}} for r in recs)


def test_publisher_stats_merge_a_servers():
    """``combined_serve_stats`` folds a server's queue and latency stats in
    beside the publisher's, as the reference's does."""
    cfg, state = _Pkg("torch").model()
    pub = t_serve.SnapshotPublisher(cfg, publish_every=1)
    pub.publish(0, state)
    with t_serve.ContinuousBatchingServer({4: lambda b: np.zeros(4)},
                                          lambda reqs, bucket: {}) as srv:
        srv.submit({}).result(timeout=10)
        rec = t_serve.combined_serve_stats(pub, srv)()
    assert rec["snapshot"]["version"] == 1 and rec["requests"] == 1
    assert set(rec) == {"snapshot", *srv.stats()}


def _u8(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes."""
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).view(-1).numpy().view(np.uint8)


def _leaves_bytes(snap: dict) -> list:
    from repro_torch.optim.data_parallel import tree_leaves
    return [_u8(t).copy() for t in tree_leaves(snap)]


def test_published_snapshot_keeps_its_bytes_across_in_place_steps(tmp_path):
    """The port's step updates the state in place: a snapshot published by
    the loop's hook shares no memory with the state, keeps its bytes through
    three more in-place steps (which change the state's slabs), and scores
    the weights it captured; the heartbeat carries its version."""
    cfg, state = _Pkg("torch").model()
    step = t_dlrm.make_train_step(cfg, t_make_mesh((1, 1), ("data", "model"), device="cpu"))
    pub = t_serve.SnapshotPublisher(cfg, publish_every=1, keep=8)
    v1 = pub.publish(0, state)
    before = _leaves_bytes(v1.state)
    hi0 = state["emb"]["hi"].clone()
    hb = tmp_path / "hb.jsonl"
    loop = t_train.TrainLoop(
        t_train.TrainLoopConfig(steps=3, log_every=100, prefetch=1, heartbeat_path=str(hb),
                                heartbeat_every=1),
        step, state, dlrm_stream(0, cfg, alpha=1.05), device="cpu", step_hook=pub,
        serve_stats=t_serve.combined_serve_stats(pub))
    state = loop.run()
    assert pub.registry.versions() == [1, 2, 3, 4]
    assert not torch.equal(state["emb"]["hi"], hi0)   # the steps moved the table in place
    for a, b in zip(_leaves_bytes(v1.state), before):
        assert np.array_equal(a, b)
    for snap in (pub.registry.get(v) for v in (1, 2, 3)):
        assert snap.state["emb_w"].data_ptr() != state["emb"]["hi"].data_ptr()
    assert torch.equal(pub.registry.current().state["emb_w"], state["emb"]["hi"])
    recs = [json.loads(ln) for ln in hb.read_text().splitlines()]
    assert [r["serve"]["snapshot"]["version"] for r in recs][:3] == [2, 3, 4]
    batch = next(dlrm_stream(5, cfg))
    fn, _ = t_serve.make_snapshot_score_step(cfg, batch=cfg.batch, device="cpu")
    tb = {"idx": torch.from_numpy(batch["idx"]), "dense_x": to_torch(batch["dense_x"])}
    got = fn(v1.state, tb)
    want = fn(t_serve.snapshot_state(cfg, {"emb": {"hi": hi0, "lo": None},
                                          "dense": {"hi": v1.state["dense_hi"]}}), tb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("copy", [False, True])
def test_snapshot_carries_the_hot_slab_as_the_reference(copy):
    """With ``hot_rows > 0`` the snapshot holds ``hot_w`` and ``hot_pos``
    beside ``emb_w`` and ``dense_hi``, as the reference's does, bit for bit
    from the same state; without it, neither."""
    over = dict(emb_mode="table", idx_input="sharded", hot_rows=4)
    j_model, j_state = _Pkg("jax").model(**over)
    t_cfg, t_state = _Pkg("torch").model(**over)
    want = j_serve.snapshot.snapshot_state(j_model, j_state, copy=copy)
    got = t_serve.snapshot_state(t_cfg, t_state, copy=copy)
    assert set(got) == set(want) == {"emb_w", "dense_hi", "hot_w", "hot_pos"}
    for k in ("hot_w", "hot_pos", "emb_w"):
        np.testing.assert_array_equal(_u8(weights.to_torch(np.asarray(want[k]))), _u8(got[k]))
    assert (got["hot_w"] is t_state["cache"]["hot_w"]) == (not copy)
    cold, cold_state = _Pkg("torch").model()
    assert set(t_serve.snapshot_state(cold, cold_state)) == {"emb_w", "dense_hi"}
