"""The port's launcher (``python -m repro_torch.launch.train``, its DLRM
path) against the reference's ``repro.launch.train``, on the CPU.

The refusal matrix: every refusal of the reference's launcher raises the
same ``SystemExit`` text from both (the weighted refusal names each
package's own packer), and the port's own refusals name their ROADMAP
items.  ``main(argv)`` with ``--device cpu``: the synthetic stream; a packed
dataset with ``--host-presort --optimizer adagrad_rowwise``; ``--trace-dir``
with a preemption and a resume; publishing and the serving smoke; two ranks
(two spawned gloo processes), whose first loss is the one-rank run's within
1e-6.  The launcher parity case: the reference's launcher checkpoints step 3
of a packed ``dlrm-smoke`` run (batch 64) in format v2; both launchers
resume copies of it to step 6 on the same dataset, and the two step-6
checkpoints agree within the tolerances of
``tests/test_torch_train_loop.py::test_quickstart_contract_matches_the_reference_loop``.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import train as j_launch
from repro_torch import weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import dlrm as t_dlrm
from repro_torch.data import format as t_format
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.launch import train as t_launch
from repro_torch.launch.local import run_ranks
from repro_torch.testing import to_torch
from _torch_ranks import rank_echo
from test_torch_train_loop import _assert_logits_close

ROOT = Path(__file__).resolve().parents[1]
SMOKE_TABLES = "5000,5000,5000,5000,5000,5000,5000,5000"


def _ref_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    return j_launch.main()


def _exit_text(call) -> str:
    with pytest.raises(SystemExit) as e:
        call()
    return str(e.value.code)


SHARED_REFUSALS = {
    "packed-without-dir": ["--arch", "dlrm-smoke", "--data-format", "packed"],
    "weighted-synthetic": ["--arch", "dlrm-smoke", "--weighted"],
    "presort-synthetic": ["--arch", "dlrm-smoke", "--host-presort"],
    "beta-without-optimizer": ["--arch", "dlrm-smoke", "--beta", "0.9"],
    "eps-without-optimizer": ["--arch", "dlrm-100m", "--eps", "1e-6"],
    "lm-packed": ["--arch", "internlm2-1.8b", "--data-dir", "nowhere"],
    "lm-microbatches": ["--arch", "internlm2-1.8b", "--microbatches", "2"],
    "lm-optimizer": ["--arch", "gemma2-27b", "--optimizer", "sgd"],
    "lm-hot-rows": ["--arch", "internlm2-1.8b", "--hot-rows", "4"],
    "lm-exchange": ["--arch", "internlm2-1.8b", "--exchange-dtype", "bf16"],
    "lm-step-metrics": ["--arch", "internlm2-1.8b", "--step-metrics"],
    "lm-publish": ["--arch", "internlm2-1.8b", "--publish-every", "5"],
    "lm-serve-smoke": ["--arch", "internlm2-1.8b", "--serve-smoke"],
}


@pytest.mark.parametrize("case", sorted(SHARED_REFUSALS))
def test_refusals_match_the_reference(case, monkeypatch):
    argv = SHARED_REFUSALS[case]
    want = _exit_text(lambda: _ref_main(argv, monkeypatch))
    got = _exit_text(lambda: t_launch.main(argv))
    assert want and got.replace("repro_torch.", "repro.") == want


def test_unknown_optimizer_fails_in_both(monkeypatch):
    argv = ["--arch", "dlrm-smoke", "--optimizer", "nope"]
    for call in (lambda: _ref_main(argv, monkeypatch), lambda: t_launch.main(argv)):
        with pytest.raises(ValueError, match="unknown sparse optimizer 'nope'"):
            call()


PORT_REFUSALS = {
    "fm": (["--arch", "fm"], "item 9"),
    "bst": (["--arch", "bst"], "item 9"),
    "sasrec": (["--arch", "sasrec", "--data-dir", "x"], "item 9"),
    "din": (["--arch", "din"], "item 9"),
    "lm": (["--arch", "internlm2-1.8b"], "item 8"),
    "publish-two-ranks": (["--arch", "dlrm-smoke", "--ranks", "2", "--device", "cpu",
                           "--publish-every", "5"], "item 7"),
    "serve-two-ranks": (["--arch", "dlrm-smoke", "--ranks", "2", "--device", "cpu",
                         "--serve-smoke"], "item 7"),
}


@pytest.mark.parametrize("case", sorted(PORT_REFUSALS))
def test_port_refusals_name_their_roadmap_item(case):
    argv, item = PORT_REFUSALS[case]
    text = _exit_text(lambda: t_launch.main(argv))
    assert f"ROADMAP queue 1 {item}" in text


def test_no_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--arch", "dlrm-smoke", "--steps", "1"])


def test_local_mesh_shape_is_the_references():
    assert [t_launch.local_mesh_shape(n) for n in (1, 2, 4, 6, 8, 16)] == [
        (1, 1), (1, 2), (1, 4), (1, 6), (2, 4), (4, 4)]
    for name in ("dlrm-100m", "dlrm-small", "dlrm-smoke"):
        want = j_launch.reduced_dlrm(name, 128)
        got = t_launch.reduced_dlrm(name, 128)
        for f in ("num_dense", "bottom", "top", "table_rows", "emb_dim", "pooling", "batch"):
            assert getattr(got, f) == getattr(want, f), (name, f)
    params = sum(t_launch.reduced_dlrm("dlrm-100m", 1).table_rows) * 64
    assert params == 102_400_000


def _pack(out: Path, n: int = 512, weighted: bool = False) -> Path:
    argv = ["synthetic", "--out", str(out), "--tables", SMOKE_TABLES, "--pooling", "10",
            "--num-dense", "64", "--num-samples", str(n), "--samples-per-shard", "128",
            "--alpha", "1.05"]
    t_format.main(argv + (["--weighted"] if weighted else []))
    return out


def _finite(losses) -> bool:
    return len(losses) > 0 and bool(np.isfinite(losses).all())


def test_main_on_the_synthetic_stream(capsys):
    out = t_launch.main(["--arch", "dlrm-smoke", "--steps", "4", "--batch", "32",
                         "--device", "cpu", "--alpha", "1.05"])
    assert out["start_step"] == 0 and len(out["losses"]) == 4 and _finite(out["losses"])
    text = capsys.readouterr().out
    assert "[train] devices=1 (cpu) mesh={'data': 1, 'model': 1}" in text
    assert f"[train] done: first loss {out['losses'][0]:.4f}" in text


def test_main_on_a_packed_dataset_with_presort(tmp_path, capsys):
    """``--host-presort --optimizer adagrad_rowwise`` on a packed dataset:
    the losses are those of the port's own step on the reader's batches
    with the device sort, bit for bit."""
    import dataclasses
    from repro_torch.data.reader import ShardedReader
    from repro_torch.launch.mesh import make_mesh
    d = _pack(tmp_path / "ds")
    out = t_launch.main(["--arch", "dlrm-smoke", "--steps", "5", "--batch", "64", "--device",
                         "cpu", "--data-dir", str(d), "--host-presort", "--optimizer",
                         "adagrad_rowwise", "--lr", "0.01"])
    assert "host pre-sort ON" in capsys.readouterr().out
    cfg = dataclasses.replace(t_launch.reduced_dlrm("dlrm-smoke", 64), lr=0.01,
                              sparse_optimizer="adagrad_rowwise")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    state = t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), mesh=mesh)
    step = t_dlrm.make_train_step(cfg, mesh)
    want = []
    for b, _ in zip(ShardedReader(d, batch=64, seed=0), range(5)):
        state, loss = step(state, {k: torch.from_numpy(np.array(v)) for k, v in b.items()})
        want.append(float(loss))
    assert out["losses"] == want


def test_main_traces_preempts_and_resumes(tmp_path, capsys):
    d = _pack(tmp_path / "ds")
    tr, ck = tmp_path / "trace", tmp_path / "ckpt"
    argv = ["--arch", "dlrm-smoke", "--steps", "6", "--batch", "64", "--device", "cpu",
            "--data-dir", str(d), "--ckpt-dir", str(ck), "--ckpt-every", "3",
            "--trace-dir", str(tr), "--metrics-every", "2"]
    first = t_launch.main(argv + ["--preempt-at", "1"])
    assert len(first["losses"]) == 2                  # a stop requested at 1: step 1 completes
    events = [json.loads(ln) for ln in (tr / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["fault_injected", "preempted"]
    assert CheckpointManager(ck).latest_valid_step() == 2
    doc = json.loads((tr / "trace.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train/step", "ingest/prep"} <= names
    assert {f"stage/{s}" for s in ("index_exchange", "embedding_fwd", "dense_fwd_bwd",
                                   "dY_exchange", "sparse_update", "dense_update")} <= names
    second = t_launch.main(argv)
    assert second["start_step"] == 2 and len(second["losses"]) == 4
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert CheckpointManager(ck).latest_valid_step() == 6
    hb = [json.loads(ln) for ln in (tr / "heartbeat.jsonl").read_text().splitlines()]
    assert [r["step"] for r in hb][-3:] == [4, 6, 6]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", "summarize",
                           str(tr / "trace.json")], capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "track: pipeline_stages" in proc.stdout and "train/step" in proc.stdout
    from repro_torch import telemetry
    assert not telemetry.get_tracer().enabled     # the launcher leaves the tracer off


def test_main_publishes_and_serves(tmp_path, capsys):
    """``--publish-every 2 --serve-smoke``: versions at steps 0, 2 and 4,
    and the smoke's scores those of the eval step on the state the last
    version captured, within an fp32 ulp."""
    out = t_launch.main(["--arch", "dlrm-smoke", "--steps", "4", "--batch", "32", "--device",
                         "cpu", "--publish-every", "2", "--serve-smoke", "--serve-buckets",
                         "8,16,64", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4"])
    text = capsys.readouterr().out
    assert "[serve] snapshot v1 published" in text and "cadence 2 steps" in text
    serve = out["serve"]
    assert serve["freshness"]["version"] == 3 and serve["freshness"]["steps_behind"] == 0
    scores = serve["scores"]
    assert scores.shape == (32,) and bool(((scores > 0) & (scores < 1)).all())
    for b, p in serve["percentiles"].items():
        assert f"[serve]   bucket {b:>4}:" in text and p["n"] > 0
    cfg = t_launch.reduced_dlrm("dlrm-smoke", 32)
    like = t_dlrm.init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    _, state = CheckpointManager(tmp_path / "ck").restore(like, device="cpu")
    batch = next(dlrm_stream(1, cfg))
    want = t_dlrm.make_eval_step(cfg, device="cpu")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(scores, want.numpy(), rtol=0, atol=6e-8)


def test_main_at_two_ranks(tmp_path):
    """``--ranks 2``: two gloo processes on (1, 2), each reading the global
    packed stream and training its shard from the one-rank run's start
    state.  The first loss is the one-rank run's within 1e-6 relative (the
    two ranks' loss sums meet in another order); the later ones within 5e-4
    relative: at two shards the reduce-scatter sums each bag's
    two partial sums in fp32 and rounds once to bf16, where one rank rounds
    the whole bag, so a bag can move by a bf16 ulp (2^-8 relative), which
    moved the loss by up to 7.9e-5 relative here.  A checkpoint of the
    gathered state is written."""
    d = _pack(tmp_path / "ds")
    argv = ["--arch", "dlrm-smoke", "--steps", "3", "--batch", "64", "--device", "cpu",
            "--data-dir", str(d), "--host-presort"]
    one = t_launch.main(argv)
    two = t_launch.main(argv + ["--ranks", "2", "--ckpt-dir", str(tmp_path / "ck"),
                                "--ckpt-every", "3"])
    assert len(two["losses"]) == 3
    np.testing.assert_allclose(two["losses"][0], one["losses"][0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=5e-4, atol=0)
    assert CheckpointManager(tmp_path / "ck").latest_valid_step() == 3


def _children() -> list[str]:
    """The command lines of this process's live children."""
    out = []
    for f in Path(f"/proc/{os.getpid()}/task").glob("*/children"):
        for pid in f.read_text().split():
            try:
                out.append(Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode())
            except FileNotFoundError:  # it ended meanwhile
                pass
    return sorted(out)


@pytest.mark.parametrize("fail_rank", [-1, 1], ids=["returns", "a-rank-raises"])
def test_run_ranks_leaves_no_process(fail_rank):
    """The ranks end with the call, and so does multiprocessing's resource
    tracker, which the first ``spawn`` starts and which would otherwise live
    on as a child of the caller until it exits: whether the ranks return or
    one raises, the caller has the children it had before."""
    before = _children()
    if fail_rank < 0:
        assert run_ranks(rank_echo, 2, (fail_rank,)) == [0, 1]
    else:
        with pytest.raises(RuntimeError, match="fails on purpose"):
            run_ranks(rank_echo, 2, (fail_rank,))
    assert _children() == before


def test_launcher_parity_from_a_reference_checkpoint(tmp_path, monkeypatch):
    """The reference's launcher trains 3 steps of a packed ``dlrm-smoke`` run
    and checkpoints step 3 (format v2); each launcher resumes a copy to step
    6 on the same dataset.  The resumed losses agree within 1e-6 relative,
    and the two step-6 checkpoints within the quickstart contract's
    tolerances: the eval step's logits on a fresh batch as
    ``_assert_logits_close`` holds them, the table and dense masters within
    ``tests/test_torch_hybrid.py``'s 1e-3 relative, 1e-5 absolute."""
    from _torch_cases import dense_master, master
    d = _pack(tmp_path / "ds")
    base = ["--arch", "dlrm-smoke", "--batch", "64", "--data-dir", str(d), "--ckpt-every", "3"]
    ck = tmp_path / "ck"
    _ref_main(base + ["--steps", "3", "--ckpt-dir", str(ck)], monkeypatch)
    assert CheckpointManager(ck).latest_valid_step() == 3
    shutil.copytree(ck, tmp_path / "ck_ref")
    shutil.copytree(ck, tmp_path / "ck_port")

    loops = []

    class Recorded(j_launch.TrainLoop):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    monkeypatch.setattr(j_launch, "TrainLoop", Recorded)
    _ref_main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "ck_ref")], monkeypatch)
    port = t_launch.main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "ck_port"),
                                 "--device", "cpu"])
    assert loops[0].start_step == port["start_step"] == 3
    np.testing.assert_allclose(port["losses"], loops[0].losses, rtol=1e-6, atol=0)

    cfg = t_launch.reduced_dlrm("dlrm-smoke", 64)
    like = t_dlrm.init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    states = {}
    for tag in ("ref", "port"):
        mgr = CheckpointManager(tmp_path / f"ck_{tag}")
        assert mgr.latest_valid_step() == 6
        states[tag] = mgr.restore(like, device="cpu")[1]
    got_np, want_np = (weights.state_to_numpy(states[t]) for t in ("port", "ref"))
    np.testing.assert_allclose(master(got_np["emb"]), master(want_np["emb"]), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dense_master(got_np, 1), dense_master(want_np, 1), rtol=1e-3,
                               atol=1e-5)
    batch = next(dlrm_stream(9, cfg, alpha=1.05))
    ev = t_dlrm.make_eval_step(cfg, device="cpu")
    tb = {k: to_torch(v) for k, v in batch.items()}
    _assert_logits_close(ev(states["port"], tb), ev(states["ref"], tb).numpy())
