"""``repro_torch/launch/dryrun.py`` against the JAX package's dry run.

One reference subprocess (8 forced XLA devices, a (2, 4) mesh) lowers and
compiles a set of cells at cut batches and reports XLA's
``argument_size_in_bytes`` and the collectives of the compiled HLO
(``repro.launch.dryrun.parse_collective_bytes``); the port records the same
cells on a shape-only (2, 4) mesh (``launch.dryrun.run_cell``), rank 0's
step on the CPU.  Two gloo ranks (``launch.local.run_ranks``) run the EGNN
cells' real steps at (1, 2), whose ``CollectiveStats`` the shape-only
counts must equal.

How the counts are compared, kind by kind:

* ``argument_bytes`` to the byte.  XLA prunes the arguments a step never
  reads, and the port counts what the caller passes; the leaves only the
  port counts are named below with their bytes (the score and retrieval
  steps read ``hi`` and not ``lo``, and no ``labels``).
* the collectives under ``tests/test_torch_hybrid.py``'s widening rule:
  XLA's CPU pipeline carries the bf16 collectives as fp32, so the
  reference's HLO counts twice the port's bytes for each bf16 all-gather
  (the dense update's ``hi``) and reduce-scatter (row mode's bag sums;
  EGNN's node features and their transposes), while the row-mode cotangent
  all-gather stays bf16.  Named beside it: FM's dense tree is one bias
  value, padded to four buckets of 8, and XLA folds the collectives of the
  buckets that carry only padding; EGNN's layers are held against the
  reference unrolled (``cost_mode``: its HLO counts a scanned layer's
  collectives once), where XLA drops the closing all-gather of each
  checkpointed layer that PyTorch's checkpoint runs again in the backward,
  and merges and reuses its all-reduces (the degree sum is computed once),
  so EGNN's all-reduce bytes are held to the two real gloo ranks and to
  their count from the shapes instead.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from _torch_ranks import dryrun_cells_rank
from repro_torch.launch import dryrun
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_shape_mesh

ROOT = Path(__file__).resolve().parents[1]

# (arch, shape, overrides); the reference compiles each as the dry run does
CELLS = {
    "dlrm-small/train": ("dlrm-small", "train", {"batch": 64}),
    "dlrm-small/train_tablewise": ("dlrm-small", "train_tablewise", {"batch": 64}),
    "fm/train_batch": ("fm", "train_batch", {"batch": 64}),
    "fm/serve_p99": ("fm", "serve_p99", {"batch": 64}),
    "fm/retrieval_cand": ("fm", "retrieval_cand", {}),
    "egnn/full_graph_sm": ("egnn", "full_graph_sm", {}),
    "egnn/molecule": ("egnn", "molecule", {}),
    "internlm2/train_4k": ("internlm2-1.8b", "train_4k", {"n_layers": 2, "batch": 8}),
    "internlm2/decode_32k": ("internlm2-1.8b", "decode_32k", {"n_layers": 2, "batch": 8}),
    "qwen3-moe/decode_32k": ("qwen3-moe-30b-a3b", "decode_32k", {"n_layers": 2, "batch": 8}),
}
STEPPED = [k for k, (arch, _, _) in CELLS.items() if arch in ("dlrm-small", "fm", "egnn")]
# the LM cells stepped here: the decode cells (a train_4k step at full width is the card's)
LM_STEPPED = ["internlm2/decode_32k", "qwen3-moe/decode_32k"]

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import base
from repro.launch.dryrun import parse_collective_bytes
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for key, (arch, shape, over) in pickle.load(open(sys.argv[1], "rb")).items():
    for cost_mode in ((False, True) if arch == "egnn" else (False,)):
        b = base.get(arch).build(shape, mesh, cost_mode=cost_mode, **over)
        with jax.set_mesh(mesh):
            c = b.fn.lower(*b.args).compile()
        out[key, cost_mode] = {"argument_bytes": int(c.memory_analysis().argument_size_in_bytes),
                               "collectives": parse_collective_bytes(c.as_text())}
pickle.dump(out, open(sys.argv[2], "wb"))
"""

# the leaves the port passes and XLA prunes (never read by the step), with their bytes
PRUNED = {
    "fm/serve_p99": {"state emb lo [23472560, 11] int16": 516396320,
                     "state dense lo [4] int16": 8, "batch labels [64] fp32 / 8 ranks": 32},
    "fm/retrieval_cand": {"state emb lo [23472560, 11] int16": 516396320,
                          "state dense lo [4] int16": 8, "query labels [1] fp32": 4},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's compiled cells, the port's records at (2, 4) and the
    two gloo ranks' stats at (1, 2), the three run side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    with open(tmp / "cells.pkl", "wb") as f:
        pickle.dump(CELLS, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF), str(tmp / "cells.pkl"),
                             str(tmp / "ref.pkl")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mesh = make_shape_mesh((2, 4), ("data", "model"), device="cpu")
        port = {k: dryrun.run_cell(arch, shape, mesh, "2x4", over, device="cpu",
                                   step=k in STEPPED + LM_STEPPED, timed=0)
                for k, (arch, shape, over) in CELLS.items()}
        gloo = run_ranks(dryrun_cells_rank, 2, ([("egnn", "full_graph_sm"), ("egnn", "molecule")],),
                         timeout_s=240)
        one_two = make_shape_mesh((1, 2), ("data", "model"), device="cpu")
        shape_only = [dryrun.run_cell("egnn", s, one_two, "1x2", device="cpu", timed=0)
                      for s in ("full_graph_sm", "molecule")]
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, port, gloo, shape_only


@pytest.mark.parametrize("key", list(CELLS))
def test_argument_bytes_equal_xla(runs, key):
    """Rank 0's argument bytes (state and batch structs at their per-rank
    shapes; the LM parameters by ``lm_param_specs``, the decode cache by
    ``cache_specs``, XLA's padding of dims that do not divide) equal XLA's
    ``argument_size_in_bytes`` to the byte, but for the named leaves XLA
    prunes."""
    ref, port, _, _ = runs
    got = port[key]["memory"]["argument_bytes"]
    assert got - sum(PRUNED.get(key, {}).values()) == ref[key, False]["argument_bytes"]
    if key in STEPPED:   # the built state and batch hold what the structs say
        assert port[key]["memory"]["built_bytes"] == got


def _bytes(rec: dict) -> dict:
    return rec["collectives"]["bytes_out"]


def _hlo(ref: dict, key: str, cost_mode: bool = False) -> dict:
    return {k: int(v) for k, v in ref[key, cost_mode]["collectives"]["bytes_by_op"].items()}


def _dense_hi_bytes(arch: str, shape: str, over: dict) -> int:
    """The port's bf16 ``hi`` all-gather of the dense update: the padded
    dense vector, 2 bytes a value."""
    from repro_torch.configs import base
    from repro_torch.core import hybrid
    from repro_torch.launch.mesh import shape_only_meshes
    mesh = make_shape_mesh((2, 4), ("data", "model"), device="cpu")
    with shape_only_meshes():
        model = base.get(arch).build(shape, mesh, **over).model
        return hybrid.padded_dense(model, mesh) * 2


@pytest.mark.parametrize("key", ["dlrm-small/train", "dlrm-small/train_tablewise"])
def test_dlrm_collective_bytes_equal_the_hlo(runs, key):
    """The DLRM cells' shape-only counts at (2, 4) against the reference's
    HLO under the widening rule: all-to-all and all-reduce exactly, the
    all-gathers less the widened bf16 ``hi`` all-gather, row mode's
    reduce-scatters less the widened bf16 bag reduce-scatter ([8, 8, 64])."""
    ref, port, _, _ = runs
    got, want = _bytes(port[key]), _hlo(ref, key)
    hi = _dense_hi_bytes(*CELLS[key])
    bag = 8 * 8 * 64 * 2 if key.endswith("/train") else 0
    assert set(got) == set(want)
    assert want["all-gather"] == got["all-gather"] + hi
    assert want["reduce-scatter"] == got["reduce-scatter"] + bag
    for kind in set(got) - {"all-gather", "reduce-scatter"}:
        assert want[kind] == got[kind]


def test_fm_collective_bytes_equal_the_hlo(runs):
    """FM's three cells against the HLO: the bag reduce-scatter ([8, 39, 11]
    bf16) widened; the retrieval's all-gathers of 128 scores and 128 int32
    indices a rank and its replicated query bag's all-reduce exactly; the
    train step's dense update with the padding buckets XLA folds away (of
    the port's four 4-byte reduce-scatters and four 16-byte bf16 ``hi``
    all-gathers the HLO keeps 8 bytes and one f32[8])."""
    ref, port, _, _ = runs
    bag = 8 * 39 * 11 * 2
    got, want = _bytes(port["fm/serve_p99"]), _hlo(ref, "fm/serve_p99")
    assert got == {"reduce-scatter": bag} and want == {"reduce-scatter": 2 * bag}
    got, want = _bytes(port["fm/retrieval_cand"]), _hlo(ref, "fm/retrieval_cand")
    assert got == want == {"all-gather": 8 * 128 * 4 * 2, "all-reduce": 39 * 11 * 4}
    got, want = _bytes(port["fm/train_batch"]), _hlo(ref, "fm/train_batch")
    assert got["all-reduce"] == want["all-reduce"] == 4
    assert got["reduce-scatter"] == bag + 4 * 4 and want["reduce-scatter"] == 2 * bag + 8
    assert got["all-gather"] == 64 * 39 * 11 * 2 + 4 * 16
    assert want["all-gather"] == 64 * 39 * 11 * 2 + 8 * 4


def _egnn_shapes(key: str) -> tuple:
    """(N, N / 8) of a cell at (2, 4): its nodes padded to 64."""
    n = {"egnn/full_graph_sm": 2708, "egnn/molecule": 128 * 30}[key]
    N = -(-n // 64) * 64
    return N, N // 8


@pytest.mark.parametrize("key", ["egnn/full_graph_sm", "egnn/molecule"])
def test_egnn_collective_bytes_equal_the_unrolled_hlo(runs, key):
    """EGNN's 4 layers at (2, 4) against the reference unrolled: the
    all-gathers of bf16 node features (the encoder's, each layer's and each
    checkpointed layer's again in the backward) and of fp32 aggregate
    cotangents; the reduce-scatters of fp32 aggregates (forward and
    recomputed) and of bf16 feature cotangents.  With bf16 widened and the
    recomputed closing all-gathers dropped, the HLO's bytes exactly."""
    ref, port, _, _ = runs
    N, Nsh, H, L = *_egnn_shapes(key), 64, 4
    got, want = _bytes(port[key]), _hlo(ref, key, cost_mode=True)
    assert got["all-gather"] == (1 + 2 * L) * N * H * 2 + L * N * H * 4
    assert got["reduce-scatter"] == 2 * L * Nsh * H * 4 + (1 + L) * Nsh * H * 2
    assert want["all-gather"] == (1 + L) * N * H * 4 + L * N * H * 4
    assert want["reduce-scatter"] == 2 * L * Nsh * H * 4 + (1 + L) * Nsh * H * 4


@pytest.mark.parametrize("i,key", enumerate(["egnn/full_graph_sm", "egnn/molecule"]))
def test_shape_only_counts_equal_two_real_ranks(runs, i, key):
    """At (1, 2) the shape-only step's calls and bytes of every kind equal
    the ``CollectiveStats`` of the same cell's real step on two gloo ranks
    (both ranks alike)."""
    _, _, gloo, shape_only = runs
    for rank in gloo:
        assert rank[i] == shape_only[i]["collectives"]
    assert shape_only[i]["collectives"]["bytes_out"]["all-reduce"] > 0


@pytest.mark.parametrize("key", ["egnn/full_graph_sm", "egnn/molecule"])
def test_egnn_all_reduce_bytes_from_the_shapes(runs, key):
    """EGNN's all-reduce bytes at (2, 4) from its shapes: each layer's fp32
    coordinate partials [N, 3] and degrees [N] (forward and recomputed), the
    partials' cotangent of every layer but the last (whose coordinates reach
    no loss); the loss's sums; the flat bf16 gradient (each leaf at a
    multiple of 8 values)."""
    from repro_torch.configs import egnn_arch
    from repro_torch.models.egnn_steps import egnn_state_structs
    _, port, _, _ = runs
    N, Nsh, L = *_egnn_shapes(key), 4
    leaves = []

    def walk(t):
        for v in (t.values() if isinstance(t, dict) else t):
            walk(v) if isinstance(v, (dict, list)) else leaves.append(v[0])
    walk(egnn_state_structs(egnn_arch.config(key.split("/")[1]))["hi"])
    flat = sum(-(-int(torch.Size(s).numel()) // 8) * 8 for s in leaves) * 2
    layers = 2 * L * (N * 3 * 4 + N * 4) + (L - 1) * N * 3 * 4
    loss = ({"egnn/full_graph_sm": 2 * Nsh * 4 + 4, "egnn/molecule": 2 * 128 * 4}[key])
    assert _bytes(port[key])["all-reduce"] == layers + loss + flat


def test_records_of_the_stepped_cells(runs):
    """Every stepped cell is ``ok``: products counted where the dense
    network multiplies matrices, outputs counted, no peak off the card."""
    _, port, _, _ = runs
    for key in STEPPED:
        rec = port[key]
        assert rec["status"] == "ok" and rec["device"] == "cpu"
        assert rec["memory"]["output_bytes"] > 0 and "peak_bytes" not in rec["memory"]
        assert rec["collectives"]["total_bytes"] == sum(rec["collectives"]["bytes_out"].values())
    assert port["dlrm-small/train"]["cost"]["product_flops"] > 0
    assert port["egnn/full_graph_sm"]["cost"]["product_flops"] > 0


def test_lm_cells_are_structs_only_and_skips_the_reference_s(runs):
    """The stepped LM cells are recorded ``ok``: rank 0's step cut to one
    layer at full width (``meta.stepped_layers``), its built state,
    parameters and cache equal to the cut depth's structs, its outputs and
    collectives counted (the decode's gathers, the MoE's all-to-alls), the
    argument bytes still the full depth's; a cell whose step is not asked
    for stays ``structs_only``; a two-pod LM cell is ``structs_only`` with
    its argument bytes; the reference's skips are ``skipped`` with its
    reason word for word."""
    _, port, _, _ = runs
    for key in LM_STEPPED:
        rec = port[key]
        assert rec["status"] == "ok" and rec["meta"]["family"] == "lm", rec.get("error")
        assert rec["meta"]["stepped_layers"] == 1
        m = rec["memory"]
        assert m["built_bytes"] == m["stepped_argument_bytes"] < m["argument_bytes"]
        assert m["output_bytes"] > 0 and rec["collectives"]["calls"]["all-gather"] > 0
    assert port["qwen3-moe/decode_32k"]["collectives"]["calls"]["all-to-all"] > 0
    assert port["internlm2/train_4k"]["status"] == "structs_only"
    two = make_shape_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", two, "2x2x2",
                          {"n_layers": 2, "batch": 8}, device="cpu")
    assert rec["status"] == "structs_only" and rec["memory"]["argument_bytes"] > 0
    mesh = make_shape_mesh((16, 16), ("data", "model"), device="cpu")
    rec = dryrun.run_cell("phi3-medium-14b", "long_500k", mesh, "pod1x16x16", device="cpu")
    assert rec["status"] == "skipped"
    assert rec["skip_reason"] == ("pure full-attention arch: long_500k requires sub-quadratic "
                                  "attention (DESIGN.md section 5)")


def test_cli_runs_fm_on_the_cpu_and_resumes(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch fm --multi-pod skip`` on
    the CPU at a cut batch: one record a cell, each ``ok``, rank 0's built
    bytes its argument bytes; a second run takes every cell from its cache."""
    argv = ["--arch", "fm", "--multi-pod", "skip", "--device", "cpu", "--batch", "512",
            "--out", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "dry-run summary: ok=4 skipped=0 structs_only=0 failed=0" in proc.stdout
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"fm__{s}__pod1x16x16.json" for s in
                     ("retrieval_cand", "serve_bulk", "serve_p99", "train_batch")]
    for p in tmp_path.iterdir():
        rec = json.loads(p.read_text())
        assert rec["status"] == "ok"
        assert rec["memory"]["built_bytes"] == rec["memory"]["argument_bytes"]
    assert dryrun.main(argv) == 0


def test_cli_exits_non_zero_on_a_failed_cell(tmp_path, monkeypatch, capsys):
    """A cell whose record is ``error`` is written, counted and makes the
    run exit 1; a cached error is run again."""
    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    argv = ["--arch", "fm", "--shape", "serve_p99", "--multi-pod", "only", "--device", "cpu",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 1
    rec = json.loads((tmp_path / "fm__serve_p99__pod2x16x16.json").read_text())
    assert rec["status"] == "error" and "planted" in rec["error"]
    assert dryrun.main(argv) == 1
    assert "failed=1" in capsys.readouterr().out
