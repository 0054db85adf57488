"""The port stands alone: no file of ``src/repro_torch/``, ``chip_smoke.py``,
``tools/``, ``examples/quickstart_torch.py``,
``examples/elastic_restart_torch.py`` or ``examples/train_dlrm_100m_torch.py``
imports ``jax`` or anything of
``repro``, the checkpoint and the train loop need no ``ml_dtypes`` (the chip
machine's installation does not list it), importing the port
leaves JAX unloaded, the entry points that default to CUDA raise where there
is none instead of moving to the CPU, and the kernels build inside the
checkout (or, installed, under ``HOME``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py"))
              + [ROOT / "examples" / name
                 for name in ("quickstart_torch.py", "elastic_restart_torch.py",
                              "train_dlrm_100m_torch.py")])


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_scan_covers_every_tool():
    """Every script of ``tools/`` (the ablations of the port's kernels among
    them) is in the scan below."""
    tools = {p.name for p in PORT_FILES if p.parent == ROOT / "tools"}
    assert {"ablate_bag.py", "ablate_hopper.py", "ablate_row_update.py",
            "build_report.py", "time_torch_build.py"} <= tools


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.weights, "
            "repro_torch.kernels.ops, repro_torch.configs.dlrm_paper, repro_torch.data.synthetic, "
            "repro_torch.core.pipeline, repro_torch.core.hybrid, repro_torch.models.lm_steps, "
            "repro_torch.configs.internlm2_1_8b, repro_torch.configs.gemma2_27b, "
            "repro_torch.checkpoint, repro_torch.train, repro_torch.faults, repro_torch.launch.mesh, "
            "repro_torch.launch.local, repro_torch.dist.comm, repro_torch.dist.exchange, "
            "repro_torch.data, repro_torch.data.reader, repro_torch.launch.train, "
            "repro_torch.serve.publish, repro_torch.models.recsys, repro_torch.configs.fm_arch, "
            "repro_torch.configs.bst_arch, repro_torch.configs.sasrec_arch, "
            "repro_torch.configs.din_arch, repro_torch.configs.recsys_common, "
            "repro_torch.models.egnn, repro_torch.models.egnn_steps, repro_torch.data.graph, "
            "repro_torch.configs.egnn_arch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_checkpoint_and_loop_need_no_ml_dtypes(tmp_path):
    """A bf16 and int16 state saved, verified and restored, and a loop run
    over prefetched numpy batches, with ``ml_dtypes`` and JAX unimportable."""
    code = f"""
import sys
for m in ("ml_dtypes", "jax", "jaxlib"):
    sys.modules[m] = None
import numpy as np, torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.train import TrainLoop, TrainLoopConfig
state = {{"hi": torch.randn(4, 3).to(torch.bfloat16), "lo": torch.arange(5, dtype=torch.int16)}}
mgr = CheckpointManager({str(tmp_path)!r})
mgr.save(1, state, blocking=True)
step, back = mgr.restore(state, device="cpu")
assert step == 1 and all(torch.equal(back[k], state[k]) for k in state)
loop = TrainLoop(TrainLoopConfig(steps=3, prefetch=2, log_every=10), lambda s, b: (s, 0.0),
                 0, iter([{{"x": np.zeros(2)}}] * 5), device="cpu")
loop.run()
assert len(loop.losses) == 3
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_default_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import resolve_device, weights
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.configs.internlm2_1_8b import config as internlm2
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dlrm import (init_dense_params, init_state, make_eval_step,
                                       make_train_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm_steps, transformer
    from repro_torch.serve import make_bucket_scorers, make_snapshot_score_step
    from repro_torch.train import TrainLoop, TrainLoopConfig, prefetch_to_device

    cfg = dlrm_small()
    lm = internlm2()
    for call in (lambda: resolve_device(),
                 lambda: make_snapshot_score_step(cfg),
                 lambda: make_bucket_scorers(cfg, (8,), lambda: None),
                 lambda: init_dense_params(cfg, torch.Generator()),
                 lambda: weights.init_snapshot(cfg, torch.Generator()),
                 lambda: weights.snapshot_from_numpy({}, cfg),
                 lambda: make_train_step(cfg),
                 lambda: init_state(cfg, torch.Generator()),
                 lambda: weights.state_from_numpy({}, cfg),
                 lambda: weights.state_to({}, "cuda"),
                 lambda: lm_steps.make_prefill_step(lm, 1, 8),
                 lambda: lm_steps.make_decode_step(lm, 1, 8),
                 lambda: transformer.init_params(lm, torch.Generator()),
                 lambda: weights.init_lm_params(lm, torch.Generator()),
                 lambda: weights.lm_params_from_numpy({}, lm),
                 lambda: weights.lm_params_to({}, "cuda"),
                 lambda: make_eval_step(cfg),
                 lambda: prefetch_to_device(iter(())),
                 lambda: TrainLoop(TrainLoopConfig(), lambda s, b: (s, 0.0), 0, iter(())),
                 lambda: CheckpointManager(tmp_path).restore({}),
                 lambda: make_mesh((1, 1), ("data", "model"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernels_build_inside_the_checkout_or_under_home(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    installed = tmp_path / "lib" / "python3" / "site-packages" / "repro_torch"
    assert build.build_dir(installed) == tmp_path / "home" / ".cache" / "repro_torch" / "torch_kernels"
    stray_src = tmp_path / "src" / "repro_torch"       # a src/ with no project around it
    assert build.build_dir(stray_src).is_relative_to(tmp_path / "home")
