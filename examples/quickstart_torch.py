"""Quickstart of the PyTorch port: DLRM training end to end on one CUDA card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py`` with the same model, data and loop:
Split-SGD-BF16 for the sparse and the dense parameters, 60 steps with a
verified checkpoint every 20, a second loop that restores the newest one and
continues to step 80, then the eval step scores a batch.  The kernels are
built from ``src/repro_torch/csrc`` at their first launch.  ``--device cpu``
runs the kernels' plain PyTorch versions instead.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import dlrm as D
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainLoop, TrainLoopConfig


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    mesh = make_mesh((1, 1), ("data", "model"), device=args.device)
    dev = mesh.device
    print(f"device={dev}, mesh={mesh.shape}")

    cfg = D.DLRMConfig(
        name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
        table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100),
        emb_dim=32, pooling=8, batch=512, lr=0.05)
    state = D.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = D.make_train_step(cfg, device=dev)
    stream = ({k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for b in dlrm_stream(0, cfg, alpha=0.6))

    with tempfile.TemporaryDirectory() as ckdir:
        loop = TrainLoop(TrainLoopConfig(steps=60, ckpt_dir=ckdir, ckpt_every=20, log_every=20),
                         step, state, stream, device=dev)
        state = loop.run()
        print(f"loss: {loop.losses[0]:.4f} -> {loop.losses[-1]:.4f}")

        # simulate a restart: a fresh loop restores from the checkpoint
        loop2 = TrainLoop(TrainLoopConfig(steps=80, ckpt_dir=ckdir, ckpt_every=20, log_every=20),
                          step, state, stream, device=dev)
        assert loop2.start_step >= 60, loop2.start_step
        state = loop2.run()
        print(f"restored at step {loop2.start_step}, continued to 80 OK")

    ev = D.make_eval_step(cfg, device=dev)
    scores = ev(state, next(stream))
    print(f"eval scores: shape {tuple(scores.shape)}, mean {float(scores.mean()):.4f}")


if __name__ == "__main__":
    main()
