"""Quickstart of the PyTorch port: hybrid-parallel DLRM training end to end.

    PYTHONPATH=src python examples/quickstart_torch.py [--ranks N] [--device cpu]

The twin of ``examples/quickstart.py`` with the same model, data and loop:
Split-SGD-BF16 for the sparse and the dense parameters, 60 steps with a
verified checkpoint every 20, a second loop that restores the newest one and
continues to step 80, then the eval step scores a batch.  ``--ranks N`` runs
N ranks, one process each, on the reference's mesh ``(max(1, N // 4),
min(4, N))`` over ``("data", "model")``; every rank reads the same global
stream and trains its shard, and rank 0 writes the gathered checkpoints.
Ranks talk over NCCL with a card each, or over gloo on the CPU or when they
share a card (their payloads then cross through pinned host memory).  The
kernels are built from ``src/repro_torch/csrc`` once, before the ranks
start.  ``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import dlrm as D
from repro_torch.core import hybrid
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.launch.local import backend_for, rank_device, run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainLoop, TrainLoopConfig

CFG = D.DLRMConfig(
    name="quickstart", num_dense=64, bottom=(128, 32), top=(128, 64),
    table_rows=(40_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100),
    emb_dim=32, pooling=8, batch=512, lr=0.05)


def quickstart(rank: int, ranks: int, device: str, ckdir: str) -> dict:
    """One rank's run of the quickstart."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh((max(1, ranks // 4), min(4, ranks)), ("data", "model"), device=dev)
    if rank == 0:
        print(f"ranks={ranks}, device={dev}, mesh={mesh.shape}")
    state = D.init_state(CFG, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    step = D.make_train_step(CFG, mesh)
    stream = dlrm_stream(0, CFG, alpha=0.6)  # global batches: the loop cuts each rank's block

    def loop_cfg(steps):
        return TrainLoopConfig(steps=steps, ckpt_dir=ckdir, ckpt_every=20, log_every=20)

    loop = TrainLoop(loop_cfg(60), step, state, stream, mesh=mesh, model_cfg=CFG)
    state = loop.run()
    # simulate a restart: a fresh loop restores from the checkpoint
    loop2 = TrainLoop(loop_cfg(80), step, state, stream, mesh=mesh, model_cfg=CFG)
    assert loop2.start_step >= 60, loop2.start_step
    state = loop2.run()

    ev = D.make_eval_step(CFG, mesh)
    batch = {k: torch.from_numpy(v) for k, v in next(stream).items()}
    scores = ev(state, {k: v.to(dev) for k, v in hybrid.local_batch(CFG, mesh, batch).items()})
    return {"losses": loop.losses, "start_step": loop2.start_step,
            "scores": scores.cpu().numpy()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1, help="processes, one a rank (default 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.device != "cpu":
        from repro_torch import resolve_device
        from repro_torch.kernels import build
        resolve_device(args.device)  # raises where there is no card
        build.load()  # once here, so that the ranks find the libraries built
    with tempfile.TemporaryDirectory() as ckdir:
        if args.ranks == 1:
            out = [quickstart(0, 1, args.device, ckdir)]
        else:
            out = run_ranks(quickstart, args.ranks, (args.device, ckdir),
                            backend=backend_for(args.device, args.ranks), timeout_s=900)
    losses = out[0]["losses"]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"restored at step {out[0]['start_step']}, continued to 80 OK")
    scores = torch.cat([torch.from_numpy(r["scores"]) for r in out])
    print(f"eval scores: shape {tuple(scores.shape)}, mean {float(scores.mean()):.4f}")


if __name__ == "__main__":
    main()
