"""End-to-end script of the PyTorch port: train a ~103M-parameter DLRM for a
few hundred steps on one card (the twin of ``examples/train_dlrm_100m.py``).

    PYTHONPATH=src python examples/train_dlrm_100m_torch.py [--steps 300] [--device cpu]

Uses the skewed (zipf) index stream, the regime where the race-free
ownership update matters, and row-wise Adagrad for the sparse update by
default.

With ``--data-dir DIR`` the same stream is PACKED into shard files on first
run and training streams from disk through the whole ingestion chain: mmap
reader -> threaded ``HostPipeline`` -> ``prefetch_to_device``.
``--host-presort`` also moves the sparse update's index sort onto the
loader thread.  ``--device cpu`` runs the kernels' plain PyTorch versions;
without it the script raises where there is no card.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dlrm as D
from repro_torch.core import hybrid
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainLoop, TrainLoopConfig


def packed_stream(cfg, data_dir, steps, host_presort, layout):
    """Pack (first run) + stream the packed dataset."""
    from repro_torch.data.format import DatasetSpec, write_shards
    from repro_torch.data.pipeline import HostPipeline
    from repro_torch.data.reader import ShardedReader
    if not os.path.exists(os.path.join(data_dir, "dataset.json")):
        n = max(steps * cfg.batch // 4, cfg.batch)   # ~4 epochs of reuse
        print(f"packing {n} synthetic samples into {data_dir} ...")
        spec = DatasetSpec(table_rows=cfg.table_rows, pooling=cfg.pooling,
                           num_dense=cfg.num_dense)
        write_shards(dlrm_stream(0, cfg, alpha=0.8), data_dir, spec, n,
                     samples_per_shard=8192)
    reader = ShardedReader(data_dir, batch=cfg.batch, seed=0, shuffle=True)
    reader.spec.check(cfg.table_rows, cfg.pooling, num_dense=cfg.num_dense)
    return HostPipeline(reader, layout=layout, presort=host_presort)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--data-dir", default=None,
                    help="train from packed shards (packed on first run)")
    ap.add_argument("--host-presort", action="store_true",
                    help="pre-sort the update index stream on the loader "
                         "thread (requires --data-dir)")
    ap.add_argument("--optimizer", default="adagrad_rowwise",
                    help="sparse row optimizer for the embedding path; the "
                         "production DLRM default is row-wise Adagrad: "
                         "O(rows) optimizer state")
    ap.add_argument("--eps", type=float, default=None,
                    help="adagrad denominator floor override")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.host_presort and not args.data_dir:
        ap.error("--host-presort requires --data-dir")

    dev = resolve_device(args.device)  # raises where there is no card
    cfg = D.DLRMConfig(
        name="dlrm-100m", num_dense=64, bottom=(128, 64), top=(256, 128),
        table_rows=(200_000,) * 8, emb_dim=64, pooling=20, batch=256,
        lr=0.03, sparse_optimizer=args.optimizer, opt_eps=args.eps,
        host_presort=args.host_presort)
    print(f"sparse optimizer: {args.optimizer}")
    emb_params = cfg.spec.total_rows * cfg.emb_dim
    dense_params = sum(a * b for a, b in zip(cfg.bottom_sizes[:-1],
                                             cfg.bottom_sizes[1:]))
    dense_params += sum(a * b for a, b in zip(cfg.top_sizes[:-1],
                                              cfg.top_sizes[1:]))
    print(f"~{(emb_params + dense_params)/1e6:.1f}M params "
          f"({emb_params/1e6:.1f}M embedding) on {dev}")

    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    state = D.init_state(cfg, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    step = D.make_train_step(cfg, mesh)
    if args.data_dir:
        layout = hybrid.make_layout(cfg, mesh)
        stream = packed_stream(cfg, args.data_dir, args.steps,
                               args.host_presort, layout)
    else:
        stream = dlrm_stream(0, cfg, alpha=0.8)
    loop = TrainLoop(TrainLoopConfig(steps=args.steps, log_every=25, prefetch=2),
                     step, state, stream, device=dev)
    try:
        loop.run()
    finally:
        if hasattr(stream, "close"):
            stream.close()        # release the HostPipeline worker
    first = np.mean(loop.losses[:10])
    last = np.mean(loop.losses[-10:])
    print(f"mean loss first-10 {first:.4f} -> last-10 {last:.4f}")
    assert last < first, "training should reduce loss"


if __name__ == "__main__":
    main()
