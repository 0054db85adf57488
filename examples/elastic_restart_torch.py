"""Elastic restart of the PyTorch port: train on one mesh, lose ranks,
restore the SAME logical state onto a smaller mesh and keep training.

    PYTHONPATH=src python examples/elastic_restart_torch.py [--device cpu]

The twin of ``examples/elastic_restart.py``: the elastic configuration
trains 10 steps on a (2, 4) mesh of 8 ranks, which gather the global arrays
and rank 0 saves them; then 4 ranks on a (1, 4) mesh restore those arrays,
lay them out for 4 shards (``weights.reshard_global``: the embedding store
by ``checkpoint.reshard_store``, every slab alike, and the dense ``lo`` by
``checkpoint.reshard_dense``), take their shards and train 10 more steps on
the same stream.  Each mesh is one ``launch.local.run_ranks`` call of a
process a rank; ``--device cpu`` runs on the CPU with the kernels' plain
versions.
"""

import argparse
import itertools
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import dlrm as D
from repro_torch.core import hybrid
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.launch.local import backend_for, rank_device, run_ranks
from repro_torch.launch.mesh import Mesh, make_mesh

CFG = D.DLRMConfig(name="elastic", num_dense=32, bottom=(64, 16), top=(64,),
                   table_rows=(5000, 3000, 1000, 500), emb_dim=16, pooling=4, batch=64, lr=0.05)
BIG, SMALL = (2, 4), (1, 4)  # a healthy cluster; after losing a host
AXES = ("data", "model")
STEPS = 10


def train(mesh, state, batches) -> float:
    step = D.make_train_step(CFG, mesh)
    for b in batches:
        batch = hybrid.local_batch(CFG, mesh, {k: torch.from_numpy(v) for k, v in b.items()})
        state, loss = step(state, {k: v.to(mesh.device) for k, v in batch.items()})
    return float(loss)


def big(rank: int, ranks: int, device: str, ckdir: str) -> float:
    dev = rank_device(device, rank)
    mesh = make_mesh(BIG, AXES, dev)
    state = D.init_state(CFG, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    loss = train(mesh, state, itertools.islice(dlrm_stream(0, CFG), STEPS))
    glob = weights.state_to_global(state, mesh, CFG)  # every rank: a collective
    if rank == 0:
        CheckpointManager(ckdir).save(STEPS, glob, blocking=True)
    return loss


def small(rank: int, ranks: int, device: str, ckdir: str) -> float:
    dev = rank_device(device, rank)
    mesh = make_mesh(SMALL, AXES, dev)
    old = Mesh(shape=dict(zip(AXES, BIG)), device=torch.device("cpu"))  # its shape alone
    _, glob = CheckpointManager(ckdir).restore(weights.global_like(CFG, old), device="cpu")
    state = weights.state_from_global(weights.reshard_global(glob, CFG, old, mesh), CFG, mesh)
    # the same stream, past the batches the (2, 4) mesh trained on
    return train(mesh, state, itertools.islice(dlrm_stream(0, CFG), STEPS, 2 * STEPS))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.device != "cpu":
        from repro_torch import resolve_device
        from repro_torch.kernels import build
        resolve_device(args.device)  # raises where there is no card
        build.load()  # once here, so that the ranks find the libraries built
    n_big, n_small = int(np.prod(BIG)), int(np.prod(SMALL))
    with tempfile.TemporaryDirectory() as ckdir:
        loss = run_ranks(big, n_big, (args.device, ckdir),
                         backend=backend_for(args.device, n_big), timeout_s=600)[0]
        print(f"big mesh ({n_big} ranks): {STEPS} steps, loss {loss:.4f}")
        # ---- "failure": rebuild everything on the 4-rank mesh ----------------
        loss2 = run_ranks(small, n_small, (args.device, ckdir),
                          backend=backend_for(args.device, n_small), timeout_s=600)[0]
    print(f"small mesh ({n_small} ranks): resumed, {STEPS} more steps, loss {loss2:.4f}")
    assert np.isfinite(loss2)
    print("elastic restart OK: same logical state, half the ranks")


if __name__ == "__main__":
    main()
