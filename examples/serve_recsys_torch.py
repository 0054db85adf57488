"""Serving on the PyTorch port: DIN online scoring with a batching server
(serve_p99) and a retrieval pass (retrieval_cand) with a distributed top-k
merge.

    PYTHONPATH=src python examples/serve_recsys_torch.py [--ranks N] [--device cpu]

The twin of ``examples/serve_recsys.py``: DIN with a 50,000-item table and
four context tables of 1,000 rows, its requests drawn at zipf skew 0.7; a
synchronous ``BatchingServer`` of 64-request batches scores 400 requests,
draining at random points; then one query is scored against 4,096
candidates in the history's target slot (100) and the top 16 merged over
the ranks, which must be 16 distinct candidates.  ``--ranks N`` runs N
ranks, one process each, on the reference's mesh ``(max(1, N // 4), min(4,
N))`` over ``("data", "model")``: each rank holds its shard of the tables
and scores its block of every batch, rank 0 serves and the others follow
its batches (``serve.snapshot.follow``).  Ranks talk over NCCL with a card
each, or over gloo on the CPU or when they share a card.  ``--device cpu``
runs the kernels' plain PyTorch versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import hybrid as H
from repro_torch.data.synthetic import hybrid_stream
from repro_torch.launch.local import backend_for, rank_device, run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import recsys as R
from repro_torch.serve import BatchingServer, follow, make_bucket_scorers, release, snapshot_state

BATCH = 64
REQUESTS = 400
N_CAND = 4096
TOPK = 16
TARGET_SLOT = 100


def serve(rank: int, ranks: int, device: str) -> dict:
    """One rank's run: returns the server's percentiles (rank 0) or the
    batches it followed, and the retrieval's top-k."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh((max(1, ranks // 4), min(4, ranks)), ("data", "model"), device=dev)
    mdef = R.make_din(50_000, (1000,) * 4, batch=BATCH)
    state = H.init_state(mdef, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    snap = snapshot_state(mdef, state)
    fns, pad = make_bucket_scorers(mdef, (BATCH,), lambda: snap, mesh=mesh, device=dev)
    out = {}
    if rank == 0:
        server = BatchingServer(fns[BATCH], BATCH, lambda reqs: pad(reqs, BATCH))
        rng = np.random.default_rng(1)
        template = next(hybrid_stream(0, mdef, alpha=0.7))
        chunks = []
        try:
            for _ in range(REQUESTS):
                i = rng.integers(0, BATCH)
                server.submit({"idx": template["idx"][i], "hist_mask": template["hist_mask"][i]})
                if rng.random() < 0.3:
                    chunks += [len(reqs) for reqs, _ in server.drain()]
            chunks += [len(reqs) for reqs, _ in server.drain()]
        finally:
            release(mesh)
        out.update(scored=sum(chunks), batches=len(chunks), percentiles=server.percentiles())
        print("online scoring latency:", out["percentiles"])
    else:
        out["followed"] = follow(fns, mesh)

    # ---- retrieval: one query against the sharded candidates, a global top-k
    retr = H.make_retrieval_step(mdef, mesh, N_CAND, target_slot=TARGET_SLOT, topk=TOPK)
    query = {k: torch.from_numpy(v[:1]).to(dev)
             for k, v in next(hybrid_stream(2, mdef, alpha=0.7)).items()}
    per = N_CAND // mesh.size
    cand = np.random.default_rng(2).standard_normal((N_CAND, mdef.spec.dim)).astype(np.float32)
    block = torch.from_numpy(cand[mesh.rank * per:(mesh.rank + 1) * per]).to(dev, torch.bfloat16)
    vals, ids = retr(state, query, block)
    out.update(ids=ids.cpu().numpy(), vals=vals.cpu().numpy())
    if rank == 0:
        print(f"retrieval top-{TOPK} of {N_CAND} candidates: "
              f"ids {out['ids'][:5]}... scores {out['vals'][:3]}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.ranks == 1:
        out = serve(0, 1, args.device)
    else:
        if torch.device(args.device).type == "cuda":
            from repro_torch.kernels import build
            build.load()  # once here, so that the ranks find the libraries built
        outs = run_ranks(serve, args.ranks, (args.device,),
                         backend=backend_for(args.device, args.ranks), timeout_s=900)
        out = outs[0]
        for o in outs[1:]:  # every rank scored every batch and merged the same top-k
            assert o["followed"] == out["batches"]
            np.testing.assert_array_equal(o["ids"], out["ids"])
    assert out["scored"] == REQUESTS
    assert len(set(out["ids"].tolist())) == TOPK
    return out


if __name__ == "__main__":
    main()
