#!/usr/bin/env python3
"""Where rank 0's dense shard parts from the plain step in ``chip_smoke.py``'s
phase 34b, for one dry-run cell: the card's step (the kernels) and the same
step with the plain versions on the card, as phase 34b runs them, then the
gaps between the two dense shards after the update, apart for the values
that start at zero (the biases: their whole value is the update) and the
rest.

    python3 tools/dryrun_dense_gap.py [--arch dlrm-large] [--shape train_tablewise]

from the root of a checkout, on one CUDA card.  Prints one JSON object: the
largest update, and for each group its size, how many of its gaps pass 1e-2
of the largest update (phase 6's rule) and one fp32 ulp of the weight beyond
it (phase 21's), its largest gap over the largest update, and its largest
gap over the value's own update.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def gaps(got, want, before, upd: float, tol: float, ulp_rel: float) -> dict:
    import torch
    gap = (got - want).abs()
    own = (want - before).abs()
    return {"values": int(got.numel()),
            "beyond_1e-2": int((gap > tol * upd).sum()),
            "beyond_1e-2_and_one_ulp": int((gap > tol * upd + ulp_rel * want.abs()).sum()),
            "gap_max_over_largest_update": float(gap.max() / upd) if got.numel() else 0.0,
            "gap_max_over_own_update": float(torch.where(own > 0, gap / own, 0.0).max())
            if got.numel() else 0.0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="dlrm-large")
    ap.add_argument("--shape", default="train_tablewise")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load()
    seen = []
    shard_master = cs.dense_master

    def record(*a, **k):  # phase 34b reads the shard before, after the card's step, after the plain
        out = shard_master(*a, **k)
        seen.append(out.detach().float().clone())
        return out
    cs.dense_master = record
    failures: list = []
    cs.dryrun_held(args.arch, args.shape, False, torch.device("cuda", 0), failures)
    before, got, want = seen[:3]
    upd = float((want - before).abs().max())
    zero = before == 0
    tol = cs.TRAIN_TOL["update"]
    out = {"arch": args.arch, "shape": args.shape, "largest_update": upd,
           "card": cs.nvidia_smi(), "failures": failures,
           "zero_at_start": gaps(got[zero], want[zero], before[zero], upd, tol,
                                 cs.RECSYS_DENSE_ULP),
           "the_rest": gaps(got[~zero], want[~zero], before[~zero], upd, tol,
                            cs.RECSYS_DENSE_ULP)}
    print(json.dumps(out))
    cs.stop_children()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
