#!/usr/bin/env python3
"""How far chip_smoke.py's phase-23a serving gate sees a wrong row, by the
scale of the snapshot's rows.

    python3 tools/mesh_serve_scale.py [SCALE ...]

from the root of a checkout, on a machine with one CUDA card: builds the
kernels, then for each scale (default 1e-3, the trainer's init scale of
dlrm-small, 4e-3 and 1e-2) runs ``chip_smoke.mesh_serve_rank`` in two
processes sharing the card (gloo), its rows scaled to U(-scale, scale), and
prints per mode (row, table) the largest gap of a served logit to the plain
forward, the moved-rows control's largest distance from the served logits
and how many of them it moves past the gate's 3e-3.  Prints the card's name
and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv: list[str]) -> int:
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.launch.local import run_ranks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.load()
    for scale in [float(a) for a in argv] or [1e-3, 4e-3, 1e-2]:
        ranks = run_ranks(chip_smoke.mesh_serve_rank, 2, ("cuda:0", scale), backend="gloo",
                          timeout_s=600)
        for res in ranks[0]:
            n_off, n = res["control_outside"]
            print(f"scale {scale:g} {res['mode']}: gap {res['gap']:.3e}, control "
                  f"{res['control']:.3e}, {n_off} of {n} past {chip_smoke.LOGIT_TOL}; "
                  f"{res['bitwise']} of {res['batches']} batches bit for bit make_score_step; "
                  f"failures {res['failures']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
