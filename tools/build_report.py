#!/usr/bin/env python3
"""Build every CUDA source of the port and print what ptxas says of each kernel.

    python3 tools/build_report.py

from the root of a checkout, on a machine with ``nvcc``: compiles
``src/repro_torch/csrc/*.cu`` (one ``nvcc`` each, all at once, as the first
kernel launch would) into ``build/torch_kernels/`` and prints, per source,
the seconds ``nvcc`` took and, per kernel, its registers, static shared
memory and spills, then every ptxas warning.  A library already built for
the same sources prints "(already built)": delete ``build/torch_kernels/``
to see the report again.  Exits 1 if a kernel spills.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    from repro_torch.kernels import build
    build.load()
    spills = 0
    for stem, rec in build.build_log.items():
        print(f"{stem}: nvcc {rec['seconds']:.1f} s", flush=True)
        if rec["seconds"] == 0.0:
            print("  (already built)")
        for r in build.ptxas_report(stem):
            if "warning" in r:
                print(f"  {r['warning']}")
                continue
            print(f"  {r['kernel']}: {r.get('registers')} registers, {r.get('smem')} bytes static "
                  f"smem, spill stores {r.get('spill_stores')} and loads {r.get('spill_loads')} "
                  "bytes")
            spills += r.get("spill_stores", 0) + r.get("spill_loads", 0)
    return 1 if spills else 0


if __name__ == "__main__":
    sys.exit(main())
