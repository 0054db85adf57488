#!/usr/bin/env python3
"""Time two ways of building the port's CUDA kernels, each from nothing.

    python3 tools/time_torch_build.py [--limit SECONDS]

from the root of a checkout, on a machine with ``nvcc`` and a CUDA build of
PyTorch:

1. ``ctypes``: ``repro_torch.kernels.build.load()``, one ``nvcc`` per
   ``src/repro_torch/csrc/*.cu``, all in parallel, into a shared library each
   (the route the port takes);
2. ``cpp_extension``: ``torch.utils.cpp_extension.load`` of the same sources
   plus one small binding file that includes ``torch/extension.h``, with
   ``-O3 -gencode=arch=compute_90a,code=sm_90a`` (``ninja`` compiles the
   files in parallel).

Each builds into a fresh directory under ``build/time_torch_build/``; the
second runs in a child process, cut at ``--limit`` seconds; a cut or failed
build prints why and reports ``null``.  The last line is
``{"ctypes_s": t, "cpp_extension_s": t or null, "device": "...", "nvidia_smi": "..."}``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "time_torch_build"
BINDING = """#include <torch/extension.h>
int64_t n_sources() { return %d; }
PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("n_sources", &n_sources); }
"""


def time_ctypes() -> float:
    from repro_torch.kernels import build
    build.BUILD_DIR = OUT / f"ctypes_{os.getpid()}"
    t0 = time.perf_counter()
    build.load()
    return time.perf_counter() - t0


def time_cpp_extension(build_dir: Path) -> float:
    from torch.utils.cpp_extension import load
    from repro_torch.kernels.build import CSRC
    sources = sorted(CSRC.glob("*.cu"))
    build_dir.mkdir(parents=True)
    binding = build_dir / "binding.cpp"
    binding.write_text(BINDING % len(sources))
    t0 = time.perf_counter()
    ext = load(name="repro_torch_timing", sources=[str(binding), *map(str, sources)],
               build_directory=str(build_dir), verbose=False,
               extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"])
    seconds = time.perf_counter() - t0
    assert ext.n_sources() == len(sources)
    return seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--limit", type=float, default=900.0,
                    help="seconds after which the cpp_extension build is cut")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps({"cpp_extension_s": time_cpp_extension(args.child)}), flush=True)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("time_torch_build: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ctypes_s = time_ctypes()
    print(f"ctypes route: {ctypes_s:.1f} s", flush=True)
    child = [sys.executable, __file__, "--child", str(OUT / f"cpp_extension_{os.getpid()}")]
    # its own process group, so that a cut also stops ninja's compilers
    proc = subprocess.Popen(child, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    cpp_s = None
    try:
        out, err = proc.communicate(timeout=args.limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        print(f"cpp_extension route: not done after {args.limit:.0f} s", flush=True)
    else:
        if proc.returncode != 0:
            print(f"cpp_extension route failed:\n{out[-4000:]}\n{err[-8000:]}", flush=True)
        else:
            cpp_s = json.loads(out.strip().splitlines()[-1])["cpp_extension_s"]
            print(f"cpp_extension route: {cpp_s:.1f} s", flush=True)
    print(json.dumps({"ctypes_s": ctypes_s, "cpp_extension_s": cpp_s,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
