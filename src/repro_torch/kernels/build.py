"""One lazy build of every CUDA source under ``repro_torch/csrc/``.

Each ``csrc/<name>.cu`` exports plain C launchers (``extern "C"``) and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, bound with
``ctypes``.  No source includes PyTorch's headers, so each compiles in
seconds (``tools/time_torch_build.py`` times this route against
``torch.utils.cpp_extension.load`` of the same sources).  All sources compile
at once, one ``nvcc`` each, at the first launch of any kernel, into
``build/torch_kernels/`` at the root of the checkout, or, for an installed
copy of the package, into ``~/.cache/repro_torch/torch_kernels/``.  A library
is named after the hash of its source, of every header beside it
(``csrc/*.cuh``, which any source may include) and of the flags, so an
unchanged source is not compiled twice and an edited header rebuilds every
library.

TMA tensor maps are encoded on the host by libcuda's
``cuTensorMapEncodeTiled``, which ``csrc/hopper.cuh`` looks up through the
runtime (``cudaGetDriverEntryPointByVersion``), so nothing links ``-lcuda``.

Importing this module needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(package: Path = Path(__file__).resolve().parents[1]) -> Path:
    """``<checkout>/build/torch_kernels`` when ``package`` lies in a
    checkout's ``src/``; else a directory under ``HOME``."""
    if package.parent.name == "src" and (package.parent.parent / "pyproject.toml").exists():
        return package.parent.parent / "build" / "torch_kernels"
    return Path.home() / ".cache" / "repro_torch" / "torch_kernels"


BUILD_DIR = build_dir()
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}
# per source: seconds spent in nvcc (0.0 when the library was already built)
# and what ptxas reported (registers, shared memory, spills)
build_log: dict[str, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def _target(src: Path) -> Path:
    """The library ``src`` builds into: named after the hash of ``src``, of
    the headers in its directory and of the flags."""
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def load() -> dict[str, ctypes.CDLL]:
    """Compile (where needed) and load every source; returns ``{stem: CDLL}``.
    Raises ``RuntimeError`` with the compiler's output if a source fails."""
    with _lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        sources = sorted(CSRC.glob("*.cu"))
        jobs = {}
        for src in sources:
            target = _target(src)
            if target.exists():
                build_log[src.stem] = {"seconds": 0.0, "ptxas": "(already built)"}
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[src] = (tmp, target, time.perf_counter(),
                         subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        failed = []
        for src, (tmp, target, t0, proc) in jobs.items():
            log, _ = proc.communicate()
            build_log[src.stem] = {"seconds": time.perf_counter() - t0, "ptxas": log}
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        _libs.update({src.stem: ctypes.CDLL(str(_target(src))) for src in sources})
        return _libs


def ptxas_report(stem: str) -> list[dict]:
    """What ptxas said of each kernel of ``csrc/<stem>.cu`` when this
    process compiled it: ``{"kernel", "registers", "smem", "spill_stores",
    "spill_loads"}`` a kernel (``kernel`` the mangled name's identifier and
    template arguments, as ``flash_attention_kernel<128>``), plus every
    ptxas warning and numbered note (such as C7514, wgmma serialized) as
    ``{"warning": line}``.  Empty when the library was already built."""
    out: list[dict] = []
    for line in build_log.get(stem, {}).get("ptxas", "").splitlines():
        if m := re.search(r"Compiling entry function '_Z\w*?([a-z][a-z_]*_kernel)(\w*)'", line):
            args = re.findall(r"L[ib](\d+)E", m.group(2))
            out.append({"kernel": m.group(1) + (f"<{', '.join(args)}>" if args else "")})
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            if out and "kernel" in out[-1]:
                out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif m := re.search(r"Used (\d+) registers", line):
            if out and "kernel" in out[-1]:
                smem = re.search(r"(\d+) bytes smem", line)
                out[-1].update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
        elif "warning" in line.lower() or re.search(r"\(C\d{4}\)", line):
            out.append({"warning": line.strip()})
    return out


def function(stem: str, name: str, argtypes: list, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<stem>.cu`` with its argument and
    result types declared; every launcher returns the CUDA error of its
    launch as int."""
    key = f"{stem}.{name}"
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(load()[stem], name)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[key] = fn
    return fn
