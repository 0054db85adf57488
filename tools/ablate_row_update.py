#!/usr/bin/env python3
"""Where the row-update kernel's time goes: time ablated copies of
``src/repro_torch/csrc/embedding_update.cu`` on one CUDA card.

    python3 tools/ablate_row_update.py

from the root of a checkout.  Each copy changes one thing in the run walk,
by text substitution in the source (the script fails if the source no
longer has the text it replaces), and is built with its own ``nvcc`` into
``build/ablate_row_update/``:

- ``as is``: the kernel unchanged (checked bit for bit against the port's
  kernel);
- ``per-row path only``: every segment summed a position at a time, none
  group by group (bitwise too: the same adds with the same operands);
- ``no dY loads``: the cotangent row loads replaced by a constant;
- ``no adds``: the fp32 add chain replaced by an xor of the bits.

All on dlrm-small's split store (8,000,000 x 64), its first zipf(1.05) batch
and a uniform one, with a bf16 cotangent [B * S, 64]; CUDA events over 10
launches after 2.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LOADS = ("dY + static_cast<int64_t>(bag) * E + c))", "dY + static_cast<int64_t>(bg[u]) * E + c))")
ADDS = ("""        a0 = __fadd_rn(a0, g0);
        a1 = __fadd_rn(a1, g1);""",
        """    a0 = __fadd_rn(a0, __fmul_rn(__uint_as_float(v[u] << 16), w[u]));
    a1 = __fadd_rn(a1, __fmul_rn(__uint_as_float(v[u] & 0xffff0000u), w[u]));""")
VARIANTS = {
    "as is": [],
    "per-row path only": [("constexpr int kFew = 4;", "constexpr int kFew = -1;")],
    "no dY loads": [(f"__ldg(reinterpret_cast<const unsigned int*>({x}",
                     f"(0x3c003c00u + static_cast<uint32_t>({b}))")
                    for x, b in zip(LOADS, ("bag", "bg[u]"))],
    "no adds": [(ADDS[0], """        a0 = __uint_as_float(__float_as_uint(a0) ^ __float_as_uint(g0));
        a1 = __uint_as_float(__float_as_uint(a1) ^ __float_as_uint(g1));"""),
                (ADDS[1], """    a0 = __uint_as_float(__float_as_uint(a0) ^ v[u] ^ __float_as_uint(w[u]));
    a1 = __uint_as_float(__float_as_uint(a1) ^ (v[u] << 3));""")],
}


def build(out_dir: Path) -> dict:
    from repro_torch.kernels import build as kbuild
    src = (ROOT / "src" / "repro_torch" / "csrc" / "embedding_update.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libv{i}.so"
        procs[name] = (so, subprocess.Popen([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).embedding_update_split
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_row_update: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    fns = build(ROOT / "build" / "ablate_row_update")
    cfg = dlrm_small()
    dev = torch.device("cuda", 0)
    state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32,
                              device=dev)
    rng = np.random.default_rng(1)
    uniform = np.stack([rng.integers(0, m, (cfg.batch, cfg.pooling)) for m in cfg.table_rows],
                       axis=1).astype(np.int32)
    dY = (torch.randn((cfg.batch * len(cfg.table_rows), cfg.emb_dim), device=dev) * 1e-3
          ).to(torch.bfloat16)
    rows = state["emb"]["hi"].shape[0]
    for tag, idx in (("zipf", next(dlrm_stream(0, cfg, 1.05))["idx"]), ("uniform", uniform)):
        g = (torch.from_numpy(idx).to(dev) + offsets[None, :, None]).reshape(-1)
        stream = eu.sort_lookups(g, None, rows, cfg.pooling)
        want = [t.clone() for t in (state["emb"]["hi"], state["emb"]["lo"])]
        ops.fused_update_split(*want, *stream, dY, 0.1)
        for name, fn in fns.items():
            hi, lo = state["emb"]["hi"].clone(), state["emb"]["lo"].clone()

            def call():
                err = fn(*(t.data_ptr() for t in stream), dY.data_ptr(), hi.data_ptr(),
                         lo.data_ptr(), stream[0].numel(), cfg.emb_dim, 0.1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            same = torch.equal(hi.view(torch.int16), want[0].view(torch.int16)) \
                and torch.equal(lo, want[1])
            if name == "as is" and not same:
                raise SystemExit("the unchanged copy disagrees with the port's kernel")
            for _ in range(2):
                call()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            print(f"{tag}, {name}: {start.elapsed_time(end) / 10:.4f} ms, bitwise equal to the "
                  f"port's kernel: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
