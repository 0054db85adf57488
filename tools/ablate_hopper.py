#!/usr/bin/env python3
"""What the Hopper kernels' design choices cost: time altered copies of
``src/repro_torch/csrc/flash_attention.cu`` and ``fused_mlp.cu`` on one CUDA
card.

    python3 tools/ablate_hopper.py [--only flash|mlp]

from the root of a checkout.  Each copy changes one thing, by text
substitution in the source (the script fails if the source no longer has the
text it replaces), and is built with its own ``nvcc`` into
``build/ablate_hopper/``.  The copies named ``as is`` are the kernels
unchanged (checked bit for bit against the port's kernel).

Flash attention, at chip_smoke.py's attention cases for internlm2-1.8b's
prefill and gemma2's global and local layers (D 128), each copy held to the
plain version under chip_smoke.py's gates (rtol = atol = 2^-7, at most 2 %
of outputs unequal and 0.25 % past one bf16 ulp):

- ``tanh.approx``: the soft-cap's accurate ``tanhf`` replaced by the
  hardware's ``tanh.approx.f32``;
- ``tanh from ex2``: ``tanhf`` replaced by an odd series below |y| = 0.25
  and ``(1 - e^-2|y|) / (1 + e^-2|y|)`` from ``ex2.approx`` above;
- ``3 stages``: three K and V tiles in flight instead of two;
- ``no turns``: the two consumer warpgroups issue their products without
  the named barriers that make them take turns.

fused_mlp's wgmma route, at dlrm-small's six layers that take it, at M =
8192 and 128 (tolerances of chip_smoke.py):

- ``tile 128``: every output tile 128 x 128;
- ``tile 256``: 128 x 256 wherever N >= 256, whatever the grid;
- ``2 stages``: two K slices in flight instead of four.

Times are CUDA events over 10 launches after 2.  Prints the card's name and
power limit first; a copy that fails a gate says so and is still timed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "csrc"
TANH = "if constexpr (kCapped) x = cap_out * tanhf(x * cap_in);"
TILE = "return N >= 256 && tiles256 >= 96 ? 256 : 128;"
VARIANTS = {
    "flash_attention": {
        "as is": [],
        "tanh.approx": [(TANH, """if constexpr (kCapped) {
          float t;
          asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x * cap_in));
          x = cap_out * t;
        }""")],
        "tanh from ex2": [(TANH, """if constexpr (kCapped) {
          // odd series below |y| = 0.25, else (1 - e^-2|y|) / (1 + e^-2|y|)
          const float y = x * cap_in;
          const float a = fabsf(y);
          const float y2 = y * y;
          const float series = y * fmaf(y2, fmaf(y2, fmaf(y2, fmaf(y2, 0.02186948853f,
              -0.05396825397f), 0.1333333333f), -0.3333333333f), 1.f);
          const float e = exp2_fast(-2.885390081777927f * a);
          const float t = a < 0.25f ? series : copysignf(__fdividef(1.f - e, 1.f + e), y);
          x = cap_out * t;
        }""")],
        "3 stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
        "no turns": [("bar_sync(me, kConsumerThreads);", ""),
                     ("bar_arrive(kBarTurn, kConsumerThreads);", ";"),
                     ("bar_arrive(other, kConsumerThreads);", ";")],
    },
    "fused_mlp": {
        "as is": [],
        "tile 128": [(TILE, "return tiles256 > 0 ? 128 : 128;")],
        "tile 256": [(TILE, "return N >= 256 && tiles256 > 0 ? 256 : 128;")],
        "2 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    },
}
FLASH_CASES = ("internlm2 prefill", "gemma2 global layer", "gemma2 local layer")


def build(stem: str, launcher: str, argtypes: list, out_dir: Path) -> dict:
    from repro_torch.kernels import build as kbuild
    src = (CSRC / f"{stem}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS[stem].items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{stem}, {name}: the source no longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{stem}_v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{stem}_v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, f"-I{CSRC}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{stem}, {name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), launcher)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(name, fn, want, port, gates, time_ms):
    """One copy: launch (``fn`` fills ``port``'s twin), check, time."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    if name == "as is" and not torch.equal(out, port):
        raise SystemExit("the unchanged copy disagrees with the port's kernel")
    ok, note = gates(out, want)
    ms = time_ms(fn, iters=10, warmup=2)
    return ms, ok, note


def flash(cs, dev, out_dir):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import _ARGS
    fns = build("flash_attention", "flash_attention_fwd", _ARGS, out_dir)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for case, B, H, Hkv, Lq, Lk, causal, window, softcap in cs.ATTN_CASES:
        if case not in FLASH_CASES:
            continue
        D = 128
        q = torch.randn((B, H, Lq, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, Hkv, Lk, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        want = ref.flash_attention(q, k, v, **kw)
        port = ops.flash_attention(q, k, v, **kw)
        pairs = B * H * cs.visible_pairs(Lq, Lk, causal, window)
        bms, by = cs.bound_ms(2 * (2 * B * H * Lq * D + 2 * B * Hkv * Lk * D), 4.0 * pairs * D,
                              cs.BF16_TENSOR_FLOPS)
        print(f"{case}: q [{B},{H},{Lq},{D}], k/v [{B},{Hkv},{Lk},{D}], softcap {softcap:g}, "
              f"window {window}; bound {bms:.4f} ms ({by})", flush=True)

        def gates(out, want):
            failures: list[str] = []
            err = cs.close_or_fail("    against the plain version", out, want, *cs.ATTN_TOL,
                                   failures)
            unequal = float((out != want).float().mean())
            past = float((cs.bf16_ulps(out, want) > 1).float().mean())
            ok = not failures and unequal <= cs.ATTN_MAX_UNEQUAL and past <= cs.ATTN_MAX_PAST_ULP
            return ok, (f"max_abs_err {err:.3e}, {unequal * 100:.4f}% unequal, "
                        f"{past * 100:.4f}% past one ulp")

        for name, fn in fns.items():
            out = torch.empty_like(q)

            def call(fn=fn, out=out, name=name):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Lq,
                         Lk, D, D ** -0.5, int(causal), softcap, window,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
                return out

            ms, ok, note = run(name, call, want, port, gates, cs.time_ms)
            print(f"  {name}: {ms:.4f} ms ({bms / ms * 100:.1f}% of bound); {note}: "
                  f"{'passes' if ok else 'FAILS'} chip_smoke's gates", flush=True)


def mlp(cs, dev, out_dir):
    import torch
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.kernels import fused_mlp, ops, ref
    fns = build("fused_mlp", "fused_mlp_wgmma_fwd", fused_mlp._ARGS, out_dir)
    cfg = dlrm_small()
    layers = [(k, n) for sizes in (cfg.bottom_sizes, cfg.top_sizes)
              for k, n in zip(sizes, sizes[1:]) if fused_mlp.route(cfg.batch, k, n) == "wgmma"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for M in (cfg.batch, 128):
        totals = dict.fromkeys(fns, 0.0)
        for K, N in layers:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
            b = torch.randn((N,), generator=gen, device=dev).to(torch.bfloat16)
            out_dtype = torch.float32 if N == 64 else torch.bfloat16
            tol = cs.KERNEL_TOL["fused_mlp"] if N == 64 else cs.FUSED_MLP_BF16_TOL
            want = ref.fused_mlp_layer(x, w, b, "relu", out_dtype)
            port = ops.fused_mlp_layer(x, w, b, "relu", out_dtype)
            nbytes = (M * K + K * N + N) * 2 + M * N * port.element_size()
            bms, by = cs.bound_ms(nbytes, 2.0 * M * K * N, cs.BF16_TENSOR_FLOPS)
            print(f"[{M}x{K}]@[{K}x{N}]: bound {bms:.4f} ms ({by})", flush=True)

            def gates(out, want):
                failures: list[str] = []
                err = cs.close_or_fail("    against the plain version", out, want, *tol,
                                       failures)
                return not failures, f"max_abs_err {err:.3e}"

            for name, fn in fns.items():
                out = torch.empty_like(port)

                def call(fn=fn, out=out, name=name):
                    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                             1, int(out_dtype == torch.bfloat16), 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")
                    return out

                ms, ok, note = run(name, call, want, port, gates, cs.time_ms)
                totals[name] += ms
                print(f"  {name}: {ms:.4f} ms ({bms / ms * 100:.1f}% of bound); {note}: "
                      f"{'passes' if ok else 'FAILS'}", flush=True)
        print(f"M = {M}, the {len(layers)} layers: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in totals.items()), flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("flash", "mlp"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_hopper: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "ablate_hopper"
    if args.only != "mlp":
        flash(cs, dev, out_dir)
    if args.only != "flash":
        mlp(cs, dev, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
