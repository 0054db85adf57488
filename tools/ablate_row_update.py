#!/usr/bin/env python3
"""Where the row-update kernel's time goes: time ablated copies of
``src/repro_torch/csrc/embedding_update.cuh`` (the kernel; its launchers are
``embedding_update*.cu``) on one CUDA card, and the kernel against an
earlier version of it in the same run.

    python3 tools/ablate_row_update.py [--parent DIR] [--only ablation|parent|narrow]

from the root of a checkout.  ``DIR`` is an unpacked earlier checkout (for
example ``git archive <commit> | tar -x -C build/parent``) whose row-update
source has the launchers of before the long-run schedule (no cotangent type
flag, no long runs' list).

The ablation changes one thing of the run walk a copy, by text substitution
in the source (the script fails if the source no longer has the text it
replaces), each copy built with its own ``nvcc`` into
``build/ablate_row_update/``, all at once:

- ``as is``: the kernel unchanged (checked bit for bit against the port's
  kernel);
- ``consumer: no stage reads``: the consumer takes zero rows in place of the
  cotangent rows it would read from a stage (it still waits for the stage
  and reads its weights and masks);
- ``producers: no cotangent gather``: the producers copy no cotangent row
  (only the weights and masks);
- ``ring depth 2``, ``4`` and ``16``: the ring's stages (8 as is; a ring of
  S stages has min(7, S - 1) producer warps);
- ``consumer: no adds``: the consumer skips each full stage's products and
  adds (it still reads the next stage's look);
- ``consumer: all-ones path``: a full stage whose every weight is 1 skips
  the products (``x * 1`` is ``x``, bit for bit), the stage's look voting
  on its weights too: the path the kernel had before it was measured here
  and removed;
- ``long runs from 256`` and ``from 4096``: the long schedule's threshold
  (512 as is).

Timed on dlrm-small (8 tables x 1,000,000 x 64), its first zipf(1.05)
batch and a uniform one, with a bf16 cotangent [B * S, 64]: row 6 (the
``sgd`` row update on an fp32 table) on both streams, and row 10
(``momentum_bf16``, a bf16 momentum) on the zipf batch with weights
U[0.5, 1.5); CUDA events over 10 launches after 2, each beside the longest
run's add chain.

The narrow instances (an odd E, or a slab off its pairs' alignment), first
in every run but ``--only ablation|parent``: this source's copies
(``NARROW``: the narrow producers without cotangent copies, the consumer
without the parity shift or without stage reads) and, with ``--only
narrow --parent DIR`` (an earlier checkout with this one's launchers), the
earlier narrow producer's (``NARROW_EARLIER``, the first one's register
loads and stores with a release arrival: with a ``cp.async`` arrival,
without cotangent loads, without loads or stores), rows 6 and 10 at
chip_smoke.py's phase-21a shapes (zipf ids over a 1,000,000-row table, the
sorted stream of 8,192 samples of FM's 39 slots at E 11 and DIN's 105 at
E 18, a bf16 cotangent), each beside the ns a position of its longest run.

With ``--parent``, all eight row kinds (table rows 5-12) on the zipf and the
uniform batch, the earlier kernel and this one on the same inputs: their
results bit for bit equal, then each timed in the order earlier, this, this,
earlier (20 launches after 3 a time), and the ratio of this one's mean to
the earlier one's printed.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_FULL_STAGE = (
    "    if (lc.valid == kFull) {\n"
    "      add_stage<TY, kNarrow, 1>(R, st, cur, lc, n_of(k), st_next, n_of(k + 1), nxt, ln, a0, a1,\n"
    "                                na);")
VARIANTS = {
    "as is": [],
    "consumer: no stage reads": [
        ("  for (int u = 0; u < kSeg; ++u) nxt[u] = read_slot<TY, kNarrow>(R, st_next, u, na, odd);",
         "  for (int u = 0; u < kSeg; ++u) nxt[u] = Cot<TY>::zero();")],
    "producers: no cotangent gather": [
        ("        if (wide) {  // lane l takes chunks",
         "        if (false) {  // lane l takes chunks"),
        ("            if (c < E && bu >= 0) {\n              const TY* src =",
         "            if (false) {\n              const TY* src ="),
        ("            if (bu >= 0 && w < ((static_cast<int>(a0 & 1) + ncols + 1) >> 1)) {",
         "            if (false) {")],
    "ring depth 2": [("constexpr int kStages = 8;", "constexpr int kStages = 2;")],
    "ring depth 4": [("constexpr int kStages = 8;", "constexpr int kStages = 4;")],
    "ring depth 16": [("constexpr int kStages = 8;", "constexpr int kStages = 16;")],
    "consumer: no adds": [
        (_FULL_STAGE, "    if (lc.valid == kFull) {\n      ln = look(R, st_next, n_of(k + 1));")],
    "consumer: all-ones path": [
        ("struct Look {\n  unsigned valid;\n};", "struct Look {\n  unsigned valid;\n  bool ones;\n};"),
        ("  return Look{__ballot_sync(kFull, lane < n && msk != 0)};",
         "  const float w = R.wgt[st * kSeg + lane];\n"
         "  const bool m = lane < n && msk != 0;\n"
         "  return Look{__ballot_sync(kFull, m), __all_sync(kFull, !m || w == 1.f) != 0};"),
        ("    const float x0 = Cot<TY>::first(cur[u]), x1 = Cot<TY>::second(cur[u]);\n",
         "    const float x0 = Cot<TY>::first(cur[u]), x1 = Cot<TY>::second(cur[u]);\n"
         "    if (kPath == 0) {\n"
         "      a0 = __fadd_rn(a0, x0);\n"
         "      a1 = __fadd_rn(a1, x1);\n"
         "      continue;\n"
         "    }\n"),
        (_FULL_STAGE,
         "    if (lc.valid == kFull && lc.ones) {\n"
         "      add_stage<TY, kNarrow, 0>(R, st, cur, lc, n_of(k), st_next, n_of(k + 1), nxt, ln, a0, a1,\n"
         "                                na);\n"
         "    } else if (lc.valid == kFull) {\n"
         "      add_stage<TY, kNarrow, 1>(R, st, cur, lc, n_of(k), st_next, n_of(k + 1), nxt, ln, a0, a1,\n"
         "                                na);")],
    "long runs from 256": [("constexpr int kLongRun = 512;", "constexpr int kLongRun = 256;")],
    "long runs from 4096": [("constexpr int kLongRun = 512;", "constexpr int kLongRun = 4096;")],
}

# the narrow instances (an odd E, or a dY off its pairs' alignment) at the recsys
# archetypes' widths, chip_smoke.py's phase 21a streams: copies of this source
NARROW = {
    "as is": [],
    "narrow producers: no cotangent copies": [
        ("            if (bu >= 0 && w < ((static_cast<int>(a0 & 1) + ncols + 1) >> 1)) {",
         "            if (false) {")],
    "narrow consumer: no parity (wrong halves)": [
        ("    return __funnelshift_r(w.x, w.y, ((odd >> u) & 1u) << 4) & na.keep;",
         "    return w.x & na.keep;")],
    "narrow consumer: no stage reads": [
        ("  for (int u = 0; u < kSeg; ++u) nxt[u] = read_slot<TY, kNarrow>(R, st_next, u, na, odd);",
         "  for (int u = 0; u < kSeg; ++u) nxt[u] = Cot<TY>::zero();")],
}

# copies of the earlier narrow producer (the first one: 2-byte loads of its two
# columns a position, stored to the stage from registers, the weights and masks
# stored too, then an arrival with release semantics)
_NARROW_STORE = ("              *stage_slot<TY>(R, st, u) =\n"
                 "                  load_pair<TY, true>(dY, static_cast<int64_t>(bu) * E + c, c + 1 < E);")
_NARROW_ARRIVE = ("            R.msk[st * kSeg + lane] = __ldg(sm.msk + q);\n"
                  "          }\n"
                  "          hopper::mbar_arrive(R.full + 8 * st);")
NARROW_EARLIER = {
    "as is": [],
    "narrow producers: cp.async arrive": [
        (_NARROW_ARRIVE, _NARROW_ARRIVE.replace("hopper::mbar_arrive", "hopper::cp_async_arrive"))],
    "narrow producers: no cotangent loads": [
        (_NARROW_STORE, "              *stage_slot<TY>(R, st, u) = Cot<TY>::zero();")],
    "narrow producers: no cotangent loads or stores": [
        ("            if (c < E && bu >= 0)\n              *stage_slot<TY>(R, st, u) =",
         "            if (false)\n              *stage_slot<TY>(R, st, u) =")],
    "narrow producers: no cotangent loads or stores, cp.async arrive": [
        ("            if (c < E && bu >= 0)\n              *stage_slot<TY>(R, st, u) =",
         "            if (false)\n              *stage_slot<TY>(R, st, u) ="),
        (_NARROW_ARRIVE, _NARROW_ARRIVE.replace("hopper::mbar_arrive", "hopper::cp_async_arrive"))],
}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# launcher, the store's pointers (the seed included), the scalars (lr, and hp)
KINDS = {
    "split_sgd": ("embedding_update_split", 2, 1),
    "sgd": ("embedding_update_fp32", 1, 1),
    "momentum": ("embedding_update_momentum", 2, 2),
    "adagrad": ("embedding_update_adagrad", 2, 2),
    "adagrad_rowwise": ("embedding_update_adagrad_rowwise", 2, 2),
    "adagrad_freq": ("embedding_update_freq", 2, 2),
    "momentum_bf16": ("embedding_update_momentum_bf16", 3, 2),
    "adagrad_bf16": ("embedding_update_adagrad_bf16", 3, 2),
}
HP = {"momentum": 0.9, "adagrad": 1e-8, "adagrad_rowwise": 1e-8, "adagrad_freq": 1e-8,
      "momentum_bf16": 0.9, "adagrad_bf16": 1e-8}
LR = {"adagrad": 0.01, "adagrad_rowwise": 0.01, "adagrad_bf16": 0.01}


def compile_all(jobs: dict, out_dir: Path, headers: Path) -> dict:
    """Build each ``{name: source text}`` into its own library at once;
    returns ``{name: CDLL}``."""
    from repro_torch.kernels import build as kbuild
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in headers.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    procs = {}
    for i, (name, text) in enumerate(jobs.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libv{i}.so"
        procs[name] = (so, subprocess.Popen([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def whole_source(csrc: Path) -> str:
    """The row update as one compile unit with all eight launchers: ``csrc``'s
    ``embedding_update.cuh`` followed by its four launcher sources (their
    include of it dropped); an earlier checkout's ``embedding_update.cu``
    where it had no such header."""
    from repro_torch.kernels.embedding_update import SOURCE
    header = csrc / "embedding_update.cuh"
    if not header.exists():
        return (csrc / "embedding_update.cu").read_text()
    include = '#include "embedding_update.cuh"\n'
    return header.read_text().replace("#pragma once\n", "") + "".join(
        (csrc / f"{stem}.cu").read_text().replace(include, "")
        for stem in sorted(set(SOURCE.values())))


def variant_sources(table: dict | None = None, csrc: Path | None = None) -> dict:
    """``{name: source text}``: each copy of ``table`` (VARIANTS) made from
    ``csrc``'s (this checkout's) row update, :func:`whole_source`."""
    src = whole_source(csrc or ROOT / "src" / "repro_torch" / "csrc")
    out = {}
    for name, subs in (VARIANTS if table is None else table).items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has {old.strip()[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


class Launcher:
    """One row kind's launcher of one built library, called on the sorted
    stream, a bf16 ``dY`` and a store; ``parent`` for the launchers of the
    earlier source."""

    def __init__(self, lib, kind: str, parent: bool):
        cname, pointers, n_scalars = KINDS[kind]
        self.fn = getattr(lib, cname)
        self.fn.restype = _I
        store, scalars = [_P] * pointers, [_F] * n_scalars
        if parent:
            self.fn.argtypes = [_P] * 5 + store + [_L, _I] + scalars + [_P]
            self.words = None
        else:
            self.fn.argtypes = [_P] * 5 + [_I] + store + [_P, _L, _I] + scalars + [_P]
            words = lib.embedding_update_list_words
            words.argtypes, words.restype = [_L], _L
            self.words = words
        self.parent = parent
        self.runs = None

    def __call__(self, stream, dY, ptrs, L, E, scalars):
        import torch
        if self.parent:
            args = (*ptrs, L, E)
        else:
            if self.runs is None or self.runs.numel() < self.words(L):
                self.runs = torch.empty(self.words(L), dtype=torch.int64, device=dY.device)
            args = (0, *ptrs, self.runs.data_ptr(), L, E)
        err = self.fn(*(t.data_ptr() for t in stream), dY.data_ptr(), *args, *scalars,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")


def time_ms(call, warm: int, reps: int) -> float:
    import torch
    for _ in range(warm):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(got, want) -> bool:
    import torch
    bits = {2: torch.int16, 4: torch.int32}
    return all(torch.equal(a.view(bits[a.element_size()]), b.view(bits[b.element_size()]))
               for a, b in zip(got, want))


def setup():
    """dlrm-small's table, its zipf and uniform batches, the bf16 cotangent."""
    import torch
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.synthetic import dlrm_stream
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.optim.split_sgd import combine_split
    cfg = dlrm_small()
    dev = torch.device("cuda", 0)
    state = dlrm.init_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    split = (state["emb"]["hi"], state["emb"]["lo"])
    W = combine_split(*split)
    del state
    offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32,
                              device=dev)
    rng = np.random.default_rng(1)
    uniform = np.stack([rng.integers(0, m, (cfg.batch, cfg.pooling)) for m in cfg.table_rows],
                       axis=1).astype(np.int32)
    zipf = next(dlrm_stream(0, cfg, 1.05))["idx"]
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, zipf.shape).astype(np.float32)).to(dev)
    dY = (torch.randn((cfg.batch * len(cfg.table_rows), cfg.emb_dim), device=dev) * 1e-3
          ).to(torch.bfloat16)

    def sort(idx, wgt=None):
        g = (torch.from_numpy(idx).to(dev) + offsets[None, :, None]).reshape(-1)
        return eu.sort_lookups(g, None, W.shape[0], cfg.pooling,
                               None if wgt is None else wgt.reshape(-1))
    streams = {"zipf": sort(zipf), "uniform": sort(uniform), "weighted zipf": sort(zipf, weights)}
    return cfg, dev, split, W, streams, dY


def chain_ms(stream, ghz: float) -> tuple[float, str]:
    import torch
    _, counts = torch.unique_consecutive(stream[0], return_counts=True)
    ms = int(counts.max()) * 4 / (ghz * 1e9) * 1e3
    return ms, (f"{stream[0].numel()} lookups, {counts.numel()} runs, longest "
                f"{int(counts.max())}, add chain {ms:.4f} ms at {ghz:.3f} GHz")


def ablation(libs, W, streams, dY, ghz) -> None:
    import torch
    from repro_torch.kernels import ops
    dev = W.device
    mom = (torch.randn(W.shape, device=dev) * 1e-3).to(torch.bfloat16)
    seed = torch.tensor(12345, dtype=torch.int32, device=dev)
    E = W.shape[1]
    for kernel, tag in (("row 6", "zipf"), ("row 6", "uniform"), ("row 10", "weighted zipf")):
        stream = streams[tag]
        L = stream[0].numel()
        chain, text = chain_ms(stream, ghz)
        print(f"{kernel}, {tag}: {text}", flush=True)
        kind = "sgd" if kernel == "row 6" else "momentum_bf16"
        store = (W,) if kernel == "row 6" else (W, mom)
        want = [t.clone() for t in store]
        if kernel == "row 6":
            ops.fused_update_fp32(*want, *stream, dY, 0.1)
        else:
            ops.fused_update_momentum_bf16(*want, *stream, dY, 0.1, 0.9, seed)
        scalars = (0.1,) if kernel == "row 6" else (0.1, 0.9)
        for name, lib in libs.items():
            fn = Launcher(lib, kind, parent=False)
            got = [t.clone() for t in store]
            ptrs = [t.data_ptr() for t in got] + ([seed.data_ptr()] if kernel == "row 10" else [])

            def call():
                fn(stream, dY, ptrs, L, E, scalars)

            call()
            torch.cuda.synchronize()
            same = same_bits(got, want)
            if name == "as is" and not same:
                raise SystemExit("the unchanged copy disagrees with the port's kernel")
            ms = time_ms(call, 2, 10)
            print(f"{kernel}, {tag}, {name}: {ms:.4f} ms, {ms / chain:.2f}x the add chain, "
                  f"{int(fn.runs[0])} long runs, bitwise equal to the port's kernel: {same}",
                  flush=True)
            del got


def kind_store(kind: str, split, W, gen):
    """A fresh store of ``kind`` on W's rows: the slabs, and the extra
    launch pointers (the seed)."""
    import torch
    dev = W.device
    if kind == "split_sgd":
        return [t.clone() for t in split], []
    if kind == "sgd":
        return [W.clone()], []
    shape = (W.shape[0], 1) if kind in ("adagrad_rowwise", "adagrad_freq") else W.shape
    if kind == "adagrad_freq":
        S = torch.randint(1, 100, shape, dtype=torch.int32, device=dev, generator=gen)
    elif kind.startswith("momentum"):
        S = torch.randn(shape, device=dev, generator=gen) * 1e-3
    else:
        S = torch.rand(shape, device=dev, generator=gen) * 1e-3
    if kind.endswith("bf16"):
        S = S.to(torch.bfloat16)
        return [W.clone(), S], [torch.tensor(777, dtype=torch.int32, device=dev)]
    return [W.clone(), S], []


def against_parent(lib, parent_lib, split, W, streams, dY) -> None:
    import torch
    gen = torch.Generator(device=W.device).manual_seed(5)
    E = W.shape[1]
    for kind in KINDS:
        scalars = (LR.get(kind, 0.1),) + ((HP[kind],) if kind in HP else ())
        fns = {"earlier": Launcher(parent_lib, kind, parent=True),
               "this": Launcher(lib, kind, parent=False)}
        for tag in ("zipf", "uniform"):
            stream = streams[tag]
            L = stream[0].numel()
            store, extra = kind_store(kind, split, W, gen)
            results = {}
            for version, fn in fns.items():
                got = [t.clone() for t in store]
                fn(stream, dY, [t.data_ptr() for t in got + extra], L, E, scalars)
                torch.cuda.synchronize()
                results[version] = got
            if not same_bits(results["this"], results["earlier"]):
                raise SystemExit(f"{kind}, {tag}: this kernel and the earlier one disagree")
            del results
            ms = {"earlier": [], "this": []}
            for version in ("earlier", "this", "this", "earlier"):
                ptrs = [t.data_ptr() for t in store + extra]
                ms[version].append(time_ms(lambda: fns[version](stream, dY, ptrs, L, E, scalars),
                                           3, 20))
            mean = {v: sum(t) / len(t) for v, t in ms.items()}
            print(f"{kind}, {tag}: earlier {ms['earlier'][0]:.4f} {ms['earlier'][1]:.4f} ms, "
                  f"this {ms['this'][0]:.4f} {ms['this'][1]:.4f} ms, this / earlier "
                  f"{mean['this'] / mean['earlier']:.4f}, bitwise equal", flush=True)
            del store, extra


def narrow_setup():
    """Phase 21a's row-update inputs at E 11 (FM, the narrow walk) and E 18
    (DIN, the pair walk): fp32 tables of NARROW_ROWS rows, the sorted stream
    of the first NARROW_UPDATE_BATCH samples of zipf ids [B, S, 1], a bf16
    cotangent a lookup."""
    import torch
    from chip_smoke import ALPHA, NARROW_BAG_BATCH, NARROW_ROWS, NARROW_UPDATE_BATCH, NARROW_WIDTHS
    from repro_torch.data.synthetic import zipf_indices
    from repro_torch.kernels import embedding_update as eu
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    out = []
    for _, E, S in NARROW_WIDTHS[:2]:
        W = (torch.rand((NARROW_ROWS, E), device=dev, generator=gen) - 0.5) * 2e-3
        idx = zipf_indices(rng, NARROW_ROWS, (NARROW_BAG_BATCH, S, 1), ALPHA).astype(np.int32)
        g = torch.from_numpy(idx[:NARROW_UPDATE_BATCH]).to(dev).reshape(-1)
        stream = eu.sort_lookups(g, None, NARROW_ROWS, 1)
        dY = (torch.randn((stream[0].numel(), E), device=dev, generator=gen) * 1e-3).to(
            torch.bfloat16)
        out.append((E, W, stream, dY))
    return out


def ablate_narrow(libs, cases, ghz) -> None:
    """Rows 6 (``sgd``) and 10 (``momentum_bf16``) of each copy on each
    narrow case, the unchanged copy held bit for bit to the port's kernel,
    timed as in :func:`ablation`, with the longest run's length and the ns a
    position of the long runs' walk (the kernel's time over the longest
    run, which one block walks while the others finish)."""
    import torch
    from repro_torch.kernels import ops
    for E, W, stream, dY in cases:
        L = stream[0].numel()
        chain, text = chain_ms(stream, ghz)
        _, counts = torch.unique_consecutive(stream[0], return_counts=True)
        longest = int(counts.max())
        print(f"narrow E {E}: {text}", flush=True)
        mom = (torch.randn(W.shape, device=W.device) * 1e-3).to(torch.bfloat16)
        seed = torch.tensor(12345, dtype=torch.int32, device=W.device)
        for kernel, kind in (("row 6", "sgd"), ("row 10", "momentum_bf16")):
            store = (W,) if kind == "sgd" else (W, mom)
            want = [t.clone() for t in store]
            if kind == "sgd":
                ops.fused_update_fp32(*want, *stream, dY, 0.1)
            else:
                ops.fused_update_momentum_bf16(*want, *stream, dY, 0.1, 0.9, seed)
            scalars = (0.1,) if kind == "sgd" else (0.1, 0.9)
            for name, lib in libs.items():
                fn = Launcher(lib, kind, parent=False)
                got = [t.clone() for t in store]
                ptrs = [t.data_ptr() for t in got] + ([seed.data_ptr()] if kind != "sgd" else [])

                def call():
                    fn(stream, dY, ptrs, L, E, scalars)

                call()
                torch.cuda.synchronize()
                same = same_bits(got, want)
                if name == "as is" and not same:
                    raise SystemExit(f"E {E}: the unchanged copy disagrees with the port's kernel")
                ms = time_ms(call, 2, 10)
                print(f"narrow E {E}, {kernel}, {name}: {ms:.4f} ms, "
                      f"{ms * 1e6 / longest:.2f} ns a position of the longest run, "
                      f"bitwise equal to the port's kernel: {same}", flush=True)
                del got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked earlier checkout")
    ap.add_argument("--only", choices=("ablation", "parent", "narrow"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_row_update: no CUDA device", file=sys.stderr)
        return 1
    if args.only == "parent" and args.parent is None:
        ap.error("--only parent needs --parent")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    ghz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.split()[0]) / 1e3
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    if args.only in (None, "narrow"):
        libs = compile_all(variant_sources(NARROW), ROOT / "build" / "ablate_row_update" / "narrow",
                           csrc)
        cases = narrow_setup()
        print("the narrow instances, this source's copies", flush=True)
        ablate_narrow(libs, cases, ghz)
        if args.parent is not None and args.only == "narrow":
            pcsrc = args.parent.resolve() / "src" / "repro_torch" / "csrc"
            parent = compile_all(variant_sources(NARROW_EARLIER, pcsrc),
                                 ROOT / "build" / "ablate_row_update" / "narrow_earlier", pcsrc)
            print("the narrow instances, the earlier source's copies", flush=True)
            ablate_narrow(parent, cases, ghz)
        del cases
        torch.cuda.empty_cache()
        if args.only == "narrow":
            return 0
    sources = variant_sources()
    if args.only == "parent":
        sources = {"as is": sources["as is"]}
    libs = compile_all(sources, ROOT / "build" / "ablate_row_update", csrc)
    parent_lib = None
    if args.parent is not None:
        pcsrc = args.parent.resolve() / "src" / "repro_torch" / "csrc"
        parent_lib = compile_all({"earlier": whole_source(pcsrc)},
                                 ROOT / "build" / "ablate_row_update" / "parent",
                                 pcsrc)["earlier"]
    _, _, split, W, streams, dY = setup()
    if args.only != "parent":
        ablation(libs, W, streams, dY, ghz)
    if parent_lib is not None:
        against_parent(libs["as is"], parent_lib, split, W, streams, dY)
    return 0


if __name__ == "__main__":
    sys.exit(main())
