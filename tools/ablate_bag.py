#!/usr/bin/env python3
"""Where the bag forward's and the dot interaction's time goes: time
text-substituted copies of ``src/repro_torch/csrc/embedding_bag.cu`` and
``interaction.cu`` on one CUDA card, and both kernels against an earlier
version of them in the same run.

    python3 tools/ablate_bag.py [--parent DIR] [--only this|earlier|parent|narrow]

from the root of a checkout.  ``DIR`` is an unpacked earlier checkout (for
example ``git archive <commit> | tar -x -C build/parent``) whose two sources
have the launchers of before the fused bag stage: ``embedding_bag_fwd`` and
``embedding_bag_weighted_fwd`` on global row ids, ``dot_interaction_fwd``
without a tile.

Each copy changes one thing, by text substitution (the script fails if a
source no longer has the text it replaces), and is built with its own
``nvcc`` into ``build/ablate_bag/``, all at once.  The copies named ``as
is`` are the kernels unchanged, held to the plain versions.  This source's
copies (``VARIANTS``):

- bag: ``no row loads`` (every row read as zeros; the ids are still loaded
  and listed), ``every lookup reads row 0`` (each valid id replaced by row
  0 of the table after it is loaded: one list entry a word), ``no index
  loads`` (the ids p mod 16 made in registers), ``no dedup`` (every lookup
  its own entry, read and added: the in-order walk's loads with this
  kernel's schedule), ``one bag a warp`` (its rows spread over the four lane
  groups and summed in a butterfly, as a small batch runs, in place of four
  bags a warp at E = 64 bf16, one a lane group), ``four bags a warp at
  every batch`` (the small batches too), ``bags sample-major`` (a warp's
  bags are one sample's slots, as the earlier kernel's blocks took them);
- interaction: ``no products`` (each pair's sum is its first float4's),
  ``no staging`` (no copies into shared memory; the products read Z from
  device memory), ``one FMA chain a pair`` (in place of four),
  ``plain loads, no TMA`` (the block's loads and stores in place of the
  bulk copies), ``one stage`` (a ring of one tile).

With ``--parent`` (and ``--only earlier``), the earlier sources' copies
(``EARLIER``): the bag ``no row loads``, ``every lookup reads row 0``, ``no
index loads`` and ``blocks taken table-major``; the interaction ``no
products`` and ``no staging``.

Timed on dlrm-small (8 tables x 1,000,000 x 64, a bf16 table, pooling 50):
the bag on its first zipf(1.05) batch, a uniform one and the zipf batch with
weights U[0.5, 1.5) at B = 8192, and on the zipf batch's first 8, 32 and 128
samples; the interaction at the same batch sizes (fp32 dense [B, 64] and
bags [B, 8, 64]).  Device time of 20 launches captured in a CUDA graph,
replayed once to warm up and once between CUDA events.

The narrow path (a row of no whole number of 16-byte chunks), first in
every run but ``--only this|earlier|parent``: this source's copies
(``NARROW``: ``no row loads``, ``no id loads``, ``no stores``, ``one round
in flight`` and ``eight``, ``stores through shuffles`` (each store 32
consecutive floats of a round's output, the values handed round by
shuffle), ``no second word of an odd row``, ``six blocks an SM`` (a
tighter register cap than five blocks'), ``first lookup loaded each pass``
and ``no register cap``) and, with ``--only narrow --parent DIR`` (an
earlier checkout with this one's launcher), the earlier narrow path's
(``NARROW_EARLIER``, the first narrow path, a thread a value: ``32-bit
index arithmetic``, ``no index arithmetic``, ``no id or offset loads``,
``no row loads``, ``no stores``),
each the bag stage (offsets, bf16 round) timed as a CUDA graph at
chip_smoke.py's phase-21a shapes (B 65,536, one lookup a bag, zipf ids
over a bf16 table of 1,000,000 rows, E 11, 18, 50 with 39, 105, 150
slots), the unchanged copies held bit for bit to the plain stage, beside
``F.embedding`` of the same rows as a graph and the byte bound; with
``--parent`` the two unchanged copies bit for bit to each other and timed
in turns.  ``--only narrow`` stops there.

With ``--parent``, also the earlier kernels against these on the same
inputs: the bag on global ids and fp32 sums (the earlier kernel's contract),
held to each other within chip_smoke.py's tolerances, then timed in the
order earlier, this, this, earlier, and the ratio of this one's mean to the
earlier one's printed; and the bag stage (earlier: the offset add, the
kernel and the bf16 round as three launches; this: one).  Then the host's
cost of a call at bucket 8 (where the card keeps up): microseconds on the
host clock a call over 100 calls enqueued without a wait, earlier, this,
this, earlier, for the bag's launcher, the bag stage and the interaction's
launcher called through ``ctypes``, and this checkout's Python wrappers
(``ops.embedding_bag_stage``, ``ops.dot_interaction``) alone.  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

from ablate_row_update import compile_all  # noqa: E402
from chip_smoke import KERNEL_TOL, graph_ms  # noqa: E402

SOURCES = ("embedding_bag", "interaction")
BATCHES = (8192, 8, 32, 128)
TOL = {"embedding_bag": KERNEL_TOL["embedding_bag"], "interaction": KERNEL_TOL["dot_interaction"]}

# text substitutions of this checkout's sources
VARIANTS = {
    "embedding_bag": {
        "as is": [],
        "no row loads": [
            ("          v[u] = ok ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(e.x) * E) + c)\n"
             "                    : make_uint4(0u, 0u, 0u, 0u);",
             "          v[u] = make_uint4(ok && e.x == 0x7ffffff1 ? 1u : 0u, 0u, 0u, 0u);")],
        "every lookup reads row 0": [
            ("const int32_t key = h * 32 + lane < np && g >= 0 && g < rows ? g : -1;",
             "const int32_t key = h * 32 + lane < np && g >= 0 && g < rows ? (g & INT32_MIN) : -1;")],
        "no index loads": [("ids[g][h] = in ? __ldg(idx + at) : 0;", "ids[g][h] = in ? (p & 15) : 0;")],
        "no dedup": [("const unsigned same = __match_any_sync(kFull, key);",
                      "const unsigned same = 1u << lane;")],
        "one bag a warp": [("if (groups > 1 && layout_bags < static_cast<int64_t>(groups) * 32 * sms)",
                            "if (groups > 1)")],
        "four bags a warp at every batch": [
            ("if (groups > 1 && layout_bags < static_cast<int64_t>(groups) * 32 * sms)",
             "if (groups > 1 && layout_bags < 0)")],
        "bags sample-major": [
            ("    const uint32_t j = j0 + g, s = j / Bu;\n"
             "    const bool in = g < G && j < n_bags;\n"
             "    bags[g] = in ? static_cast<int32_t>((j - s * Bu) * S + s) : -1;",
             "    const uint32_t j = j0 + g, s = j % S;\n"
             "    const bool in = g < G && j < n_bags;\n"
             "    bags[g] = in ? static_cast<int32_t>(j) : -1;")],
    },
    "interaction": {
        "as is": [],
        "no products": [("for (int e4 = 0; e4 < E4; ++e4) {", "for (int e4 = 0; e4 < 1; ++e4) {")],
        "no staging": [
            ("if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, static_cast<uint32_t>(nT * F * E * 4));",
             "if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, 0u);"),
            ("      hopper::bulk_load(hopper::smem_u32(z + r * ld), src, static_cast<uint32_t>(E * 4), bar);",
             "      (void)src;"),
            ("      const float4* zi = reinterpret_cast<const float4*>(z + (t * F + (ij >> 16)) * ld);\n"
             "      const float4* zj = reinterpret_cast<const float4*>(z + (t * F + (ij & 0xffff)) * ld);",
             "      const int64_t smp = tile * T + t;\n"
             "      const int ii = ij >> 16, jj = ij & 0xffff;\n"
             "      const float4* zi = reinterpret_cast<const float4*>(ii ? emb + (smp * S + ii - 1) * E : dense + smp * E);\n"
             "      const float4* zj = reinterpret_cast<const float4*>(jj ? emb + (smp * S + jj - 1) * E : dense + smp * E);")],
        "one FMA chain a pair": [
            ("        s1 = fmaf(a.y, b.y, s1);\n        s2 = fmaf(a.z, b.z, s2);\n        s3 = fmaf(a.w, b.w, s3);",
             "        s0 = fmaf(a.y, b.y, s0);\n        s0 = fmaf(a.z, b.z, s0);\n        s0 = fmaf(a.w, b.w, s0);")],
        "plain loads, no TMA": [("const bool bulk = E % 4 == 0 &&", "const bool bulk = false &&")],
        "one stage": [("const Plan tries[] = {{0, 2, 2}, {0, 2, 1}, {0, 1, 1}};",
                       "const Plan tries[] = {{0, 1, 2}, {0, 1, 1}};")],
    },
}

# text substitutions of the earlier sources (the --parent checkout)
EARLIER = {
    "embedding_bag": {
        "as is": [],
        "no row loads": [
            ("          v[u] = ok ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(row) * E) + c)\n"
             "                    : make_uint4(0u, 0u, 0u, 0u);",
             "          v[u] = make_uint4(ok && row == 0x7ffffff1 ? 1u : 0u, 0u, 0u, 0u);")],
        "every lookup reads row 0": [
            ("const int32_t mine = lane < np ? __ldg(idx + p0 + lane) : -1;",
             "const int32_t mine = lane < np ? (__ldg(idx + p0 + lane) & INT32_MIN) : -1;")],
        "no index loads": [
            ("const int32_t mine = lane < np ? __ldg(idx + p0 + lane) : -1;",
             "const int32_t mine = lane < np ? ((p0 + lane) & 15) : -1;")],
        "blocks taken table-major": [
            ("  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);\n"
             "  if (bag >= n_bags) return;",
             "  const int64_t n_samples = n_bags / 8;\n"
             "  const int64_t chunks = (n_samples + kWarpsPerBlock - 1) / kWarpsPerBlock;\n"
             "  const int64_t sample = (blockIdx.x % chunks) * kWarpsPerBlock + (threadIdx.x >> 5);\n"
             "  const int64_t bag = sample * 8 + blockIdx.x / chunks;\n"
             "  if (sample >= n_samples) return;")],
    },
    "interaction": {
        "as is": [],
        "no products": [("    for (int e = 0; e < E; ++e) s = fmaf(zi[e], zj[e], s);",
                         "    s = zi[0] + zj[0];")],
        "no staging": [
            ("  for (int t = lane; t < S * E; t += 32) z[(1 + t / E) * ld + t % E] = em[t];\n", ""),
            ("    const float* zi = z + i * ld;\n    const float* zj = z + j * ld;",
             "    const float* zi = i ? em + (i - 1) * E : d;\n"
             "    const float* zj = j ? em + (j - 1) * E : d;")],
    },
}

# the narrow path (a row of no whole number of 16-byte chunks) at the recsys
# archetypes' widths, chip_smoke.py's phase 21a shapes: copies of this source
_NARROW_STORES = (
    "        const uint32_t j = j0 + static_cast<uint32_t>((r0 + u) * G + grp);  // the group's bag\n"
    '#pragma unroll\n'
    '        for (int v = 0; v < V; ++v)\n'
    '          if (c + v < E && j < n_bags) out[static_cast<int64_t>(j) * E + c + v] = acc[u][v];\n')
NARROW = {
    "embedding_bag": {
        "as is": [],
        "no row loads": [("          if (key[u] >= 0 && c < E && r0 + u < rl) {",
                          "          if (key[u] == 0x7ffffff1) {")],
        "no id loads": [("static_cast<uint32_t>(__ldg(idx + at))",
                         "static_cast<uint32_t>(at & 1023)")],
        "no stores": [("if (c + v < E && j < n_bags) out[",
                       "if (acc[u][v] == 12345.f) out[")],
        "one round in flight": [("constexpr int kNarrowRounds = 4;",
                                 "constexpr int kNarrowRounds = 1;")],
        "eight rounds in flight": [("constexpr int kNarrowRounds = 4;",
                                    "constexpr int kNarrowRounds = 8;")],
        "stores through shuffles": [  # each store 32 consecutive floats of the round's run
            ("  const int32_t off = bag_in && offsets ? __ldg(offsets + jl % static_cast<uint32_t>(S)) : 0;\n",
             "  const int32_t off = bag_in && offsets ? __ldg(offsets + jl % static_cast<uint32_t>(S)) : 0;\n"
             + "  // store k of a round: the run's value 32 k + lane, held by lane src[k] as its value hsel[k]\n"
               '  int src[V], hsel[V], sgrp[V], scol[V];\n'
               '#pragma unroll\n'
               '  for (int k = 0; k < V; ++k) {\n'
               '    const int o = 32 * k + lane;\n'
               '    sgrp[k] = o / ep;\n'
               '    scol[k] = o - sgrp[k] * ep;\n'
               '    src[k] = ((sgrp[k] << map.rl_log2) + scol[k] / V) & 31;\n'
               '    hsel[k] = scol[k] % V;\n'
               '  }\n'),
            ("  const int grp = lane >> map.rl_log2, gl = lane & (rl - 1);\n",
             "  const int grp = lane >> map.rl_log2, gl = lane & (rl - 1);\n"
             "  const int ep = min(E, 32 * V);\n"),
            (_NARROW_STORES,
             "        const uint32_t jr = j0 + static_cast<uint32_t>((r0 + u) * G);  // the round's first bag\n"
             '#pragma unroll\n'
             '        for (int k = 0; k < V; ++k) {\n'
             '          float y = __shfl_sync(kFull, acc[u][0], src[k]);\n'
             '          if constexpr (V == 2) {\n'
             '            const float y1 = __shfl_sync(kFull, acc[u][1], src[k]);\n'
             '            y = hsel[k] ? y1 : y;\n'
             '          }\n'
             '          const uint32_t j = jr + static_cast<uint32_t>(sgrp[k]);\n'
             '          const int col = cbase + scol[k];\n'
             '          if (sgrp[k] < G && col < E && j < n_bags) out[static_cast<int64_t>(j) * E + col] = y;\n'
             '        }\n')],
        "no second word of an odd row": [
            ("              if (sh[u] && c + 1 < E) hi[u] = __ldg(Ww + (a >> 1) + 1);",
             "              if (sh[u] && c + 1 < 0) hi[u] = __ldg(Ww + (a >> 1) + 1);")],
        "six blocks an SM": [
            ("__global__ void __launch_bounds__(kNarrowWarps * 32, 5)\n    embedding_bag_narrow_kernel",
             "__global__ void __launch_bounds__(kNarrowWarps * 32, 6)\n    embedding_bag_narrow_kernel")],
        "first lookup loaded each pass": [
            ("        int32_t key_l = key0;\n        float w_l = w0;\n        if (p > 0) lookup(p, key_l, w_l);",
             "        int32_t key_l;\n        float w_l;\n        lookup(p, key_l, w_l);")],
        "no register cap": [
            ("__global__ void __launch_bounds__(kNarrowWarps * 32, 5)\n    embedding_bag_narrow_kernel",
             "__global__ void __launch_bounds__(kNarrowWarps * 32)\n    embedding_bag_narrow_kernel")],
    },
}

# copies of the earlier narrow path (one thread a value of the output,
# a 64-bit t / E and j % S each, its own id and offset loads, 2-byte row loads)
NARROW_EARLIER = {
    "embedding_bag": {
        "as is": [],
        "32-bit index arithmetic": [
            ("    const int64_t j = t / E;",
             "    const int64_t j = static_cast<uint32_t>(t) / static_cast<uint32_t>(E);"),
            ("__ldg(offsets + j % S)",
             "__ldg(offsets + static_cast<uint32_t>(j) % static_cast<uint32_t>(S))")],
        "no index arithmetic": [
            ("    const int64_t j = t / E;\n    const int c = static_cast<int>(t - j * E);",
             "    const int64_t j = t >> 6;\n    const int c = static_cast<int>(t & 7);"),
            ("__ldg(offsets + j % S)", "__ldg(offsets + (j & 31))")],
        "no id or offset loads": [
            ("static_cast<uint32_t>(__ldg(idx + at))", "static_cast<uint32_t>(at & 1023)"),
            ("const int32_t off = offsets ? __ldg(offsets + j % S) : 0;",
             "const int32_t off = 0;")],
        "no row loads": [("      if (g >= 0 && g < rows) {", "      if (g == 0x7ffffff1) {")],
        "no stores": [("    out[t] = acc;", "    if (acc == 12345.f) out[t] = acc;")],
    },
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def substituted(csrc: Path, table: dict) -> dict:
    """``{(source, variant): text}`` for every variant of ``table``."""
    out = {}
    for stem, variants in table.items():
        src = (csrc / f"{stem}.cu").read_text()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"{stem}, {name}: the source no longer has "
                                     f"{old.strip()[:60]!r}")
                text = text.replace(old, new)
            out[(stem, name)] = text
    return out


def build(csrc: Path, table: dict, tag: str) -> dict:
    """``{"source: variant": CDLL}``, every copy built at once."""
    jobs = {f"{stem}: {name}": text for (stem, name), text in substituted(csrc, table).items()}
    return compile_all(jobs, ROOT / "build" / "ablate_bag" / tag, csrc)


class Bag:
    """One built bag library, called on table-local ids ``idx`` [B, S, P]
    with the per-slot ``offsets``: ``this`` sources take them as they are
    (``fused``: rounded to bf16), the earlier ones on precomputed global
    ids (``gidx``)."""

    def __init__(self, lib, earlier: bool):
        self.earlier = earlier
        if earlier:
            self.fn = lib.embedding_bag_fwd
            self.fn.argtypes = [_P, _P, _P, _L, _I, _I, _L, _I, _P]
            self.wfn = lib.embedding_bag_weighted_fwd
            self.wfn.argtypes = [_P, _P, _P, _P, _L, _I, _I, _L, _I, _P]
            self.wfn.restype = _I
        else:
            self.fn = lib.embedding_bag_fwd
            self.fn.argtypes = [_P, _P, _P, _P, _P, _L, _I, _I, _I, _L, _I, _I, _L, _P]
        self.fn.restype = _I

    def __call__(self, W, idx, gidx, offsets, wgt, out, rows, fused=False):
        import torch
        B, S, P = idx.shape
        E = W.shape[1]
        bf16 = int(W.dtype == torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        if self.earlier:
            if wgt is None:
                err = self.fn(W.data_ptr(), gidx.data_ptr(), out.data_ptr(), B * S, P, E, rows,
                              bf16, stream)
            else:
                err = self.wfn(W.data_ptr(), gidx.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                               B * S, P, E, rows, bf16, stream)
        else:
            src = idx if fused else gidx
            err = self.fn(W.data_ptr(), src.data_ptr(), offsets.data_ptr() if fused else None,
                          None if wgt is None else wgt.data_ptr(), out.data_ptr(), B, S, P, E,
                          rows, bf16, int(fused), 0, stream)
        if err:
            raise SystemExit(f"CUDA error {err}")


class Interaction:
    """One built interaction library (the earlier launcher and this one
    take the same arguments)."""

    def __init__(self, lib):
        self.fn = lib.dot_interaction_fwd
        self.fn.argtypes = [_P, _P, _P, _L, _I, _I, _P]
        self.fn.restype = _I

    def __call__(self, dense, emb, out):
        import torch
        B, S, E = emb.shape
        err = self.fn(dense.data_ptr(), emb.data_ptr(), out.data_ptr(), B, S, E,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")


def setup():
    """dlrm-small's bf16 table, its zipf and uniform batches at 8192 (ids
    table-local), weights, the offsets, and interaction inputs."""
    import torch
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.core import sharded_embedding as se
    from repro_torch.data.synthetic import dlrm_stream
    cfg = dlrm_small()
    dev = torch.device("cuda", 0)
    layout = se.make_layout(cfg.spec, 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = 1.0 / float(np.sqrt(np.mean(cfg.table_rows)))
    W = torch.empty((layout.total_rows, cfg.emb_dim), device=dev).uniform_(
        -a, a, generator=gen).to(torch.bfloat16)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(1)
    uniform = np.stack([rng.integers(0, m, (cfg.batch, cfg.pooling)) for m in cfg.table_rows],
                       axis=1).astype(np.int32)
    zipf = next(dlrm_stream(0, cfg, 1.05))["idx"]
    streams = {"zipf": torch.from_numpy(zipf).to(dev), "uniform": torch.from_numpy(uniform).to(dev)}
    wgt = torch.from_numpy(rng.uniform(0.5, 1.5, zipf.shape).astype(np.float32)).to(dev)
    dense = torch.randn((cfg.batch, cfg.emb_dim), device=dev, generator=gen)
    emb = torch.randn((cfg.batch, len(cfg.table_rows), cfg.emb_dim), device=dev, generator=gen) * 0.05
    return W, layout.rows_per_shard, offsets, streams, wgt, dense, emb


def bag_cases(streams, wgt):
    """(label, idx, weights): zipf, uniform and weighted zipf at 8192, zipf
    at each serving bucket."""
    cases = [("zipf 8192", streams["zipf"], None), ("uniform 8192", streams["uniform"], None),
             ("weighted 8192", streams["zipf"], wgt)]
    cases += [(f"zipf {b}", streams["zipf"][:b].contiguous(), None) for b in BATCHES[1:]]
    return cases


def close(got, want, rtol, atol) -> tuple[bool, float]:
    d = (got - want).abs()
    return bool((d <= atol + rtol * want.abs()).all()), float(d.max())


def ablate_bag(libs, earlier, W, rows, offsets, streams, wgt) -> None:
    import torch
    from repro_torch.kernels import ref
    for label, idx, w in bag_cases(streams, wgt):
        gidx = idx + offsets[None, :, None]
        B, S, _ = idx.shape
        want = ref.embedding_bag(W, gidx, rows, w)
        out = torch.empty((B, S, W.shape[1]), device=W.device)
        row = []
        for name, lib in libs.items():
            fn = Bag(lib, earlier)
            fn(W, idx, gidx, offsets, w, out, rows)
            torch.cuda.synchronize()
            ok, err = close(out, want, *TOL["embedding_bag"])
            if name.endswith("as is") and not ok:
                raise SystemExit(f"{name}: the unchanged copy disagrees with the plain bag ({err:.3e})")
            ms = graph_ms(lambda: fn(W, idx, gidx, offsets, w, out, rows))
            row.append(f"{name.split(': ')[1]} {ms:.4f}")
        print(f"bag, {label} (ms): " + "; ".join(row), flush=True)


def ablate_interaction(libs, earlier, dense, emb) -> None:
    import torch
    from repro_torch.kernels import ref
    for B in BATCHES:
        d, e = dense[:B].contiguous(), emb[:B].contiguous()
        want = ref.dot_interaction(d, e)
        out = torch.empty_like(want)
        row = []
        for name, lib in libs.items():
            fn = Interaction(lib)
            fn(d, e, out)
            torch.cuda.synchronize()
            ok, err = close(out, want, *TOL["interaction"])
            if name.endswith("as is") and not ok:
                raise SystemExit(f"{name}: the unchanged copy disagrees with the plain interaction "
                                 f"({err:.3e})")
            ms = graph_ms(lambda: fn(d, e, out))
            row.append(f"{name.split(': ')[1]} {ms:.4f}")
        print(f"interaction, B {B} (ms): " + "; ".join(row), flush=True)


def ablation(libs, earlier, data) -> None:
    W, rows, offsets, streams, wgt, dense, emb = data
    tag = "earlier" if earlier else "this"
    print(f"ablation of the {tag} sources", flush=True)
    ablate_bag({k: v for k, v in libs.items() if k.startswith("embedding_bag")}, earlier, W, rows,
               offsets, streams, wgt)
    ablate_interaction({k: v for k, v in libs.items() if k.startswith("interaction")}, earlier,
                       dense, emb)


def narrow_setup():
    """Phase 21a's bag inputs at each narrow width: (E, S, the bf16 table of
    NARROW_ROWS rows, zipf ids [NARROW_BAG_BATCH, S, 1], zero offsets)."""
    import torch
    from chip_smoke import ALPHA, NARROW_BAG_BATCH, NARROW_ROWS, NARROW_WIDTHS
    from repro_torch.data.synthetic import zipf_indices
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    out = []
    for _, E, S in NARROW_WIDTHS:
        W = ((torch.rand((NARROW_ROWS, E), device=dev, generator=gen) - 0.5) * 2e-3).to(
            torch.bfloat16)
        idx = torch.from_numpy(zipf_indices(rng, NARROW_ROWS, (NARROW_BAG_BATCH, S, 1), ALPHA)
                               .astype(np.int32)).to(dev)
        out.append((E, S, W, idx, torch.zeros(S, dtype=torch.int32, device=dev)))
    return out


def ablate_narrow(libs, cases) -> None:
    """Each copy's bag stage (offsets, bf16 round) at each narrow width as a
    CUDA graph, the unchanged copy held bit for bit to the plain stage;
    beside them F.embedding of the same rows (a bag of one lookup is a
    gather) as a graph and the byte bound."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import FP32_FLOPS, bound_ms
    from repro_torch.kernels import ref
    for E, S, W, idx, zero in cases:
        B = idx.shape[0]
        rows = W.shape[0]
        want = ref.embedding_bag_stage(W, idx, zero, rows)
        out = torch.empty((B, S, E), device=W.device)
        row = []
        for name, lib in libs.items():
            fn = Bag(lib, False)
            fn(W, idx, None, zero, None, out, rows, fused=True)
            torch.cuda.synchronize()
            if name.endswith("as is") and not torch.equal(out, want):
                raise SystemExit(f"{name}: the unchanged copy disagrees with the plain bag stage "
                                 f"at E {E}")
            ms = graph_ms(lambda: fn(W, idx, None, zero, None, out, rows, fused=True))
            row.append(f"{name.split(': ')[1]} {ms:.4f}")
        gid = idx.reshape(-1).long()
        lib_ms = graph_ms(lambda: F.embedding(gid, W))
        U = int(torch.unique(idx).numel())
        bms, _ = bound_ms(U * E * 2 + idx.numel() * 4 + B * S * E * 4, B * S * E, FP32_FLOPS)
        print(f"narrow bag, E {E} [{B}x{S}x1] (ms): " + "; ".join(row)
              + f"; F.embedding {lib_ms:.4f}; bound {bms:.4f}", flush=True)


def narrow_against_parent(lib, parent_lib, cases) -> None:
    """The earlier narrow path and this one at each narrow width, bit for
    bit, then in turns."""
    import torch
    fns = {"earlier": Bag(parent_lib, False), "this": Bag(lib, False)}
    for E, S, W, idx, zero in cases:
        outs = {v: torch.empty((idx.shape[0], S, E), device=W.device) for v in fns}
        for v, fn in fns.items():
            fn(W, idx, None, zero, None, outs[v], W.shape[0], fused=True)
        torch.cuda.synchronize()
        if not torch.equal(outs["this"], outs["earlier"]):
            raise SystemExit(f"narrow bag, E {E}: this kernel and the earlier one disagree")
        print(f"narrow bag, E {E}: " + turns({v: (lambda v=v: fns[v](
            W, idx, None, zero, None, outs[v], W.shape[0], fused=True)) for v in fns})
            + ", bitwise equal", flush=True)


def turns(calls: dict) -> str:
    """Each of ``calls`` ({"earlier": fn, "this": fn}) timed in the order
    earlier, this, this, earlier; their times and this / earlier."""
    ms = {"earlier": [], "this": []}
    for version in ("earlier", "this", "this", "earlier"):
        ms[version].append(graph_ms(calls[version]))
    mean = {v: sum(t) / len(t) for v, t in ms.items()}
    return (f"earlier {ms['earlier'][0]:.4f} {ms['earlier'][1]:.4f} ms, this {ms['this'][0]:.4f} "
            f"{ms['this'][1]:.4f} ms, this / earlier {mean['this'] / mean['earlier']:.4f}")


def host_us(fn, calls: int = 100) -> float:
    """Microseconds on the host clock a call of ``fn`` over ``calls`` calls
    enqueued without a wait (fewer launches than the card's queue holds)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_turns(calls: dict) -> str:
    """As :func:`turns`, on the host clock: microseconds a call."""
    us = {"earlier": [], "this": []}
    for version in ("earlier", "this", "this", "earlier"):
        us[version].append(host_us(calls[version]))
    mean = {v: sum(t) / len(t) for v, t in us.items()}
    return (f"earlier {us['earlier'][0]:.2f} {us['earlier'][1]:.2f} us, this {us['this'][0]:.2f} "
            f"{us['this'][1]:.2f} us, this / earlier {mean['this'] / mean['earlier']:.4f}")


def host_cost(fns, ints, data) -> None:
    """The host's cost of a call at bucket 8: the launchers and the bag
    stage, earlier and this; this checkout's Python wrappers alone."""
    import torch
    from repro_torch.kernels import ops
    W, rows, offsets, streams, wgt, dense, emb = data
    B = BATCHES[1]
    idx = streams["zipf"][:B].contiguous()
    gidx = idx + offsets[None, :, None]
    out = torch.empty((B, idx.shape[1], W.shape[1]), device=W.device)
    print(f"host, bag launcher at B {B}: " + host_turns(
        {v: (lambda v=v: fns[v](W, idx, gidx, offsets, None, out, rows)) for v in fns}), flush=True)

    def earlier_stage():
        fns["earlier"](W, idx, idx + offsets[None, :, None], offsets, None, out, rows)
        return out.to(torch.bfloat16).float()
    print(f"host, bag stage at B {B}: " + host_turns({
        "earlier": earlier_stage,
        "this": lambda: fns["this"](W, idx, None, offsets, None, out, rows, fused=True)}),
        flush=True)
    d, e = dense[:B].contiguous(), emb[:B].contiguous()
    o = torch.empty((B, e.shape[2] + (e.shape[1] + 1) * e.shape[1] // 2), device=d.device)
    print(f"host, interaction launcher at B {B}: " + host_turns(
        {v: (lambda v=v: ints[v](d, e, o)) for v in ints}), flush=True)
    stage_us = host_us(lambda: ops.embedding_bag_stage(W, idx, offsets, rows))
    int_us = host_us(lambda: ops.dot_interaction(d, e))
    print(f"host, this checkout's wrappers at B {B}: ops.embedding_bag_stage {stage_us:.2f} us, "
          f"ops.dot_interaction {int_us:.2f} us", flush=True)


def against_parent(lib_bag, lib_int, parent_bag, parent_int, data) -> None:
    import torch
    W, rows, offsets, streams, wgt, dense, emb = data
    fns = {"earlier": Bag(parent_bag, True), "this": Bag(lib_bag, False)}
    for label, idx, w in bag_cases(streams, wgt):
        gidx = idx + offsets[None, :, None]
        B, S, _ = idx.shape
        outs = {v: torch.empty((B, S, W.shape[1]), device=W.device) for v in fns}
        for v, fn in fns.items():
            fn(W, idx, gidx, offsets, w, outs[v], rows)
        torch.cuda.synchronize()
        ok, err = close(outs["this"], outs["earlier"], *TOL["embedding_bag"])
        if not ok:
            raise SystemExit(f"bag, {label}: this kernel and the earlier one disagree ({err:.3e})")
        print(f"bag, {label}: " + turns({v: (lambda v=v: fns[v](W, idx, gidx, offsets, w, outs[v],
                                                                 rows)) for v in fns})
              + f", max_abs_err {err:.3e}", flush=True)

        def earlier_stage():
            g = idx + offsets[None, :, None]
            fns["earlier"](W, idx, g, offsets, w, outs["earlier"], rows)
            return outs["earlier"].to(torch.bfloat16).float()
        print(f"bag stage, {label}: " + turns({
            "earlier": earlier_stage,
            "this": lambda: fns["this"](W, idx, None, offsets, w, outs["this"], rows, fused=True)}),
            flush=True)
    ints = {"earlier": Interaction(parent_int), "this": Interaction(lib_int)}
    for B in BATCHES:
        d, e = dense[:B].contiguous(), emb[:B].contiguous()
        outs = {v: torch.empty((B, e.shape[2] + (e.shape[1] + 1) * e.shape[1] // 2),
                               device=d.device) for v in ints}
        for v, fn in ints.items():
            fn(d, e, outs[v])
        torch.cuda.synchronize()
        ok, err = close(outs["this"], outs["earlier"], *TOL["interaction"])
        if not ok:
            raise SystemExit(f"interaction, B {B}: this kernel and the earlier one disagree "
                             f"({err:.3e})")
        print(f"interaction, B {B}: " + turns({v: (lambda v=v: ints[v](d, e, outs[v]))
                                               for v in ints}) + f", max_abs_err {err:.3e}",
              flush=True)
    host_cost(fns, ints, data)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked earlier checkout")
    ap.add_argument("--only", choices=("this", "earlier", "parent", "narrow"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate_bag: no CUDA device", file=sys.stderr)
        return 1
    if args.only in ("earlier", "parent") and args.parent is None:
        ap.error(f"--only {args.only} needs --parent")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    pcsrc = None if args.parent is None else args.parent.resolve() / "src" / "repro_torch" / "csrc"
    if args.only in (None, "narrow"):
        libs = build(csrc, NARROW, "narrow")
        parent = (build(pcsrc, NARROW_EARLIER, "narrow_earlier")
                  if pcsrc is not None and args.only == "narrow" else {})
        cases = narrow_setup()
        print("the narrow path, this source's copies", flush=True)
        ablate_narrow(libs, cases)
        if parent:
            print("the narrow path, the earlier source's copies", flush=True)
            ablate_narrow(parent, cases)
            narrow_against_parent(libs["embedding_bag: as is"], parent["embedding_bag: as is"],
                                  cases)
        del cases
        torch.cuda.empty_cache()
        if args.only == "narrow":
            return 0
    this = VARIANTS if args.only in (None, "this") else {s: {"as is": []} for s in SOURCES}
    if args.only == "earlier":
        this = {}
    libs = build(csrc, this, "this") if this else {}
    parent = {}
    if pcsrc is not None:
        earlier = EARLIER if args.only in (None, "earlier") else {s: {"as is": []} for s in SOURCES}
        parent = build(pcsrc, earlier, "earlier")
    data = setup()
    if args.only in (None, "this"):
        ablation(libs, False, data)
    if args.only in (None, "earlier"):
        ablation(parent, True, data)
    if args.parent is not None and args.only != "earlier":
        against_parent(libs["embedding_bag: as is"], libs["interaction: as is"],
                       parent["embedding_bag: as is"], parent["interaction: as is"], data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
