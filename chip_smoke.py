#!/usr/bin/env python3
"""Drive the PyTorch port's DLRM serving path on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which fails the run:

1. build: compile every kernel of ``src/repro_torch/csrc/`` (one ``nvcc``
   each, all at once) and print what ``ptxas`` reports;
2. kernels: call each kernel's wrapper at dlrm-small's shapes, at the
   config's batch (8192) and at every serving bucket (8, 32, 128), hold the
   result against the kernel's plain PyTorch version on the same inputs on
   the card, and, at 8192, time kernel, plain version and a PyTorch library
   call that computes the same function (a yardstick the port never calls);
   the bag also on uniform indices, whose rows are nearly all distinct;
3. serving: dlrm-small at full size (8 tables x 1,000,000 rows x 64, bf16-hi,
   pooling 50; random weights from a seeded ``torch.Generator``) published to
   a ``SnapshotRegistry`` and served by a ``ContinuousBatchingServer`` on
   buckets (8, 32, 128): 1024 requests with zipf(1.05) indices, in bursts
   that reach every bucket.  Every score must be finite and in (0, 1), and
   its logit must match the plain-version forward's on the card; every
   kernel must have been launched, fused_mlp 8 times a batch;
4. breakdown: per bucket, the host's padding, the score fn's wall time and
   the device's busy time in it (torch.profiler).

The line before the last two is ``{"kernels": [...]}`` (times in ms, CUDA
events after warm-up; ``bound_ms`` from this run's bytes and operations over
the card's published peaks); then the card's name and power limit from
``nvidia-smi``; the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

SEED = 0
ALPHA = 1.05            # zipf skew of the request indices
BUCKETS = (8, 32, 128)  # the default serving ladder (docs/serve.md)
# the main path's traffic, 1024 requests: one burst of 896 (seven full
# batches of 128), then three of 32 and four of 8, each sent once the last
# is answered
BURSTS = (896, 32, 32, 32, 8, 8, 8, 8)
N_REQUESTS = sum(BURSTS)
KERNEL_TOL = {"embedding_bag": (1e-5, 1e-6), "dot_interaction": (1e-5, 1e-5),
              "fused_mlp": (1e-4, 1e-4)}  # (rtol, atol): fp32 sums in another order
FUSED_MLP_BF16_TOL = (2 ** -7, 1e-4)     # a bf16 output may round to the neighbour
# atol for the served logits against the plain forward's: the kernels' fp32
# sums differ in order from the plain versions', so a bf16 rounding between
# layers may fall the other way (1.27e-4 on the scores, about 5e-4 on the
# logits, measured); the logits of this random model span about +-0.08
LOGIT_TOL = 3e-3


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def close_or_fail(name, got, want, rtol, atol, failures) -> float:
    d = (got.float() - want.float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    bad = int((d > atol + rtol * want.float().abs()).sum())
    finite = bool(got.float().isfinite().all())
    log(f"  {name}: max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:g}), {bad} outside, "
        f"finite {finite}")
    if bad or not finite:
        failures.append(f"{name}: {bad} values outside tolerance, finite={finite}")
    return err


def make_requests(cfg, n: int, rng) -> list[dict]:
    from repro_torch.data.synthetic import zipf_indices
    idx = np.stack([zipf_indices(rng, m, (n, cfg.pooling), ALPHA) for m in cfg.table_rows], axis=1)
    dense = rng.standard_normal((n, cfg.num_dense)).astype(np.float32)
    return [{"idx": idx[i].astype(np.int32), "dense_x": dense[i]} for i in range(n)]


def plain_logits(cfg, snap, batch, offsets, bag: bool = True):
    """The serving forward before its sigmoid, with every kernel replaced by
    its plain version (``bag=False``: the bag outputs zeroed)."""
    import torch
    from repro_torch.kernels import ref
    rows = snap["emb_w"].shape[0]
    emb = ref.embedding_bag(snap["emb_w"], batch["idx"] + offsets[None, :, None], rows)
    emb = emb.to(torch.bfloat16).float()
    if not bag:
        emb = torch.zeros_like(emb)

    def mlp(params, h, final_act):
        n = len(params["w"])
        for i, (w, b) in enumerate(zip(params["w"], params["b"])):
            last = i == n - 1
            h = ref.fused_mlp_layer(h, w, b, "relu" if (final_act or not last) else "none",
                                    torch.float32 if last else torch.bfloat16)
        return h

    bot = mlp(snap["dense_hi"]["bot"], batch["dense_x"], True)
    z = ref.dot_interaction(bot, emb).to(torch.bfloat16)
    return mlp(snap["dense_hi"]["top"], z, False)[:, 0]


def kernel_phase(cfg, snap, offsets, dev, rng, failures) -> list[dict]:
    """Each kernel against its plain version at B = cfg.batch (timed) and at
    every bucket the main path serves; returns the kernel entries of the JSON
    line (the bag's entry also holds its uniform-index times)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.interaction import tril_indices
    from repro_torch.kernels import ops, ref

    W = snap["emb_w"]
    rows, E = W.shape
    S, P = len(cfg.table_rows), cfg.pooling
    entries = {}
    for B in (cfg.batch, *BUCKETS):
        reqs = make_requests(cfg, B, rng)
        idx = torch.from_numpy(np.stack([r["idx"] for r in reqs])).to(dev)
        dense_x = torch.from_numpy(np.stack([r["dense_x"] for r in reqs])).to(dev).to(torch.bfloat16)
        gidx = idx + offsets[None, :, None]
        timed = B == cfg.batch
        log(f"kernels at B={B}:")

        # embedding_bag
        got = ops.embedding_bag(W, gidx, rows)
        want = ref.embedding_bag(W, gidx, rows)
        err = close_or_fail(f"embedding_bag [{B},{S},{P}] x [{rows},{E}] {W.dtype}", got, want,
                            *KERNEL_TOL["embedding_bag"], failures)
        e = entries.setdefault("embedding_bag", {"name": "embedding_bag", "max_abs_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if timed:
            unique = int(torch.unique(gidx).numel())
            nbytes = unique * E * W.element_size() + gidx.numel() * 4 + B * S * E * 4
            flops = gidx.numel() * E
            bms, by = bound_ms(nbytes, flops, FP32_FLOPS)
            flat = gidx.view(B * S, P)
            e.update(ms=time_ms(lambda: ops.embedding_bag(W, gidx, rows)),
                     plain_ms=time_ms(lambda: ref.embedding_bag(W, gidx, rows)),
                     library_ms=time_ms(lambda: F.embedding_bag(flat, W, mode="sum")),
                     bound_ms=bms, bound_by=by)
            log(f"  embedding_bag: {unique} distinct rows of {gidx.numel()} lookups; "
                f"{nbytes / 1e6:.1f} MB needed ({gidx.numel() * (E * W.element_size() + 4) / 1e6 + B * S * E * 4 / 1e6:.1f} MB "
                f"if no row repeated)")
            # the same number of lookups, uniform over each table: nearly
            # every row distinct, so the rows come from HBM and not from L2
            uidx = torch.from_numpy(np.stack([rng.integers(0, m, (B, P)) for m in cfg.table_rows],
                                             axis=1).astype(np.int32)).to(dev) + offsets[None, :, None]
            err = close_or_fail(f"embedding_bag, uniform indices [{B},{S},{P}]",
                                ops.embedding_bag(W, uidx, rows), ref.embedding_bag(W, uidx, rows),
                                *KERNEL_TOL["embedding_bag"], failures)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            u_unique = int(torch.unique(uidx).numel())
            u_bytes = u_unique * E * W.element_size() + uidx.numel() * 4 + B * S * E * 4
            u_bms, u_by = bound_ms(u_bytes, flops, FP32_FLOPS)
            uflat = uidx.view(B * S, P)
            e["uniform"] = dict(distinct=u_unique, mb=u_bytes / 1e6, bound_ms=u_bms, bound_by=u_by,
                                ms=time_ms(lambda: ops.embedding_bag(W, uidx, rows)),
                                library_ms=time_ms(lambda: F.embedding_bag(uflat, W, mode="sum")))
            log(f"  embedding_bag, uniform indices: {u_unique} distinct rows, {u_bytes / 1e6:.1f} MB "
                f"needed; kernel {e['uniform']['ms']:.4f} ms, F.embedding_bag "
                f"{e['uniform']['library_ms']:.4f} ms, bound {u_bms:.4f} ms ({u_by})")
        emb = got.to(torch.bfloat16).float()

        # fused_mlp, layer by layer on the forward's own activations
        def layers(params, h, final_act, tag):
            n = len(params["w"])
            for i, (w, b) in enumerate(zip(params["w"], params["b"])):
                last = i == n - 1
                act = "relu" if (final_act or not last) else "none"
                out_dtype = torch.float32 if last else torch.bfloat16
                k_out = ops.fused_mlp_layer(h, w, b, act, out_dtype)
                p_out = ref.fused_mlp_layer(h, w, b, act, out_dtype)
                tol = KERNEL_TOL["fused_mlp"] if last else FUSED_MLP_BF16_TOL
                M, K = h.shape
                N = w.shape[1]
                err = close_or_fail(f"fused_mlp {tag}{i} [{M}x{K}]@[{K}x{N}] {act} -> {out_dtype}",
                                    k_out, p_out, *tol, failures)
                e = entries.setdefault("fused_mlp", {"name": "fused_mlp", "max_abs_err": 0.0,
                                                     "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                                     "library_ms": 0.0, "flops": 0.0, "bytes": 0.0})
                e["max_abs_err"] = max(e["max_abs_err"], err)
                if timed:
                    nbytes = (M * K + K * N) * 2 + N * b.element_size() + M * N * k_out.element_size()
                    flops = 2.0 * M * K * N
                    bms, _ = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
                    lib = torch.relu if act == "relu" else (lambda y: y)
                    t = dict(ms=time_ms(lambda: ops.fused_mlp_layer(h, w, b, act, out_dtype)),
                             plain_ms=time_ms(lambda: ref.fused_mlp_layer(h, w, b, act, out_dtype)),
                             library_ms=time_ms(lambda: lib(torch.addmm(b.to(h.dtype), h, w))),
                             bound_ms=bms)
                    for key, v in t.items():
                        e[key] += v
                    e["flops"] += flops
                    e["bytes"] += nbytes
                    log(f"    {tag}{i}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                        f"addmm {t['library_ms']:.4f} ms, bound {bms:.4f} ms, "
                        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
                h = p_out
            return h

        bot = layers(snap["dense_hi"]["bot"], dense_x, True, "bot")

        # dot_interaction
        got = ops.dot_interaction(bot, emb)
        want = ref.dot_interaction(bot, emb)
        err = close_or_fail(f"dot_interaction [{B},{E}] + [{B},{S},{E}]", got, want,
                            *KERNEL_TOL["dot_interaction"], failures)
        e = entries.setdefault("dot_interaction", {"name": "dot_interaction", "max_abs_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if timed:
            F_ = S + 1
            pairs = F_ * (F_ - 1) // 2
            nbytes = (B * E + B * S * E) * 4 + B * (E + pairs) * 4
            bms, by = bound_ms(nbytes, 2.0 * B * pairs * E, FP32_FLOPS)
            Z = torch.cat([bot[:, None, :], emb], dim=1)
            li, lj = tril_indices(F_)
            flat = torch.as_tensor(li * F_ + lj, device=dev)
            e.update(ms=time_ms(lambda: ops.dot_interaction(bot, emb)),
                     plain_ms=time_ms(lambda: ref.dot_interaction(bot, emb)),
                     library_ms=time_ms(
                         lambda: torch.bmm(Z, Z.transpose(1, 2)).view(B, -1)[:, flat]),
                     bound_ms=bms, bound_by=by)

        layers(snap["dense_hi"]["top"], want.to(torch.bfloat16), False, "top")

    fm = entries["fused_mlp"]
    fm["bound_by"] = ("operations" if fm["flops"] / BF16_TENSOR_FLOPS >= fm["bytes"] / HBM_BYTES_PER_S
                      else "bytes")
    del fm["flops"], fm["bytes"]
    return [entries[k] for k in ("embedding_bag", "dot_interaction", "fused_mlp")]


def serving_phase(cfg, reg, offsets, dev, reqs, failures) -> dict:
    """The main path: the requests through the server, in bursts that each
    wait for the last to be answered (BURSTS), so that every bucket serves.
    Returns the launch counts of this run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ContinuousBatchingServer, make_bucket_scorers

    fns, pad = make_bucket_scorers(cfg, BUCKETS, lambda: reg.current().state, device=dev)
    scores = []
    ops.reset_launches()
    t0 = time.perf_counter()
    with ContinuousBatchingServer(fns, pad, max_wait_ms=2.0) as srv:
        start = 0
        for n in BURSTS:
            handles = [srv.submit(r) for r in reqs[start:start + n]]
            scores += [h.result(timeout=300.0) for h in handles]
            start += n
        stats = srv.stats()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    scores = np.array(scores, dtype=np.float32)
    n_batches = sum(stats["batches"].values())
    log(f"served {stats['requests']} requests in {n_batches} batches {stats['batches']} "
        f"({stats['padded']} padded rows) in {wall:.3f} s")
    for b, p in sorted(stats["buckets"].items()):
        log(f"  bucket {b}: n {p['n']}, p50 {p['p50_ms']:.3f} ms, p99 {p['p99_ms']:.3f} ms")
    log(f"kernel launches on the main path: {counts}")

    ok = np.isfinite(scores).all() and ((scores > 0) & (scores < 1)).all()
    if not ok or scores.shape != (N_REQUESTS,):
        failures.append(f"served scores: shape {scores.shape}, finite and in (0, 1): {ok}")
    if min(counts.values()) == 0:
        failures.append(f"a kernel was not launched on the main path: {counts}")
    if counts["fused_mlp"] != 8 * n_batches or counts["embedding_bag"] != n_batches \
            or counts["dot_interaction"] != n_batches:
        failures.append(f"launches {counts} do not match {n_batches} batches (fused_mlp 8 each)")

    # every served score's logit against the plain-version forward's logit
    # of the same rows (fp32 scores near 0.5 invert to within about 3e-7)
    snap = reg.current().state
    want, no_bag = [], []
    for i in range(0, N_REQUESTS, BUCKETS[-1]):
        batch = pad(reqs[i:i + BUCKETS[-1]], BUCKETS[-1])
        want.append(plain_logits(cfg, snap, batch, offsets).cpu())
        no_bag.append(plain_logits(cfg, snap, batch, offsets, bag=False).cpu())
    want, no_bag = torch.cat(want)[:N_REQUESTS].double(), torch.cat(no_bag)[:N_REQUESTS].double()
    got = torch.logit(torch.from_numpy(scores).double())
    close_or_fail(f"served logits vs plain forward ({N_REQUESTS})", got, want, 0.0, LOGIT_TOL,
                  failures)
    log(f"  scores: min {scores.min():.6f}, max {scores.max():.6f}, mean {scores.mean():.6f}; "
        f"logits: min {float(got.min()):.6f}, max {float(got.max()):.6f}; zeroing the bags "
        f"would move the logits by up to {float((no_bag - want).abs().max()):.3e}")
    return counts


def breakdown_phase(cfg, reg, reqs, dev) -> None:
    """Where one batch's time goes, per bucket: padding on the host, the
    score fn's wall time until the scores are on the host, and the device's
    busy time in it from torch.profiler (kernels by name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import make_bucket_scorers

    fns, pad = make_bucket_scorers(cfg, BUCKETS, lambda: reg.current().state, device=dev)
    reps = 20
    for b in BUCKETS:
        payloads = reqs[:b]
        t0 = time.perf_counter()
        for _ in range(reps):
            batch = pad(payloads, b)
        pad_ms = (time.perf_counter() - t0) / reps * 1e3
        for _ in range(3):
            fns[b](batch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fns[b](batch)
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log(f"bucket {b}: pad {pad_ms:.3f} ms; score fn {wall_ms:.3f} ms wall, device busy "
            f"{busy_ms:.3f} ms ({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / reps / 1e3:.4f} ms x"
                        f"{e.count // reps}" for e in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.kernels import build
    from repro_torch.serve import SnapshotRegistry
    from repro_torch import weights
    from repro_torch.core import sharded_embedding as se

    # plain fp32 products in full fp32, not TF32, on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"peaks for the bounds (H100 SXM data sheet, at 700 W): {HBM_BYTES_PER_S / 1e12} TB/s, "
        f"{BF16_TENSOR_FLOPS / 1e12} TFLOP/s bf16 tensor, {FP32_FLOPS / 1e12} TFLOP/s fp32")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.build_log)} sources")
    for stem, rec in build.build_log.items():
        info = [ln.strip() for ln in rec["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "error" in ln]
        log(f"  {stem}: nvcc {rec['seconds']:.1f} s; " + " | ".join(info))

    cfg = dataclasses.replace(dlrm_small(), mlp_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    reg = SnapshotRegistry()
    snap = reg.publish(weights.init_snapshot(cfg, gen, device=dev), step=0)
    torch.cuda.synchronize()
    log(f"snapshot v{snap.version}: emb_w {tuple(snap.state['emb_w'].shape)} "
        f"{snap.state['emb_w'].dtype}, {snap.emb_bytes / 1e9:.3f} GB "
        f"(fp32 would be {snap.fp32_emb_bytes / 1e9:.3f} GB), total {snap.total_bytes / 1e9:.3f} GB, "
        f"made in {time.perf_counter() - t0:.1f} s")
    offsets = torch.as_tensor(se.make_layout(cfg.spec, 1).row_offsets, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(SEED)

    failures: list[str] = []
    kernels = kernel_phase(cfg, snap.state, offsets, dev, rng, failures)
    if failures:
        raise SystemExit("kernel phase failed:\n" + "\n".join(failures))
    reqs = make_requests(cfg, N_REQUESTS, rng)
    counts = serving_phase(cfg, reg, offsets, dev, reqs, failures)
    if failures:
        raise SystemExit("serving phase failed:\n" + "\n".join(failures))
    breakdown_phase(cfg, reg, reqs, dev)

    routes = {"embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                                "src/repro/kernels/embedding_bag.py:31"),
              "dot_interaction": ("src/repro_torch/csrc/interaction.cu",
                                  "src/repro/kernels/interaction.py:22"),
              "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                            "src/repro/kernels/fused_mlp.py:22")}
    line = []
    u = kernels[0]["uniform"]
    log(f"embedding_bag, uniform indices: kernel {u['ms']:.4f} ms, library {u['library_ms']:.4f} ms, "
        f"bound {u['bound_ms']:.4f} ms ({u['bound_by']}), {u['bound_ms'] / u['ms'] * 100:.1f}% of bound")
    for k in kernels:
        src, replaces = routes[k["name"]]
        line.append({"name": k["name"], "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
        log(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
            f"{k['bound_ms'] / k['ms'] * 100:.1f}% of bound")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
