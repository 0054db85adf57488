#!/usr/bin/env python3
"""Drive the PyTorch port's DLRM serving and training paths on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which fails the run:

1. build: compile every kernel of ``src/repro_torch/csrc/`` (one ``nvcc``
   each, all at once) and print what ``ptxas`` reports;
2. kernels: call each serving kernel's wrapper at dlrm-small's shapes, at
   the config's batch (8192) and at every serving bucket (8, 32, 128), hold
   the result against the kernel's plain PyTorch version on the same inputs
   on the card, and, at 8192, time kernel, plain version and a PyTorch
   library call that computes the same function (a yardstick the port never
   calls); the bag also on uniform indices, whose rows are nearly all
   distinct;
3. serving: dlrm-small at full size (8 tables x 1,000,000 rows x 64, bf16-hi,
   pooling 50; random weights from a seeded ``torch.Generator``) published to
   a ``SnapshotRegistry`` and served by a ``ContinuousBatchingServer`` on
   buckets (8, 32, 128): 1024 requests with zipf(1.05) indices, in bursts
   that reach every bucket.  Every score must be finite and in (0, 1), and
   its logit must match the plain-version forward's on the card; every
   serving kernel must have been launched, fused_mlp 8 times a batch;
4. breakdown: per bucket, the host's padding, the score fn's wall time and
   the device's busy time in it (torch.profiler);
5. row kernels: the fused row update (split store and fp32 store) and the
   flat Split-SGD step, bit for bit against their plain versions at
   dlrm-small's shapes (the training stream's first zipf batch and a uniform
   one; the dense update's 3,811,396 values), timed, with the byte bound and
   the serial-chain floor of the longest run;
6. training: dlrm-small at full size (the 2.05 GB split store), batch 8192,
   lr 0.1, ``make_train_step`` over 20 staged zipf batches: every loss
   finite, one launch a step of the bag, interaction, row-update and
   Split-SGD kernels and none of fused_mlp, one step held to the same step
   on the CPU (every kernel's plain version), one step under
   ``torch.cuda.set_sync_debug_mode("error")``, samples per second, each
   stage's time and the device's busy share (torch.profiler);
7. sgd: 3 steps with the fp32 store (``sparse_optimizer="sgd"``), which runs
   the fp32 row-update kernel.

The line before the last two is ``{"kernels": [...]}`` (times in ms, CUDA
events after warm-up; ``bound_ms`` from this run's bytes and operations over
the card's published peaks; ``launches`` from each kernel's own path); then
the card's name and power limit from ``nvidia-smi``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device.
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
SERVING_KERNELS = ("embedding_bag", "dot_interaction", "fused_mlp")
N_TRAIN = 20  # staged zipf batches of the training phase
# a kernel train step against the same step on the CPU (every kernel's plain
# version): the loss within 1e-4 relative; the store and the dense weights
# within 1e-2 of the step's largest update: the two sum the dense network
# in other orders, so a bf16 cotangent may round to its neighbour (2^-8
# relative) and the row sums carry that into the update
TRAIN_TOL = {"loss": 1e-4, "update": 1e-2}


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
    if min(counts[k] for k in SERVING_KERNELS) == 0:
        failures.append(f"a kernel was not launched on the main path: {counts}")
    if counts["fused_mlp"] != 8 * n_batches or counts["embedding_bag"] != n_batches \
            or counts["dot_interaction"] != n_batches \
            or any(v for k, v in counts.items() if k not in SERVING_KERNELS):
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


def sm_clock_ghz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) / 1e3


def bitwise_or_fail(name, got, want, failures) -> float:
    """Bitwise equality of two tensors of one type; returns the max abs
    difference of their values (0.0 when equal)."""
    import torch
    ib = torch.int16 if got.element_size() == 2 else torch.int32
    same = got.shape == want.shape and bool((got.view(ib) == want.view(ib)).all())
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    log(f"  {name}: bitwise {same}, max_abs_err {err:.3e}")
    if not same:
        failures.append(f"{name}: not bitwise equal to its plain version (max_abs_err {err:.3e})")
    return err


def master(store):
    """The fp32 master rows of an embedding store."""
    from repro_torch.optim.split_sgd import combine_split
    return store["w"] if "w" in store else combine_split(store["hi"], store["lo"])


def dense_master(dense):
    """The fp32 master values of the dense state, padding included."""
    from repro_torch.optim import data_parallel as dp
    from repro_torch.optim.split_sgd import combine_split
    return combine_split(dp.flat_hi(dense["hi"], dense["lo"].numel()), dense["lo"])


def row_kernel_phase(cfg, state, offsets, batch, dev, rng, failures) -> list[dict]:
    """Rows 5 and 6 (the fused row update, split and fp32 store) and row 4
    (the flat Split-SGD step) against their plain versions, bit for bit, at
    dlrm-small's shapes: the main path's first zipf(1.05) batch and a
    uniform one, with a bf16 cotangent of the wire's shape [B * S, E]; the
    plain row update sums on CPU copies to fix its order.  Timed with CUDA
    events; returns the kernel entries of the JSON line."""
    import torch
    from repro_torch.kernels import embedding_update as eu
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import data_parallel as dp

    B, S, P, E = cfg.batch, len(cfg.table_rows), cfg.pooling, cfg.emb_dim
    rows = state["emb"]["hi"].shape[0]
    lr = cfg.lr
    ghz = sm_clock_ghz()
    dY = (torch.randn((B * S, E), device=dev) * 1e-3).to(torch.bfloat16)
    W32 = master(state["emb"])
    uidx = torch.from_numpy(np.stack([rng.integers(0, m, (B, P)) for m in cfg.table_rows],
                                     axis=1).astype(np.int32)).to(dev)
    entries = {"embedding_update": {"name": "embedding_update", "max_abs_err": 0.0},
               "embedding_update_fp32": {"name": "embedding_update_fp32", "max_abs_err": 0.0}}
    for tag, idx in (("zipf", batch["idx"]), ("uniform", uidx)):
        stream = eu.sort_lookups((idx + offsets[None, :, None]).reshape(-1), None, rows, P)
        L = stream[0].numel()
        _, counts = torch.unique_consecutive(stream[0], return_counts=True)
        U, longest = counts.numel(), int(counts.max())
        # each touched row read and written once, dY and the sorted stream read once
        base = dY.numel() * 2 + L * 16
        flops = L * E * 2 + U * E * 2
        chain_ms = longest * 4 / (ghz * 1e9) * 1e3  # one dependent fp32 add (4 cycles) a lookup
        log(f"row update, {tag} indices: L {L}, {U} runs, longest {longest} lookups; the serial "
            f"chain of the longest run: {chain_ms:.4f} ms at {ghz:.3f} GHz (4-cycle fp32 add)")
        for name, keys in (("embedding_update", ("hi", "lo")), ("embedding_update_fp32", ("w",))):
            e = entries[name]
            # the plain version, timed on the host clock (it syncs with the
            # host to sum on the CPU), then the kernel on a copy of the table
            if keys == ("w",):
                store, want = {"w": W32.clone()}, {"w": W32.clone()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref.fused_update_fp32(want["w"], *stream, dY, lr)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                ops.fused_update_fp32(store["w"], *stream, dY, lr)
            else:
                store = {k: state["emb"][k].clone() for k in keys}
                want = {k: state["emb"][k].clone() for k in keys}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref.fused_update_split(want["hi"], want["lo"], *stream, dY, lr)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                ops.fused_update_split(store["hi"], store["lo"], *stream, dY, lr)
            torch.cuda.synchronize()
            for k in keys:
                err = bitwise_or_fail(f"{name} [{L} lookups -> {rows}x{E}] {tag}, {k}", store[k],
                                      want[k], failures)
                e["max_abs_err"] = max(e["max_abs_err"], err)
            bms, by = bound_ms(base + U * E * 4 * 2, flops, FP32_FLOPS)
            if keys == ("w",):
                def kern():
                    ops.fused_update_fp32(store["w"], *stream, dY, lr)
            else:
                def kern():
                    ops.fused_update_split(store["hi"], store["lo"], *stream, dY, lr)
            t = dict(ms=time_ms(kern), plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, chain_ms=chain_ms, longest=longest, runs=U)
            if keys == ("w",):
                # the library yardstick: index_add_ of pre-gathered rows (atomics: no fixed order)
                g = torch.where(stream[2][:, None] != 0, dY[stream[1].long()].float(), 0.0)
                r64 = stream[0].long()
                t["library_ms"] = time_ms(lambda: store["w"].index_add_(0, r64, g, alpha=-lr))
                del g
            else:
                t["library_ms"] = None  # no PyTorch call splits fp32 into halves
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            log(f"  {name} {tag}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, "
                f"library {lib}, bound {bms:.4f} ms ({by}, {(base + U * E * 8) / 1e6:.1f} MB), "
                f"{t['ms'] / chain_ms:.2f}x the longest run's serial chain")
            if tag == "zipf":
                e.update(t)
            else:
                e["uniform"] = t
            del store, want

    # row 4 at the dense update's shape: the padded dense vector of dlrm-small
    lo = state["dense"]["lo"]
    n = lo.numel()
    hi = dp.flat_hi(state["dense"]["hi"], n).clone()
    lo = lo.clone()
    g = torch.randn(n, device=dev) * 1e-3
    want_h, want_l = ref.split_sgd(hi.clone(), lo.clone(), g, lr)
    ops.split_sgd(hi, lo, g, lr)
    torch.cuda.synchronize()
    e = {"name": "split_sgd", "max_abs_err": max(
        bitwise_or_fail(f"split_sgd [{n}] hi", hi, want_h, failures),
        bitwise_or_fail(f"split_sgd [{n}] lo", lo, want_l, failures))}
    bms, by = bound_ms(n * 12, n * 2, FP32_FLOPS)
    e.update(ms=time_ms(lambda: ops.split_sgd(hi, lo, g, lr)),
             plain_ms=time_ms(lambda: ref.split_sgd(hi, lo, g, lr)), bound_ms=bms, bound_by=by,
             library_ms=None)  # no PyTorch call splits fp32 into halves
    log(f"  split_sgd [{n}]: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by}, {n * 12 / 1e6:.1f} MB)")
    return [entries["embedding_update"], entries["embedding_update_fp32"], e]


def stage_batches(cfg, n: int, dev) -> list[dict]:
    """n zipf(1.05) batches from the port's synthetic stream, on the card."""
    import torch
    from repro_torch.data.synthetic import dlrm_stream
    out = []
    for b, _ in zip(dlrm_stream(SEED, cfg, ALPHA), range(n)):
        out.append({"idx": torch.from_numpy(b["idx"]).to(dev),
                    "dense_x": torch.from_numpy(b["dense_x"]).to(dev).to(torch.bfloat16),
                    "labels": torch.from_numpy(b["labels"]).to(dev)})
    return out


def training_phase(cfg, state, batches, dev, failures) -> dict:
    """The main path of training: make_train_step over the staged batches,
    every loss finite, one launch a step of each training kernel, one step
    without a host sync, one step against the same step on the CPU (every
    kernel's plain version), samples per second, and where a step's time
    goes.  Returns the launch counts of the timed steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import weights
    from repro_torch.core import dlrm
    from repro_torch.core import sharded_embedding as se
    from repro_torch.kernels import ops
    from repro_torch.optim import row as row_optim

    step = dlrm.make_train_step(cfg, device=dev)
    cpu_step = dlrm.make_train_step(cfg, device="cpu")

    # one step against the plain versions, from a copy of the state on the CPU
    ref_state = weights.state_to(state, "cpu")
    before = weights.state_to(state, "cpu")
    t0 = time.perf_counter()
    ref_state, ref_loss = cpu_step(ref_state, {k: v.cpu() for k, v in batches[0].items()})
    cpu_s = time.perf_counter() - t0
    state, loss = step(state, batches[0])
    torch.cuda.synchronize()
    log(f"one step against the plain versions on the CPU ({cpu_s:.1f} s there): loss {float(loss):.7f} "
        f"vs {float(ref_loss):.7f}")
    close_or_fail("train step loss vs plain step", loss.cpu(), ref_loss, TRAIN_TOL["loss"], 0.0,
                  failures)
    for part, fn in (("embedding store", master), ("dense weights", dense_master)):
        key = "emb" if part == "embedding store" else "dense"
        got, want, old = fn(state[key]).cpu(), fn(ref_state[key]), fn(before[key])
        upd = float((want - old).abs().max())
        close_or_fail(f"train step, {part} vs plain step (atol {TRAIN_TOL['update']:g} x the "
                      f"largest update, {upd:.3e})", got, want, 0.0, TRAIN_TOL["update"] * upd,
                      failures)
    del ref_state, before

    # no host sync between the batch's arrival and the returned loss
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batches[1])
    except RuntimeError as e:
        failures.append(f"the train step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("one train step under torch.cuda.set_sync_debug_mode('error'): no host sync")

    ops.reset_launches()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches()
    losses = torch.stack(losses).cpu().numpy()
    n = len(batches)
    log(f"trained {n} steps of B={cfg.batch} in {wall:.3f} s: {n * cfg.batch / wall:.0f} samples/s, "
        f"{wall / n * 1e3:.2f} ms a step; losses {losses[0]:.6f} -> {losses[-1]:.6f}")
    log(f"kernel launches in {n} steps: {counts}")
    if not np.isfinite(losses).all():
        failures.append(f"a loss is not finite: {losses}")
    want = {**{k: 0 for k in counts}, "embedding_bag": n, "dot_interaction": n,
            "embedding_update": n, "split_sgd": n}
    if counts != want:
        failures.append(f"launches {counts}, want {want} (one a step, fused_mlp none)")

    # where a step's time goes: the stages one by one between CUDA events
    st = step.stages
    layout = se.make_layout(cfg.spec, 1)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    opt = row_optim.resolve(cfg)
    names = ("sort", "bag fwd", "dense fwd+bwd", "row update", "dense update")
    totals = dict.fromkeys(names, 0.0)
    reps = 5
    for b in batches[:reps]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        g = (b["idx"] + offsets[None, :, None]).reshape(-1)
        stream = se._row_sorted_streams(layout, g, cfg.pooling)
        ev[1].record()
        emb_out = st.embedding_fwd(row_optim.fwd_weights(opt, state["emb"]), b["idx"])
        ev[2].record()
        _, g_dense, d_emb = st.dense_fwd_bwd(state["dense"]["hi"], emb_out, b)
        dY = st.dY_exchange(d_emb)
        ev[3].record()
        row_optim.apply_sparse(opt, state["emb"], stream, dY.reshape(-1, cfg.emb_dim), cfg.lr)
        ev[4].record()
        state["dense"] = st.dense_update(state["dense"], g_dense)
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            totals[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    log("a step by stage (ms, CUDA events, mean of 5): "
        + "; ".join(f"{k} {v:.3f}" for k, v in totals.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[:reps]:
            state, loss = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"train step under torch.profiler: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"({(1 - busy_ms / wall_ms) * 100:.1f}% idle); top kernels: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / reps / 1e3:.4f} ms x"
                    f"{e.count // reps}" for e in top))
    return counts


def sgd_phase(cfg, dev, batches, failures) -> dict:
    """3 steps with the fp32 table (``sparse_optimizer="sgd"``): the row 6
    kernel on a path.  Returns the launch counts of those steps."""
    import torch
    from repro_torch.core import dlrm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    state = dlrm.init_state(cfg, gen, device=dev)
    log(f"sgd state: w {tuple(state['emb']['w'].shape)} fp32, "
        f"{state['emb']['w'].numel() * 4 / 1e9:.3f} GB")
    step = dlrm.make_train_step(cfg, device=dev)
    ops.reset_launches()
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = ops.launches()
    losses = torch.stack(losses).cpu().numpy()
    log(f"sgd: {len(batches)} steps, losses {losses}; launches {counts}")
    if not np.isfinite(losses).all():
        failures.append(f"sgd: a loss is not finite: {losses}")
    if counts["embedding_update_fp32"] != len(batches) or counts["embedding_update"] != 0:
        failures.append(f"sgd: launches {counts}")
    return counts


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
    from repro_torch.core import dlrm
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

    # training: dlrm-small at full size, split_sgd, then sgd
    t_cfg = dlrm_small()
    t0 = time.perf_counter()
    state = dlrm.init_state(t_cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batches = stage_batches(t_cfg, N_TRAIN, dev)
    torch.cuda.synchronize()
    log(f"train state: hi {tuple(state['emb']['hi'].shape)} bf16 + lo int16, "
        f"{sum(v.numel() * v.element_size() for v in state['emb'].values()) / 1e9:.3f} GB, dense "
        f"{state['dense']['lo'].numel()} values padded; {N_TRAIN} batches staged; "
        f"{time.perf_counter() - t0:.1f} s")
    kernels += row_kernel_phase(t_cfg, state, offsets, batches[0], dev, rng, failures)
    if failures:
        raise SystemExit("row kernel phase failed:\n" + "\n".join(failures))
    train_counts = training_phase(t_cfg, state, batches, dev, failures)
    if failures:
        raise SystemExit("training phase failed:\n" + "\n".join(failures))
    del state
    torch.cuda.empty_cache()
    sgd_counts = sgd_phase(dataclasses.replace(t_cfg, sparse_optimizer="sgd"), dev, batches[:3],
                           failures)
    if failures:
        raise SystemExit("sgd phase failed:\n" + "\n".join(failures))
    counts.update(embedding_update=train_counts["embedding_update"],
                  split_sgd=train_counts["split_sgd"],
                  embedding_update_fp32=sgd_counts["embedding_update_fp32"])

    routes = {"embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                                "src/repro/kernels/embedding_bag.py:31"),
              "dot_interaction": ("src/repro_torch/csrc/interaction.cu",
                                  "src/repro/kernels/interaction.py:22"),
              "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                            "src/repro/kernels/fused_mlp.py:22"),
              "embedding_update": ("src/repro_torch/csrc/embedding_update.cu",
                                   "src/repro/kernels/embedding_update.py:82"),
              "embedding_update_fp32": ("src/repro_torch/csrc/embedding_update.cu",
                                        "src/repro/kernels/embedding_update.py:114"),
              "split_sgd": ("src/repro_torch/csrc/split_sgd.cu",
                            "src/repro/kernels/split_sgd.py:18")}
    line = []
    u = kernels[0]["uniform"]
    log(f"embedding_bag, uniform indices: kernel {u['ms']:.4f} ms, library {u['library_ms']:.4f} ms, "
        f"bound {u['bound_ms']:.4f} ms ({u['bound_by']}), {u['bound_ms'] / u['ms'] * 100:.1f}% of bound")
    for k in kernels[3:5]:
        u = k["uniform"]
        log(f"{k['name']}, uniform indices: kernel {u['ms']:.4f} ms, plain {u['plain_ms']:.1f} ms, "
            f"bound {u['bound_ms']:.4f} ms ({u['bound_by']}), {u['bound_ms'] / u['ms'] * 100:.1f}% "
            f"of bound; zipf: longest run {k['longest']}, serial chain {k['chain_ms']:.4f} ms")
    for k in kernels:
        src, replaces = routes[k["name"]]
        line.append({"name": k["name"], "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[k["name"]], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {lib}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
            f"{k['bound_ms'] / k['ms'] * 100:.1f}% of bound")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
