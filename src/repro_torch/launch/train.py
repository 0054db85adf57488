"""Training launcher (twin of ``repro/launch/train.py``, its DLRM path).

Runs reduced-scale DLRMs on the local cards, or on the CPU with ``--device
cpu`` (the kernels' plain PyTorch versions).  Examples:

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-small --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-100m --device cpu

``--arch dlrm-100m`` is the ~103 M-parameter model; any other ``dlrm*`` name
is the small reduced config (8 tables of 5,000 rows), as in the reference,
so ``--arch dlrm-small`` here is not the paper's dlrm-small.  The mesh is
the reference's ``local_mesh`` over ``--ranks`` ranks (default: one a card,
one on the CPU): ``(n // 4, 4)`` from 8 ranks, ``(1, n)`` below.  One rank
runs in this process; N ranks run one process each
(``launch.local.run_ranks``: NCCL with a card a rank, gloo on the CPU or
when ranks share a card), every rank reading the same global stream and
training its shard; the kernels are built once, before the ranks start.

The DLRM can stream a PACKED dataset instead of the in-process synthetic
generator:

    python -m repro_torch.data synthetic --out /data/ds \\
        --tables 5000,5000,5000,5000,5000,5000,5000,5000 --pooling 10 \\
        --num-dense 64 --num-samples 65536
    python -m repro_torch.launch.train --arch dlrm-small --data-dir /data/ds \\
        --data-format packed --host-presort

``--host-presort`` moves the sparse update's index sort off the card and
into the loader's worker thread (``data/pipeline.py``); ``--optimizer``
selects the sparse row optimizer (``optim/row.py``).  ``--publish-every``
and ``--serve-smoke`` publish serving snapshots from the loop and serve
them (one rank).  Refused, each naming its ROADMAP item: the recsys archs
(fm, bst, sasrec, din; item 9), the LM archs (item 8) and publishing or
serving at more than one rank (item 7).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.launch.local import backend_for, rank_device, run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainLoop, TrainLoopConfig

RECSYS_ARCHS = ("fm", "bst", "sasrec", "din")


def local_mesh_shape(n: int) -> tuple[int, int]:
    """The reference's ``local_mesh`` over ``n`` devices: ``(n // 4, 4)``
    from 8, ``(1, n)`` below."""
    if n >= 8:
        return (n // 4, 4)
    return (1, max(n, 1))


def packed_stream(args, cfg, layout, host_presort: bool, verbose: bool = True):
    """The packed-shard loader chain: ``ShardedReader`` (mmap + two-level
    shuffle) -> ``HostPipeline`` (threaded decode + optional per-batch
    pre-sort).  The dataset's spec must match the model: a mismatch fails
    here, at wiring time, not inside the step."""
    from repro_torch.data.pipeline import HostPipeline
    from repro_torch.data.reader import ShardedReader
    reader = ShardedReader(args.data_dir, batch=cfg.batch, seed=args.seed, shuffle=True)
    reader.spec.check_model(cfg)
    if reader.spec.weighted and not cfg.weighted:
        raise SystemExit("dataset carries per-lookup weights but the model "
                         "is unweighted — pass --weighted (or repack "
                         "without weights)")
    if verbose:
        print(f"[train] packed dataset: {reader.num_samples} samples in "
              f"{len(reader.shards)} shard(s), "
              f"{reader.batches_per_epoch()} batches/epoch"
              + (", host pre-sort ON" if host_presort else ""))
    return HostPipeline(reader, layout=layout, presort=host_presort)


def serve_smoke(cfg, publisher, batch: dict, buckets: tuple, device) -> dict:
    """Post-train serving smoke (``--serve-smoke``): continuous batching over
    the published snapshot with a burst of single-sample requests sliced
    from one synthetic batch; per-bucket latency and freshness printed.  A
    weighted model's requests carry weights of one (the synthetic stream
    has none)."""
    from repro_torch.serve import ContinuousBatchingServer, make_bucket_scorers
    registry = publisher.registry
    score_fns, pad_batch = make_bucket_scorers(cfg, buckets, lambda: registry.current().state,
                                               device=device)
    batch = dict(batch)
    if cfg.weighted and "weights" not in batch:
        batch["weights"] = np.ones(batch["idx"].shape, np.float32)
    n = int(np.asarray(batch["idx"]).shape[0])
    payloads = [{k: np.asarray(v)[i] for k, v in batch.items()} for i in range(n)]
    with ContinuousBatchingServer(score_fns, pad_batch, max_wait_ms=2.0) as srv:
        handles = [srv.submit(p) for p in payloads]
        scores = [h.result(timeout=120.0) for h in handles]
        stats = srv.stats()
        pct = srv.percentiles()
    print(f"[serve] smoke: {len(scores)} requests scored in "
          f"{sum(stats['batches'].values())} batches "
          f"(padded rows: {stats['padded']})")
    for b in sorted(pct):
        p = pct[b]
        print(f"[serve]   bucket {b:>4}: p50 {p['p50_ms']:8.2f} ms   "
              f"p99 {p['p99_ms']:8.2f} ms   n={p['n']}")
    f = publisher.freshness()
    print(f"[serve] snapshot v{f['version']}: {f['steps_behind']} steps / "
          f"{f['seconds_behind']:.2f}s behind the training head")
    return {"scores": np.asarray(scores, np.float32), "percentiles": pct, "freshness": f}


def reduced_dlrm(name: str, batch: int):
    from repro_torch.core.dlrm import DLRMConfig
    if name == "dlrm-100m":
        # ~103M params: the end-to-end "train a ~100M model" run
        return DLRMConfig(name=name, num_dense=64, bottom=(128, 64),
                          top=(256, 128), table_rows=(200_000,) * 8,
                          emb_dim=64, pooling=20, batch=batch)
    return DLRMConfig(name=name, num_dense=64, bottom=(64, 32),
                      top=(64, 32), table_rows=(5000,) * 8, emb_dim=32,
                      pooling=10, batch=batch)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default=None,
                    help="sparse RowOptimizer for the embedding path "
                         "(repro_torch/optim/row.py): sgd | split_sgd | momentum "
                         "| adagrad_rowwise | adagrad | momentum_bf16 | "
                         "adagrad_bf16 (the _bf16 kinds store compressed "
                         "bf16-hi state with seeded stochastic rounding) | "
                         "adagrad_freq (frequency-adaptive LR off the "
                         "hot-row cache's touch counters); default keeps "
                         "the arch's configured optimizer (split_sgd)")
    ap.add_argument("--beta", type=float, default=None,
                    help="momentum coefficient override for --optimizer")
    ap.add_argument("--eps", type=float, default=None,
                    help="adagrad denominator floor override for "
                         "--optimizer")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint cadence in completed steps (preemption "
                         "cost: up to ckpt-every-1 steps of lost work)")
    ap.add_argument("--skip-batch-budget", type=int, default=0,
                    help="transient loader failures absorbed per run "
                         "(each skip is logged; beyond the budget the "
                         "failure propagates)")
    ap.add_argument("--event-log", default=None,
                    help="append structured failure/recovery events "
                         "(checkpoint retries, corrupt-checkpoint skips, "
                         "batch skips, preemptions) to this .jsonl file")
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="index-skew for sparse streams (paper Fig. 8)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="staged-pipeline microbatches (core/pipeline.py): "
                         "double-buffered index exchange overlap")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host-side copy-ahead window to the device (0 = off)")
    ap.add_argument("--data-dir", default=None,
                    help="packed-shard dataset directory (python -m "
                         "repro_torch.data packs one)")
    ap.add_argument("--data-format", choices=("synthetic", "packed"),
                    default=None,
                    help="batch source; defaults to 'packed' when "
                         "--data-dir is given, else 'synthetic'")
    ap.add_argument("--host-presort", action="store_true",
                    help="pre-sort the sparse-update index stream on the "
                         "loader thread (row and table mode; drops the "
                         "on-device sort from the step)")
    ap.add_argument("--seed", type=int, default=0,
                    help="data order seed (reader epoch shuffle); also "
                         "seeds the stochastic-rounding counter of the "
                         "_bf16 compressed-state optimizers")
    ap.add_argument("--weighted", action="store_true",
                    help="weighted bags: consume the packed dataset's "
                         "per-lookup weight arrays")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="frequency-tiered hot-row cache (core/cache.py): "
                         "mirror the top-K touched rows PER TABLE on "
                         "every rank so hot bags skip the all-to-all "
                         "(table mode); 0 = off")
    ap.add_argument("--promote-every", type=int, default=1,
                    help="hot-set promotion cadence in steps (counter-"
                         "driven, deterministic across ranks/restarts)")
    ap.add_argument("--hot-sync", default="allreduce",
                    help="hot-slab refresh: 'allreduce' (every step; "
                         "bitwise == cache off) or 'deferred:N' (refresh "
                         "every N steps; bounded staleness)")
    ap.add_argument("--exchange-dtype", default=None,
                    choices=("fp32", "bf16", "bf16_sr"),
                    help="wire format of the dY exchange + dense gradient "
                         "reduce-scatter (dist/exchange.py): fp32 = the "
                         "bitwise wire, bf16 = round-to-nearest (the dense "
                         "leg carries error feedback), bf16_sr = seeded "
                         "stochastic rounding (deterministic, "
                         "checkpoint-replayable)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable the process tracer: writes "
                         "<dir>/trace.json (Chrome trace-event JSON, open in "
                         "Perfetto; python -m repro_torch.telemetry "
                         "summarize reads it), <dir>/heartbeat.jsonl "
                         "(per-window train-loop heartbeats) and — unless "
                         "--event-log points elsewhere — "
                         "<dir>/events.jsonl; appends a per-stage pipeline "
                         "profile to the trace (rank 0)")
    ap.add_argument("--step-metrics", action="store_true",
                    help="accumulate in-graph step metrics (cache hits, "
                         "rows touched, exchange payload bytes) in a "
                         "replicated state vector, drained every "
                         "--metrics-every steps")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="in-graph metrics drain / heartbeat cadence "
                         "(steps)")
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="preemption drill: request a stop at this step "
                         "(records a 'preempted' event, writes the final "
                         "checkpoint) — gives smoke traces a fault track")
    ap.add_argument("--publish-every", type=int, default=0,
                    help="publish a read-only serving snapshot of the "
                         "forward slabs every N completed steps (one rank); "
                         "snapshot version and train-to-serve freshness "
                         "ride the heartbeat; 0 = off")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="after training, drive a continuous-batching "
                         "serving smoke over the published snapshot "
                         "(per-bucket latency percentiles printed)")
    ap.add_argument("--serve-buckets", default="8,32,128",
                    help="serving batch-shape ladder for --serve-smoke "
                         "(ascending, comma-separated)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises where there is no card) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks, one process each (default: one a card, one "
                         "on the CPU)")
    return ap


def refuse(args) -> None:
    """Every refusal of the reference's launcher, with its message, and the
    port's own: the archs it has no twin of yet, and publishing at more
    than one rank.  Raises ``SystemExit``."""
    if args.data_format is None:
        args.data_format = "packed" if args.data_dir else "synthetic"
    if args.data_format == "packed" and not args.data_dir:
        raise SystemExit("--data-format packed requires --data-dir")
    if args.weighted and args.data_format != "packed":
        raise SystemExit("--weighted needs a weighted packed dataset "
                         "(the synthetic streams carry no weights); pack "
                         "one with `python -m repro_torch.data synthetic "
                         "--weighted ...`")
    if args.host_presort and args.data_format != "packed":
        raise SystemExit("--host-presort rides the packed loader's worker "
                         "thread; add --data-dir/--data-format packed")
    if ((args.beta is not None or args.eps is not None)
            and args.optimizer is None):
        raise SystemExit("--beta/--eps tune a sparse optimizer; name one "
                         "with --optimizer")
    if args.optimizer is not None:
        from repro_torch.optim import row as row_optim
        row_optim.get(args.optimizer)   # unknown name fails here, loudly
    if args.arch.startswith("dlrm"):
        return
    if args.arch in RECSYS_ARCHS:
        raise SystemExit(f"--arch {args.arch}: the port has no recsys archetype "
                         "(fm, bst, sasrec, din) yet; ROADMAP queue 1 item 9")
    # the reference's LM branch refuses these before it trains
    if args.data_format == "packed":
        raise SystemExit("--data-dir/--data-format packed is the recsys "
                         "ingestion path (dlrm/fm/bst/sasrec/din); LM "
                         "archs stream tokens")
    if args.microbatches != 1:
        raise SystemExit(
            "--microbatches applies to the recsys hybrid pipeline "
            "(dlrm/fm/bst/sasrec/din); LM archs microbatch via "
            "TransformerConfig.microbatch instead")
    if args.optimizer is not None:
        raise SystemExit(
            "--optimizer selects the sparse embedding RowOptimizer of "
            "the recsys hybrid step (dlrm/fm/bst/sasrec/din); LM archs "
            "use the dense Split-SGD path")
    if args.hot_rows:
        raise SystemExit(
            "--hot-rows caches hot embedding rows of the recsys hybrid "
            "step (dlrm/fm/bst/sasrec/din); LM archs have no sparse "
            "embedding path")
    if args.exchange_dtype is not None:
        raise SystemExit(
            "--exchange-dtype compresses the recsys hybrid step's dY "
            "exchange + dense reduce-scatter (dlrm/fm/bst/sasrec/din); "
            "LM archs have no exchange collectives")
    if args.step_metrics:
        raise SystemExit(
            "--step-metrics counts the recsys hybrid step's sparse "
            "traffic (dlrm/fm/bst/sasrec/din); LM archs have no "
            "metrics vector")
    if args.publish_every or args.serve_smoke:
        raise SystemExit(
            "--publish-every/--serve-smoke publish the recsys serving "
            "snapshot (dlrm/fm/bst/sasrec/din); LM archs have no "
            "serving path")
    raise SystemExit(f"--arch {args.arch}: the port does not train LMs yet (it serves "
                     "internlm2 and gemma2); ROADMAP queue 1 item 8")


def run(rank: int, world: int, args) -> dict:
    """One rank's run of the launcher: returns its losses, the step it
    started from (a restore) and, on rank 0 with ``--serve-smoke``, the
    serving smoke's scores."""
    from repro_torch.core import dlrm as D
    from repro_torch.core import hybrid
    from repro_torch.data.synthetic import dlrm_stream

    lead = rank == 0
    dev = rank_device(args.device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(local_mesh_shape(world), ("data", "model"), device=dev)
    if lead:
        print(f"[train] devices={world} ({dev.type}) mesh={mesh.shape}")
    if args.trace_dir and lead:
        tracer = telemetry.configure(enabled=True, trace_dir=args.trace_dir)
        tracer.reset()  # this run's trace holds this run's events
    cfg = dataclasses.replace(reduced_dlrm(args.arch, args.batch), lr=args.lr,
                              sparse_optimizer=args.optimizer,
                              opt_beta=args.beta, opt_eps=args.eps,
                              microbatches=args.microbatches,
                              host_presort=args.host_presort,
                              weighted=args.weighted, sr_seed=args.seed,
                              hot_rows=args.hot_rows,
                              promote_every=args.promote_every,
                              hot_sync=args.hot_sync,
                              exchange_dtype=args.exchange_dtype,
                              step_metrics=args.step_metrics)
    state = D.init_state(cfg, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    step = D.make_train_step(cfg, mesh)
    if args.data_format == "packed":
        stream = packed_stream(args, cfg, hybrid.make_layout(cfg, mesh), args.host_presort,
                               verbose=lead)
    else:
        stream = dlrm_stream(0, cfg, args.alpha)
    if lead:
        n_params = cfg.spec.total_rows * cfg.emb_dim
        print(f"[train] {args.arch}: ~{n_params/1e6:.1f}M embedding params")

    publisher = None
    serve_stats = None
    if args.publish_every or args.serve_smoke:
        from repro_torch.serve import SnapshotPublisher, combined_serve_stats
        publisher = SnapshotPublisher(cfg, publish_every=args.publish_every or max(args.steps, 1))
        publisher.publish(0, state)   # v1: tables before training starts
        serve_stats = combined_serve_stats(publisher)
        print(f"[serve] snapshot v1 published "
              f"({publisher.registry.current().emb_bytes / 1e6:.2f} MB "
              f"serving table), cadence {publisher.publish_every} steps")

    event_log = None
    if lead and (args.event_log or args.trace_dir):
        from repro_torch.faults import FailureLog
        event_log = FailureLog(args.event_log or str(Path(args.trace_dir) / "events.jsonl"))
    faults = None
    if args.preempt_at is not None:  # on every rank: all stop at one step
        from repro_torch.faults import FaultPlan
        faults = FaultPlan.single("train.step", "preempt", step=args.preempt_at)
        faults.log = event_log
    heartbeat_path = (str(Path(args.trace_dir) / "heartbeat.jsonl")
                      if args.trace_dir and lead else None)
    loop = TrainLoop(
        TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        prefetch=args.prefetch, skip_batch_budget=args.skip_batch_budget,
                        heartbeat_path=heartbeat_path, heartbeat_every=args.metrics_every,
                        metrics_every=args.metrics_every),
        step, state, stream, faults=faults, event_log=event_log, step_hook=publisher,
        serve_stats=serve_stats, mesh=mesh, model_cfg=cfg)
    out = {"start_step": loop.start_step}
    try:
        loop.run()
        if args.trace_dir and lead:
            from repro_torch.telemetry import stages as stage_profiler
            print("[train] profiling pipeline stages (barrier mode)")
            stage_profiler.profile_stages(cfg, tracer=telemetry.get_tracer(), device=dev)
        if args.serve_smoke:
            buckets = tuple(int(b) for b in args.serve_buckets.split(","))
            out["serve"] = serve_smoke(cfg, publisher, next(dlrm_stream(1, cfg, args.alpha)),
                                       buckets, dev)
    finally:
        if hasattr(stream, "close"):
            stream.close()        # release the HostPipeline worker
        if args.trace_dir and lead:
            path = telemetry.export()
            telemetry.configure(enabled=False)
            print(f"[train] trace written: {path}")
    out["losses"] = list(loop.losses)
    if lead and loop.losses:
        print(f"[train] done: first loss {loop.losses[0]:.4f} "
              f"-> last {loop.losses[-1]:.4f}")
    if lead and loop.monitor.events:
        print(f"[train] stragglers observed: {len(loop.monitor.events)}")
    return out


def main(argv=None) -> dict:
    """Parse ``argv`` (``sys.argv[1:]`` when None), refuse what the port
    cannot run, and train: one rank in this process, N ranks in N
    processes.  Returns rank 0's :func:`run` result."""
    from repro_torch import resolve_device
    args = parser().parse_args(argv)
    refuse(args)
    dev = resolve_device(args.device)  # raises where there is no card
    world = args.ranks or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if world > 1 and (args.publish_every or args.serve_smoke):
        raise SystemExit("--publish-every/--serve-smoke at more than one rank: the port "
                         "serves one rank, row mode; ROADMAP queue 1 item 7")
    if world == 1:
        return run(0, 1, args)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load()  # once here, so that the ranks find the libraries built
    return run_ranks(run, world, (args,), backend=backend_for(args.device, world),
                     timeout_s=3600)[0]


if __name__ == "__main__":
    main()
