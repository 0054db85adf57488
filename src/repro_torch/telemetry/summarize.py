"""A trace's summary (twin of ``repro/telemetry/summarize.py``): per track,
per span name, the count, total and mean wall time, and the modelled bytes
and flops the stage spans carry.

``python -m repro_torch.telemetry summarize <trace.json>`` reads a trace
that either package's tracer exported and prints the table (``--json``: the
aggregate).  The in-graph metrics' counter samples (``"repro.metrics"``)
become a metrics section: the cumulative totals, the last drain's window
and the hit rates, in the fp32 arithmetic of ``telemetry.metrics``.  Of one
file, this summary and the reference's are equal.
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.telemetry import metrics as _metrics

METRICS_COUNTER = "repro.metrics"


def load_events(path) -> list[dict]:
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, dict):
        return doc.get("traceEvents", [])
    return doc  # bare-array form is also valid Chrome trace JSON


def summarize(path) -> dict:
    """Aggregate a trace file into ``{"tracks", "metrics", "instants",
    "serve"}``.

    tracks:   track name -> span name -> {count, total_ms, mean_ms,
              modeled_bytes, modeled_flops} (byte/flop columns only when
              the spans carried them)
    metrics:  {"cumulative", "last_window", "hit_rate",
               "last_window_hit_rate", "drains"} from the
              ``repro.metrics`` counter samples (empty when none)
    instants: event name -> count (failure-log events etc.)
    serve:    aggregate over ``serve/*`` spans — total batches/requests/
              time plus a per-bucket breakdown of the serve/batch spans
              (empty when the trace has no serving traffic)
    """
    events = load_events(path)
    track_of: dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            track_of[ev["tid"]] = ev.get("args", {}).get("name", str(ev["tid"]))

    tracks: dict[str, dict] = {}
    instants: dict[str, int] = {}
    drains: list[dict] = []
    serve: dict = {}
    for ev in events:
        ph = ev.get("ph")
        track = track_of.get(ev.get("tid"), str(ev.get("tid")))
        if ph == "X":
            row = tracks.setdefault(track, {}).setdefault(
                ev["name"], {"count": 0, "total_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += ev.get("dur", 0.0) / 1e3
            args = ev.get("args", {})
            for k in ("modeled_bytes", "modeled_flops", "modeled_us"):
                if k in args:
                    row[k] = float(args[k])   # per-dispatch model, not summed
            if ev["name"].startswith("serve/"):
                _fold_serve(serve, ev["name"], ev.get("dur", 0.0) / 1e3, args)
        elif ph == "i":
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
        elif ph == "C" and ev.get("name") == METRICS_COUNTER:
            drains.append((ev.get("ts", 0.0), ev.get("args", {})))
    for spans in tracks.values():
        for row in spans.values():
            row["mean_ms"] = row["total_ms"] / row["count"]

    drains.sort(key=lambda t: t[0])
    samples = [d for _, d in drains]
    metrics: dict = {}
    if samples:
        cum = samples[-1]
        win = _metrics.window(cum, samples[-2] if len(samples) > 1 else None)
        metrics = {
            "cumulative": cum,
            "last_window": win,
            "hit_rate": _metrics.hit_rate(cum),
            "last_window_hit_rate": _metrics.hit_rate(win),
            "drains": len(samples),
        }
    for row in serve.values():
        row["mean_ms"] = row["total_ms"] / row["count"]
        for b in row.get("by_bucket", {}).values():
            b["mean_ms"] = b["total_ms"] / b["count"]
    return {"tracks": tracks, "metrics": metrics, "instants": instants,
            "serve": serve}


def _fold_serve(serve: dict, name: str, dur_ms: float, args: dict) -> None:
    """Fold one ``serve/*`` span into the serve aggregate: batch/request
    counts and wall time, split per compiled bucket when the span says
    which bucket it ran (serve/batch spans from the continuous server)."""
    row = serve.setdefault(name, {"count": 0, "total_ms": 0.0, "requests": 0})
    row["count"] += 1
    row["total_ms"] += dur_ms
    row["requests"] += int(args.get("n", 0))
    if "bucket" in args:
        b = row.setdefault("by_bucket", {}).setdefault(
            str(args["bucket"]), {"count": 0, "total_ms": 0.0, "requests": 0})
        b["count"] += 1
        b["total_ms"] += dur_ms
        b["requests"] += int(args.get("n", 0))


def _fmt_qty(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def format_summary(s: dict) -> str:
    lines = []
    for track in sorted(s["tracks"]):
        lines.append(f"track: {track}")
        lines.append(f"  {'span':<28} {'count':>7} {'total_ms':>10} "
                     f"{'mean_ms':>9} {'bytes':>9} {'flops':>9}")
        spans = s["tracks"][track]
        for name in sorted(spans, key=lambda n: -spans[n]["total_ms"]):
            r = spans[name]
            b = _fmt_qty(r["modeled_bytes"]) if "modeled_bytes" in r else "-"
            f = _fmt_qty(r["modeled_flops"]) if "modeled_flops" in r else "-"
            lines.append(f"  {name:<28} {r['count']:>7} "
                         f"{r['total_ms']:>10.3f} {r['mean_ms']:>9.3f} "
                         f"{b:>9} {f:>9}")
    if s.get("serve"):
        lines.append("serve spans:")
        lines.append(f"  {'span / bucket':<28} {'count':>7} {'reqs':>7} "
                     f"{'total_ms':>10} {'mean_ms':>9}")
        for name in sorted(s["serve"]):
            r = s["serve"][name]
            lines.append(f"  {name:<28} {r['count']:>7} {r['requests']:>7} "
                         f"{r['total_ms']:>10.3f} {r['mean_ms']:>9.3f}")
            for bk in sorted(r.get("by_bucket", {}), key=int):
                b = r["by_bucket"][bk]
                lines.append(f"    bucket {bk:<19} {b['count']:>7} "
                             f"{b['requests']:>7} {b['total_ms']:>10.3f} "
                             f"{b['mean_ms']:>9.3f}")
    if s["instants"]:
        lines.append("instant events:")
        for name in sorted(s["instants"]):
            lines.append(f"  {name:<28} {s['instants'][name]:>7}")
    m = s["metrics"]
    if m:
        lines.append(f"in-graph metrics ({m['drains']} drains):")
        lines.append(f"  {'slot':<24} {'cumulative':>14} {'last_window':>14}")
        for k in m["cumulative"]:
            lines.append(f"  {k:<24} {m['cumulative'][k]:>14.0f} "
                         f"{m['last_window'].get(k, 0.0):>14.0f}")
        lines.append(f"  {'hit_rate':<24} {m['hit_rate']:>14.9f} "
                     f"{m['last_window_hit_rate']:>14.9f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="offline analysis of exported telemetry traces")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("summarize",
                        help="per-track/per-span time+bytes table")
    ps.add_argument("trace", help="trace.json exported by the tracer")
    ps.add_argument("--json", action="store_true",
                    help="emit the aggregate as JSON instead of a table")
    args = ap.parse_args(argv)
    s = summarize(args.trace)
    if args.json:
        print(json.dumps(s, indent=2, sort_keys=True))
    else:
        print(format_summary(s))
    return 0
