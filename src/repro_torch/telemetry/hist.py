"""Bounded-memory latency histogram with quantile readout (copy of
``repro/telemetry/hist.py``, so the port needs nothing of ``repro``).

The serve loop's p50/p99 report used to keep every latency sample in an
unbounded Python list — fine for a bench, wrong for a server meant to
stay up under heavy traffic.  :class:`LatencyHistogram` keeps
log-spaced buckets instead: O(1) record, O(buckets) quantile, memory
fixed regardless of request count, relative quantile error bounded by
the bucket growth factor (2% by default).

Units are caller-defined (the serve loop records milliseconds); the
histogram only assumes positive values.  Thread-safe: ``record`` may be
called from multiple serving threads.
"""

from __future__ import annotations

import math
import threading


class LatencyHistogram:
    """Log-bucketed histogram over ``[lo, hi)`` with ``growth``-factor
    bucket widths.  Values below ``lo`` land in the first bucket, above
    ``hi`` in the last (and are still exact in min/max/mean)."""

    def __init__(self, lo: float = 1e-3, hi: float = 1e5, growth: float = 1.02):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"need 0 < lo < hi and growth > 1, got {lo}, {hi}, {growth}")
        self.lo = lo
        self.growth = growth
        self._log_lo = math.log(lo)
        self._log_g = math.log(growth)
        self.nbuckets = int(math.ceil((math.log(hi) - self._log_lo) / self._log_g)) + 1
        self.counts = [0] * self.nbuckets
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        b = int((math.log(v) - self._log_lo) / self._log_g)
        return min(b, self.nbuckets - 1)

    def record(self, v: float) -> None:
        b = self._bucket(v)
        with self._lock:
            self.counts[b] += 1
            self.n += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (geometric bucket midpoint; clamped to
        the exact observed min/max so q=0/1 are honest)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.n == 0:
                return 0.0
            # rank of the q-quantile under the 'lower' convention
            rank = min(self.n - 1, int(q * self.n))
            seen = 0
            for b, c in enumerate(self.counts):
                seen += c
                if seen > rank:
                    mid = math.exp(self._log_lo + (b + 0.5) * self._log_g)
                    return min(max(mid, self.vmin), self.vmax)
            return self.vmax

    def summary(self) -> dict:
        """{p50, p99, mean, min, max, n} — empty dict when no samples
        (matches the serve loop's historical contract)."""
        with self._lock:
            n, total = self.n, self.total
            vmin, vmax = self.vmin, self.vmax
        if n == 0:
            return {}
        return {
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
            "mean": total / n,
            "min": vmin,
            "max": vmax,
            "n": n,
        }
