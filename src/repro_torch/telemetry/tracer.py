"""Host-side tracer: nestable spans and instants -> Chrome trace JSON (the
span, instant, counter and track parts of ``repro/telemetry/tracer.py``, copied so the
port needs nothing of ``repro``).

``span()`` on a disabled tracer (the default) returns a shared no-op context
manager after one attribute check: nothing is allocated and no clock is
read, so the serving loop keeps its span compiled in.  Enabled, each span is
a complete ('X') event on its thread's track, or on a named virtual track
(``track=``: the checkpoint writer's spans land on ``ckpt_writer`` from
whichever thread writes); :meth:`Tracer.set_track` renames the calling
thread's track, :meth:`Tracer.instant` records a zero-length marker
(failure-log events, heartbeats) and :meth:`Tracer.counter` a counter
sample (the drained step metrics); :meth:`Tracer.export` writes
``{"traceEvents": [...]}``, loadable in Perfetto or ``chrome://tracing``.
Timestamps are microseconds on the ``perf_counter`` clock, zeroed when the
tracer was made.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Optional


class _NoopSpan:
    """Shared do-nothing context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: records its own start, emits a complete ('X') event
    on exit.  Created only when the tracer is enabled."""

    __slots__ = ("_tracer", "name", "cat", "args", "_tid", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._tid = tid
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": (self._t0 - tr._epoch) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": tr._pid,
            "tid": self._tid,
        }
        if self.cat:
            ev["cat"] = self.cat
        if self.args:
            ev["args"] = self.args
        with tr._lock:
            tr._events.append(ev)
        return False


class Tracer:
    """Collects spans; exports Chrome trace JSON.  ``enabled=False`` (the
    default) makes :meth:`span` a cheap no-op."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        # thread ident -> track name override; virtual track name -> tid
        self._thread_tracks: dict[int, str] = {}
        self._virtual_tids: dict[str, int] = {}
        self._named_tids: set[int] = set()

    def set_track(self, name: str) -> None:
        """Name the calling thread's track (overrides the thread name)."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        self._thread_tracks[tid] = name
        with self._lock:
            self._named_tids.discard(tid)  # re-emit the metadata with the new name

    def _tid(self, track: Optional[str] = None) -> int:
        if track is not None:
            with self._lock:
                tid = self._virtual_tids.get(track)
                if tid is None:
                    # virtual tracks get ids well away from real thread idents
                    tid = 1_000_000 + len(self._virtual_tids)
                    self._virtual_tids[track] = tid
                    self._events.append(_thread_name(self._pid, tid, track))
                    self._named_tids.add(tid)
            return tid
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._named_tids:
                name = self._thread_tracks.get(tid) or threading.current_thread().name
                self._events.append(_thread_name(self._pid, tid, name))
                self._named_tids.add(tid)
        return tid

    def span(self, name: str, cat: str = "", track: Optional[str] = None, **args):
        """Context manager timing the enclosed block; ``args`` are attached
        to the event; ``track`` places it on a named virtual track instead
        of the calling thread's."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, cat, self._tid(track), args)

    def instant(self, name: str, cat: str = "", track: Optional[str] = None, **args) -> None:
        """Zero-duration marker (failure-log events, heartbeats, ...)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "ts": (time.perf_counter() - self._epoch) * 1e6,
              "pid": self._pid, "tid": self._tid(track)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, values: dict, track: Optional[str] = None) -> None:
        """A counter sample ('C'): ``values`` maps series to numbers (the
        drained in-graph metrics, ``telemetry.metrics``: one event a drain,
        cumulative values)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "C", "ts": (time.perf_counter() - self._epoch) * 1e6,
              "pid": self._pid, "tid": self._tid(track),
              "args": {k: float(v) for k, v in values.items()}}
        with self._lock:
            self._events.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> Path:
        """Write ``{"traceEvents": [...]}`` JSON to ``path``."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"traceEvents": self.events(), "displayTimeUnit": "ms"}))
        return p


# The process-global tracer the serving loop emits to: enabling tracing is
# one configure() call, with no tracer threaded through every constructor.
_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def configure(enabled: bool = True) -> Tracer:
    """Enable (or disable) the process-global tracer."""
    _GLOBAL.enabled = enabled
    return _GLOBAL


def span(name: str, cat: str = "", track: Optional[str] = None, **args):
    return _GLOBAL.span(name, cat, track, **args)


def instant(name: str, cat: str = "", track: Optional[str] = None, **args) -> None:
    _GLOBAL.instant(name, cat, track, **args)


def counter(name: str, values: dict, track: Optional[str] = None) -> None:
    _GLOBAL.counter(name, values, track)


def set_track(name: str) -> None:
    _GLOBAL.set_track(name)


def _thread_name(pid: int, tid: int, name: str) -> dict:
    return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}}
