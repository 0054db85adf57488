"""Host-side tracer: nestable spans -> Chrome trace JSON (the span part of
``repro/telemetry/tracer.py``, copied so the port needs nothing of ``repro``).

``span()`` on a disabled tracer (the default) returns a shared no-op context
manager after one attribute check: nothing is allocated and no clock is
read, so the serving loop keeps its span compiled in.  Enabled, each span is
a complete ('X') event on its thread's track; :meth:`Tracer.export` writes
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
        self._named_tids: set[int] = set()

    def _tid(self) -> int:
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._named_tids:
                self._events.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                                     "tid": tid,
                                     "args": {"name": threading.current_thread().name}})
                self._named_tids.add(tid)
        return tid

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing the enclosed block; ``args`` are attached
        to the event."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, cat, self._tid(), args)

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


def span(name: str, cat: str = "", **args):
    return _GLOBAL.span(name, cat, **args)
