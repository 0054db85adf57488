"""Structured failure-event log (a copy of ``repro/faults/log.py`` that
records its trace instants on the port's tracer).

Every recovery action in the resilience stack — a checkpoint write retry,
a corrupt checkpoint skipped during the restore scan, a skipped batch, a
preemption — records a structured event here instead of (only) printing.
Drills and the resilience bench assert on ``counts()``; operators tail the
JSON-lines file.

Events are plain dicts: ``{"kind": ..., "t": <unix time>, **fields}``.
Thread-safe (the checkpoint writer thread and loader workers record
concurrently with the train loop).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional

from repro_torch import telemetry


class FailureLog:
    """Append-only event list, optionally mirrored to a ``.jsonl`` file.

    The mirror is flushed AND fsynced per event: these lines exist for the
    post-mortem of a process that may die on the very next instruction, so
    an event buffered in userspace (or the page cache) is an event lost.
    Each event is also an instant on the process trace timeline (track
    ``faults``), so recovery actions line up against the train-loop and
    checkpoint-writer spans in Perfetto.
    """

    def __init__(self, path: Optional[str] = None):
        self.events: list[dict] = []
        self.path = Path(path) if path else None
        self._lock = threading.Lock()
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def record(self, kind: str, **fields) -> dict:
        event = {"kind": kind, "t": time.time(), **fields}
        with self._lock:
            self.events.append(event)
            if self.path is not None:
                with self.path.open("a") as f:
                    f.write(json.dumps(event, default=str) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
        telemetry.instant(f"fault/{kind}", cat="fault", track="faults",
                          **{k: str(v) for k, v in fields.items()})
        return event

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(Counter(e["kind"] for e in self.events))

    def of_kind(self, kind: str) -> list[dict]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)
