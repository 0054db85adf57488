"""Train-to-serve publishing: fresh snapshots from a live training loop
(twin of ``repro/serve/publish.py``).

:class:`SnapshotPublisher` is a :class:`repro_torch.train.TrainLoop`
``step_hook``: every ``publish_every`` completed steps it captures
:func:`repro_torch.serve.snapshot.snapshot_state` with ``copy=True`` (the
forward slabs only) and publishes it to a
:class:`~repro_torch.serve.snapshot.SnapshotRegistry` that a concurrently
running :class:`~repro_torch.serve.server.ContinuousBatchingServer` reads per
batch.  The port's train step updates its state in place, so a snapshot must
own clones of its slabs: one by reference would change under the server at
the next step.

Train-to-serve FRESHNESS is a measured number: ``freshness()`` reports how
far the serving tables trail the training head, ``steps_behind`` (head step
minus the published snapshot's step; bounded by ``publish_every - 1`` plus
in-flight time) and ``seconds_behind`` (wall time since publish).
``stats()`` is heartbeat-shaped: pass it (or :func:`combined_serve_stats`)
as the train loop's ``serve_stats`` so every heartbeat JSONL record carries
the snapshot's version and freshness next to the serving latencies.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from repro_torch import telemetry
from repro_torch.serve import snapshot as snap_mod


class SnapshotPublisher:
    """Publishes a serving snapshot every ``publish_every`` steps.

    Use as a TrainLoop ``step_hook`` (called with ``(completed_step,
    state)``); ``cfg`` is the model's ``core.dlrm.DLRMConfig``;
    ``registry`` defaults to a fresh
    :class:`~repro_torch.serve.snapshot.SnapshotRegistry`."""

    def __init__(self, cfg, *, publish_every: int = 10,
                 registry: Optional[snap_mod.SnapshotRegistry] = None, keep: int = 2):
        if publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {publish_every}")
        self.cfg = cfg
        self.publish_every = publish_every
        self.registry = registry if registry is not None else snap_mod.SnapshotRegistry(keep=keep)
        self.head_step = 0
        self.publishes = 0

    def __call__(self, step: int, state: Any) -> Optional[snap_mod.ServingSnapshot]:
        """TrainLoop step hook: track the head, publish on cadence."""
        self.head_step = max(self.head_step, step)
        if step % self.publish_every == 0:
            return self.publish(step, state)
        return None

    def publish(self, step: int, state: Any) -> snap_mod.ServingSnapshot:
        """Publish now, regardless of cadence (e.g. version 1 at step 0 so
        the server has tables before training starts).  Always clones the
        forward slabs, which the next train step overwrites in place."""
        self.head_step = max(self.head_step, step)
        snap = self.registry.publish(snap_mod.snapshot_state(self.cfg, state, copy=True),
                                     step=step)
        self.publishes += 1
        telemetry.instant("serve/publish", cat="serve", step=step, version=snap.version)
        return snap

    def freshness(self, head_step: Optional[int] = None, now: Optional[float] = None) -> dict:
        """{version, steps_behind, seconds_behind} of the CURRENT snapshot
        vs the training head (empty before the first publish)."""
        cur = self.registry.current()
        if cur is None:
            return {}
        head = self.head_step if head_step is None else head_step
        return {
            "version": cur.version,
            "steps_behind": head - cur.step,
            "seconds_behind": (time.time() if now is None else now) - cur.published_t,
        }

    def stats(self) -> dict:
        """Heartbeat-shaped publisher summary."""
        out = {"publishes": self.publishes, "versions": self.registry.versions()}
        out.update(self.freshness())
        return out


def combined_serve_stats(publisher: Optional[SnapshotPublisher],
                         server=None) -> Callable[[], dict]:
    """A ``TrainLoop(serve_stats=...)`` callable merging publisher
    freshness with the server's queue/latency stats (either side
    optional)."""

    def stats() -> dict:
        rec: dict = {}
        if publisher is not None:
            rec["snapshot"] = publisher.stats()
        if server is not None:
            rec.update(server.stats())
        return rec

    return stats
