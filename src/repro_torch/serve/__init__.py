"""Serving: snapshots of the forward slabs, their publishing from a training
loop, and continuous batching over them."""

from repro_torch.serve.publish import SnapshotPublisher, combined_serve_stats
from repro_torch.serve.server import ContinuousBatchingServer, ServerClosed, bucket_for
from repro_torch.serve.snapshot import (ServingSnapshot, SnapshotRegistry, make_bucket_scorers,
                                        make_snapshot_score_step, snapshot_from_state,
                                        snapshot_state)

__all__ = [
    "ContinuousBatchingServer",
    "ServerClosed",
    "ServingSnapshot",
    "SnapshotPublisher",
    "SnapshotRegistry",
    "bucket_for",
    "combined_serve_stats",
    "make_bucket_scorers",
    "make_snapshot_score_step",
    "snapshot_from_state",
    "snapshot_state",
]
