"""Serving: snapshots of the forward slabs, their publishing from a training
loop, and batching over them, on one rank or on a mesh (rank 0 serves, the
other ranks follow its batches)."""

from repro_torch.serve.publish import SnapshotPublisher, combined_serve_stats
from repro_torch.serve.server import (BatchingServer, ContinuousBatchingServer, ServerClosed,
                                      bucket_for)
from repro_torch.serve.snapshot import (ServingSnapshot, SnapshotRegistry, follow,
                                        make_bucket_scorers, make_snapshot_score_step, release,
                                        snapshot_from_state, snapshot_specs, snapshot_state)

__all__ = [
    "BatchingServer",
    "ContinuousBatchingServer",
    "ServerClosed",
    "ServingSnapshot",
    "SnapshotPublisher",
    "SnapshotRegistry",
    "bucket_for",
    "combined_serve_stats",
    "follow",
    "make_bucket_scorers",
    "make_snapshot_score_step",
    "release",
    "snapshot_from_state",
    "snapshot_specs",
    "snapshot_state",
]
