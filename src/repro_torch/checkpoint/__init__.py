"""Verified checkpoints in the reference's format v2 (twin of ``repro/checkpoint``)."""

from repro_torch.checkpoint.manager import (FORMAT_VERSION, CheckpointCorruptError, CheckpointError,
                                            CheckpointManager, reshard_dense, reshard_embedding,
                                            reshard_store)

__all__ = ["FORMAT_VERSION", "CheckpointCorruptError", "CheckpointError", "CheckpointManager",
           "reshard_dense", "reshard_embedding", "reshard_store"]
