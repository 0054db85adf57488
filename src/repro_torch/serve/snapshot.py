"""Read-only serving snapshots and the snapshot score step (twin of
``repro/serve/snapshot.py``; one device, row mode, replicated indices,
weighted bags with ``cfg.weighted``).

A snapshot holds exactly the slabs the forward pass reads: ``emb_w``, the
bf16 ``hi`` slab of a Split-SGD store (the fp32 ``w`` slab for ``sgd``), and
``dense_hi``, the bf16 dense parameters.  Scoring runs
``row_sharded_bag_fwd`` (the embedding_bag kernel) and then the dense scorer
(the fused_mlp and dot_interaction kernels) on the snapshot's device.

The reference donates each batch's buffers to XLA; PyTorch has no such
thing and the port simply lets the batch go.  Each scorer of
:func:`make_bucket_scorers` copies its scores to the host, and that copy is
the one synchronisation per batch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sharded_embedding as se
from repro_torch.core.dlrm import DLRMConfig, dlrm_dense_score
from repro_torch.optim import row as row_optim
from repro_torch.optim.data_parallel import tree_leaves, tree_map


def snapshot_state(cfg: DLRMConfig, state: dict, *, copy: bool = False) -> dict:
    """The forward-only view ``{emb_w, dense_hi}`` of a state ``{"emb":
    store, "dense": {"hi": tree, ...}}``; never an optimizer-state slab.
    ``copy=True`` clones the slabs, for a state that goes on training in
    place."""
    snap = {"emb_w": row_optim.fwd_weights(row_optim.resolve(cfg), state["emb"]),
            "dense_hi": state["dense"]["hi"]}
    return tree_map(torch.clone, snap) if copy else snap


def _tree_bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class ServingSnapshot:
    """One immutable published version of the serving tables."""

    version: int
    step: int
    published_t: float  # wall time of publish (time.time())
    state: dict         # {emb_w, dense_hi} — tensors

    @property
    def emb_bytes(self) -> int:
        """Bytes of the serving embedding table as stored."""
        return _tree_bytes(self.state["emb_w"])

    @property
    def fp32_emb_bytes(self) -> int:
        """Bytes the same table would take in fp32."""
        return int(self.state["emb_w"].numel()) * 4

    @property
    def total_bytes(self) -> int:
        return _tree_bytes(self.state)

    def seconds_behind(self, now: Optional[float] = None) -> float:
        return (time.time() if now is None else now) - self.published_t


def snapshot_from_state(cfg: DLRMConfig, state: dict, *, version: int = 1, step: int = 0,
                        now: Optional[float] = None) -> ServingSnapshot:
    """Build an immutable snapshot straight from a state."""
    return ServingSnapshot(version=version, step=step,
                           published_t=time.time() if now is None else now,
                           state=snapshot_state(cfg, state))


class SnapshotRegistry:
    """Versioned publish/retire store between ONE publisher and many
    serving readers.  Thread-safe; ``publish`` assigns monotonically
    increasing versions and auto-retires all but the newest ``keep``."""

    def __init__(self, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.keep = keep
        self._lock = threading.Lock()
        self._snaps: dict[int, ServingSnapshot] = {}
        self._next_version = 1

    def publish(self, snap_state: dict, *, step: int = 0) -> ServingSnapshot:
        """Publish a snapshot state (:func:`snapshot_state`) as the next
        version; snapshots beyond ``keep`` are retired."""
        with self._lock:
            snap = ServingSnapshot(version=self._next_version, step=step,
                                   published_t=time.time(), state=snap_state)
            self._next_version += 1
            self._snaps[snap.version] = snap
            for v in sorted(self._snaps)[: -self.keep]:
                del self._snaps[v]
            return snap

    def current(self) -> Optional[ServingSnapshot]:
        """Newest published snapshot (None before the first publish)."""
        with self._lock:
            if not self._snaps:
                return None
            return self._snaps[max(self._snaps)]

    def get(self, version: int) -> Optional[ServingSnapshot]:
        with self._lock:
            return self._snaps.get(version)

    def retire(self, version: int) -> bool:
        """Drop one version (readers holding the object keep it alive).
        Returns whether it existed."""
        with self._lock:
            return self._snaps.pop(version, None) is not None

    def versions(self) -> list[int]:
        with self._lock:
            return sorted(self._snaps)


def batch_struct(cfg: DLRMConfig, batch: Optional[int] = None) -> dict:
    """``{field: (shape, dtype)}`` of one scoring batch."""
    B = batch or cfg.batch
    out = {"idx": ((B, len(cfg.table_rows), cfg.pooling), torch.int32),
           "dense_x": ((B, cfg.num_dense), torch.bfloat16)}
    if cfg.weighted:
        out["weights"] = ((B, len(cfg.table_rows), cfg.pooling), torch.float32)
    return out


def make_snapshot_score_step(cfg: DLRMConfig, batch: Optional[int] = None, *, device="cuda"):
    """Forward-only scoring from a snapshot state on ``device``.

    Returns ``(fn, bstructs)``; call as ``scores = fn(snapshot.state,
    batch)`` with ``batch = {"idx": [B, S, P] int32, "dense_x": [B,
    num_dense] bf16}`` on ``device``, and ``"weights"`` [B, S, P] fp32 with
    ``cfg.weighted``; ``scores`` is [B] fp32 on ``device``."""
    if cfg.emb_mode != "row":
        raise NotImplementedError(f"embedding mode {cfg.emb_mode!r}: the port serves row mode only; "
                                  "table-mode serving is ROADMAP queue 1 item 7")
    dev = resolve_device(device)
    layout = se.make_layout(cfg.spec, 1, "row")
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)
    score = dlrm_dense_score(cfg)

    def fn(snap: dict, batch_d: dict) -> torch.Tensor:
        emb_out = se.row_sharded_bag_fwd(layout, snap["emb_w"], batch_d["idx"], offsets,
                                         weights=batch_d["weights"] if cfg.weighted else None)
        return score(snap["dense_hi"], emb_out, batch_d)

    return fn, batch_struct(cfg, batch)


def make_bucket_scorers(cfg: DLRMConfig, buckets: tuple[int, ...], source: Callable[[], Any], *,
                        device="cuda"):
    """Per-bucket score fns over a snapshot source, in the shape
    :class:`repro_torch.serve.server.ContinuousBatchingServer` consumes.

    ``source`` returns the snapshot state to score against (e.g. ``lambda:
    registry.current().state``), read per batch so that a publish between
    batches is picked up at once.  Returns ``(score_fns, pad_batch)``:
    ``score_fns[bucket](batch)`` -> numpy [bucket] scores, and
    ``pad_batch(payloads, bucket)``, which stacks the payloads' ``idx``
    [S, P], ``dense_x`` [num_dense] and, with ``cfg.weighted``, ``weights``
    [S, P] (numpy), zero-pads them to the bucket and moves them to
    ``device`` in the batch's dtypes."""
    dev = resolve_device(device)
    steps, structs_by = {}, {}
    for b in sorted(buckets):
        steps[b], structs_by[b] = make_snapshot_score_step(cfg, batch=b, device=dev)

    def _score(bucket):
        def run(batch):
            return steps[bucket](source(), batch).cpu().numpy()
        return run

    def pad_batch(payloads: list, bucket: int) -> dict:
        out = {}
        for k, (shape, dtype) in structs_by[bucket].items():
            base = np.zeros(shape, np.int32 if dtype == torch.int32 else np.float32)
            for i, p in enumerate(payloads):
                base[i] = np.asarray(p[k])
            out[k] = torch.from_numpy(base).to(dtype).to(dev)
        return out

    return {b: _score(b) for b in sorted(buckets)}, pad_batch
