"""Read-only serving snapshots and the snapshot score step (twin of
``repro/serve/snapshot.py``; one device, row mode, replicated indices,
weighted bags with ``mdef.weighted``).  Every function takes the model as a
``core.hybrid.HybridDef`` or a ``core.dlrm.DLRMConfig``.

A snapshot holds exactly the slabs the forward pass reads: ``emb_w``, the
bf16 ``hi`` slab of a Split-SGD store (the fp32 ``w`` slab for ``sgd``), and
``dense_hi``, the bf16 dense parameters.  Scoring runs
``row_sharded_bag_fwd`` (the embedding_bag kernel) and then the model's
``dense_score`` (a DLRM's: the fused_mlp and dot_interaction kernels) on the
snapshot's device.

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
from repro_torch.core.hybrid import as_hybrid
from repro_torch.optim import row as row_optim
from repro_torch.optim.data_parallel import tree_leaves, tree_map


def snapshot_state(cfg, state: dict, *, copy: bool = False) -> dict:
    """The forward-only view ``{emb_w, dense_hi}`` of a state ``{"emb":
    store, "dense": {"hi": tree, ...}}``, plus the hot-row cache's ``hot_w``
    and ``hot_pos`` when ``cfg.hot_rows > 0`` (as the reference's; scoring
    reads neither); never an optimizer-state slab.  ``copy=True`` clones
    the slabs: required for a state that goes on training, since the port's
    step updates it in place (``serve.publish.SnapshotPublisher`` always
    copies)."""
    snap = {"emb_w": row_optim.fwd_weights(row_optim.resolve(cfg), state["emb"]),
            "dense_hi": state["dense"]["hi"]}
    if getattr(cfg, "hot_rows", 0) > 0:
        snap["hot_w"] = state["cache"]["hot_w"]
        snap["hot_pos"] = state["cache"]["hot_pos"]
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


def snapshot_from_state(cfg, state: dict, *, version: int = 1, step: int = 0,
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


def batch_struct(mdef, batch: Optional[int] = None) -> dict:
    """``{field: (shape, dtype)}`` of one scoring batch: ``idx`` [B, S, P]
    int32 in the model's slots, ``weights`` in its layout when weighted, and
    every extra the model declares but ``labels`` (a training target no
    scorer reads)."""
    mdef = as_hybrid(mdef)
    B = batch or mdef.batch
    S = len(mdef.slot_to_table) if mdef.slot_to_table is not None else mdef.spec.num_tables
    out = {"idx": ((B, S, mdef.pooling), torch.int32)}
    if mdef.weighted:
        out["weights"] = ((B, S, mdef.pooling), torch.float32)
    for name, (shape, dtype) in mdef.extras.items():
        if name != "labels":
            out[name] = ((B, *shape), dtype)
    return out


def make_snapshot_score_step(mdef, batch: Optional[int] = None, *, device="cuda"):
    """Forward-only scoring from a snapshot state on ``device``.

    Returns ``(fn, bstructs)``; call as ``scores = fn(snapshot.state,
    batch)`` with the fields of :func:`batch_struct` on ``device`` (a DLRM's
    ``{"idx": [B, S, P] int32, "dense_x": [B, num_dense] bf16}``, and
    ``"weights"`` [B, S, P] fp32 with ``weighted``); ``scores`` is the
    model's ``dense_score``, [B] fp32 on ``device``."""
    mdef = as_hybrid(mdef)
    if mdef.emb_mode != "row":
        raise NotImplementedError(f"embedding mode {mdef.emb_mode!r}: the port serves row mode "
                                  "only; table-mode serving is ROADMAP queue 1 item 7")
    dev = resolve_device(device)
    layout = se.make_layout(mdef.spec, 1, "row", slot_to_table=mdef.slot_to_table)
    offsets = torch.as_tensor(layout.row_offsets, dtype=torch.int32, device=dev)

    def fn(snap: dict, batch_d: dict) -> torch.Tensor:
        emb_out = se.row_sharded_bag_fwd(layout, snap["emb_w"], batch_d["idx"], offsets,
                                         weights=batch_d["weights"] if mdef.weighted else None)
        return mdef.dense_score(snap["dense_hi"], emb_out, batch_d)

    return fn, batch_struct(mdef, batch)


def make_bucket_scorers(cfg, buckets: tuple[int, ...], source: Callable[[], Any], *,
                        device="cuda"):
    """Per-bucket score fns over a snapshot source, in the shape
    :class:`repro_torch.serve.server.ContinuousBatchingServer` consumes.

    ``source`` returns the snapshot state to score against (e.g. ``lambda:
    registry.current().state``), read per batch so that a publish between
    batches is picked up at once.  Returns ``(score_fns, pad_batch)``:
    ``score_fns[bucket](batch)`` -> numpy [bucket] scores, and
    ``pad_batch(payloads, bucket)``, which stacks the payloads' fields of
    :func:`batch_struct` (``idx`` [S, P], every declared extra but
    ``labels``, e.g. a DLRM's ``dense_x`` [num_dense], and with
    ``weighted`` ``weights`` [S, P]; numpy), zero-pads them to the bucket
    and moves them to ``device`` in the batch's dtypes."""
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
