"""Read-only serving snapshots and the snapshot score step (twin of
``repro/serve/snapshot.py``; row and table mode on this rank of a mesh,
weighted bags with ``mdef.weighted``).  Every function takes the model as a
``core.hybrid.HybridDef`` or a ``core.dlrm.DLRMConfig``.

A snapshot holds exactly the slabs the forward pass reads: ``emb_w``, this
rank's shard of the bf16 ``hi`` slab of a Split-SGD store (the fp32 ``w``
slab for ``sgd``; :func:`snapshot_specs` says which shard), and
``dense_hi``, the bf16 dense parameters, replicated.  Scoring runs the
train step's forward stages (the embedding_bag kernel, then row mode's
reduce-scatter or table mode's all-to-all) and then the model's
``dense_score`` (a DLRM's: the fused_mlp and dot_interaction kernels) on the
rank's device.  At N ranks, one process a rank, rank 0 serves and the
others follow its batches (:func:`make_bucket_scorers`, :func:`follow`).

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

from repro_torch.core import hybrid, pipeline
from repro_torch.core import sharded_embedding as se
from repro_torch.core.hybrid import as_hybrid
from repro_torch.dist import comm
from repro_torch.launch.mesh import refuse_shape_only, resolve_mesh
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


@dataclasses.dataclass(frozen=True)
class SlabShard:
    """A snapshot slab sharded by rows over the mesh axes ``axes``: this
    rank holds shard ``index`` of ``count``, the rows ``[index * rows,
    (index + 1) * rows)`` of the layout's global row space."""

    axes: tuple
    index: int
    count: int
    rows: int

    def cut(self, glob):
        """This rank's rows of the global slab ``glob``."""
        return glob[self.index * self.rows:(self.index + 1) * self.rows]


def snapshot_specs(mdef, mesh=None) -> dict:
    """How this rank of ``mesh`` (None: one rank) holds each slab of a
    snapshot, the twin of the reference's ``snapshot_specs`` (its
    ``PartitionSpec`` s): ``emb_w`` a :class:`SlabShard` over the embedding
    axes (the store's sharding: the whole mesh in row mode, the model axis
    in table mode), every other slab ``None``, replicated."""
    mdef = as_hybrid(mdef)
    mesh = resolve_mesh(mesh, "cpu")
    layout = hybrid.make_layout(mdef, mesh)
    axes = pipeline.emb_axes(mdef, mesh)[0]
    specs = {"emb_w": SlabShard(tuple(axes), mesh.group(axes).index, layout.num_shards,
                                layout.rows_per_shard),
             "dense_hi": None}
    if getattr(mdef, "hot_rows", 0) > 0:
        specs["hot_w"] = specs["hot_pos"] = None
    return specs


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


def make_snapshot_score_step(mdef, mesh=None, batch: Optional[int] = None, *, device="cuda"):
    """Forward-only scoring from a snapshot state on this rank of ``mesh``
    (None: one rank on ``device``), in row or table mode.

    The stages of ``core.hybrid.make_score_step``, entered at the forward
    slabs: the train step's ``index_exchange`` (its forward stream) and
    ``embedding_fwd`` (row mode's bag and bf16 reduce-scatter, table mode's
    bag and fp32 all-to-all) on ``snap["emb_w"]``, then the model's
    ``dense_score`` on ``snap["dense_hi"]``; so the scores are
    ``make_score_step``'s on the same weights, bit for bit.  Returns ``(fn,
    bstructs)``; call as ``scores = fn(snapshot.state, batch)``, ``batch``
    this rank's block of a global batch (``core.hybrid.local_batch``) on
    the rank's device, ``scores`` its [b] fp32 scores.  ``bstructs`` is
    :func:`batch_struct`, a request batch in the original slots (a DLRM's
    ``{"idx": [B, S, P] int32, "dense_x": [B, num_dense] bf16}``, and
    ``"weights"`` [B, S, P] fp32 with ``weighted``)."""
    mdef = as_hybrid(mdef)
    mesh = resolve_mesh(mesh, device)
    stages = pipeline.build_stages(mdef, hybrid.make_layout(mdef, mesh), mesh)

    def fn(snap: dict, batch_d: dict) -> torch.Tensor:
        idx_fwd = stages.index_exchange(batch_d["idx"], fwd_only=True)[0]
        wgt_fwd = (stages.index_exchange(batch_d["weights"], fwd_only=True)[0]
                   if mdef.weighted else None)
        emb_out = stages.embedding_fwd(snap["emb_w"], idx_fwd, wgt_fwd)
        return mdef.dense_score(snap["dense_hi"], emb_out, batch_d)

    return fn, batch_struct(mdef, batch)


def _leader(mesh) -> Optional[comm.Group]:
    """The group over the whole mesh when it spans more than one rank."""
    refuse_shape_only(mesh, "the server")
    g = mesh.group(pipeline.mesh_axes(mesh)[0])
    return g if g.size > 1 else None


def _broadcast(g: comm.Group, obj):
    """``obj`` of the group's rank 0 on every rank of ``g`` (pickled)."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(g.pg, 0), group=g.pg)
    return box[0]


def make_bucket_scorers(cfg, buckets: tuple[int, ...], source: Callable[[], Any], *,
                        mesh=None, device="cuda"):
    """Per-bucket score fns over a snapshot source on this rank of ``mesh``
    (None: one rank on ``device``), in the shape
    :class:`repro_torch.serve.server.ContinuousBatchingServer` consumes.

    ``source`` returns the snapshot state to score against (e.g. ``lambda:
    registry.current().state``, this rank's shard), read per batch so that
    a publish between batches is picked up at once.  Returns ``(score_fns,
    pad_batch)``: ``score_fns[bucket](batch)`` -> numpy [bucket] scores of
    a global batch, and ``pad_batch(payloads, bucket)``, which stacks the
    payloads' fields of :func:`batch_struct` (``idx`` [S, P] in the original
    slots, every declared extra but ``labels``, e.g. a DLRM's ``dense_x``
    [num_dense], and with ``weighted`` ``weights`` [S, P]; numpy),
    zero-pads them to the bucket, puts a table-mode model's replicated ids
    in padded-slot order and moves them to the device in the batch's
    dtypes.

    On a mesh of N ranks every rank must run the same score steps on the
    same batches in the same order (each scores its block, and the blocks
    meet in an all-gather).  Rank 0 serves: each of its score fns first
    broadcasts ``(bucket, batch)`` over the mesh, and the other ranks run
    :func:`follow` on their own score fns until rank 0 calls
    :func:`release`.  A rank that dies or hangs fails the others' waits at
    the process group's timeout."""
    from repro_torch.core.hybrid import local_batch

    mdef = as_hybrid(cfg)
    refuse_shape_only(mesh, "the server")
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    g_all = mesh.group(pipeline.mesh_axes(mesh)[0])
    lead = _leader(mesh) is not None and mesh.rank == 0
    steps, structs_by = {}, {}
    for b in sorted(buckets):
        if b % mesh.size:
            raise ValueError(f"bucket {b} does not split over {mesh.size} ranks")
        steps[b], structs_by[b] = make_snapshot_score_step(mdef, mesh, batch=b)
    layout = hybrid.make_layout(mdef, mesh)
    padded = mdef.emb_mode == "table" and mdef.idx_input == "replicated"
    maps = se.slot_maps(layout, "cpu") if padded else None

    def _score(bucket):
        def run(batch):
            if lead:
                _broadcast(g_all, (bucket, {k: v.cpu() for k, v in batch.items()}))
            s = steps[bucket](source(), local_batch(mdef, mesh, batch))
            return comm.all_gather(s, g_all).cpu().numpy()
        return run

    def pad_batch(payloads: list, bucket: int) -> dict:
        out = {}
        for k, (shape, dtype) in structs_by[bucket].items():
            base = np.zeros(shape, np.int32 if dtype == torch.int32 else np.float32)
            for i, p in enumerate(payloads):
                base[i] = np.asarray(p[k])
            t = torch.from_numpy(base)
            if padded and k in ("idx", "weights"):
                t = se.permute_indices(layout, t, maps)
            out[k] = t.to(dtype).to(dev)
        return out

    return {b: _score(b) for b in sorted(buckets)}, pad_batch


def follow(score_fns: dict, mesh) -> int:
    """The serving loop of a rank other than 0 of ``mesh``: take each
    ``(bucket, batch)`` rank 0's score fns broadcast and score it with this
    rank's ``score_fns`` (of :func:`make_bucket_scorers`) until
    :func:`release`.  Returns the batches scored."""
    g = _leader(mesh)
    if g is None or mesh.rank == 0:
        raise ValueError("follow runs on the ranks other than 0 of a mesh of several")
    n = 0
    while True:
        msg = _broadcast(g, None)
        if msg is None:
            return n
        bucket, batch = msg
        score_fns[bucket]({k: v.to(mesh.device) for k, v in batch.items()})
        n += 1


def release(mesh) -> None:
    """Rank 0 of ``mesh`` ends the other ranks' :func:`follow` (nothing at
    one rank)."""
    g = _leader(mesh)
    if g is not None:
        _broadcast(g, None)
