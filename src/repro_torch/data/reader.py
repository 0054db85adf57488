"""Distributed shard reader (twin of ``repro/data/reader.py``): mmap-backed,
rank-sliced, deterministically shuffled.  Numpy and zero-copy, like the
reference's; either package's reader reads either package's dataset into
the same batches, bit for bit.

Determinism contract (``tests/test_ingest.py``, ``tests/test_torch_ingest.py``):

* The GLOBAL epoch order is a pure function of ``(seed, epoch,
  num_samples, shuffle window)`` — independent of rank count.  Rank ``r``
  of ``R`` takes rows ``[r*B/R, (r+1)*B/R)`` of every global batch, the
  block the step's batch layout gives it, so concatenating
  the rank streams reconstructs the single-reader stream bit-for-bit and
  a job can change rank count without changing the training trajectory.
* Two-level shuffle: level 1 permutes shuffle windows (window size
  defaults to the manifest's ``samples_per_shard``, i.e. shard
  permutation); level 2 permutes samples within each window (intra-shard
  shuffle with bounded memory).  With an explicit ``window`` the order is
  also invariant to how the dataset was re-sharded on disk.
* ``shuffle=False`` is sequential file order — resharding-invariant by
  construction, and the fast path: for a batch whose samples are one
  contiguous range inside one shard, dense/labels come back as mmap
  VIEWS and the fixed-width CSR index decode degenerates to a reshape +
  slot stack (one memcpy, no per-sample work).  Those views are READ-ONLY:
  a consumer that makes tensors of them copies them first
  (``train.loop.prefetch_to_device``, ``weights.to_torch``), so that no
  tensor aliases memory it cannot write.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from repro_torch.data.format import (FLAG_LABELS, FLAG_WEIGHTS, MAGIC, VERSION, _HEADER,
                                     _SECTION, load_manifest)


class PackedShard:
    """mmap view of one packed shard file (see format.py for the layout).
    Arrays are exposed as zero-copy numpy views into the map."""

    def __init__(self, path):
        self.path = Path(path)
        raw = np.memmap(self.path, dtype=np.uint8, mode="r")
        magic, ver, n, S, D, flags, n_arr = _HEADER.unpack(
            bytes(raw[:_HEADER.size]))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        if ver != VERSION:
            raise ValueError(f"{path}: version {ver}, reader is {VERSION}")
        self.num_samples, self.num_slots, self.num_dense = int(n), S, D
        self.has_labels = bool(flags & FLAG_LABELS)
        self.has_weights = bool(flags & FLAG_WEIGHTS)
        table = [
            _SECTION.unpack_from(raw, _HEADER.size + i * _SECTION.size)
            for i in range(n_arr)
        ]

        def view(i, dtype):
            off, nbytes = table[i]
            return raw[off:off + nbytes].view(dtype)

        i = 0
        self.dense = (view(i, np.float32).reshape(n, D) if D else None)
        i += bool(D)
        self.labels = view(i, np.float32) if self.has_labels else None
        i += self.has_labels
        self._offsets, self._indices, self._weights = [], [], []
        for _ in range(S):
            self._offsets.append(view(i, np.int64)); i += 1
            self._indices.append(view(i, np.int32)); i += 1
            if self.has_weights:
                self._weights.append(view(i, np.float32)); i += 1
            else:
                self._weights.append(None)
        self._fixed: dict[tuple[int, int], bool] = {}

    def fixed_pooling(self, s: int, pooling: int) -> bool:
        """True when slot ``s`` is uniformly ``pooling``-wide — the layout
        the writer emits, where decode is a reshape of the index view.
        The offsets scan is cached: the mmap is immutable, and re-checking
        [N+1] offsets per slot per batch would rival the decode cost."""
        key = (s, pooling)
        if key not in self._fixed:
            o = self._offsets[s]
            self._fixed[key] = bool(o[-1] == self.num_samples * pooling
                                    and (np.diff(o) == pooling).all())
        return self._fixed[key]

    def slot_idx(self, s: int, ids: np.ndarray, pooling: int,
                 out_w: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather [len(ids), pooling] int32 indices for slot ``s`` (ragged
        bags are right-padded with index 0 / weight 0).  When ``out_w`` is
        given the per-lookup weights are gathered into it."""
        if self.fixed_pooling(s, pooling):
            mat = self._indices[s].reshape(self.num_samples, pooling)
            if out_w is not None:
                out_w[...] = self._weights[s].reshape(
                    self.num_samples, pooling)[ids]
            return mat[ids]
        if not self.has_weights:
            raise ValueError(
                f"{self.path}: slot {s} has ragged bags but no weights — "
                "padding needs weight 0 to be a no-op; repack the dataset "
                "weighted or fixed-width")
        o = self._offsets[s]
        out = np.zeros((len(ids), pooling), np.int32)
        if out_w is not None:
            out_w[...] = 0.0
        for j, sid in enumerate(ids):
            lo, hi = int(o[sid]), int(o[sid + 1])
            k = min(hi - lo, pooling)
            out[j, :k] = self._indices[s][lo:lo + k]
            if out_w is not None:
                out_w[j, :k] = self._weights[s][lo:lo + k]
        return out


class ShardedReader:
    """Iterate packed shards as model-ready batches.

    ``rank``/``num_ranks`` slice each GLOBAL batch over the data axis (see
    the module docstring for why that — and not whole-shard assignment —
    is what makes the epoch order rank-count-invariant).  The single-host
    launchers here run ``num_ranks=1`` and every rank of a loop on a mesh cuts
    its block from the global batch (``train.loop.LocalBatches``); a
    multi-host deployment gives each host its slice.

    Yields dicts: ``idx`` [b, S, P] int32 (+ ``dense_x`` [b, D] f32,
    ``labels`` [b] f32, ``weights`` [b, S, P] f32 per the DatasetSpec).
    """

    def __init__(self, data_dir, batch: int, *, rank: int = 0,
                 num_ranks: int = 1, seed: int = 0, shuffle: bool = True,
                 window: Optional[int] = None, drop_remainder: bool = True):
        if not (0 <= rank < num_ranks):
            raise ValueError(f"rank {rank} not in [0, {num_ranks})")
        if batch % num_ranks:
            raise ValueError(f"batch {batch} not divisible by num_ranks "
                             f"{num_ranks}")
        self.spec, self.manifest = load_manifest(data_dir)
        self.data_dir = Path(data_dir)
        self.batch, self.rank, self.num_ranks = batch, rank, num_ranks
        self.seed, self.shuffle = seed, shuffle
        self.window = int(window or self.manifest["samples_per_shard"])
        self.drop_remainder = drop_remainder
        self.shards = [PackedShard(self.data_dir / s["file"])
                       for s in self.manifest["shards"]]
        counts = np.array([s.num_samples for s in self.shards], np.int64)
        self.num_samples = int(counts.sum())
        if self.num_samples != self.manifest["num_samples"]:
            raise ValueError("manifest/shard sample-count mismatch")
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        if not drop_remainder and self.num_samples % batch:
            raise ValueError("drop_remainder=False requires num_samples "
                             "divisible by batch")
        if batch > self.num_samples:
            raise ValueError(f"batch {batch} > dataset {self.num_samples}")

    # -- epoch order ---------------------------------------------------------

    def iter_epoch_windows(self, epoch: int) -> Iterator[np.ndarray]:
        """Global sample order for one epoch, streamed one shuffle window
        at a time (rank-independent).  O(window) memory — the shuffle
        never materializes the full O(N) permutation, which matters at
        the terabyte scale the format targets."""
        N, W = self.num_samples, self.window
        if not self.shuffle:
            for lo in range(0, N, W):
                yield np.arange(lo, min(lo + W, N), dtype=np.int64)
            return
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        nwin = -(-N // W)
        for w in rng.permutation(nwin):        # level 1: window permutation
            lo = int(w) * W
            m = min(W, N - lo)
            yield lo + rng.permutation(m)      # level 2: intra-window

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Materialized epoch order (tests / small datasets); iteration
        itself uses the streamed :meth:`iter_epoch_windows`."""
        return np.concatenate(list(self.iter_epoch_windows(epoch)))

    def batches_per_epoch(self) -> int:
        return self.num_samples // self.batch

    # -- gather --------------------------------------------------------------

    def _gather(self, ids: np.ndarray) -> dict:
        spec = self.spec
        S, P = spec.num_slots, spec.pooling
        b = len(ids)
        sh = np.searchsorted(self._starts, ids, side="right") - 1
        first = self.shards[sh[0]]
        local = ids - self._starts[sh]
        contig = bool((sh == sh[0]).all() and (np.diff(local) == 1).all())
        out: dict[str, np.ndarray] = {}
        if contig and all(first.fixed_pooling(s, P) for s in range(S)):
            # fast path: one contiguous range in one shard -> mmap views
            # (dense/labels) + a reshape/stack of the index views
            lo, hi = int(local[0]), int(local[0]) + b
            out["idx"] = np.stack(
                [first._indices[s].reshape(first.num_samples, P)[lo:hi]
                 for s in range(S)], axis=1)
            if spec.num_dense:
                out["dense_x"] = first.dense[lo:hi]
            if spec.labels:
                out["labels"] = first.labels[lo:hi]
            if spec.weighted:
                out["weights"] = np.stack(
                    [first._weights[s].reshape(first.num_samples, P)[lo:hi]
                     for s in range(S)], axis=1)
            return out
        idx = np.empty((b, S, P), np.int32)
        wgt = np.empty((b, S, P), np.float32) if spec.weighted else None
        if spec.num_dense:
            out["dense_x"] = np.empty((b, spec.num_dense), np.float32)
        if spec.labels:
            out["labels"] = np.empty((b,), np.float32)
        for u in np.unique(sh):
            sel = np.flatnonzero(sh == u)
            shard, loc = self.shards[u], local[sh == u]
            for s in range(S):
                w_out = (np.empty((len(loc), P), np.float32)
                         if spec.weighted else None)
                idx[sel, s, :] = shard.slot_idx(s, loc, P, out_w=w_out)
                if spec.weighted:
                    wgt[sel, s, :] = w_out
            if spec.num_dense:
                out["dense_x"][sel] = shard.dense[loc]
            if spec.labels:
                out["labels"][sel] = shard.labels[loc]
        out["idx"] = idx
        if spec.weighted:
            out["weights"] = wgt
        return out

    # -- iteration -----------------------------------------------------------

    def epoch_batches(self, epoch: int) -> Iterator[dict]:
        B, R, r = self.batch, self.num_ranks, self.rank
        share = B // R
        buf = np.empty(0, np.int64)        # O(window + batch) id buffer
        produced, total = 0, self.batches_per_epoch()
        for win in self.iter_epoch_windows(epoch):
            buf = np.concatenate([buf, win])
            while len(buf) >= B and produced < total:
                yield self._gather(buf[r * share:(r + 1) * share])
                buf = buf[B:]
                produced += 1
        # trailing < batch ids dropped (drop_remainder)

    def batches(self, epochs: Optional[int] = None) -> Iterator[dict]:
        epoch = 0
        while epochs is None or epoch < epochs:
            yield from self.epoch_batches(epoch)
            epoch += 1

    def __iter__(self) -> Iterator[dict]:
        return self.batches()

    def nbytes_per_batch(self) -> int:
        """Decoded bytes one rank pulls per batch (bench accounting)."""
        spec = self.spec
        b = self.batch // self.num_ranks
        n = b * spec.num_slots * spec.pooling * 4
        if spec.weighted:
            n *= 2
        n += b * spec.num_dense * 4 + (b * 4 if spec.labels else 0)
        return n
