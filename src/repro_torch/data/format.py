"""Packed shard format for streaming recsys ingestion (twin of
``repro/data/format.py``; a dataset written by either package is byte for
byte the other's, the shard files and ``dataset.json`` alike).

Click-log training streams terabytes, so the loader must never deserialize
on the hot path and must shard cleanly over the data axis: a binary,
memory-mappable format instead of a TSV or parquet decode per batch.

One dataset = a directory:

    dataset.json            DatasetSpec + shard manifest (the sidecar)
    shard-00000.bin         packed samples
    shard-00001.bin         ...

Shard file layout (all little-endian, every array 8-byte aligned):

    +--------------------------------------------------------------+
    | header (32 B): magic 'RPKS' | u32 version | u64 num_samples  |
    |                u32 num_slots | u32 num_dense | u32 flags     |
    |                u32 n_arrays                                  |
    +--------------------------------------------------------------+
    | section table: n_arrays x (u64 offset, u64 nbytes)           |
    +--------------------------------------------------------------+
    | dense    [N, num_dense] f32          (if num_dense > 0)      |
    | labels   [N] f32                     (if flags & LABELS)     |
    | per slot s in 0..S-1 (CSR):                                  |
    |   offsets_s [N+1] i64                                        |
    |   indices_s [nnz_s] i32                                      |
    |   weights_s [nnz_s] f32              (if flags & WEIGHTS)    |
    +--------------------------------------------------------------+

The CSR offsets make ragged bags representable; the writer emits the
fixed-width ``pooling`` layout the models consume, for which the reader's
decode is a reshape of an mmap view (zero-copy on contiguous sample
ranges).  Index values are PER-TABLE (original slot order), what the train
step takes for ``idx_input in ('replicated', 'sharded')``; the offsets into
the unified row space are added on the device.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np

MAGIC = b"RPKS"
VERSION = 1
FLAG_LABELS = 1
FLAG_WEIGHTS = 2
SPEC_NAME = "dataset.json"
_HEADER = struct.Struct("<4sIQIIII")        # magic, ver, N, S, D, flags, n_arr
_SECTION = struct.Struct("<QQ")


def _align8(n: int) -> int:
    return (n + 7) & ~7


def model_extras(mdef) -> dict:
    """The batch fields beyond the sparse ids that a model declares: its
    ``extras`` where it has them, else a DLRM config's dense features and
    labels (the reference's ``as_hybrid_def`` extras)."""
    extras = getattr(mdef, "extras", None)
    if extras is None:
        extras = {"dense_x": ((mdef.num_dense,), "bfloat16"), "labels": ((), "float32")}
    return extras


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Schema sidecar: everything a consumer needs to build the batch
    struct (``repro_torch.core.hybrid.batch_struct_from_spec``) without
    touching a shard file.  The field order is the reference's: it is the
    key order of ``dataset.json``."""

    table_rows: tuple                    # rows per TABLE
    pooling: int                         # P lookups per slot (fixed width)
    num_dense: int = 0
    slot_to_table: Optional[tuple] = None  # slot -> table (None = identity)
    labels: bool = True
    weighted: bool = False               # per-lookup bag weights present

    @property
    def slots(self) -> tuple:
        return (self.slot_to_table if self.slot_to_table is not None
                else tuple(range(len(self.table_rows))))

    @property
    def num_slots(self) -> int:
        return len(self.slots)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["table_rows"] = list(self.table_rows)
        d["slot_to_table"] = (None if self.slot_to_table is None
                              else list(self.slot_to_table))
        return d

    @classmethod
    def from_json(cls, d: dict) -> "DatasetSpec":
        return cls(table_rows=tuple(d["table_rows"]),
                   pooling=int(d["pooling"]),
                   num_dense=int(d.get("num_dense", 0)),
                   slot_to_table=(None if d.get("slot_to_table") is None
                                  else tuple(d["slot_to_table"])),
                   labels=bool(d.get("labels", True)),
                   weighted=bool(d.get("weighted", False)))

    # -- model compatibility -------------------------------------------------

    def check(self, table_rows, pooling: int, num_dense: int = 0,
              labels: bool = True, slot_to_table=None,
              weighted: bool = False) -> None:
        """Raise ValueError listing every mismatch between this dataset and
        a model's expectations (fail loudly at wiring time, not step 1)."""
        errs = []
        if tuple(self.table_rows) != tuple(table_rows):
            errs.append(f"table_rows {tuple(self.table_rows)} != model "
                        f"{tuple(table_rows)}")
        if self.pooling != pooling:
            errs.append(f"pooling {self.pooling} != model {pooling}")
        if self.num_dense != num_dense:
            errs.append(f"num_dense {self.num_dense} != model {num_dense}")
        if bool(self.labels) != bool(labels):
            errs.append(f"labels {self.labels} != model {labels}")
        s2t = (None if slot_to_table is None else tuple(slot_to_table))
        if (self.slot_to_table or None) != (s2t or None):
            if self.slots != (s2t if s2t is not None
                              else tuple(range(len(table_rows)))):
                errs.append(f"slot_to_table {self.slot_to_table} != model "
                            f"{s2t}")
        if weighted and not self.weighted:
            errs.append("model expects per-lookup weights; dataset is "
                        "unweighted")
        if errs:
            raise ValueError("DatasetSpec incompatible with model: "
                             + "; ".join(errs))

    def check_model(self, mdef) -> None:
        """Check against a model: a ``core.dlrm.DLRMConfig`` (dense
        features, labels, identity slots, ``weighted``) or any model
        declaring ``extras``, ``spec.table_rows``, ``pooling``.  Every batch
        field the model declares must be coverable by the format: extras
        beyond dense_x/labels (seq_mask, hist_mask, ...) are not
        representable in packed shards and are rejected HERE, not as a
        missing field inside the step."""
        extras = model_extras(mdef)
        unsupported = sorted(set(extras) - {"dense_x", "labels"})
        if unsupported:
            raise ValueError(
                f"model declares batch extras {unsupported} the packed "
                "shard format cannot carry (it stores dense_x/labels/"
                "sparse indices+weights only)")
        num_dense = (extras["dense_x"][0][0] if "dense_x" in extras else 0)
        self.check(mdef.spec.table_rows, mdef.pooling, num_dense=num_dense,
                   labels="labels" in extras,
                   slot_to_table=getattr(mdef, "slot_to_table", None),
                   weighted=getattr(mdef, "weighted", False))


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _write_shard(path: Path, spec: DatasetSpec, idx: np.ndarray,
                 dense: Optional[np.ndarray], labels: Optional[np.ndarray],
                 weights: Optional[np.ndarray]) -> int:
    """Write one shard from fixed-width arrays (idx [n,S,P] int32, dense
    [n,D] f32, labels [n] f32, weights [n,S,P] f32).  Returns n."""
    n, S, P = idx.shape
    flags = (FLAG_LABELS if spec.labels else 0) | (
        FLAG_WEIGHTS if spec.weighted else 0)
    arrays: list[np.ndarray] = []
    if spec.num_dense:
        arrays.append(np.ascontiguousarray(dense, np.float32))
    if spec.labels:
        arrays.append(np.ascontiguousarray(labels, np.float32))
    offs = (np.arange(n + 1, dtype=np.int64) * P)
    for s in range(S):
        arrays.append(offs)
        arrays.append(np.ascontiguousarray(idx[:, s, :].reshape(-1),
                                           np.int32))
        if spec.weighted:
            arrays.append(np.ascontiguousarray(
                weights[:, s, :].reshape(-1), np.float32))
    off = _align8(_HEADER.size + _SECTION.size * len(arrays))
    table = []
    for a in arrays:
        table.append((off, a.nbytes))
        off = _align8(off + a.nbytes)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, n, S, spec.num_dense, flags,
                             len(arrays)))
        for o, nb in table:
            f.write(_SECTION.pack(o, nb))
        pos = _HEADER.size + _SECTION.size * len(arrays)
        for a, (o, nb) in zip(arrays, table):
            f.write(b"\0" * (o - pos))
            f.write(a.tobytes())
            pos = o + nb
    return n


class ShardWriter:
    """Accumulate fixed-width batches and flush packed shard files.

    ``append_batch`` takes the dict layout the synthetic generators emit
    (``idx`` [b, S, P] int32 (+ ``dense_x``, ``labels``, ``weights``));
    shards of ``samples_per_shard`` samples are written as they fill and
    ``close()`` flushes the remainder + the ``dataset.json`` sidecar."""

    def __init__(self, out_dir, spec: DatasetSpec,
                 samples_per_shard: int = 8192):
        if samples_per_shard < 1:
            raise ValueError("samples_per_shard must be >= 1")
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.spec = spec
        self.samples_per_shard = samples_per_shard
        self._buf: list[dict] = []
        self._buffered = 0
        self._shards: list[dict] = []
        self._closed = False

    def append_batch(self, batch: dict) -> None:
        idx = np.asarray(batch["idx"])
        b, S, P = idx.shape
        if S != self.spec.num_slots or P != self.spec.pooling:
            raise ValueError(f"batch idx {idx.shape} does not match spec "
                             f"(S={self.spec.num_slots}, "
                             f"P={self.spec.pooling})")
        rows = np.asarray(self.spec.table_rows)[np.asarray(self.spec.slots)]
        if idx.min() < 0 or (idx.max(axis=(0, 2)) >= rows).any():
            raise ValueError("index out of range for table_rows")
        rec = {"idx": idx.astype(np.int32)}
        if self.spec.num_dense:
            rec["dense_x"] = np.asarray(batch["dense_x"], np.float32)
        if self.spec.labels:
            rec["labels"] = np.asarray(batch["labels"], np.float32)
        if self.spec.weighted:
            rec["weights"] = np.asarray(batch["weights"], np.float32)
        self._buf.append(rec)
        self._buffered += b
        while self._buffered >= self.samples_per_shard:
            self._flush(self.samples_per_shard)

    def _take(self, n: int) -> dict:
        out: dict[str, list] = {k: [] for k in self._buf[0]}
        got = 0
        while got < n:
            rec = self._buf[0]
            b = rec["idx"].shape[0]
            take = min(b, n - got)
            for k, v in rec.items():
                out[k].append(v[:take])
            if take == b:
                self._buf.pop(0)
            else:
                self._buf[0] = {k: v[take:] for k, v in rec.items()}
            got += take
        self._buffered -= n
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}

    def _flush(self, n: int) -> None:
        rec = self._take(n)
        name = f"shard-{len(self._shards):05d}.bin"
        _write_shard(self.out_dir / name, self.spec, rec["idx"],
                     rec.get("dense_x"), rec.get("labels"),
                     rec.get("weights"))
        self._shards.append({"file": name, "num_samples": n})

    def close(self) -> dict:
        if self._closed:
            raise RuntimeError("ShardWriter already closed")
        if self._buffered:
            self._flush(self._buffered)
        manifest = {
            "format": "repro-packed-shards",
            "version": VERSION,
            "spec": self.spec.to_json(),
            "samples_per_shard": self.samples_per_shard,
            "num_samples": sum(s["num_samples"] for s in self._shards),
            "shards": self._shards,
        }
        (self.out_dir / SPEC_NAME).write_text(json.dumps(manifest, indent=1))
        self._closed = True
        return manifest


def load_manifest(data_dir) -> tuple[DatasetSpec, dict]:
    p = Path(data_dir) / SPEC_NAME
    if not p.exists():
        raise FileNotFoundError(f"no {SPEC_NAME} under {data_dir}")
    manifest = json.loads(p.read_text())
    if manifest.get("format") != "repro-packed-shards":
        raise ValueError(f"{p} is not a repro-packed-shards manifest")
    if manifest.get("version") != VERSION:
        raise ValueError(f"unsupported shard format version "
                         f"{manifest.get('version')} (reader is {VERSION})")
    return DatasetSpec.from_json(manifest["spec"]), manifest


def write_shards(batches: Iterable[dict], out_dir, spec: DatasetSpec,
                 num_samples: int, samples_per_shard: int = 8192) -> dict:
    """Drain ``batches`` (any iterator of synthetic-layout dicts, e.g.
    ``repro_torch.data.synthetic.dlrm_stream``) until ``num_samples``
    samples are packed.  Returns the manifest."""
    w = ShardWriter(out_dir, spec, samples_per_shard)
    got = 0
    for b in batches:
        idx = np.asarray(b["idx"])
        take = min(idx.shape[0], num_samples - got)
        if take < idx.shape[0]:
            b = {k: np.asarray(v)[:take] for k, v in b.items()}
        w.append_batch(b)
        got += take
        if got >= num_samples:
            break
    if got < num_samples:
        raise ValueError(f"stream exhausted at {got}/{num_samples} samples")
    return w.close()


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def criteo_tsv_to_shards(tsv_path, out_dir, table_rows,
                         samples_per_shard: int = 8192,
                         log_transform: bool = True,
                         batch: int = 4096) -> dict:
    """Convert a Criteo-TSV-style click log (label \\t 13 int dense \\t 26
    hex categorical per line; empty fields allowed) into packed shards.
    Categorical values hash into ``table_rows[t]`` rows; dense ints get the
    standard ``log1p`` transform.  pooling = 1 (one-hot slots)."""
    table_rows = tuple(int(r) for r in table_rows)
    S = len(table_rows)
    spec = DatasetSpec(table_rows=table_rows, pooling=1, num_dense=13,
                       labels=True, weighted=False)
    w = ShardWriter(out_dir, spec, samples_per_shard)
    idx_b, den_b, lab_b = [], [], []

    def flush():
        if not idx_b:
            return
        w.append_batch({"idx": np.stack(idx_b)[:, :, None],
                        "dense_x": np.stack(den_b),
                        "labels": np.asarray(lab_b, np.float32)})
        idx_b.clear(), den_b.clear(), lab_b.clear()

    with open(tsv_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 1 + 13 + S:
                raise ValueError(f"bad Criteo line: {len(parts)} fields, "
                                 f"expected {1 + 13 + S}")
            lab_b.append(float(parts[0] or 0))
            dense = np.array([float(x or 0) for x in parts[1:14]], np.float32)
            if log_transform:
                dense = np.log1p(np.maximum(dense, 0.0))
            den_b.append(dense)
            idx_b.append(np.array(
                [int(c, 16) % table_rows[t] if c else 0
                 for t, c in enumerate(parts[14:])], np.int32))
            if len(idx_b) >= batch:
                flush()
    flush()
    return w.close()


def pack_synthetic(out_dir, table_rows, pooling: int, num_samples: int,
                   num_dense: int = 0, alpha: float = 0.0, seed: int = 0,
                   slot_to_table=None, labels: bool = True,
                   weighted: bool = False, samples_per_shard: int = 8192,
                   batch: int = 4096) -> dict:
    """Pack a seeded synthetic stream (``repro_torch.data.synthetic``):
    the "synthetic -> packed -> train" leg, and the round-trip fixture of
    the tests.  The same arguments pack the reference's bytes."""
    from repro_torch.data.synthetic import SparseBatchSpec, sparse_batch
    spec = DatasetSpec(table_rows=tuple(table_rows), pooling=pooling,
                       num_dense=num_dense, slot_to_table=slot_to_table,
                       labels=labels, weighted=weighted)
    rng = np.random.default_rng(seed)
    sspec = SparseBatchSpec(tuple(table_rows), slot_to_table, pooling, batch,
                            num_dense=num_dense, alpha=alpha, labels=labels)

    def stream() -> Iterator[dict]:
        while True:
            b = sparse_batch(rng, sspec)
            if weighted:
                b["weights"] = rng.uniform(
                    0.5, 1.5, b["idx"].shape).astype(np.float32)
            yield b

    return write_shards(stream(), out_dir, spec, num_samples,
                        samples_per_shard)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Pack datasets into the repro shard format")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sy = sub.add_parser("synthetic", help="pack a seeded synthetic stream")
    sy.add_argument("--out", required=True)
    sy.add_argument("--tables", required=True,
                    help="comma-separated rows per table, e.g. 1000,2000")
    sy.add_argument("--pooling", type=int, default=1)
    sy.add_argument("--num-dense", type=int, default=0)
    sy.add_argument("--num-samples", type=int, default=65536)
    sy.add_argument("--samples-per-shard", type=int, default=8192)
    sy.add_argument("--alpha", type=float, default=0.0)
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--weighted", action="store_true")
    cr = sub.add_parser("criteo", help="convert a Criteo-style TSV")
    cr.add_argument("--out", required=True)
    cr.add_argument("--tsv", required=True)
    cr.add_argument("--tables", required=True)
    cr.add_argument("--samples-per-shard", type=int, default=8192)
    args = ap.parse_args(argv)
    rows = tuple(int(x) for x in args.tables.split(","))
    if args.cmd == "synthetic":
        m = pack_synthetic(args.out, rows, args.pooling, args.num_samples,
                           num_dense=args.num_dense, alpha=args.alpha,
                           seed=args.seed, weighted=args.weighted,
                           samples_per_shard=args.samples_per_shard)
    else:
        m = criteo_tsv_to_shards(args.tsv, args.out, rows,
                                 samples_per_shard=args.samples_per_shard)
    print(f"packed {m['num_samples']} samples into {len(m['shards'])} "
          f"shard(s) under {args.out}")


if __name__ == "__main__":
    main()
