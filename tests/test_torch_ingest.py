"""The port's packed-shard ingestion (``repro_torch.data.format``,
``reader``, ``pipeline.HostPipeline``, ``core.hybrid.batch_struct_from_spec``)
against the reference's, on the CPU.

The reference's format and reader contracts (``tests/test_ingest.py``: the
round trips, the manifest and spec checks, the writer's refusals, rank and
reshard invariance, the seeded two-level shuffle, validation, the host
pipeline over a reader) run on ``repro.data`` and ``repro_torch.data`` alike.
Across packages: a dataset written by either is byte for byte the other's
(shard files and ``dataset.json``; unweighted, weighted, with a
``slot_to_table``, a Criteo TSV with empty fields, and the two
``python -m ... data synthetic`` CLIs), and each package's reader reads the
other's dataset into the same batches, bit for bit, over seeds, epochs,
shuffle windows and rank counts; a ragged weighted shard (written by hand)
reads alike in both.  The reference's acceptance property on the port:
packed -> reader -> ``HostPipeline(presort=True)`` -> the port's step is bit
for bit the port's step on the in-process stream at M in {1, 2}, and it is
held to the reference's packed step at (1, 1).  The reader's fast path hands
out read-only mmap views, which a CPU loop must copy: that loop runs with
``UserWarning`` an error.
"""

import json
import os
import struct
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.core import sharded_embedding as j_se
from repro.core.embedding import EmbeddingSpec as JSpec
from repro.data import format as j_format
from repro.data import pipeline as j_pipeline
from repro.data import reader as j_reader
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.train import prefetch_to_device as j_prefetch
from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import hybrid as t_hybrid
from repro_torch.core import sharded_embedding as t_se
from repro_torch.core.embedding import EmbeddingSpec as TSpec
from repro_torch.data import format as t_format
from repro_torch.data import pipeline as t_pipeline
from repro_torch.data import reader as t_reader
from repro_torch.data import synthetic as t_syn
from repro_torch.launch.mesh import make_mesh as t_make_mesh
from repro_torch.testing import to_torch
from repro_torch.train import TrainLoop, TrainLoopConfig
from repro_torch.train import prefetch_to_device as t_prefetch

ROOT = Path(__file__).resolve().parents[1]
TABLES = (100, 60, 40, 30, 20, 200, 51, 77)


class _Pkg:
    """One package's format, reader and pipeline modules."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.fmt = j_format if jax_side else t_format
        self.reader = j_reader if jax_side else t_reader
        self.pipeline = j_pipeline if jax_side else t_pipeline
        self._se, self._spec = (j_se, JSpec) if jax_side else (t_se, TSpec)
        self.prefetch = j_prefetch if jax_side else (
            lambda it, size: t_prefetch(it, size=size, device="cpu"))

    def layout(self, ns=4, mode="row"):
        return self._se.make_layout(self._spec(TABLES, 8), ns, mode)

    def Reader(self, *a, **kw):
        return self.reader.ShardedReader(*a, **kw)


PKGS = {n: _Pkg(n) for n in ("jax", "torch")}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _stream(seed, batch=32, weighted=False, alpha=0.6):
    rng = np.random.default_rng(seed)
    spec = t_syn.SparseBatchSpec(TABLES, None, 3, batch, num_dense=16, alpha=alpha)
    while True:
        b = t_syn.sparse_batch(rng, spec)
        if weighted:
            b["weights"] = rng.uniform(0.5, 1.5, b["idx"].shape).astype(np.float32)
        yield b


def _pack(pkg, tmp_path, n=192, per_shard=40, weighted=False, seed=0):
    out = str(tmp_path / f"{pkg.name}-ds{'w' if weighted else ''}{n}_{per_shard}_{seed}")
    spec = pkg.fmt.DatasetSpec(table_rows=TABLES, pooling=3, num_dense=16, weighted=weighted)
    pkg.fmt.write_shards(_stream(seed, weighted=weighted), out, spec, n,
                         samples_per_shard=per_shard)
    return out


# ---------------------------------------------------------------------------
# tests/test_ingest.py, on both packages
# ---------------------------------------------------------------------------


def test_packed_round_trip_bitwise(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=192, per_shard=40)   # batches cross shard edges
    got = 0
    for mine, orig in zip(pkg.Reader(d, batch=32, shuffle=False).batches(epochs=1), _stream(0)):
        for k in ("idx", "dense_x", "labels"):
            assert np.array_equal(mine[k], orig[k]), k
        got += 1
    assert got == 192 // 32


def test_weighted_round_trip_bitwise(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=96, per_shard=48, weighted=True)
    for mine, orig in zip(pkg.Reader(d, batch=32, shuffle=False).batches(epochs=1),
                          _stream(0, weighted=True)):
        assert np.array_equal(mine["weights"], orig["weights"])
        assert np.array_equal(mine["idx"], orig["idx"])


def test_manifest_and_spec_check(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=64, per_shard=64)
    spec, manifest = pkg.fmt.load_manifest(d)
    assert spec.table_rows == TABLES and spec.pooling == 3
    assert manifest["num_samples"] == 64
    spec.check(TABLES, 3, num_dense=16)              # compatible
    with pytest.raises(ValueError, match="pooling"):
        spec.check(TABLES, 5, num_dense=16)
    with pytest.raises(ValueError, match="table_rows"):
        spec.check((10,) * 8, 3, num_dense=16)
    with pytest.raises(ValueError, match="weights"):
        spec.check(TABLES, 3, num_dense=16, weighted=True)


def test_writer_rejects_bad_batches(pkg, tmp_path):
    w = pkg.fmt.ShardWriter(str(tmp_path / "bad"), pkg.fmt.DatasetSpec(TABLES, 3), 16)
    with pytest.raises(ValueError, match="does not match spec"):
        w.append_batch({"idx": np.zeros((4, 2, 3), np.int32), "labels": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="out of range"):
        bad = np.zeros((4, 8, 3), np.int32)
        bad[0, 0, 0] = 1_000_000
        w.append_batch({"idx": bad, "labels": np.zeros(4, np.float32)})


def test_reader_rank_invariance(pkg, tmp_path):
    """Same seed => identical GLOBAL epoch order across rank counts."""
    d = _pack(pkg, tmp_path, n=192, per_shard=40)
    whole = list(pkg.Reader(d, batch=48, shuffle=True, seed=3).batches(epochs=2))
    for R in (2, 4):
        parts = [list(pkg.Reader(d, batch=48, shuffle=True, seed=3, rank=r,
                                 num_ranks=R).batches(epochs=2)) for r in range(R)]
        for i, ref in enumerate(whole):
            for k in ref:
                cat = np.concatenate([parts[r][i][k] for r in range(R)])
                assert np.array_equal(cat, ref[k]), (R, i, k)


def test_reader_reshard_invariance(pkg, tmp_path):
    """Identical batch contents no matter how the dataset was sharded on
    disk: sequential always; shuffled with an explicit window."""
    d_small = _pack(pkg, tmp_path, n=192, per_shard=24)
    d_large = _pack(pkg, tmp_path, n=192, per_shard=96)
    for kw in (dict(shuffle=False), dict(shuffle=True, window=48, seed=5)):
        a = list(pkg.Reader(d_small, batch=32, **kw).batches(epochs=1))
        b = list(pkg.Reader(d_large, batch=32, **kw).batches(epochs=1))
        for x, y in zip(a, b):
            for k in x:
                assert np.array_equal(x[k], y[k]), (kw, k)


def test_reader_shuffle_seeded_and_epoch_varies(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=128, per_shard=32)
    r = pkg.Reader(d, batch=32, shuffle=True, seed=1)
    o0, o0b = r.epoch_order(0), r.epoch_order(0)
    assert np.array_equal(o0, o0b)                     # deterministic
    assert sorted(o0.tolist()) == list(range(128))     # a permutation
    assert not np.array_equal(o0, r.epoch_order(1))    # epoch decorrelates
    r2 = pkg.Reader(d, batch=32, shuffle=True, seed=2)
    assert not np.array_equal(o0, r2.epoch_order(0))   # seed decorrelates
    # two-level structure: with window == samples_per_shard, every window
    # stays contiguous in id space (shard permutation + intra-shard)
    win = o0.reshape(-1, 32)
    assert sorted(set(w.min() // 32 for w in win)) == [0, 1, 2, 3]
    for w in win:
        assert w.max() - w.min() < 32


def test_reader_validation(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=64, per_shard=32)
    with pytest.raises(ValueError, match="divisible"):
        pkg.Reader(d, batch=30, num_ranks=4)
    with pytest.raises(ValueError, match="rank"):
        pkg.Reader(d, batch=32, rank=4, num_ranks=4)
    with pytest.raises(FileNotFoundError):
        pkg.Reader(str(tmp_path / "nope"), batch=8)


def test_hostpipeline_attaches_psort_and_preserves_stream(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=96, per_shard=48)
    layout = pkg.layout(4)
    plain = list(pkg.Reader(d, batch=32, shuffle=False).batches(epochs=1))
    hp = pkg.pipeline.HostPipeline(pkg.Reader(d, batch=32, shuffle=False).batches(epochs=1),
                                   layout=layout, presort=True)
    piped = list(hp)
    assert len(piped) == len(plain)
    L = 32 * 8 * 3
    for a, b in zip(piped, plain):
        for k in b:
            assert np.array_equal(a[k], b[k]), k
        for k in ("psort_rows", "psort_bags", "psort_msk", "psort_wgt"):
            assert a[k].shape == (4, L)
        ref = pkg.pipeline.presort_batch(layout, b["idx"])
        assert np.array_equal(a["psort_rows"], ref["psort_rows"])
    assert hp.stats["batches"] == len(plain)


def test_hostpipeline_stats_pinned_after_drain(pkg, tmp_path):
    d = _pack(pkg, tmp_path, n=96, per_shard=48)
    hp = pkg.pipeline.HostPipeline(pkg.Reader(d, batch=32, shuffle=False).batches(epochs=1))
    n = sum(1 for _ in hp)
    st = hp.stats
    assert set(st) == {"prep_s", "wait_s", "batches", "retries"}
    assert n == 3 and st["batches"] == 3
    assert st["retries"] == 0
    assert st["prep_s"] > 0.0 and st["wait_s"] >= 0.0


def test_hostpipeline_poisons_on_worker_failure(pkg):
    def bad():
        yield {"idx": np.zeros((2, 8, 3), np.int32)}
        raise OSError("shard vanished")

    hp = pkg.pipeline.HostPipeline(bad())
    next(hp)
    with pytest.raises(OSError, match="shard vanished"):
        next(hp)


def test_chained_pipeline_prefetch_close_does_not_strand(pkg, tmp_path):
    """The launcher chains HostPipeline -> prefetch and closes the INNER
    pipeline first; the outer worker must see the sticky end-of-stream and
    finish instead of blocking forever."""
    d = _pack(pkg, tmp_path, n=64, per_shard=32)
    hp = pkg.pipeline.HostPipeline(pkg.Reader(d, batch=32, shuffle=False))  # infinite
    it = pkg.prefetch(hp, size=2)
    next(it)
    hp.close()
    done = threading.Event()

    def drain():
        for _ in it:        # must terminate via the sticky end-of-stream
            pass
        done.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    assert done.wait(timeout=10.0), "outer prefetch worker stranded"
    it.close()


def test_hostpipeline_validation_and_close(pkg, tmp_path):
    with pytest.raises(ValueError, match="layout"):
        pkg.pipeline.HostPipeline(iter(()), presort=True)
    with pytest.raises(ValueError, match="depth"):
        pkg.pipeline.HostPipeline(iter(()), depth=0)
    d = _pack(pkg, tmp_path, n=64, per_shard=32)
    hp = pkg.pipeline.HostPipeline(pkg.Reader(d, batch=32, shuffle=False))  # infinite
    next(hp)
    hp.close()                                          # no hang


# ---------------------------------------------------------------------------
# Across packages: the bytes, and each reader on the other's dataset
# ---------------------------------------------------------------------------


def _tree_bytes(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def _criteo_tsv(path: Path) -> None:
    """A tiny Criteo-style log: label, 13 dense ints, 26 hex categoricals,
    with empty fields in all three."""
    rng = np.random.default_rng(7)
    lines = []
    for i in range(50):
        label = "" if i % 17 == 3 else str(int(rng.integers(0, 2)))
        dense = ["" if rng.random() < 0.2 else str(int(rng.integers(-2, 500)))
                 for _ in range(13)]
        cats = ["" if rng.random() < 0.15 else f"{int(rng.integers(0, 2 ** 32)):08x}"
                for _ in range(26)]
        lines.append("\t".join([label, *dense, *cats]))
    path.write_text("\n".join(lines) + "\n")


def _cli(module: str, out: Path) -> None:
    args = [sys.executable, "-m", module, "synthetic", "--out", str(out), "--tables",
            ",".join(map(str, TABLES)), "--pooling", "3", "--num-dense", "16", "--num-samples",
            "300", "--samples-per-shard", "128", "--alpha", "1.05", "--seed", "4", "--weighted"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(args, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "packed 300 samples into 3 shard(s)" in proc.stdout


@pytest.mark.parametrize("case", ["unweighted", "weighted", "slot_to_table", "criteo", "cli"])
def test_datasets_are_byte_identical(case, tmp_path):
    """The same arguments pack the same bytes in both packages: every shard
    file and ``dataset.json`` (its key order is the DatasetSpec's fields)."""
    dirs = {}
    for name, p in PKGS.items():
        out = tmp_path / name
        if case == "criteo":
            tsv = tmp_path / "log.tsv"
            if not tsv.exists():
                _criteo_tsv(tsv)
            p.fmt.criteo_tsv_to_shards(tsv, out, (1000,) * 26, samples_per_shard=16, batch=7)
        elif case == "cli":
            _cli("repro.data" if name == "jax" else "repro_torch.data", out)
        else:
            kw = {"weighted": case == "weighted"}
            rows = TABLES
            if case == "slot_to_table":
                rows, kw["slot_to_table"] = TABLES[:3], (0, 2, 2, 1, 0)
            p.fmt.pack_synthetic(out, rows, 3, 203, num_dense=5, alpha=0.8, seed=2,
                                 samples_per_shard=64, batch=50, **kw)
        dirs[name] = out
    a, b = _tree_bytes(dirs["jax"]), _tree_bytes(dirs["torch"])
    assert sorted(a) == sorted(b) and "dataset.json" in a and len(a) > 2
    for name in a:
        assert a[name] == b[name], name
    manifest = json.loads(a["dataset.json"])
    assert list(manifest["spec"]) == [f.name for f in
                                      t_format.dataclasses.fields(t_format.DatasetSpec)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("num_ranks", [1, 2, 4])
def test_readers_read_either_dataset_alike(writer, num_ranks, tmp_path):
    """Each package's reader on a dataset packed by ``writer``: the same
    batches bit for bit, over two seeds, two epochs, the shard window and an
    explicit one, and every rank's slice; and the same epoch orders."""
    d = _pack(PKGS[writer], tmp_path, n=200, per_shard=48, weighted=True, seed=num_ranks)
    for seed in (0, 11):
        for window in (None, 40):
            kw = dict(batch=32, seed=seed, window=window, num_ranks=num_ranks)
            j_r = j_reader.ShardedReader(d, **kw)
            t_r = t_reader.ShardedReader(d, **kw)
            for e in (0, 1):
                assert np.array_equal(j_r.epoch_order(e), t_r.epoch_order(e))
            assert j_r.nbytes_per_batch() == t_r.nbytes_per_batch()
            for rank in range(num_ranks):
                kw["rank"] = rank
                ja = list(j_reader.ShardedReader(d, **kw).batches(epochs=2))
                ta = list(t_reader.ShardedReader(d, **kw).batches(epochs=2))
                assert len(ja) == len(ta) == 2 * (200 // 32)
                for x, y in zip(ja, ta):
                    assert sorted(x) == sorted(y)
                    for k in x:
                        assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def _write_ragged_shard(path: Path, lengths: np.ndarray, rng, weighted: bool) -> dict:
    """One shard of 2 slots whose bags are ``lengths`` [N, 2] long (CSR),
    written by hand in the format's layout; returns its arrays."""
    n, S = lengths.shape
    dense = rng.standard_normal((n, 4)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float32)
    arrays, slots = [dense, labels], []
    for s in range(S):
        offs = np.concatenate([[0], np.cumsum(lengths[:, s])]).astype(np.int64)
        ids = rng.integers(0, TABLES[s], int(offs[-1])).astype(np.int32)
        w = rng.uniform(0.5, 1.5, int(offs[-1])).astype(np.float32)
        arrays += [offs, ids] + ([w] if weighted else [])
        slots.append((offs, ids, w))
    H, T = struct.Struct("<4sIQIIII"), struct.Struct("<QQ")
    flags = t_format.FLAG_LABELS | (t_format.FLAG_WEIGHTS if weighted else 0)
    off = (H.size + T.size * len(arrays) + 7) & ~7
    table = []
    for a in arrays:
        table.append((off, a.nbytes))
        off = (off + a.nbytes + 7) & ~7
    with open(path, "wb") as f:
        f.write(H.pack(b"RPKS", 1, n, S, 4, flags, len(arrays)))
        for o, nb in table:
            f.write(T.pack(o, nb))
        pos = H.size + T.size * len(arrays)
        for a, (o, nb) in zip(arrays, table):
            f.write(b"\0" * (o - pos) + a.tobytes())
            pos = o + nb
    return {"dense": dense, "labels": labels, "slots": slots}


@pytest.mark.parametrize("weighted", [True, False])
def test_ragged_shard_reads_alike(weighted, tmp_path):
    """A shard with ragged bags (0 to 5 lookups; pooling 3): both readers
    right-pad with id 0 and weight 0 and cut a longer bag at the pooling,
    bit for bit alike and as the CSR arrays say; without weights both
    refuse it, since padding needs weight 0 to be a no-op."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 6, (40, 2))
    arr = _write_ragged_shard(tmp_path / "shard-00000.bin", lengths, rng, weighted)
    spec = t_format.DatasetSpec(table_rows=TABLES[:2], pooling=3, num_dense=4, weighted=weighted)
    manifest = {"format": "repro-packed-shards", "version": 1, "spec": spec.to_json(),
                "samples_per_shard": 40, "num_samples": 40,
                "shards": [{"file": "shard-00000.bin", "num_samples": 40}]}
    (tmp_path / "dataset.json").write_text(json.dumps(manifest, indent=1))
    readers = [m.ShardedReader(tmp_path, batch=8, seed=2) for m in (j_reader, t_reader)]
    if not weighted:
        for r in readers:
            with pytest.raises(ValueError, match="ragged bags but no weights"):
                next(iter(r))
        return
    order = readers[1].epoch_order(0)
    for i, (a, b) in enumerate(zip(*(r.batches(epochs=1) for r in readers))):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        for j, sid in enumerate(order[i * 8:(i + 1) * 8]):
            for s, (offs, ids, w) in enumerate(arr["slots"]):
                lo, hi = int(offs[sid]), int(offs[sid + 1])
                k = min(hi - lo, 3)
                want_i = np.zeros(3, np.int32)
                want_w = np.zeros(3, np.float32)
                want_i[:k], want_w[:k] = ids[lo:lo + k], w[lo:lo + k]
                assert np.array_equal(b["idx"][j, s], want_i)
                assert np.array_equal(b["weights"][j, s], want_w)
            assert np.array_equal(b["dense_x"][j], arr["dense"][sid])


MODEL = dict(name="t", num_dense=16, bottom=(32, 8), top=(32,), table_rows=TABLES, emb_dim=8,
             pooling=3, batch=32)


def test_batch_struct_from_spec_messages(tmp_path):
    """``batch_struct_from_spec`` accepts the matching dataset and raises the
    reference's messages for a pooling, a weighted and an extras mismatch."""
    t_cfg = t_dlrm.DLRMConfig(**MODEL)
    j_cfg = j_dlrm.DLRMConfig(**MODEL)
    j_mesh = j_make_mesh((1, 1), ("data", "model"))
    t_mesh = t_make_mesh((1, 1), ("data", "model"), device="cpu")
    mdef = j_dlrm.as_hybrid_def(j_cfg)
    j_layout = j_hybrid.make_layout(mdef, j_mesh)
    t_layout = t_hybrid.make_layout(t_cfg, t_mesh)
    spec, _ = t_format.load_manifest(_pack(PKGS["torch"], tmp_path, n=32, per_shard=32))
    structs = t_hybrid.batch_struct_from_spec(t_cfg, t_mesh, t_layout, spec)
    want, _ = j_hybrid.batch_struct_from_spec(mdef, j_mesh, j_layout, spec)
    assert list(structs) == list(want)
    for k, (shape, _) in structs.items():
        assert shape == tuple(want[k].shape), k

    def messages(t_spec):
        out = []
        for call in (lambda: t_hybrid.batch_struct_from_spec(t_cfg, t_mesh, t_layout, t_spec),
                     lambda: j_hybrid.batch_struct_from_spec(mdef, j_mesh, j_layout, t_spec)):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        assert out[0] == out[1]
        return out[0]

    assert "pooling 5 != model 3" in messages(
        t_format.DatasetSpec(table_rows=TABLES, pooling=5, num_dense=16))
    assert "weighted" in messages(
        t_format.DatasetSpec(table_rows=TABLES, pooling=3, num_dense=16, weighted=True))
    # extras the format cannot carry are rejected at wiring time
    from repro.models import recsys as R
    sas = R.make_sasrec(64, batch=16)
    with pytest.raises(ValueError, match="seq_mask") as j_err:
        spec.check_model(sas)
    with pytest.raises(ValueError, match="seq_mask") as t_err:
        t_format.DatasetSpec(**{**spec.to_json(), "table_rows": tuple(spec.table_rows)}
                             ).check_model(sas)
    assert str(j_err.value) == str(t_err.value)


# ---------------------------------------------------------------------------
# The reader's read-only views in a loop, and the acceptance property
# ---------------------------------------------------------------------------


@pytest.mark.filterwarnings("error::UserWarning")
@pytest.mark.parametrize("mesh", [False, True])
def test_sequential_reader_feeds_a_cpu_loop(mesh, tmp_path):
    """A ``shuffle=False`` reader's batches are read-only mmap views (the
    fast path); a CPU loop over them, with prefetch or cut to a mesh's
    block, raises no warning and trains as on writable copies."""
    d = _pack(PKGS["torch"], tmp_path, n=96, per_shard=48)
    first = next(iter(t_reader.ShardedReader(d, batch=32, shuffle=False)))
    assert not first["dense_x"].flags.writeable and not first["labels"].flags.writeable
    cfg = t_dlrm.DLRMConfig(**MODEL)
    m = t_make_mesh((1, 1), ("data", "model"), device="cpu")
    start = t_dlrm.init_state(cfg, torch.Generator().manual_seed(0), mesh=m)
    step = t_dlrm.make_train_step(cfg, m)
    loop = TrainLoop(TrainLoopConfig(steps=3, prefetch=0 if mesh else 2, log_every=100), step,
                     weights.state_to(start, "cpu"),
                     t_reader.ShardedReader(d, batch=32, shuffle=False), device="cpu",
                     **({"mesh": m, "model_cfg": cfg} if mesh else {}))
    loop.run()
    state, want = weights.state_to(start, "cpu"), []
    for b in t_reader.ShardedReader(d, batch=32, shuffle=False).batches(epochs=1):
        state, loss = step(state, {k: torch.from_numpy(v.copy()) for k, v in b.items()})
        want.append(float(loss))
    assert loop.losses == want


def _tensor_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("M", [1, 2])
def test_packed_presorted_step_is_the_in_process_step(M, tmp_path):
    """The reference's acceptance property on the port: the in-process
    stream packed, read back, pre-sorted by ``HostPipeline`` and trained
    with ``host_presort`` is bit for bit (every loss, every slab) the
    device-sorted step on the in-process stream, at M microbatches."""
    import dataclasses
    d = _pack(PKGS["torch"], tmp_path, n=96, per_shard=40)   # batches cross shards
    base = t_dlrm.DLRMConfig(**MODEL, microbatches=M)
    m = t_make_mesh((1, 1), ("data", "model"), device="cpu")
    start = t_dlrm.init_state(base, torch.Generator().manual_seed(0), mesh=m)
    res = {}
    for tag in ("inproc", "packed"):
        cfg = dataclasses.replace(base, host_presort=tag == "packed")
        step = t_dlrm.make_train_step(cfg, m)
        if tag == "packed":
            stream = t_pipeline.HostPipeline(
                t_reader.ShardedReader(d, batch=32, shuffle=False).batches(epochs=1),
                layout=t_hybrid.make_layout(cfg, m), presort=True)
        else:
            stream = _stream(0)
        state, losses = weights.state_to(start, "cpu"), []
        for _ in range(3):
            state, loss = step(state, _tensor_batch(next(stream)))
            losses.append(float(loss))
        res[tag] = losses, weights.state_to_numpy(state)
    assert res["inproc"][0] == res["packed"][0]
    for a, b in zip(jax.tree.leaves(res["inproc"][1]), jax.tree.leaves(res["packed"][1])):
        assert np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_packed_presorted_step_held_to_the_reference(tmp_path):
    """The packed, pre-sorted stream through both packages' steps at (1, 1)
    from the reference's state (``weights.state_from_numpy``): each
    package's own reader and pipeline, three steps, the losses within 1e-6
    relative and the state within ``tests/test_torch_hybrid.py``'s
    tolerances (``_torch_cases.hold_state``)."""
    from _torch_cases import hold_state
    d = _pack(PKGS["torch"], tmp_path, n=96, per_shard=40)
    j_cfg = j_dlrm.DLRMConfig(**MODEL, host_presort=True)
    t_cfg = t_dlrm.DLRMConfig(**MODEL, host_presort=True)
    j_mesh = j_make_mesh((1, 1), ("data", "model"))
    t_mesh = t_make_mesh((1, 1), ("data", "model"), device="cpu")
    state, j_layout = j_dlrm.init_state(jax.random.PRNGKey(0), j_cfg, j_mesh)
    start = jax.tree.map(np.asarray, state)
    t_state = weights.state_to(weights.state_from_numpy(start, t_cfg, device="cpu"), "cpu")
    j_step, _, _, _ = j_dlrm.make_train_step(j_cfg, j_mesh)
    t_step = t_dlrm.make_train_step(t_cfg, t_mesh)
    j_stream = j_pipeline.HostPipeline(
        j_reader.ShardedReader(d, batch=32, seed=1).batches(epochs=1), layout=j_layout,
        presort=True)
    t_stream = t_pipeline.HostPipeline(
        t_reader.ShardedReader(d, batch=32, seed=1).batches(epochs=1),
        layout=t_hybrid.make_layout(t_cfg, t_mesh), presort=True)
    j_losses, t_losses, batches = [], [], []
    for jb, tb in zip(j_stream, t_stream):
        for k in tb:
            assert np.array_equal(jb[k], tb[k]), k   # one shard: the reference's pre-sort
        batches.append({k: v for k, v in tb.items()})
        state, loss = j_step(state, jax.tree.map(jnp.asarray, jb))
        j_losses.append(float(loss))
        t_state, loss = t_step(t_state, {k: to_torch(v) for k, v in tb.items()})
        t_losses.append(float(loss))
    assert len(t_losses) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6, atol=0)
    c = {"start": start, "mesh": (1, 1), "cfg": {**MODEL, "host_presort": True},
         "batches": batches}
    hold_state(c, weights.state_to_numpy(t_state), jax.tree.map(np.asarray, state),
               bitwise=False)
