"""Fault-tolerant, verified checkpointing (twin of
``repro/checkpoint/manager.py``), in the reference's on-disk format, so that
either package restores the other's checkpoints.

* atomic commit: writes land in ``step_<n>.tmp/`` and are ``os.replace``d
  into place only when complete;
* verified restore: ``meta.json`` carries the format version and a CRC32 an
  array; restore checks the structure (the treedef string, the key set) and
  the content, on the arrays it restores (read once), and
  ``latest_valid_step`` falls back to the newest checkpoint that verifies;
* bounded retry of ``OSError`` with exponential backoff; an
  :class:`repro_torch.faults.InjectedCrash` is never retried;
* async save: the host copy of the state is taken before any later kernel
  can change it (the port's train step updates its state in place: CUDA
  leaves go to pinned buffers on the device's stream, ahead of the next
  step), the write runs on a thread once that copy has landed, and its
  failure is re-raised at the next ``save`` or ``wait``;
* retention of the newest ``keep`` checkpoints.

The format (v2): ``step_<n>/arrays.npz`` holds one array a leaf, keyed by
its path in the tree (``dense/hi/bot/b/0``, ``emb/hi``, ``sr``; ``""`` for
a state that is one leaf), in JAX's pytree order: dict keys sorted, list
and tuple items in order, ``None`` an empty subtree.  ``meta.json`` holds
``format_version``, ``step``, ``treedef`` (the string
``str(jax.tree_util.tree_structure(state))`` gives, rendered here without
JAX), ``time``, the sorted ``keys``, a ``dtypes`` tag a key and the
``checksums``.  npz holds no bf16, so a bf16 leaf is stored as its uint16
bits tagged ``"bfloat16"``; the port keeps the reference's uint16 slabs
(the Split-SGD ``lo`` halves) as int16 bits, and writes them as uint16
tagged ``"uint16"``, as the reference writes its own.  Nothing here needs
``ml_dtypes``.

Fault-injection hook points (``repro_torch/faults/plan.py``):
``ckpt.write.arrays``, ``ckpt.write.meta``, ``ckpt.commit``.

An elastic restart restores the global arrays of one mesh onto another:
:func:`reshard_store` re-lays-out the embedding store for the new shard
count, :func:`reshard_dense` the dense ``lo``'s bucketed layout for the new
rank count.  Both move values and change no bit.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.faults.plan import NO_FAULTS, InjectedCrash
from repro_torch.optim.data_parallel import tree_unflatten

#: meta.json schema version.  1 = pre-verification (no checksums, verified
#: structurally only); 2 = per-array crc32 + format_version fields.
FORMAT_VERSION = 2


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or restored."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint directory exists but fails verification."""


def tree_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` of every leaf in JAX's pytree order; a key joins the
    dict keys and sequence indices of its path with ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in tree_paths(t, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def treedef_str(tree) -> str:
    """The string ``str(jax.tree_util.tree_structure(tree))`` gives for a
    tree of dicts, lists, tuples and ``None``."""
    def render(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(render(x) for x in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(render(x) for x in t) + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({render(tree)})"


def dtype_tag(leaf) -> str:
    """The dtype a leaf is saved as: the reference's name for it (an int16
    tensor holds uint16 bits), or "" for a Python scalar."""
    if isinstance(leaf, torch.Tensor):
        return "uint16" if leaf.dtype == torch.int16 else str(leaf.dtype).removeprefix("torch.")
    return str(getattr(leaf, "dtype", ""))


def _stored(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor as the array npz stores (bf16 and int16 as
    uint16 bits), sharing its memory."""
    if t.dtype in (torch.bfloat16, torch.int16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """A numpy copy of a leaf that is not on a CUDA device, as it is stored,
    and its dtype tag."""
    if isinstance(leaf, torch.Tensor):
        return _stored(leaf.detach().to("cpu", copy=True).contiguous()), dtype_tag(leaf)
    arr = np.array(leaf)
    tag = str(arr.dtype)
    if arr.dtype.kind == "V" or tag == "bfloat16":
        arr = arr.view(np.uint16)
    return arr, tag


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def _restore_leaf(arr: np.ndarray, like: torch.Tensor, want: str, key: str) -> torch.Tensor:
    """A stored array as a CPU tensor of ``like``'s dtype (uint16 bits back to
    int16 or bf16)."""
    if tuple(arr.shape) != tuple(like.shape):
        raise CheckpointError(f"checkpoint leaf {key!r} has shape {arr.shape}, the restore target "
                              f"{tuple(like.shape)}")
    t = torch.from_numpy(arr.view(np.int16) if arr.dtype == np.uint16 else arr)
    if want == "bfloat16":
        t = t.view(torch.bfloat16)
    if t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {key!r} holds {arr.dtype}, the restore target "
                         f"{like.dtype}")
    return t


def _place(likes: list, values: list, dev: torch.device) -> list:
    """``values`` on ``dev``, with the aliasing of ``likes``: tensors that are
    views of one contiguous buffer come back as the same views of one new
    buffer (zero where no leaf covers it), so a train state keeps its dense
    ``hi`` leaves in one flat buffer; other tensors, and a view of another
    dtype than its buffer's (whose offsets count the buffer's elements), are
    copied alone."""
    bases: dict[int, torch.Tensor] = {}
    out = []
    for like, v in zip(likes, values):
        base = like._base if isinstance(like, torch.Tensor) else None
        if not isinstance(v, torch.Tensor):
            out.append(v)
        elif base is None or not base.is_contiguous() or base.dtype != like.dtype:
            out.append(v.to(dev))
        else:
            new = bases.get(id(base))
            if new is None:
                new = bases[id(base)] = torch.zeros(base.shape, dtype=base.dtype, device=dev)
            view = new.as_strided(like.shape, like.stride(),
                                  like.storage_offset() - base.storage_offset())
            out.append(view.copy_(v))
    return out


class CheckpointManager:
    def __init__(
        self,
        directory,
        keep: int = 3,
        retries: int = 2,
        backoff_s: float = 0.05,
        checksums: bool = True,
        verify_on_restore: bool = True,
        faults=None,
        event_log=None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.retries = retries
        self.backoff_s = backoff_s
        self.checksums = checksums
        self.verify_on_restore = verify_on_restore
        self.faults = faults if faults is not None else NO_FAULTS
        self.events = event_log
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: wall seconds of each completed save's write (arrays, CRCs, meta,
        #: commit), async or blocking, newest last: the heartbeat reports these
        self.save_durations: list[float] = []
        #: wall seconds from each save's copy until it had landed on the host, newest last
        self.copy_durations: list[float] = []
        # pinned host buffers for the CUDA leaves, by key, reused from save to save
        self._pinned: dict[str, torch.Tensor] = {}

    def _record(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.record(kind, **fields)

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Write checkpoint ``step``.  Re-raises any failure of a PREVIOUS
        background save first.

        The caller may go on updating the state in place once this returns:
        a CUDA leaf is copied into a pinned host buffer of this manager
        (``non_blocking``, on the device's current stream, so ahead of any
        later kernel there), and the writer waits for that copy's event
        before it reads the buffer; any other leaf is copied here.  The
        buffers are reused, so the previous save's write is joined first."""
        self._raise_pending()
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time; it reads the buffers
            self._thread = None
            self._raise_pending()
        t0 = time.perf_counter()
        with telemetry.span("ckpt/flatten", cat="ckpt", step=step):
            flat, dtypes, devices = {}, {}, set()
            for key, leaf in tree_paths(state):
                if not (isinstance(leaf, torch.Tensor) and leaf.is_cuda):
                    flat[key], dtypes[key] = _host_copy(leaf)
                    continue
                buf = self._pinned.get(key)
                if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
                    buf = self._pinned[key] = torch.empty(leaf.shape, dtype=leaf.dtype,
                                                          pin_memory=True)
                buf.copy_(leaf.detach(), non_blocking=True)
                flat[key], dtypes[key] = _stored(buf), dtype_tag(leaf)
                devices.add(leaf.device)
            copied = [torch.cuda.Event() for _ in devices]
            for event, dev in zip(copied, devices):
                event.record(torch.cuda.current_stream(dev))
        treedef = treedef_str(state)

        def write():
            for event in copied:
                event.synchronize()
            self.copy_durations.append(time.perf_counter() - t0)
            t1 = time.perf_counter()
            # explicit track: the blocking path runs on the caller's thread,
            # the async path on a fresh writer thread; both land on one
            # 'ckpt_writer' timeline
            with telemetry.span("ckpt/write", cat="ckpt", track="ckpt_writer", step=step):
                self._write_with_retry(step, flat, dtypes, treedef)
            self.save_durations.append(time.perf_counter() - t1)

        if blocking:
            write()
        else:

            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 — surfaced at next save/wait
                    self._error = e
                    self._record("ckpt_async_save_failed", step=step, error=repr(e))

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            if isinstance(e, InjectedCrash):
                raise e  # simulated process death keeps its semantics
            raise CheckpointError(f"background checkpoint save failed: {e!r}") from e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _write_with_retry(self, step, flat, dtypes, treedef_str) -> None:
        """Bounded retry with exponential backoff around one atomic write
        attempt.  Only ``OSError`` (transient IO: ENOSPC, flaky mounts) is
        retried; ``InjectedCrash`` models process death and propagates."""
        last: Optional[OSError] = None
        for attempt in range(self.retries + 1):
            try:
                self._write_once(step, flat, dtypes, treedef_str)
                return
            except OSError as e:
                last = e
                self._record("ckpt_write_retry", step=step, attempt=attempt, error=repr(e))
                if attempt < self.retries:
                    time.sleep(self.backoff_s * (2**attempt))
        self._record("ckpt_write_failed", step=step, error=repr(last))
        raise CheckpointError(
            f"checkpoint save at step {step} failed after {self.retries + 1} attempts"
        ) from last

    def _write_once(self, step, flat, dtypes, treedef_str) -> None:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        fault = self.faults.fire("ckpt.write.arrays", step=step)
        torn = fault is not None and fault.action == "partial"
        if torn:
            # commit a TORN arrays.npz behind a valid-looking directory: the
            # case that slips past the atomic rename and only the checksums
            # catch (a simulated fs lie / post-commit bit rot)
            buf = io.BytesIO()
            np.savez(buf, **flat)
            raw = buf.getvalue()
            (tmp / "arrays.npz").write_bytes(raw[: max(1, len(raw) // 3)])
        else:
            np.savez(tmp / "arrays.npz", **flat)
        meta = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "treedef": treedef_str,
            "time": time.time(),
            "keys": sorted(flat),
            "dtypes": dtypes,
        }
        if self.checksums:
            meta["checksums"] = {k: _crc(v) for k, v in flat.items()}
        self.faults.fire("ckpt.write.meta", step=step)
        (tmp / "meta.json").write_text(json.dumps(meta))
        self.faults.fire("ckpt.commit", step=step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        if torn:
            raise InjectedCrash(f"injected torn-commit crash at step {step}")
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------ verify
    def verify(self, step: int) -> None:
        """Raise :class:`CheckpointCorruptError` unless checkpoint ``step``
        is structurally complete and (format >= 2) every array's CRC32
        matches ``meta.json``."""
        self._checked(step, keep=False)

    def _checked(self, step: int, keep: bool) -> tuple[dict, Optional[dict]]:
        """:meth:`verify` of ``step``: its ``meta.json``, and with ``keep``
        its arrays as read for their checksums (so a verified restore reads
        them once), else None."""
        cdir = self.dir / f"step_{step}"
        meta_p = cdir / "meta.json"
        arrays_p = cdir / "arrays.npz"
        if not meta_p.exists() or not arrays_p.exists():
            raise CheckpointCorruptError(f"step {step}: incomplete checkpoint directory")
        try:
            meta = json.loads(meta_p.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CheckpointCorruptError(f"step {step}: unreadable meta.json: {e!r}") from e
        version = meta.get("format_version", 1)
        if version > FORMAT_VERSION:
            raise CheckpointCorruptError(
                f"step {step}: format_version {version} is newer than this reader ({FORMAT_VERSION})"
            )
        if meta.get("step") != step:
            raise CheckpointCorruptError(
                f"step {step}: meta.json records step {meta.get('step')!r}"
            )
        sums = meta.get("checksums")
        arrays = {} if keep else None
        try:
            with np.load(arrays_p) as data:
                keys = sorted(data.files)
                if keys != sorted(meta.get("keys", keys)):
                    raise CheckpointCorruptError(f"step {step}: array keys do not match meta.json")
                if sums is not None or keep:
                    for k in keys:
                        arr = data[k]
                        if sums is not None:
                            crc = _crc(arr)
                            if crc != sums.get(k):
                                raise CheckpointCorruptError(
                                    f"step {step}: checksum mismatch on {k!r} "
                                    f"(stored {sums.get(k)}, computed {crc})"
                                )
                        if keep:
                            arrays[k] = arr
        except CheckpointCorruptError:
            raise
        except Exception as e:  # noqa: BLE001 — any load failure IS corruption
            raise CheckpointCorruptError(f"step {step}: unreadable arrays.npz: {e!r}") from e
        return meta, arrays

    def is_valid(self, step: int) -> bool:
        try:
            self.verify(step)
            return True
        except CheckpointCorruptError:
            return False

    # ----------------------------------------------------------- restore
    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.iterdir()
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        )

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that passes :meth:`verify`.  Corrupt or incomplete
        checkpoints are skipped (and logged): the fallback scan that keeps a
        torn latest checkpoint from wedging a restart."""
        return self._latest_valid(keep=False)[0]

    def _latest_valid(self, keep: bool) -> tuple[Optional[int], Optional[dict], Optional[dict]]:
        """``(step, meta, arrays)`` of :meth:`latest_valid_step` (its
        :meth:`_checked`), or Nones."""
        for step in sorted(self.steps(), reverse=True):
            try:
                return (step, *self._checked(step, keep))
            except CheckpointCorruptError as e:
                self._record("ckpt_corrupt_skipped", step=step, error=str(e))
                print(f"[ckpt] skipping corrupt checkpoint step {step}: {e}")
        return None, None, None

    def restore(
        self,
        like: Any,
        step: Optional[int] = None,
        device="cuda",
        verify: Optional[bool] = None,
    ) -> tuple[int, Any]:
        """Restore into the structure of ``like``, a tree of tensors (``meta``
        tensors will do), numpy arrays or Python scalars.  Tensor leaves come
        back on ``device`` in ``like``'s dtypes and aliasing (see
        :func:`_place`); the other leaves as numpy arrays, as the reference
        gives them.

        With verification on (the default), ``step=None`` resolves to
        :meth:`latest_valid_step` (corrupt checkpoints are skipped), an
        explicitly requested ``step`` must verify or the restore refuses, and
        the saved treedef must be ``like``'s.  A leaf whose saved dtype tag is
        not the target's is refused in both directions, as the reference
        refuses it.
        """
        dev = resolve_device(device)
        verify = self.verify_on_restore if verify is None else verify
        arrays = None   # with verification, the arrays as its checksums read them
        if step is None:
            step, meta, arrays = (self._latest_valid(keep=True) if verify
                                  else (self.latest_step(), None, None))
            if step is None:
                raise FileNotFoundError(f"no {'valid ' if verify else ''}checkpoints in {self.dir}")
        elif verify:
            meta, arrays = self._checked(step, keep=True)
        cdir = self.dir / f"step_{step}"
        if arrays is None:
            meta = json.loads((cdir / "meta.json").read_text())
        # dtype tags: older checkpoints lack them and trust the target alone
        tags = meta.get("dtypes", {})
        if verify and meta.get("treedef") is not None:
            want_tree = treedef_str(like)
            if meta["treedef"] != want_tree:
                raise CheckpointError(
                    f"step {step}: checkpoint tree structure does not match the "
                    f"restore target (saved {meta['treedef']}, want {want_tree})"
                )
        paths = tree_paths(like)
        values = []
        with (np.load(cdir / "arrays.npz") if arrays is None
              else contextlib.nullcontext(arrays)) as data:
            for key, leaf in paths:
                arr = data[key]
                tag = tags.get(key)
                want = dtype_tag(leaf) or tag or ""
                if want and tag and want != tag:
                    raise ValueError(
                        f"checkpoint leaf {key!r} dtype mismatch: saved as "
                        f"{tag}, restore target {want} — convert the state "
                        "explicitly instead of reinterpreting it"
                    )
                values.append(_restore_leaf(arr, leaf, want, key)
                              if isinstance(leaf, torch.Tensor) else arr)
        likes = [leaf for _, leaf in paths]
        return step, tree_unflatten(like, _place(likes, values, dev))


def _zeros(like, shape: tuple):
    """Zeros of ``like``'s dtype: a numpy array or a CPU tensor, as ``like``."""
    if isinstance(like, torch.Tensor):
        return like.new_zeros(shape)
    return np.zeros(shape, like.dtype)


def reshard_embedding(old_layout, new_layout, W_old):
    """Re-lay-out a unified embedding array when the shard count (and hence
    row padding / bin packing) changes across an elastic restart (twin of
    the reference's function): every table's rows move from their place in
    ``old_layout`` to their place in ``new_layout``
    (``core.sharded_embedding.ShardedEmbeddingLayout``, row or table mode);
    the rows no table owns (padding, table mode's spare rows) are zero.
    ``W_old`` [old total rows, width]: a numpy array of any dtype
    (``ml_dtypes``' bf16 too) or a CPU tensor; the result is of its kind and
    dtype."""
    spec = old_layout.spec

    def table_base(layout, t):
        if layout.mode == "row":
            return int(spec.row_offsets[t])
        # table mode: the slot whose table is t (the first such)
        for pos, s in enumerate(layout.padded_slots):
            if s >= 0 and layout.slot_to_table[s] == t:
                shard = pos // layout.slots_per_shard
                return shard * layout.rows_per_shard + int(layout.slot_local_offsets[pos])
        raise KeyError(t)

    W_new = _zeros(W_old, (new_layout.total_rows,) + tuple(W_old.shape[1:]))
    for t, rows in enumerate(spec.table_rows):
        src, dst = table_base(old_layout, t), table_base(new_layout, t)
        W_new[dst:dst + rows] = W_old[src:src + rows]
    return W_new


def reshard_store(old_layout, new_layout, store: dict) -> dict:
    """Re-lay-out a whole embedding store (``optim.row``) across an elastic
    restart: the weight slabs and the optimizer's state slabs are
    row-aligned on one layout, so each reshards as the weights do, keeping
    its dtype (bf16 ``hi``, uint16 or int16 ``lo``, fp32 state, bf16
    compressed state, int32 ``cnt``)."""
    return {k: reshard_embedding(old_layout, new_layout, v) for k, v in store.items()}


def reshard_dense(dense: dict, old_ranks: int, new_ranks: int, num_buckets: int = 4) -> dict:
    """The global dense state ``{"hi": tree, "lo": [padded], "err": None}``
    of ``old_ranks`` ranks -> the same values laid out for ``new_ranks``:
    ``lo`` back to the natural order (``optim.data_parallel``'s bucketed
    layout inverted), its padding dropped and re-padded with zeros, and
    bucketed for the new rank count; ``hi`` as it is.  What the reference's
    elastic restart does (``examples/elastic_restart.py``: fp32 masters from
    ``hi`` and the old ``lo``, then ``dp_global_arrays`` on the new mesh),
    without the round trip through fp32, which changes no bit.  ``lo``: a
    numpy array or a CPU tensor."""
    if dense.get("err") is not None:
        raise NotImplementedError("the dense error feedback's 'err' slab is not resharded: the "
                                  "reference has no reshard of the dense state")
    lo = dense["lo"]
    n = sum(int(np.prod(a.shape)) for _, a in tree_paths(dense["hi"]))
    nat = lo.reshape(old_ranks, num_buckets, -1).swapaxes(0, 1).reshape(-1)
    m = new_ranks * num_buckets
    padded = _zeros(lo, (-(-n // m) * m,))
    padded[:n] = nat[:n]
    new = padded.reshape(num_buckets, new_ranks, -1).swapaxes(0, 1).reshape(-1)
    return {"hi": dense["hi"], "lo": new, "err": None}
