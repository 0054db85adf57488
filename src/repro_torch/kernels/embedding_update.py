"""Fused sparse embedding backward + row update on Hopper
(``csrc/embedding_update.cuh``, its launchers in ``csrc/embedding_update*.cu``).

Replaces the eight TPU kernels of ``repro/kernels/embedding_update.py``
(``_kernel_split`` :82 to ``_kernel_adagrad_bf16`` :268), in one kernel
source: one run walk, and each kernel's optimizer step an epilogue on it:

- ``_kernel_split`` :82 (via ``fused_update_split_pallas``; the paper's Alg. 3
  + C5) and ``_kernel_fp32`` :114 (via ``fused_update_fp32_pallas``): ``w =
  fmaf(-lr, acc, w)`` on the Split-SGD store (``w = (hi << 16) | lo``,
  re-split) or an fp32 ``W``;
- ``_kernel_momentum`` :151 (via ``fused_update_momentum_pallas``): ``m`` = the
  run's lookups added in order onto ``beta * m``, ``w = fmaf(-lr, m, w)``
  (what the jitted reference computes; the TPU kernel adds ``beta * m`` to
  the run's sum, the same terms in another order);
- ``_kernel_adagrad`` :169 (via ``fused_update_adagrad_pallas``, ``rowwise=False``):
  ``s = fmaf(acc, acc, s)``, ``w = w - (lr * acc) / (sqrt(s) + eps)``;
- ``_make_kernel_adagrad_rowwise`` :190 (the same wrapper, ``rowwise=True``): one
  accumulator a row, ``s += sum_e acc^2 / E``, then the Adagrad step;
- ``_kernel_freq`` :219 (via ``fused_update_freq_pallas``): ``w = w - (lr * acc) /
  (sqrt(max(cnt, 1)) + eps)``, reading the row's touch count, which the
  caller has bumped;
- ``_kernel_momentum_bf16`` :243 and ``_kernel_adagrad_bf16`` :268 (via
  ``fused_update_momentum_bf16_pallas`` and ``..._adagrad_bf16_pallas``):
  momentum and Adagrad with the state slab stored as bf16.  The state is
  decoded exactly, the step runs in fp32 as above (Adagrad's weight step
  divides by the root of the unrounded ``s``), and the new state is stored
  rounded stochastically (``optim/stochastic.py``): ``lowbias32`` in uint32
  arithmetic keyed on the seed, the run's row and each value's column (a
  lane holds columns ``c`` and ``c + 1``).  The seed is read on the device
  through a pointer to the train state's ``sr`` counter: passed by value it
  would need ``.item()``, a host sync.

The embedding backward is no gradient tensor: for each run of equal rows in
the sorted lookup stream, ``acc = sum(wgt * dY[bag])`` in fp32 in sorted
flat order, then one step on that row, in place.  Rows nobody looked up are
never read or written: the TPU kernels' ``input_output_aliases``.  A run
made only of masked lookups (the sorted tail) writes neither the row nor its
state, since ``beta * m`` is no no-op: the TPU kernels' liveness flag.
``dY`` is bf16 (the row-mode wire's own type) or fp32 (the type the
reference's kernels read), exact in fp32 either way; the kernel is
templated on it.  Row addresses are int64.

What bounds it on an H100: on a skewed stream, the longest run's add chain;
otherwise the bytes of the touched rows (read and written once, 8 bytes a
value of ``w`` and as much again for an ``[M, E]`` state slab), the
cotangent rows and the sorted stream.  Bitwise parity with the reference
fixes the order of the sum inside a run, so a run is one serial chain of
dependent fp32 adds, one a lookup, and no warp can split it: zipf(1.05)
sends about half of a table's lookups to one row, so at B = 8192, pooling
50, one run holds some 212 K lookups and its adds alone take about 0.43 ms.

Design: one walk, two schedules, and one epilogue (the step) per kind.

- A first kernel lists the runs of T = 512 positions or more (a constant
  of the source, :func:`long_run`): ``(start, row)`` into a device list
  with an atomic counter, capacity ``L // T + 1``, which the wrapper
  allocates at the size the library returns (:func:`list_words`).  The
  long runs' kernel gives a block to each of the list's slots (a block past
  the count exits at once); the short runs' kernel, a warp to each window
  of 32 positions, runs beside it on a second stream, forked from the
  caller's and joined back before the launcher returns (three blocks an SM
  for it, a tighter register budget than the long runs' consumer can
  take).  The second stream and its two events are one a device, shared by
  every caller, so a launch holds a lock from the fork to the join: launches
  from several threads are safe, and their short runs' kernels take turns
  on that stream.  No host sync:
  nothing about the runs comes back to the host (the count stays on the
  card, in ``wrapper.long_runs``).
- A long run's block is warp-specialised around a ring of stages in shared
  memory, each guarded by a full and an empty mbarrier.  A stage is one
  segment (32 positions): the positions' cotangent rows (64 columns), their
  weights and masks.  Seven producer warps fill the stages with ``cp.async``
  alone (16-byte chunks where the rows allow), segment j by warp j % 7;
  each lane's arrival fires when its copies land, so no producer waits for
  a load, and none executes a release, which would wait for the bags it
  keeps in flight for its next rounds.  One consumer warp does the run's
  adds, in order, two chains a lane (columns c and c + 1): each product
  rounded once, as the plain version rounds it (skipped where every weight
  of the segment is 1: ``x * 1`` is ``x``, bit for bit), then added.  It
  reads the next stage into a second register buffer while it adds the
  current one, and asks whether the stage after that is full before its
  adds and reads the answer after them.  The ring has 8 stages (32 KB of
  bf16 rows, 64 KB of fp32 ones).
- A window's warp finds the runs that start in it (``rows[i] !=
  rows[i-1]``) with one ballot, skips the long ones by the list's own test
  (``rows[s + T - 1] == rows[s]``), and walks each other run to its end, 32
  positions and 64 columns (two a lane) at a time, the next segment's
  stream and cotangent rows loaded before the current one is summed.  Within a
  segment, consecutive lookups of one bag with one weight form a group; a
  segment of at most 4 groups loads one cotangent row and rounds one
  product a group, then adds it once a lookup, in order; other segments go
  a position at a time.  Both give the same adds with the same operands.

Any width.  Both schedules move a row's columns in pairs (one 32-bit or
64-bit access a pair) where E is even and ``dY`` and the slabs sit on their
pairs' alignment; otherwise (the recsys archetypes' FM at E = 11, or an
offset view) they take a narrow path, a template instance of the same
walk.  The short walk and the step load and store every value on its own,
an odd E's last column pair read with a +0 past the row and written one
column only.  A long run's producers still copy with ``cp.async`` alone and
arrive as the pair path's do: a bf16 ``dY`` as the aligned 4-byte words
that hold each position's columns of the walk (a row starts on a 2-byte
boundary; every word copied holds a byte of the row, so no copy reads past
``dY``), the segment's spans spread over all 32 lanes, each word copied
twice (as the first of lane l's pair of words and the second of lane
l - 1's, so that the consumer reads words l and l + 1 with one 8-byte read:
a bf16 ring of 64 KB, as the fp32 one); an fp32 ``dY`` as a lane's two
columns, a 4-byte copy each.  They copy each position's bag beside its
weight and mask; the consumer turns a stage's bags into one ballot of row
start parities, ``(bag * E + cb + offset of dY) & 1``, and shifts each
pair out of its two words with one funnel shift.  The first narrow producers
loaded their columns into registers, stored them to the stage and
arrived with release semantics, which waited for those loads and for the
bags loaded ahead: FM's long runs walked about 55 ns a position against the
pair path's 10 (``tools/ablate_row_update.py --only narrow``; PERF.md §6).
The sums, their order and the steps are the same, so the plain versions
hold it bit for bit; row-wise Adagrad still averages over the E real
columns.  The store is never padded.

The old row and its state are loaded at the run's start, beside the sums,
and written once at its end.  The stateful kinds OR the valid positions
over the run's segments into its liveness.  The product and each add round
on their own; the step rounds exactly where the plain versions in
``kernels/ref.py`` do: an FMA where jitted JAX contracts one, each other
operation on its own.  Row-wise Adagrad needs the whole row's sum of
squares before it writes a column: a butterfly of ``__shfl_xor_sync`` over
the warp, after a first walk over every block of 64 columns; a second walk
recomputes the sums of the blocks before the last (the same walk, the same
bits) and steps them.  A long run's producers follow the same sequence of
walks.

Where its time goes: ``PERF.md`` §6 and ``tools/ablate_row_update.py``,
which times copies of the kernel without the consumer's stage reads,
without the producers' cotangent copies, without the consumer's adds, and
at other ring depths.  On dlrm-small's zipf stream the consumer bounds
the long runs, at over 500 cycles a segment against its two add chains'
128: without its adds the kernel takes half the time.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

# the launchers: the stream (4), dY and its type flag, the store's slabs
# (and the seed), the long runs' list, L, E, lr (and hp), the stream
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS_SPLIT = [_P] * 5 + [_I] + [_P] * 3 + [ctypes.c_int64, _I, ctypes.c_float, _P]
_ARGS_FP32 = [_P] * 5 + [_I] + [_P] * 2 + [ctypes.c_int64, _I, ctypes.c_float, _P]
_ARGS_STATE = [_P] * 5 + [_I] + [_P] * 3 + [ctypes.c_int64, _I, ctypes.c_float, ctypes.c_float,
                                            _P]
_ARGS_STATE_SR = [_P] * 5 + [_I] + [_P] * 4 + _ARGS_STATE[9:]
# the source (``csrc/<stem>.cu``) of each launcher: two row kinds a source, so
# that the four compile at once
SOURCE = {"embedding_update_split": "embedding_update",
          "embedding_update_fp32": "embedding_update",
          "embedding_update_momentum": "embedding_update_state",
          "embedding_update_adagrad": "embedding_update_state",
          "embedding_update_adagrad_rowwise": "embedding_update_rowwise",
          "embedding_update_freq": "embedding_update_rowwise",
          "embedding_update_momentum_bf16": "embedding_update_bf16",
          "embedding_update_adagrad_bf16": "embedding_update_bf16"}


def long_run() -> int:
    """The long-run schedule's threshold, as the built kernel has it: runs
    of this many positions or more (builds the library; the card only)."""
    return build.function("embedding_update", "embedding_update_long_run", [])()


def list_words(L: int) -> int:
    """The int64 words of the long runs' list that a launch on ``L`` sorted
    lookups needs, as the built kernel sizes it."""
    return build.function("embedding_update", "embedding_update_list_words", [ctypes.c_int64],
                          ctypes.c_int64)(L)


def sort_lookups(tgt: torch.Tensor, valid: torch.Tensor | None, num_rows: int, pooling: int,
                 weights: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """Sort the flat lookups by row, so duplicates form runs (twin of
    ``repro/kernels/embedding_update.py::sort_lookups``).

    ``tgt`` [L] int32 rows (may be out of range); ``valid`` [L] bool or
    None; flat lookup ``i`` reads bag ``i // pooling``.  Invalid lookups get
    the key ``num_rows``, so a stable sort puts them at the tail, where they
    clip to row ``num_rows - 1`` with ``msk = 0``: a zero-contribution run.
    Returns ``(rows, bags, msk, wgt)``: [L] int32, int32, int32, fp32.  The
    sort is stable (ties keep their flat order), as ``jnp.argsort`` is, and
    runs on ``tgt``'s device with no host sync."""
    ok = (tgt >= 0) & (tgt < num_rows)
    if valid is not None:
        ok &= valid
    key = torch.where(ok, tgt, num_rows).to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    rows = skey.clamp_max(num_rows - 1)
    bags = torch.div(order, pooling, rounding_mode="floor").to(torch.int32)
    msk = (skey < num_rows).to(torch.int32)
    wgt = (torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device) if weights is None
           else weights.float()[order])
    return rows, bags, msk, wgt


def _check(table: torch.Tensor, srows, sbags, smsk, swgt, dY) -> None:
    L = srows.shape[0]
    if table.ndim != 2 or dY.ndim != 2 or dY.shape[1] != table.shape[1]:
        raise ValueError(f"need a table [M, E] and dY [bags, E], got {tuple(table.shape)}, "
                         f"{tuple(dY.shape)}")
    if any(t.ndim != 1 or t.shape[0] != L for t in (sbags, smsk, swgt)):
        raise ValueError("the sorted stream's four arrays need one shape [L]")
    if any(t.dtype != torch.int32 for t in (srows, sbags, smsk)) or swgt.dtype != torch.float32:
        raise TypeError("need int32 rows, bags and msk and fp32 wgt")
    if len({t.device for t in (table, srows, sbags, smsk, swgt, dY)}) != 1:
        raise ValueError("the table, the stream and dY must lie on one device")


def _check_cuda(tensors, dY: torch.Tensor) -> int:
    """Checks for a launch; returns E."""
    if dY.device.type != "cuda":
        raise ValueError(f"unsupported device {dY.device}")
    if dY.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel reads dY as bf16 (the row-mode wire) or fp32, got {dY.dtype}")
    if not all(t.is_contiguous() for t in (*tensors, dY)):
        raise ValueError("the table, the stream and dY must be contiguous")
    return dY.shape[1]


def _launch(wrapper, cname: str, argtypes: list, stream: tuple, dY: torch.Tensor, store: tuple,
            E: int, scalars: tuple) -> None:
    """Launch ``cname`` on CUDA tensors and count it on ``wrapper``: the
    sorted ``stream``, ``dY``, the ``store``'s slabs (and the seed), a fresh
    list for the long runs, then ``scalars`` (lr, and hp).  Leaves the
    number of long runs the launch listed on ``wrapper.long_runs``, a 0-d
    int64 tensor on the card (reading it is a host sync)."""
    L = stream[0].shape[0]
    device = stream[0].device
    runs = torch.empty(list_words(L), dtype=torch.int64, device=device)
    fn = build.function(SOURCE[cname], cname, argtypes)
    with torch.cuda.device(device):
        err = fn(*(t.data_ptr() for t in stream), dY.data_ptr(), int(dY.dtype == torch.float32),
                 *(t.data_ptr() for t in store), runs.data_ptr(), L, E,
                 *(float(np.float32(x)) for x in scalars), torch.cuda.current_stream().cuda_stream)
        wrapper.launches += 1
    wrapper.long_runs = runs[0]
    if err:
        raise RuntimeError(f"{cname} kernel launch failed with CUDA error {err}")


def fused_update_split(hi: torch.Tensor, lo: torch.Tensor, srows: torch.Tensor,
                       sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                       dY: torch.Tensor, lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + Split-SGD row update, in place on ``hi`` [M, E]
    bf16 / ``lo`` [M, E] int16 (the low-half bits), from the sorted stream of
    :func:`sort_lookups` and the bag cotangents ``dY`` [bags, E].  CUDA
    tensors launch the kernel (``dY`` bf16 or fp32); CPU tensors run the plain
    version (``ref.fused_update_split``).  Returns ``(hi, lo)``."""
    _check(hi, srows, sbags, smsk, swgt, dY)
    if hi.dtype != torch.bfloat16 or lo.dtype != torch.int16 or lo.shape != hi.shape:
        raise TypeError(f"need hi bf16 and lo int16 of one shape, got {hi.dtype} "
                        f"{tuple(hi.shape)}, {lo.dtype} {tuple(lo.shape)}")
    if lo.device != hi.device:
        raise ValueError(f"hi on {hi.device}, lo on {lo.device}")
    if hi.device.type == "cpu":
        return ref.fused_update_split(hi, lo, srows, sbags, smsk, swgt, dY, lr)
    E = _check_cuda((hi, lo, srows, sbags, smsk, swgt), dY)
    _launch(fused_update_split, "embedding_update_split", _ARGS_SPLIT, (srows, sbags, smsk, swgt),
            dY, (hi, lo), E, (lr,))
    return hi, lo


def fused_update_fp32(W: torch.Tensor, srows: torch.Tensor, sbags: torch.Tensor,
                      smsk: torch.Tensor, swgt: torch.Tensor, dY: torch.Tensor,
                      lr: float) -> torch.Tensor:
    """:func:`fused_update_split` on an fp32 table ``W`` [M, E], in place
    (the ``sgd`` store).  Returns ``W``."""
    _check(W, srows, sbags, smsk, swgt, dY)
    if W.dtype != torch.float32:
        raise TypeError(f"need an fp32 table, got {W.dtype}")
    if W.device.type == "cpu":
        return ref.fused_update_fp32(W, srows, sbags, smsk, swgt, dY, lr)
    E = _check_cuda((W, srows, sbags, smsk, swgt), dY)
    _launch(fused_update_fp32, "embedding_update_fp32", _ARGS_FP32, (srows, sbags, smsk, swgt),
            dY, (W,), E, (lr,))
    return W


def _stateful(wrapper, cname: str, plain, W: torch.Tensor, S: torch.Tensor, per_row: bool,
              dtype: torch.dtype, stream: tuple, dY: torch.Tensor, lr: float, hp: float,
              seed: torch.Tensor | None = None):
    """Check, then launch ``cname`` on CUDA tensors (counted on ``wrapper``)
    or run ``plain`` on CPU tensors.  ``S`` is the state slab: [M, 1] when
    ``per_row``, else [M, E]; ``hp`` is beta or eps; ``seed``, for the
    compressed-state kinds, the 0-d int32 seed on ``W``'s device, whose
    pointer the kernel reads."""
    _check(W, *stream, dY)
    sr = () if seed is None else (seed,)
    if seed is not None and (seed.dtype != torch.int32 or seed.dim() != 0
                             or seed.device != W.device):
        raise TypeError(f"need a 0-d int32 seed on {W.device}, got {seed.dtype} "
                        f"{tuple(seed.shape)} on {seed.device}")
    want = (W.shape[0], 1 if per_row else W.shape[1])
    if W.dtype != torch.float32 or S.dtype != dtype or tuple(S.shape) != want:
        raise TypeError(f"need an fp32 table and a {dtype} state of shape {want}, got "
                        f"{W.dtype} {tuple(W.shape)}, {S.dtype} {tuple(S.shape)}")
    if S.device != W.device:
        raise ValueError(f"the table on {W.device}, its state on {S.device}")
    if W.device.type == "cpu":
        return plain(W, S, *stream, dY, lr, hp, *sr)
    E = _check_cuda((W, S, *stream), dY)
    _launch(wrapper, cname, _ARGS_STATE_SR if sr else _ARGS_STATE, stream, dY, (W, S, *sr), E,
            (lr, hp))
    return W, S


def fused_update_momentum(W: torch.Tensor, mom: torch.Tensor, srows: torch.Tensor,
                          sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                          dY: torch.Tensor, lr: float, beta: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + momentum, in place on ``W`` [M, E] fp32 and
    ``mom`` [M, E] fp32 (``ref.fused_update_momentum`` on CPU tensors).
    Returns ``(W, mom)``."""
    return _stateful(fused_update_momentum, "embedding_update_momentum", ref.fused_update_momentum,
                     W, mom, False, torch.float32, (srows, sbags, smsk, swgt), dY, lr, beta)


def fused_update_adagrad(W: torch.Tensor, acc: torch.Tensor, srows: torch.Tensor,
                         sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                         dY: torch.Tensor, lr: float, eps: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + elementwise Adagrad, in place on ``W`` [M, E]
    and ``acc`` [M, E] fp32 (``ref.fused_update_adagrad`` on CPU tensors).
    Returns ``(W, acc)``."""
    return _stateful(fused_update_adagrad, "embedding_update_adagrad", ref.fused_update_adagrad,
                     W, acc, False, torch.float32, (srows, sbags, smsk, swgt), dY, lr, eps)


def fused_update_adagrad_rowwise(W: torch.Tensor, acc: torch.Tensor, srows: torch.Tensor,
                                 sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                                 dY: torch.Tensor, lr: float, eps: float
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + row-wise Adagrad, in place on ``W`` [M, E]
    and ``acc`` [M, 1] fp32, one accumulator a row
    (``ref.fused_update_adagrad_rowwise`` on CPU tensors).  Returns
    ``(W, acc)``."""
    return _stateful(fused_update_adagrad_rowwise, "embedding_update_adagrad_rowwise",
                     ref.fused_update_adagrad_rowwise, W, acc, True, torch.float32,
                     (srows, sbags, smsk, swgt), dY, lr, eps)


def fused_update_freq(W: torch.Tensor, cnt: torch.Tensor, srows: torch.Tensor,
                      sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                      dY: torch.Tensor, lr: float, eps: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + the frequency-adaptive step, in place on ``W``
    [M, E] fp32, reading the bumped touch counts ``cnt`` [M, 1] int32
    (``ref.fused_update_freq`` on CPU tensors).  Returns ``(W, cnt)``."""
    return _stateful(fused_update_freq, "embedding_update_freq", ref.fused_update_freq,
                     W, cnt, True, torch.int32, (srows, sbags, smsk, swgt), dY, lr, eps)


def fused_update_momentum_bf16(W: torch.Tensor, mom: torch.Tensor, srows: torch.Tensor,
                               sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                               dY: torch.Tensor, lr: float, beta: float, seed: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + momentum with the momentum stored as bf16, in
    place on ``W`` [M, E] fp32 and ``mom`` [M, E] bf16, the new momentum
    rounded stochastically under ``seed`` (0-d int32 on ``W``'s device)
    (``ref.fused_update_momentum_bf16`` on CPU tensors).  Returns
    ``(W, mom)``."""
    return _stateful(fused_update_momentum_bf16, "embedding_update_momentum_bf16",
                     ref.fused_update_momentum_bf16, W, mom, False, torch.bfloat16,
                     (srows, sbags, smsk, swgt), dY, lr, beta, seed)


def fused_update_adagrad_bf16(W: torch.Tensor, acc: torch.Tensor, srows: torch.Tensor,
                              sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                              dY: torch.Tensor, lr: float, eps: float, seed: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + elementwise Adagrad with the accumulator
    stored as bf16, in place on ``W`` [M, E] fp32 and ``acc`` [M, E] bf16,
    rounded stochastically under ``seed`` (``ref.fused_update_adagrad_bf16``
    on CPU tensors).  Returns ``(W, acc)``."""
    return _stateful(fused_update_adagrad_bf16, "embedding_update_adagrad_bf16",
                     ref.fused_update_adagrad_bf16, W, acc, False, torch.bfloat16,
                     (srows, sbags, smsk, swgt), dY, lr, eps, seed)


for _fn in (fused_update_split, fused_update_fp32, fused_update_momentum, fused_update_adagrad,
            fused_update_adagrad_rowwise, fused_update_freq, fused_update_momentum_bf16,
            fused_update_adagrad_bf16):
    _fn.launches = 0
    _fn.long_runs = None
