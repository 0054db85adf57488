"""Fused sparse embedding backward + row update on Hopper
(``csrc/embedding_update.cu``).

Replaces the TPU kernels of ``repro/kernels/embedding_update.py``, in one
source: the first two templated on the store, the other six on the
optimizer's step:

- ``_kernel_split`` (via ``fused_update_split_pallas``; the paper's Alg. 3 +
  C5) and ``_kernel_fp32`` (via ``fused_update_fp32_pallas``): ``w =
  fmaf(-lr, acc, w)`` on the Split-SGD store (``w = (hi << 16) | lo``,
  re-split) or an fp32 ``W``;
- ``_kernel_momentum`` (via ``fused_update_momentum_pallas``): ``m`` = the
  run's lookups added in order onto ``beta * m``, ``w = fmaf(-lr, m, w)``
  (what the jitted reference computes; the TPU kernel adds ``beta * m`` to
  the run's sum, the same terms in another order);
- ``_kernel_adagrad`` (via ``fused_update_adagrad_pallas``, ``rowwise=False``):
  ``s = fmaf(acc, acc, s)``, ``w = w - (lr * acc) / (sqrt(s) + eps)``;
- ``_make_kernel_adagrad_rowwise`` (the same wrapper, ``rowwise=True``): one
  accumulator a row, ``s += sum_e acc^2 / E``, then the Adagrad step;
- ``_kernel_freq`` (via ``fused_update_freq_pallas``): ``w = w - (lr * acc) /
  (sqrt(max(cnt, 1)) + eps)``, reading the row's touch count, which the
  caller has bumped;
- ``_kernel_momentum_bf16`` and ``_kernel_adagrad_bf16`` (via
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

What bounds it: device-memory bytes, and on a skewed stream the in-order sum.
The touched rows are read and written once (8 bytes a value of ``w``, and as
much again for an ``[M, E]`` state slab), the cotangent rows and the sorted
stream read once.  The sum of a run is a serial chain of dependent fp32 adds,
one a lookup: zipf(1.05) sends about half of a table's lookups to one row,
so at B = 8192, pooling 50, one run holds some 200 K lookups and its adds
alone take about 0.4 ms.

Design: one launch, no host sync.  Each warp looks at a window of 32 sorted
positions, finds the runs that start in it (``rows[i] != rows[i-1]``) with
one ballot, and walks each to its end, 32 positions (a segment) and 64
columns (two a lane) at a time.  Bitwise parity with the reference fixes the
order of the sum inside a run, so the warp cannot split a run.  Within a
segment, consecutive lookups of one bag with one weight form a group (zipf's
hot rows: some 26 lookups of row 0 a bag); a segment of at most 4 groups
loads one cotangent row and rounds one product a group, then adds it once a
lookup, in order; other segments go a position at a time.  Both give the
same adds with the same operands.  The old row and its state are loaded at
the run's start, beside the sums.  The stateful kinds OR a ballot of the
valid positions over the run's segments into its liveness.  The product
``wgt * dY`` and each add round on their own; the step rounds exactly where
the plain versions in ``kernels/ref.py`` do: an FMA where jitted JAX
contracts one, each other operation on its own.  Row-wise Adagrad needs the
whole row's sum of squares before it writes a column: a butterfly of
``__shfl_xor_sync`` over the warp, after a first walk over every block of 64
columns; a second walk recomputes the sums of the blocks before the last
(the same walk, the same bits) and steps them.  The Split-SGD and fp32
kinds keep their own copy of the walk, as it was before the stateful kinds
came: compiled through the shared one they ran slower on zipf.  ``dY`` is read as bf16, the
row-mode wire's own type, exact in fp32.  Row addresses are int64.

Where its time goes (H100, ``PERF.md``, ``tools/ablate_row_update.py``): a
long run's walk costs some 1,300–2,000 cycles a segment whatever the segment
holds, far above its adds.  The likely reason, not yet proven: the walk
hands the next segment's registers to the current one by copying them, and
a copy waits for the loads that fill them, so each segment waits out a
memory round trip.  A ring whose roles rotate instead (unrolled, or in
shared memory through ``cp.async``) is the next step.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

_ARGS_SPLIT = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p]
_ARGS_FP32 = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                      ctypes.c_void_p]
_ARGS_STATE = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_void_p]
_ARGS_STATE_SR = [ctypes.c_void_p] * 8 + _ARGS_STATE[7:]


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
    if dY.dtype != torch.bfloat16:
        raise TypeError(f"the kernel reads dY as bf16 (the row-mode wire), got {dY.dtype}")
    if not all(t.is_contiguous() for t in (*tensors, dY)):
        raise ValueError("the table, the stream and dY must be contiguous")
    E = dY.shape[1]
    if E % 2 or any(t.data_ptr() % 8 for t in (*tensors, dY)):
        raise ValueError(f"the kernel moves two columns at a time: E={E} must be even and "
                         "every tensor 8-byte aligned")
    return E


def fused_update_split(hi: torch.Tensor, lo: torch.Tensor, srows: torch.Tensor,
                       sbags: torch.Tensor, smsk: torch.Tensor, swgt: torch.Tensor,
                       dY: torch.Tensor, lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse backward + Split-SGD row update, in place on ``hi`` [M, E]
    bf16 / ``lo`` [M, E] int16 (the low-half bits), from the sorted stream of
    :func:`sort_lookups` and the bag cotangents ``dY`` [bags, E].  CUDA
    tensors launch the kernel (``dY`` bf16); CPU tensors run the plain
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
    fn = build.function("embedding_update", "embedding_update_split", _ARGS_SPLIT)
    with torch.cuda.device(hi.device):
        err = fn(srows.data_ptr(), sbags.data_ptr(), smsk.data_ptr(), swgt.data_ptr(),
                 dY.data_ptr(), hi.data_ptr(), lo.data_ptr(), srows.shape[0], E,
                 float(np.float32(lr)), torch.cuda.current_stream().cuda_stream)
        fused_update_split.launches += 1
    if err:
        raise RuntimeError(f"embedding_update kernel launch failed with CUDA error {err}")
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
    fn = build.function("embedding_update", "embedding_update_fp32", _ARGS_FP32)
    with torch.cuda.device(W.device):
        err = fn(srows.data_ptr(), sbags.data_ptr(), smsk.data_ptr(), swgt.data_ptr(),
                 dY.data_ptr(), W.data_ptr(), srows.shape[0], E, float(np.float32(lr)),
                 torch.cuda.current_stream().cuda_stream)
        fused_update_fp32.launches += 1
    if err:
        raise RuntimeError(f"embedding_update_fp32 kernel launch failed with CUDA error {err}")
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
    fn = build.function("embedding_update", cname, _ARGS_STATE_SR if sr else _ARGS_STATE)
    with torch.cuda.device(W.device):
        err = fn(*(t.data_ptr() for t in stream), dY.data_ptr(), W.data_ptr(), S.data_ptr(),
                 *(t.data_ptr() for t in sr), stream[0].shape[0], E, float(np.float32(lr)),
                 float(np.float32(hp)), torch.cuda.current_stream().cuda_stream)
        wrapper.launches += 1
    if err:
        raise RuntimeError(f"{cname} kernel launch failed with CUDA error {err}")
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
