"""Sparse row optimizers (twin of ``repro/optim/row.py``): one table of
optimizers keyed by name, and :func:`apply_sparse`, the one place that picks
a row kernel.

An optimizer's store is its weight slab(s) and its state slabs, all
row-aligned: ``{hi, lo}`` (the bf16 upper and the int16 lower halves of the
fp32 master rows) for ``split_sgd``, else ``{w}`` (fp32), plus ``mom``
[rows, E] (``momentum``), ``acc`` [rows, E] (``adagrad``) or [rows, 1]
(``adagrad_rowwise``: one accumulator a row, not padded to any lane width),
or ``cnt`` [rows, 1] int32 (``adagrad_freq``: the touch counts, which
the hot-row cache adds to any store, ``counters=True``); the
compressed-state kinds (``momentum_bf16``, ``adagrad_bf16``) keep ``mom`` or
``acc`` [rows, E] as bf16, rounded stochastically under the train state's
per-step seed (``optim.stochastic``).  The
forward pass reads one slab: ``hi`` or ``w``.  The update runs on the sorted
lookup stream of ``kernels.embedding_update.sort_lookups``: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors (the
wrappers in ``kernels.ops`` decide).  ``kernels.ops``,
``core.sharded_embedding`` and ``core.pipeline`` hold no branch on an
optimizer: a new one is a :func:`register` call (its store and its
``kernel``, which on CPU tensors is the plain update).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.optim.split_sgd import split_fp32

@dataclasses.dataclass(frozen=True)
class RowOptimizer:
    """A sparse embedding optimizer: its store and its row kernel.

    ``state`` lists the state slabs as ``(key, width, dtype)``, width 0
    meaning E; ``kernel(opt, store, stream, dY, lr, seed)`` steps the store
    in place on the sorted stream.  ``stochastic_round``: the state is
    stored rounded under a per-step seed, which the train state carries as
    ``sr``."""

    name: str
    kernel: Callable
    split: bool = False
    state: tuple = ()
    beta: float = 0.0   # momentum coefficient
    eps: float = 1e-8   # Adagrad denominator floor
    stochastic_round: bool = False

    @property
    def weight_keys(self) -> tuple:
        return ("hi", "lo") if self.split else ("w",)

    @property
    def state_keys(self) -> tuple:
        return tuple(key for key, _, _ in self.state)

    def store_struct(self, rows: int, E: int, counters: bool = False) -> dict:
        """``(shape, dtype)`` of each slab of the store of a [rows, E] table;
        ``counters`` adds the touch counts ``cnt`` [rows, 1] int32 (the
        hot-row cache's) unless the optimizer declares them already."""
        out = ({"hi": ((rows, E), torch.bfloat16), "lo": ((rows, E), torch.int16)} if self.split
               else {"w": ((rows, E), torch.float32)})
        for key, width, dtype in self.state:
            out[key] = ((rows, width or E), dtype)
        if counters and "cnt" not in out:
            out["cnt"] = ((rows, 1), torch.int32)
        return out


def _k_split_sgd(opt, store, stream, dY, lr, seed):
    ops.fused_update_split(store["hi"], store["lo"], *stream, dY, lr)


def _k_sgd(opt, store, stream, dY, lr, seed):
    ops.fused_update_fp32(store["w"], *stream, dY, lr)


def _k_momentum(opt, store, stream, dY, lr, seed):
    ops.fused_update_momentum(store["w"], store["mom"], *stream, dY, lr, opt.beta)


def _k_adagrad(opt, store, stream, dY, lr, seed):
    ops.fused_update_adagrad(store["w"], store["acc"], *stream, dY, lr, opt.eps)


def _k_adagrad_rowwise(opt, store, stream, dY, lr, seed):
    ops.fused_update_adagrad_rowwise(store["w"], store["acc"], *stream, dY, lr, opt.eps)


def _k_adagrad_freq(opt, store, stream, dY, lr, seed):
    ops.fused_update_freq(store["w"], store["cnt"], *stream, dY, lr, opt.eps)


def _k_momentum_bf16(opt, store, stream, dY, lr, seed):
    ops.fused_update_momentum_bf16(store["w"], store["mom"], *stream, dY, lr, opt.beta, seed)


def _k_adagrad_bf16(opt, store, stream, dY, lr, seed):
    ops.fused_update_adagrad_bf16(store["w"], store["acc"], *stream, dY, lr, opt.eps, seed)


#: the registry: name -> optimizer, in registration order
OPTIMIZERS: dict[str, RowOptimizer] = {}


def register(opt: RowOptimizer) -> RowOptimizer:
    """Add ``opt`` under its name, refused (``ValueError``) where the name is
    taken or no ``kernel`` is given, as the reference refuses them.  The
    reference also refuses an optimizer with neither ``reference`` nor
    ``flat_reference`` (its plain transitions); the port's ``kernel`` is
    both, the hand-written kernel for CUDA tensors and the plain version for
    CPU tensors, so the second refusal is the first."""
    if opt.name in OPTIMIZERS:
        raise ValueError(f"row optimizer {opt.name!r} already registered")
    if opt.kernel is None:
        raise ValueError(f"row optimizer {opt.name!r} registered no fused kernel entry (kernel=)")
    OPTIMIZERS[opt.name] = opt
    return opt


def unregister(name: str) -> None:
    """Remove a registered optimizer (a test tearing a toy entry down)."""
    OPTIMIZERS.pop(name, None)


def names() -> tuple:
    """The registered names, in registration order."""
    return tuple(OPTIMIZERS)


# the reference's registrations (repro/optim/row.py:677-710), in its order, with its defaults
for _opt in (
        RowOptimizer("sgd", _k_sgd),
        RowOptimizer("split_sgd", _k_split_sgd, split=True),
        RowOptimizer("momentum", _k_momentum, state=(("mom", 0, torch.float32),), beta=0.9),
        RowOptimizer("adagrad_rowwise", _k_adagrad_rowwise, state=(("acc", 1, torch.float32),)),
        RowOptimizer("adagrad", _k_adagrad, state=(("acc", 0, torch.float32),)),
        RowOptimizer("momentum_bf16", _k_momentum_bf16, state=(("mom", 0, torch.bfloat16),),
                     beta=0.9, stochastic_round=True),
        RowOptimizer("adagrad_bf16", _k_adagrad_bf16, state=(("acc", 0, torch.bfloat16),),
                     stochastic_round=True),
        RowOptimizer("adagrad_freq", _k_adagrad_freq, state=(("cnt", 1, torch.int32),))):
    register(_opt)


def get(name: str, *, beta: Optional[float] = None, eps: Optional[float] = None) -> RowOptimizer:
    """The registered optimizer ``name``, with ``beta`` and ``eps``
    overriding its defaults where given."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown sparse optimizer {name!r}; registered: {sorted(OPTIMIZERS)}")
    return make(OPTIMIZERS[name], beta=beta, eps=eps)


def make(spec, *, beta: Optional[float] = None, eps: Optional[float] = None) -> RowOptimizer:
    """A config value (a registered name, or a :class:`RowOptimizer`) as an
    optimizer, with ``beta`` and ``eps`` overriding its defaults where
    given."""
    if not isinstance(spec, RowOptimizer):
        return get(str(spec), beta=beta, eps=eps)
    over = {k: float(v) for k, v in (("beta", beta), ("eps", eps)) if v is not None}
    return dataclasses.replace(spec, **over) if over else spec


def resolve(cfg) -> RowOptimizer:
    """The sparse optimizer of a config (unset means ``split_sgd``), with its
    ``opt_beta`` / ``opt_eps`` applied."""
    return make(getattr(cfg, "sparse_optimizer", None) or "split_sgd",
               beta=getattr(cfg, "opt_beta", None), eps=getattr(cfg, "opt_eps", None))


def fwd_weights(opt, store: dict):
    """The slab the forward pass reads (bf16 ``hi`` or fp32 ``w``)."""
    return store["hi"] if make(opt).split else store["w"]


def init_store(opt, W: torch.Tensor, counters: bool = False) -> dict:
    """The store from fp32 master rows ``W`` [rows, E], state slabs (and
    with ``counters`` the touch counts ``cnt``) zero."""
    opt = make(opt)
    if opt.split:
        hi, lo = split_fp32(W)
        out = {"hi": hi, "lo": lo}
    else:
        out = {"w": W.float()}
    for key, width, dtype in opt.state:
        out[key] = torch.zeros((W.shape[0], width or W.shape[1]), dtype=dtype, device=W.device)
    if counters and "cnt" not in out:
        out["cnt"] = torch.zeros((W.shape[0], 1), dtype=torch.int32, device=W.device)
    return out


def bump_counters(cnt: torch.Tensor, srows: torch.Tensor, smsk: torch.Tensor) -> torch.Tensor:
    """+1 per valid lookup on the touch counts ``cnt`` [rows, 1] int32, in
    place, from the sorted stream: each run of equal ``rows`` adds the sum
    of its ``msk`` once, so masked lookups add 0 and nothing waits for the
    host.  Integer sums, so the counts are the reference's
    (``repro/optim/row.py:128``) and ``index_add_``'s bit for bit; but
    where ``index_add_`` lands every lookup of a run on one address (half a
    zipf table's lookups hit its row 0), each position here writes its
    run's one new count, which is the same for every position of the run."""
    if srows.numel() == 0:
        return cnt
    rows = srows.contiguous()
    first = torch.searchsorted(rows, rows)
    last = torch.searchsorted(rows, rows, right=True) - 1
    cs = torch.cumsum(smsk, 0, dtype=torch.int32)
    flat = cnt.view(-1)
    at = rows.long()
    flat[at] = flat[at] + (cs[last] - cs[first] + smsk[first])
    return cnt


def apply_sparse(opt, store: dict, stream: tuple, dY: torch.Tensor, lr: float,
                 seed=None) -> dict:
    """One fused sparse backward + row update, in place on ``store``.

    ``stream``: the sorted ``(rows, bags, msk, wgt)`` [L] arrays; ``dY``
    [bags, E] the bag cotangents (bf16, the row-mode wire); ``seed`` the
    stochastic rounding's per-step seed (the train state's ``sr``, an int or
    a 0-d int32 tensor; None means 0, as in the reference), handed to the
    kernel as a 0-d int32 tensor on the store's device, which the kernel
    reads through its pointer: no host sync.  A ``cnt`` slab is bumped
    first (:func:`bump_counters`), once: a declared one (``adagrad_freq``),
    whose kernel then reads the count after this step's lookups, or the
    hot-row cache's auxiliary one, which no kernel reads.  Each run of equal rows sums
    ``wgt * dY[bag]`` in sorted order and steps its row once; rows outside
    the stream, and runs of masked lookups only, are not touched.  Returns
    ``store``."""
    opt = make(opt)
    if "cnt" in store:
        bump_counters(store["cnt"], stream[0], stream[2])
    if opt.stochastic_round:
        dev = store[opt.weight_keys[0]].device
        seed = torch.as_tensor(0 if seed is None else seed, dtype=torch.int32, device=dev)
    opt.kernel(opt, store, stream, dY, lr, seed)
    return store
