"""Split-SGD-BF16 (twin of ``repro/optim/split_sgd.py``, paper C5).

An fp32 master weight is stored as two 16-bit halves: ``hi``, its upper 16
bits, which IS a bf16 number and is all the forward pass reads, and ``lo``,
its lower 16 bits.  ``combine_split(*split_fp32(w)) == w`` bit for bit.  The
step puts the fp32 weight together, applies SGD (with optional momentum)
and splits it again, so it is an fp32 SGD step given the same gradients.

``lo`` is a uint16 slab in the reference; the port holds the same bits as
``torch.int16``, since PyTorch has no arithmetic on uint16.  The trees are
the port's nested dicts and lists (``optim.data_parallel.tree_map``), and
the step updates them in place where the reference returns new arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


def split_fp32(w32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi: bf16, lo: int16 bit pattern).  A pure bit partition
    (truncation, not rounding)."""
    bits = w32.to(torch.float32).contiguous().view(torch.int32)
    hi = (bits >> 16).to(torch.int16).view(torch.bfloat16)
    lo = (bits & 0xFFFF).to(torch.int16)
    return hi, lo


def combine_split(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi: bf16, lo: int16 bit pattern) -> the exact fp32."""
    h = hi.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    l16 = lo.to(torch.int64) & 0xFFFF
    return ((h << 16) | l16).to(torch.int32).view(torch.float32)


@dataclasses.dataclass
class SplitParams:
    """A pair of trees mirroring the model's parameter tree."""
    hi: Any   # bf16 tree: what the forward and backward read
    lo: Any   # int16 tree (the reference's uint16 bits): optimizer state


@dataclasses.dataclass
class SplitSGDState:
    params: SplitParams
    momentum: Optional[Any]  # fp32 tree or None


def _zip_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure; a tree of its
    results."""
    from repro_torch.optim.data_parallel import tree_leaves, tree_unflatten
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*map(tree_leaves, trees))])


def init(params_fp32: Any, momentum: float = 0.0) -> SplitSGDState:
    """Split every fp32 leaf; a zero fp32 momentum tree with ``momentum``."""
    from repro_torch.optim.data_parallel import tree_map
    hi = tree_map(lambda p: split_fp32(p)[0], params_fp32)
    lo = tree_map(lambda p: split_fp32(p)[1], params_fp32)
    mom = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params_fp32) \
        if momentum else None
    return SplitSGDState(SplitParams(hi, lo), mom)


def update_leaf(hi: torch.Tensor, lo: torch.Tensor, g: torch.Tensor, lr: float,
                mom: Optional[torch.Tensor] = None, beta: float = 0.0) -> tuple:
    """One exact-fp32 SGD step on a split leaf, in place on ``hi`` and ``lo``
    (and ``mom``).  Returns ``(hi, lo)``, or ``(hi, lo, mom)``.

    The step is ``w = fma(-lr, g, w)`` on ``w = combine(hi, lo)`` with ``g``
    (fp32 or bf16) cast to fp32, then split again: the function jitted JAX
    makes of ``w - lr * g``; with momentum ``mom = fma(beta, mom, g)``
    first and the step by ``mom``.  On the card one launch of the split_sgd
    kernel on the flattened leaf; on the CPU its plain version,
    :data:`CPU_CHUNK` values at a time (the reference scans a stacked leaf a
    layer at a time), so that its float64 temporaries stay small."""
    from repro_torch.kernels import ops
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("update_leaf steps contiguous hi and lo in place")
    flat = [hi.view(-1), lo.view(-1), g.reshape(-1).contiguous(),
            None if mom is None else mom.view(-1)]
    if flat[2].dtype not in (torch.float32, torch.bfloat16):
        flat[2] = flat[2].to(torch.float32)
    step = CPU_CHUNK if hi.device.type == "cpu" else max(hi.numel(), 1)
    for s in range(0, hi.numel(), step):
        ops.split_sgd(*(None if t is None else t[s:s + step] for t in flat[:3]), lr,
                      None if mom is None else flat[3][s:s + step], beta)
    return (hi, lo) if mom is None else (hi, lo, mom)


#: values a call of the plain step takes on the CPU (its float64 temporaries)
CPU_CHUNK = 1 << 22


def apply_updates(state: SplitSGDState, grads: Any, lr: float, beta: float = 0.0
                  ) -> SplitSGDState:
    """The tree-wide Split-SGD step (dense gradients), leaf by leaf with
    :func:`update_leaf`, in place on the state's leaves.  Returns a state
    holding the same tensors, as the reference returns its new one."""
    if state.momentum is None:
        _zip_map(lambda h, l, g: update_leaf(h, l, g, lr), state.params.hi, state.params.lo,
                 grads)
    else:
        _zip_map(lambda h, l, g, m: update_leaf(h, l, g, lr, m, beta), state.params.hi,
                 state.params.lo, grads, state.momentum)
    return SplitSGDState(SplitParams(state.params.hi, state.params.lo), state.momentum)


def materialize_fp32(state: SplitSGDState) -> Any:
    """The exact fp32 master weights (for checkpoints and eval)."""
    return _zip_map(combine_split, state.params.hi, state.params.lo)
