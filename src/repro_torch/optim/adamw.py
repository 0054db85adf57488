"""AdamW with optional split-bf16 weight storage (twin of
``repro/optim/adamw.py``).

Standard AdamW keeps fp32 (m, v) moments; with ``split=True`` the weights
themselves use the paper's hi/lo representation (C5), so the state is
2 + 2 (+ 4 + 4) bytes a parameter against 4 (+ 4 + 4) for fp32.

Tree functions over the port's nested dicts and lists, returning a new
state, as the reference does.  Each step rounds as the jitted reference
does: XLA contracts the moments' ``b * m + (1 - b) * g``, the decay's
``u + wd * w`` and the weight's ``w - lr * u`` into FMAs
(``kernels.ref.fma32``), rewrites ``(m / c1) / d`` as ``m / (c1 * d)``,
takes ``1 - b`` in Python's f64 before its one cast, and its square root is
correctly rounded (``kernels.ref.sqrt32``; PyTorch's CPU ``sqrt`` is not).
No model code calls them; they have no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ref import fma32, sqrt32
from repro_torch.optim.data_parallel import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.split_sgd import SplitParams, combine_split, split_fp32


@dataclasses.dataclass
class AdamWState:
    params: Any           # SplitParams or an fp32 tree
    m: Any
    v: Any
    count: torch.Tensor   # int32, 0-d
    split: bool = True


def init(params_fp32: Any, split: bool = True) -> AdamWState:
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),  # noqa: E731
                             params_fp32)
    if split:
        params = SplitParams(tree_map(lambda p: split_fp32(p)[0], params_fp32),
                             tree_map(lambda p: split_fp32(p)[1], params_fp32))
    else:
        params = params_fp32
    return AdamWState(params, zeros(), zeros(), torch.zeros((), dtype=torch.int32), split)


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _pow32(b: float, n: torch.Tensor) -> torch.Tensor:
    """``b ** n`` in fp32, correctly rounded (from f64)."""
    return torch.pow(torch.tensor(float(np.float32(b)), dtype=torch.float64),
                     n.double()).float()


def apply_updates(state: AdamWState, grads: Any, lr, *, b1=0.9, b2=0.999, eps=1e-8,
                  weight_decay=0.0) -> AdamWState:
    count = state.count + 1
    c1 = _f32(1.0) - _pow32(b1, count.float())
    c2 = _f32(1.0) - _pow32(b2, count.float())
    one_b1, one_b2 = _f32(1 - b1), _f32(1 - b2)   # Python's f64 differences, as JAX takes them

    def leaf(w_or_hi, lo, g, m, v):
        w32 = combine_split(w_or_hi, lo) if state.split else w_or_hi.float()
        g32 = g.float()
        m = fma32(np.float32(b1), m, one_b1 * g32)
        v = fma32(np.float32(b2), v, (one_b2 * g32) * g32)
        upd = m / (c1 * (sqrt32(v / c2) + _f32(eps)))   # XLA's (a / b) / c -> a / (b * c)
        if weight_decay:
            upd = fma32(np.float32(weight_decay), w32, upd)
        w32 = fma32(-np.float32(lr), upd, w32)
        if state.split:
            nh, nl = split_fp32(w32)
            return nh, nl, m, v
        return w32.to(w_or_hi.dtype), None, m, v

    if state.split:
        out = [leaf(h, lo, g, m, v) for h, lo, g, m, v in zip(
            tree_leaves(state.params.hi), tree_leaves(state.params.lo), tree_leaves(grads),
            tree_leaves(state.m), tree_leaves(state.v))]
        like = state.params.hi
        params = SplitParams(tree_unflatten(like, [o[0] for o in out]),
                             tree_unflatten(like, [o[1] for o in out]))
    else:
        out = [leaf(w, None, g, m, v) for w, g, m, v in zip(
            tree_leaves(state.params), tree_leaves(grads), tree_leaves(state.m),
            tree_leaves(state.v))]
        like = state.params
        params = tree_unflatten(like, [o[0] for o in out])
    return AdamWState(params, tree_unflatten(like, [o[2] for o in out]),
                      tree_unflatten(like, [o[3] for o in out]), count, state.split)
