"""Plain fp32 SGD (twin of ``repro/optim/sgd.py``): the baseline Split-SGD
matches bit for bit on the update rule.

Tree functions over the port's nested dicts and lists; they return new
trees, as the reference does.  Each step rounds as the jitted reference
does: XLA contracts ``beta * m + g`` and ``p - lr * g`` into FMAs, so the
plain versions here take one rounding (``kernels.ref.fma32``).  No model
code calls them; they have no kernel.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.ref import fma32
from repro_torch.optim.data_parallel import tree_leaves, tree_map, tree_unflatten


def init_momentum(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _step(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``p - lr * g`` in fp32, rounded once, cast back to ``p``'s dtype."""
    return fma32(-np.float32(lr), g.float(), p.float()).to(p.dtype)


def apply_updates(params: Any, grads: Any, lr, momentum: Optional[Any] = None,
                  beta: float = 0.0):
    """``params - lr * grads`` (the new tree); with ``momentum``, first
    ``m = beta * m + g`` and the step by ``m``: ``(new_params, new_mom)``."""
    if momentum is None:
        return tree_unflatten(params, [_step(p, g, lr) for p, g in
                                       zip(tree_leaves(params), tree_leaves(grads))])
    new_mom = tree_unflatten(momentum, [fma32(np.float32(beta), m, g.float()) for m, g in
                                        zip(tree_leaves(momentum), tree_leaves(grads))])
    new_params = tree_unflatten(params, [_step(p, m, lr) for p, m in
                                         zip(tree_leaves(params), tree_leaves(new_mom))])
    return new_params, new_mom
