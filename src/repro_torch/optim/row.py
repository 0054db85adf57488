"""Sparse row optimizers (twin of ``repro/optim/row.py``): ``sgd`` and
``split_sgd``.

The store of ``split_sgd`` is ``{hi, lo}`` (the bf16 upper and the int16
lower halves of the fp32 master rows), that of ``sgd`` is ``{w}`` (fp32).
The forward pass reads one slab: ``hi`` or ``w``.  The update runs on the
sorted lookup stream of ``kernels.embedding_update.sort_lookups``: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors
(the wrappers in ``kernels.ops`` decide).  The stateful optimizers of the
reference are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.optim.split_sgd import split_fp32

# optimizer -> the store key its forward reads
FWD_KEY = {"split_sgd": "hi", "sgd": "w"}


def resolve(cfg) -> str:
    """The sparse optimizer of a config; unset means ``split_sgd``."""
    name = getattr(cfg, "sparse_optimizer", None) or "split_sgd"
    if name not in FWD_KEY:
        raise NotImplementedError(f"sparse optimizer {name!r} is not ported; "
                                  f"the port has {sorted(FWD_KEY)}")
    return name


def fwd_weights(name: str, store: dict):
    """The slab the forward pass reads (bf16 ``hi`` or fp32 ``w``)."""
    return store[FWD_KEY[name]]


def init_store(name: str, W: torch.Tensor) -> dict:
    """The store from fp32 master rows ``W`` [rows, E]."""
    if name == "split_sgd":
        hi, lo = split_fp32(W)
        return {"hi": hi, "lo": lo}
    return {"w": W.float()}


def apply_sparse(name: str, store: dict, stream: tuple, dY: torch.Tensor, lr: float) -> dict:
    """One fused sparse backward + row update, in place on ``store``.

    ``stream``: the sorted ``(rows, bags, msk, wgt)`` [L] arrays; ``dY``
    [bags, E] the bag cotangents (bf16, the row-mode wire).  Each run of
    equal rows sums ``wgt * dY[bag]`` in sorted order and steps its row once;
    rows outside the stream are not touched.  Returns ``store``."""
    if name == "split_sgd":
        ops.fused_update_split(store["hi"], store["lo"], *stream, dY, lr)
    else:
        ops.fused_update_fp32(store["w"], *stream, dY, lr)
    return store
