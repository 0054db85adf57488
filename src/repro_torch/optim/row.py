"""Sparse row optimizers, the forward part (twin of ``repro/optim/row.py``).

The forward pass reads one slab of the embedding store: the bf16 ``hi``
half for ``split_sgd`` (whose store is ``{hi, lo}``), the fp32 ``w`` for
``sgd`` (``{w}``).  The update rules and the other optimizers come with the
train slice.
"""

from __future__ import annotations

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
