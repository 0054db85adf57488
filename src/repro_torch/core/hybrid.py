"""Train-state layout and initialisation (twin of the state builders of
``repro/core/hybrid.py``), at one rank.

The state is the reference's pytree:

    {"emb": {"hi": [rows, E] bf16, "lo": [rows, E] int16}    (split_sgd)
            | {"w": [rows, E] fp32, + state slabs}            (the others)
     "dense": {"hi": {"bot"|"top": {"w": [...], "b": [...]}} bf16,
               "lo": [padded] int16, "err": None}}

``lo`` holds the bits of the reference's uint16 slabs as int16, since
PyTorch has no arithmetic on uint16.  The state slabs are the optimizer's
(``optim.row.RowOptimizer.state``): ``mom`` or ``acc`` [rows, E] fp32,
``acc`` [rows, 1] fp32 (row-wise Adagrad), ``cnt`` [rows, 1] int32, or
``mom`` / ``acc`` [rows, E] bf16 (the compressed-state kinds), zero at the
start.  An optimizer that rounds its state stochastically adds ``"sr"``, the
per-step seed: a 0-d int32 tensor, ``cfg.sr_seed`` at the start, one more
after each step.  The dense ``hi`` leaves are views
into one flat bf16 buffer (``optim.data_parallel.pack_hi``), which the
dense update steps in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sharded_embedding as se
from repro_torch.core.pipeline import NUM_BUCKETS
from repro_torch.optim import data_parallel as dp
from repro_torch.optim import row as row_optim


def state_struct(cfg) -> dict:
    """``(shape, dtype)`` of every leaf of the train state of ``cfg``
    (``None`` for the absent error-feedback slab)."""
    rows = se.make_layout(cfg.spec, 1, cfg.emb_mode).total_rows
    E = cfg.emb_dim
    emb = row_optim.resolve(cfg).store_struct(rows, E)
    hi, n = {}, 0
    for part, sizes in (("bot", cfg.bottom_sizes), ("top", cfg.top_sizes)):
        pairs = list(zip(sizes[:-1], sizes[1:]))
        hi[part] = {"w": [((i, o), torch.bfloat16) for i, o in pairs],
                    "b": [((o,), torch.bfloat16) for _, o in pairs]}
        n += sum(i * o + o for i, o in pairs)
    out = {"emb": emb, "dense": {"hi": hi, "lo": ((dp.padded_size(n, 1, NUM_BUCKETS),), torch.int16),
                                 "err": None}}
    if row_optim.resolve(cfg).stochastic_round:
        out["sr"] = ((), torch.int32)
    return out


def init_state(cfg, generator: torch.Generator, device="cuda") -> dict:
    """A train state drawn from ``generator`` (which must live on
    ``device``) with the reference's distributions: table rows
    ~ U(-a, a), a = 1 / sqrt(mean table rows); dense weights as
    ``core.dlrm.init_dense_params``.  The numbers differ from the
    reference's ``jax.random`` draw; ``weights.state_from_numpy`` carries a
    JAX state across instead."""
    from repro_torch.core.dlrm import init_dense_params

    dev = resolve_device(device)
    rows = se.make_layout(cfg.spec, 1, cfg.emb_mode).total_rows
    a = 1.0 / float(np.sqrt(np.mean(cfg.table_rows)))
    W = torch.empty((rows, cfg.emb_dim), device=dev).uniform_(-a, a, generator=generator)
    opt = row_optim.resolve(cfg)
    emb = row_optim.init_store(opt, W)
    del W
    dense = dp.dp_global_arrays(init_dense_params(cfg, generator, dev), 1, NUM_BUCKETS)
    state = {"emb": emb, "dense": dense}
    if opt.stochastic_round:
        state["sr"] = torch.tensor(cfg.sr_seed, dtype=torch.int32, device=dev)
    return state
