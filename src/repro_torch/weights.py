"""Where a serving snapshot's weights come from.

* :func:`snapshot_from_numpy` and :func:`state_to_snapshot` carry the JAX
  package's weights across, bit for bit, from numpy copies of its arrays
  (``jax.tree.map(np.asarray, ...)``): the ``snapshot_state(...)`` pytree,
  or a whole train state.  The tests use them so that both sides score with
  the same weights; the JAX random generator is not ported.
* :func:`init_snapshot` draws a port-native snapshot from a
  ``torch.Generator``, with the reference's distributions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sharded_embedding as se
from repro_torch.core.dlrm import DLRMConfig, init_dense_params
from repro_torch.models.mlp import mlp_sizes
from repro_torch.optim import row as row_optim
from repro_torch.optim.split_sgd import split_fp32
from repro_torch.serve.snapshot import _tree_map


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy -> torch, bit for bit.  ``torch.from_numpy`` refuses the
    ``ml_dtypes`` bf16 dtype that JAX hands out, so bf16 goes through an
    int16 view; a uint16 array (a Split-SGD ``lo`` slab) comes out as its
    int16 bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device)
    return torch.from_numpy(a).to(device)


def _check(snap: dict, cfg: DLRMConfig) -> dict:
    rows = se.make_layout(cfg.spec, 1, cfg.emb_mode).total_rows
    if tuple(snap["emb_w"].shape) != (rows, cfg.emb_dim):
        raise ValueError(f"emb_w is {tuple(snap['emb_w'].shape)}, the config needs "
                         f"{(rows, cfg.emb_dim)}")
    for part, sizes in (("bot", cfg.bottom_sizes), ("top", cfg.top_sizes)):
        params = snap["dense_hi"][part]
        if mlp_sizes(params) != sizes or [w.shape[0] for w in params["w"]] != sizes[:-1] \
                or [b.shape[0] for b in params["b"]] != sizes[1:]:
            raise ValueError(f"dense_hi[{part!r}] has widths {mlp_sizes(params)}, the config "
                             f"needs {sizes}")
    return snap


def snapshot_from_numpy(snap_np: dict, cfg: DLRMConfig, device="cuda") -> dict:
    """The reference's ``snapshot_state`` pytree, as numpy arrays (``emb_w``
    bf16-hi or fp32, ``dense_hi`` bf16), -> the port's snapshot state on
    ``device``."""
    dev = resolve_device(device)
    snap = {"emb_w": to_torch(snap_np["emb_w"], dev),
            "dense_hi": _tree_map(lambda a: to_torch(a, dev), snap_np["dense_hi"])}
    return _check(snap, cfg)


def state_to_snapshot(state_np: dict, cfg: DLRMConfig, device="cuda") -> dict:
    """A full JAX train state as numpy arrays (``emb`` store, ``dense.hi``)
    -> the port's snapshot state on ``device``.  Only the forward slabs
    cross."""
    fwd = row_optim.fwd_weights(row_optim.resolve(cfg), state_np["emb"])
    return snapshot_from_numpy({"emb_w": fwd, "dense_hi": state_np["dense"]["hi"]}, cfg, device)


def init_snapshot(cfg: DLRMConfig, generator: torch.Generator, device="cuda") -> dict:
    """A port-native snapshot state: table rows ~ U(-a, a) with
    a = 1 / sqrt(mean table rows), dense weights as :func:`init_dense_params`,
    each fp32 master split and its bf16 ``hi`` half kept (the ``w`` slab
    itself for ``sgd``).  ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    rows = se.make_layout(cfg.spec, 1, cfg.emb_mode).total_rows
    a = 1.0 / float(np.sqrt(np.mean(cfg.table_rows)))
    W = torch.empty((rows, cfg.emb_dim), device=dev).uniform_(-a, a, generator=generator)
    split = row_optim.resolve(cfg) == "split_sgd"
    emb_w = split_fp32(W)[0] if split else W
    del W
    dense = init_dense_params(cfg, generator, dev)
    return {"emb_w": emb_w, "dense_hi": _tree_map(lambda t: split_fp32(t)[0], dense)}
