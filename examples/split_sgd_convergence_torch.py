"""The paper's Fig. 16 claim on the PyTorch port: Split-SGD-BF16 trains to the
same loss as fp32 SGD, while bf16 weights WITHOUT the lo bits (the naive
mixed-precision baseline) drift.

    PYTHONPATH=src python examples/split_sgd_convergence_torch.py [--device cpu]

The twin of ``examples/split_sgd_convergence.py``: the same small DLRM
(``fig16``), the same ``dlrm_stream(7, cfg)`` batches with the same teacher
labels, 200 steps at lr 0.05 in four modes, the same printout and the same
check (the final-20 mean loss of ``split`` within 5e-3 of ``fp32``'s).  The
initial weights are the port's own, drawn from a seeded ``torch.Generator``
with the reference's distributions.  The modes:

* ``fp32``: fp32 weights, ``w = fma(-lr, g, w)``;
* ``split``: Split-SGD-BF16 (``optim.split_sgd``): the forward reads the bf16
  ``hi`` halves, the step puts the fp32 weight together from ``hi`` and
  ``lo``, steps it and splits it again (on the card, one launch of the
  split_sgd kernel a leaf);
* ``split8``: the same with the low byte of ``lo`` zeroed after each step
  (8 extra mantissa bits, which the paper reports are not enough);
* ``bf16``: bf16 weights, each step rounded back to bf16.

The bags are ``core.embedding.bag_lookup`` (the embedding_bag kernel on the
card) with the reference's gradient: each lookup's cotangent rounded to the
table's dtype and added in that dtype.  ``--device cpu`` runs the kernels'
plain versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import embedding as E
from repro_torch.core.dlrm import DLRMConfig, bce_with_logits, forward_local, init_dense_params
from repro_torch.data.synthetic import dlrm_stream
from repro_torch.kernels import ref
from repro_torch.optim import split_sgd as S
from repro_torch.optim.data_parallel import tree_leaves, tree_map, tree_unflatten

MODES = ("fp32", "split", "split8", "bf16")
STEPS = 200
LR = 0.05


def config(lr: float = LR) -> DLRMConfig:
    return DLRMConfig(name="fig16", num_dense=32, bottom=(64, 16), top=(64, 32),
                      table_rows=(2000,) * 4, emb_dim=16, pooling=4, batch=512, lr=lr)


def init_params(cfg: DLRMConfig, device, seed: int = 0) -> dict:
    """fp32 ``{"emb": W [total_rows, E] ~ U(-0.02, 0.02), "dense": ...}``,
    drawn from a generator seeded ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    W = torch.empty((cfg.spec.total_rows, cfg.emb_dim), device=device).uniform_(
        -0.02, 0.02, generator=gen)
    return {"emb": W, "dense": init_dense_params(cfg, gen, device)}


def batches(cfg: DLRMConfig, steps: int, device) -> list:
    """``steps`` batches of ``dlrm_stream(7, cfg)`` on ``device`` with the
    reference's learnable teacher: the label is 1 when a sparse id is odd
    and a dense feature positive, so both the embedding and the MLP paths
    must train to fit it."""
    out = []
    for _, b in zip(range(steps), dlrm_stream(7, cfg)):
        y = ((b["idx"][:, 0, 0] % 2).astype(np.float32)
             + (b["dense_x"][:, 0] > 0).astype(np.float32)) >= 1.5
        out.append({"idx": torch.from_numpy(b["idx"]).to(device),
                    "dense_x": torch.from_numpy(b["dense_x"]).to(device),
                    "labels": torch.from_numpy(y.astype(np.float32)).to(device)})
    return out


def loss_fn(cfg: DLRMConfig, params: dict, batch: dict, bag=E.bag_lookup) -> torch.Tensor:
    """The mean binary cross-entropy of the model on ``params`` (fp32 or
    bf16 leaves); ``bag(W, g)`` sums the bags."""
    g = E.globalize(cfg.spec, batch["idx"])
    emb_out = bag(params["emb"], g)
    logits = forward_local(params["dense"], emb_out, batch["dense_x"].to(torch.bfloat16))
    return bce_with_logits(logits, batch["labels"]).mean()


def value_and_grad(cfg: DLRMConfig, params: dict, batch: dict, bag=E.bag_lookup):
    """``(loss, grads)``: the gradients in each leaf's dtype (bf16 leaves
    get bf16 gradients, as ``jax.value_and_grad`` gives them)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch, bag)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def sgd32(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``fma(-lr, g, p)`` in fp32, rounded once (jitted JAX's ``p - lr * g``)."""
    return ref.fma32(-np.float32(lr), g.float(), p.float())


def start(mode: str, params: dict):
    """The mode's state from fp32 ``params``."""
    if mode == "fp32":
        return params
    if mode in ("split", "split8"):
        return S.init(params)
    if mode == "bf16":  # no master bits at all
        return tree_map(lambda p: p.to(torch.bfloat16), params)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def step(mode: str, cfg: DLRMConfig, state, batch: dict, lr: float):
    """One step of ``mode``: ``(state, loss)`` (a 0-d device tensor); the
    split modes update their state in place."""
    if mode == "fp32":
        loss, g = value_and_grad(cfg, state, batch)
        return tree_unflatten(state, [sgd32(p, gg, lr) for p, gg in
                                      zip(tree_leaves(state), tree_leaves(g))]), loss
    if mode == "bf16":
        loss, g = value_and_grad(cfg, state, batch)
        return tree_unflatten(state, [sgd32(p, gg, lr).to(torch.bfloat16) for p, gg in
                                      zip(tree_leaves(state), tree_leaves(g))]), loss
    loss, g = value_and_grad(cfg, state.params.hi, batch)
    new = S.apply_updates(state, g, lr)
    if mode == "split8":  # keep only 8 extra mantissa bits
        for lo in tree_leaves(new.params.lo):
            lo.bitwise_and_(-256)  # 0xFF00 as int16
    return new, loss


def train(mode: str, steps: int = STEPS, lr: float = LR, *, device="cuda", params=None,
          data=None) -> tuple[list, object]:
    """``steps`` steps of ``mode`` from ``params`` (fp32, default
    :func:`init_params`) on ``data`` (default :func:`batches`).  Returns the
    losses and the final state."""
    dev = resolve_device(device)
    cfg = config(lr)
    state = start(mode, init_params(cfg, dev) if params is None else params)
    data = batches(cfg, steps, dev) if data is None else data
    losses = []
    for b in data[:steps]:
        state, loss = step(mode, cfg, state, b, lr)
        losses.append(loss)
    return [float(x) for x in torch.stack(losses).cpu()], state


def run(mode: str, steps: int = STEPS, lr: float = LR, device="cuda") -> list:
    return train(mode, steps, lr, device=device)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data = batches(config(), STEPS, dev)
    out = {}
    for mode in MODES:
        losses, _ = train(mode, device=dev, data=data)
        out[mode] = float(np.mean(losses[-20:]))
        print(f"{mode:7s}: final-20 mean loss {out[mode]:.5f}")
    gap_split = abs(out["split"] - out["fp32"])
    gap_bf16 = abs(out["bf16"] - out["fp32"])
    print(f"\nsplit-vs-fp32 gap {gap_split:.5f}  |  "
          f"bf16-vs-fp32 gap {gap_bf16:.5f}")
    assert gap_split < 5e-3, "Split-SGD should match fp32 (paper Fig. 16)"
    print("paper claim holds: Split-SGD-BF16 ~ fp32; naive bf16 drifts")
    return {"means": out, "gap_split": gap_split, "gap_bf16": gap_bf16}


if __name__ == "__main__":
    main()
