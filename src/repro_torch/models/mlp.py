"""MLP stack (twin of ``repro/models/mlp.py``).

bf16 inputs and weights, fp32 accumulation, bf16 between layers and fp32 out
of the last layer.  ``impl="pallas"`` runs every layer through the fused_mlp
kernel (the name the reference gives its kernel path); ``impl="xla"`` leaves
the product to ``torch.matmul``, as the reference leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def init_mlp(sizes, generator: Optional[torch.Generator], device) -> dict:
    """``sizes = [in, h1, ..., out]`` -> fp32 {'w': [...], 'b': [...]}, drawn
    as the reference draws them: w ~ N(0, 2 / (in + out)), b = 0."""
    ws, bs = [], []
    for cin, cout in zip(sizes[:-1], sizes[1:]):
        std = (2.0 / (cin + cout)) ** 0.5
        ws.append(torch.randn((cin, cout), generator=generator, device=device) * std)
        bs.append(torch.zeros((cout,), device=device))
    return {"w": ws, "b": bs}


def mlp_forward(params: dict, x: torch.Tensor, final_activation: bool = False,
                impl: str = "xla") -> torch.Tensor:
    """Apply the stack; ReLU between layers, optionally on the last one."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown mlp impl {impl!r}")
    n = len(params["w"])
    h = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        act = final_activation or i < n - 1
        last = i == n - 1
        if impl == "pallas":
            w = w.to(torch.bfloat16)
            if w.data_ptr() % 16:
                # a train state's dense leaves are views of one flat buffer, at offsets
                # the kernel's 16-byte loads do not take: a copy of this layer's weights
                w = w.clone()
            h = ops.fused_mlp_layer(h.to(torch.bfloat16), w, b,
                                    activation="relu" if act else "none",
                                    out_dtype=torch.float32 if last else torch.bfloat16)
        else:
            y = h.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + b.float()
            h = torch.relu(y) if act else y
            if not last:
                h = h.to(torch.bfloat16)
    return h  # final layer fp32


def mlp_sizes(params: dict) -> list[int]:
    return [params["w"][0].shape[0]] + [w.shape[1] for w in params["w"]]
