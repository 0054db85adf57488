"""The port's kernels, as the model code calls them, and their launch counts.

Each wrapper validates its inputs, launches its hand-written kernel for CUDA
tensors, runs its plain PyTorch version for CPU tensors, and counts its
launches in a plain int attribute (``embedding_bag.launches``; the fused bag
stage ``embedding_bag_stage`` launches the same kernel and counts there).
Nothing here branches on an optimizer: ``optim.row`` picks the row kernel.
"""

from __future__ import annotations

from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_stage  # noqa: F401
from repro_torch.kernels.embedding_update import (fused_update_adagrad, fused_update_adagrad_bf16,
                                                  fused_update_adagrad_rowwise, fused_update_fp32,
                                                  fused_update_freq, fused_update_momentum,
                                                  fused_update_momentum_bf16, fused_update_split)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_mlp import fused_mlp_layer
from repro_torch.kernels.interaction import dot_interaction
from repro_torch.kernels.split_sgd import split_sgd

KERNELS = {
    "embedding_bag": embedding_bag,
    "dot_interaction": dot_interaction,
    "fused_mlp": fused_mlp_layer,
    "embedding_update": fused_update_split,
    "embedding_update_fp32": fused_update_fp32,
    "split_sgd": split_sgd,
    "embedding_update_momentum": fused_update_momentum,
    "embedding_update_adagrad": fused_update_adagrad,
    "embedding_update_adagrad_rowwise": fused_update_adagrad_rowwise,
    "embedding_update_freq": fused_update_freq,
    "embedding_update_momentum_bf16": fused_update_momentum_bf16,
    "embedding_update_adagrad_bf16": fused_update_adagrad_bf16,
    "flash_attention": flash_attention,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for path in fused_mlp_layer.route_launches:
        fused_mlp_layer.route_launches[path] = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
