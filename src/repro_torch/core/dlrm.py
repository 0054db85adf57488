"""DLRM forward for serving (twin of ``repro/core/dlrm.py``).

The dense part of the model: bottom MLP -> dot interaction -> top MLP, on
the bf16 dense parameters ``{"bot"|"top": {"w": [...], "b": [...]}}``, with
the reference's dtype at every seam: ``dense_x`` bf16, the bottom MLP's last
layer fp32, the interaction fp32, its output cast to bf16 for the top MLP,
the top MLP's last layer fp32 and then a sigmoid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.core.interaction import dot_interaction, interaction_output_dim
from repro_torch.models.mlp import mlp_forward


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The fields of the reference's ``DLRMConfig`` that serving reads."""

    name: str
    num_dense: int                  # dense-feature width (bottom MLP input)
    bottom: tuple[int, ...]         # bottom MLP hidden sizes; last == emb dim
    top: tuple[int, ...]            # top MLP hidden sizes; final 1 appended
    table_rows: tuple[int, ...]     # M_i per table
    emb_dim: int                    # E
    pooling: int                    # P look-ups per table
    batch: int = 2048
    emb_mode: str = "row"           # the port has 'row' only
    sparse_optimizer: Optional[str] = None  # 'split_sgd' (default) | 'sgd'
    mlp_impl: str = "xla"           # 'xla' | 'pallas' (the fused_mlp kernel)

    @property
    def spec(self) -> EmbeddingSpec:
        return EmbeddingSpec(self.table_rows, self.emb_dim)

    @property
    def bottom_sizes(self) -> list[int]:
        return [self.num_dense, *self.bottom]

    @property
    def top_sizes(self) -> list[int]:
        f = len(self.table_rows) + 1
        return [interaction_output_dim(f, self.emb_dim), *self.top, 1]


def init_mlp(sizes, generator: torch.Generator, device) -> dict:
    """``sizes = [in, h1, ..., out]`` -> fp32 {'w': [...], 'b': [...]}, drawn
    as the reference draws them: w ~ N(0, 2 / (in + out)), b = 0."""
    ws, bs = [], []
    for cin, cout in zip(sizes[:-1], sizes[1:]):
        std = (2.0 / (cin + cout)) ** 0.5
        ws.append(torch.randn((cin, cout), generator=generator, device=device) * std)
        bs.append(torch.zeros((cout,), device=device))
    return {"w": ws, "b": bs}


def init_dense_params(cfg: DLRMConfig, generator: torch.Generator, device="cuda") -> dict:
    """fp32 dense parameters ``{"bot", "top"}`` from ``generator`` (which
    must live on ``device``).  The numbers differ from the reference's
    ``jax.random`` draw; the distribution is the same."""
    dev = resolve_device(device)
    return {"bot": init_mlp(cfg.bottom_sizes, generator, dev),
            "top": init_mlp(cfg.top_sizes, generator, dev)}


def forward_local(dense_hi: dict, emb_out: torch.Tensor, dense_x: torch.Tensor,
                  impl: str = "xla") -> torch.Tensor:
    """Logits [B] from the bag outputs ``emb_out`` [B, S, E] fp32 and the
    dense features ``dense_x`` [B, num_dense] bf16."""
    bot = mlp_forward(dense_hi["bot"], dense_x, final_activation=True, impl=impl)  # [B, E]
    z = dot_interaction(bot, emb_out)                                             # [B, E + F(F-1)/2]
    logits = mlp_forward(dense_hi["top"], z.to(torch.bfloat16), impl=impl)
    return logits[:, 0]


def dlrm_dense_score(cfg: DLRMConfig):
    """Stage-shaped scorer: (dense_hi, emb_out, batch) -> [B] sigmoid."""
    def score(dense_hi, emb_out, batch):
        return torch.sigmoid(forward_local(dense_hi, emb_out, batch["dense_x"], cfg.mlp_impl))
    return score
