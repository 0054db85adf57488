"""DLRM forward, loss and train step (twin of ``repro/core/dlrm.py``).

The dense part of the model: bottom MLP -> dot interaction -> top MLP, on
the bf16 dense parameters ``{"bot"|"top": {"w": [...], "b": [...]}}``, with
the reference's dtype at every seam: ``dense_x`` bf16, the bottom MLP's last
layer fp32, the interaction fp32, its output cast to bf16 for the top MLP,
the top MLP's last layer fp32 and then a sigmoid (serving and
:func:`make_eval_step`) or the binary cross-entropy on the logits (training,
:func:`make_train_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import EmbeddingSpec
from repro_torch.core.interaction import dot_interaction, interaction_output_dim
from repro_torch.dist.exchange import ExchangeConfig
from repro_torch.models.mlp import init_mlp, mlp_forward


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The fields of the reference's ``DLRMConfig`` that serving, the train
    step and the eval step read."""

    name: str
    num_dense: int                  # dense-feature width (bottom MLP input)
    bottom: tuple[int, ...]         # bottom MLP hidden sizes; last == emb dim
    top: tuple[int, ...]            # top MLP hidden sizes; final 1 appended
    table_rows: tuple[int, ...]     # M_i per table
    emb_dim: int                    # E
    pooling: int                    # P look-ups per table
    batch: int = 2048
    emb_mode: str = "row"           # 'row' | 'table'
    idx_input: str = "replicated"   # 'replicated' | 'sharded' (the on-device index exchange)
    # 'split_sgd' (default) | 'sgd' | 'momentum' | 'adagrad' | 'adagrad_rowwise'
    # | 'adagrad_freq' | 'momentum_bf16' | 'adagrad_bf16'; opt_beta / opt_eps
    # override the optimizer's defaults
    sparse_optimizer: Optional[str] = None
    opt_beta: Optional[float] = None
    opt_eps: Optional[float] = None
    mlp_impl: str = "xla"           # 'xla' | 'pallas' (the fused_mlp kernel)
    lr: float = 0.1                 # SGD step of the dense and the embedding update
    microbatches: int = 1           # M: the step's microbatches
    # the collectives' configuration (dist/exchange.py): a typed
    # ExchangeConfig, or exchange_dtype setting both wire formats
    exchange: Optional[ExchangeConfig] = None
    exchange_dtype: Optional[str] = None
    # the update's stream sorted on the host: the batch carries the psort_*
    # fields of data.pipeline.presort_batch
    host_presort: bool = False
    # the hot-row cache (core/cache.py): a mirror of the hot_rows most-touched
    # rows of each table on every rank; table mode with idx_input='sharded'
    # serves the bags whose lookups all hit it from it.  0 = off
    hot_rows: int = 0
    # rank the hot set again from the touch counts every this many steps
    promote_every: int = 1
    # 'allreduce' (the mirror refreshed every step: bit for bit hot_rows=0) or
    # 'deferred:N' (every N steps and at each promotion)
    hot_sync: str = "allreduce"
    # the in-graph step metrics (telemetry/metrics.py) in the state as
    # 'metrics', drained by the train loop
    step_metrics: bool = False
    # weighted bags: the batch carries 'weights' [B, S, P] fp32 in idx's layout
    weighted: bool = False
    # the first per-step seed of the stochastic rounding (the train state's
    # 'sr', present when the optimizer rounds its state stochastically or a
    # wire is 'bf16_sr')
    sr_seed: int = 0

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


def init_dense_params(cfg: DLRMConfig, generator: Optional[torch.Generator],
                      device="cuda") -> dict:
    """fp32 dense parameters ``{"bot", "top"}`` from ``generator`` (which
    must live on ``device``).  The numbers differ from the reference's
    ``jax.random`` draw; the distribution is the same."""
    dev = torch.device(device)
    if dev.type != "meta":  # meta: the shapes alone (core.hybrid.dense_tree)
        dev = resolve_device(dev)
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


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample binary cross-entropy on logits, in the reference's form."""
    x, y = logits.float(), labels.float()
    return torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))


def dlrm_dense_loss(cfg: DLRMConfig):
    """Stage-shaped loss: (dense_hi, emb_out, batch) -> the SUM loss over
    the batch (the pipeline's dense_fwd_bwd stage divides by the batch)."""
    def loss(dense_hi, emb_out, batch):
        logits = forward_local(dense_hi, emb_out, batch["dense_x"], cfg.mlp_impl)
        return bce_with_logits(logits, batch["labels"]).sum()
    return loss


def as_hybrid_def(cfg: DLRMConfig):
    """DLRM as the generic hybrid skeleton (``core.hybrid.HybridDef``): the
    dense tree of :func:`init_dense_params`, the loss and the scorer above
    as stage-shaped functions (``mlp_impl`` read there), ``dense_x`` bf16 and
    ``labels`` fp32 as the batch's extras, ``emb_lr`` = ``lr``.  With
    ``mlp_impl`` 'pallas' the model has no ``dense_loss``: the fused_mlp
    kernel has no backward, so such a config scores but does not train, and
    the train step refuses it (``core.pipeline.validate_pipeline``)."""
    from repro_torch.core.hybrid import HybridDef
    return HybridDef(
        name=cfg.name, spec=cfg.spec, pooling=cfg.pooling, batch=cfg.batch,
        init_dense=lambda generator, device: init_dense_params(cfg, generator, device),
        dense_loss=dlrm_dense_loss(cfg) if cfg.mlp_impl == "xla" else None,
        dense_score=dlrm_dense_score(cfg),
        extras={"dense_x": ((cfg.num_dense,), torch.bfloat16), "labels": ((), torch.float32)},
        emb_mode=cfg.emb_mode, sparse_optimizer=cfg.sparse_optimizer, opt_beta=cfg.opt_beta,
        opt_eps=cfg.opt_eps, exchange=cfg.exchange, exchange_dtype=cfg.exchange_dtype,
        lr=cfg.lr, emb_lr=cfg.lr, idx_input=cfg.idx_input, microbatches=cfg.microbatches,
        weighted=cfg.weighted, host_presort=cfg.host_presort, sr_seed=cfg.sr_seed,
        hot_rows=cfg.hot_rows, promote_every=cfg.promote_every, hot_sync=cfg.hot_sync,
        step_metrics=cfg.step_metrics)


def init_state(cfg: DLRMConfig, generator: torch.Generator, device="cuda", mesh=None) -> dict:
    """This rank's train state drawn from ``generator`` (see
    :func:`repro_torch.core.hybrid.init_state`)."""
    from repro_torch.core import hybrid
    return hybrid.init_state(cfg, generator, device, mesh)


def make_layout(cfg: DLRMConfig, mesh):
    """The embedding layout of ``cfg`` over the shards of ``mesh``."""
    from repro_torch.core import hybrid
    return hybrid.make_layout(cfg, mesh)


def make_train_step(cfg: DLRMConfig, mesh=None, *, device="cuda"):
    """The hybrid-parallel train step on this rank of ``mesh`` (a
    ``launch.mesh.Mesh``; None: the one-rank step on ``device``),
    ``step(state, batch) -> (state, loss)`` (see
    :func:`repro_torch.core.pipeline.make_pipelined_train_step`)."""
    from repro_torch.core import hybrid
    return hybrid.make_train_step(cfg, mesh, device=device)


def make_eval_step(cfg: DLRMConfig, mesh=None, *, device="cuda"):
    """The scoring step of a train state on this rank of ``mesh`` (None: one
    rank on ``device``), ``ev(state, batch) -> [B / ranks]`` sigmoid scores
    of the rank's samples: ``core.hybrid.make_score_step`` (the train
    step's ``index_exchange`` and ``embedding_fwd`` stages, then
    :func:`forward_local`, ``fused_mlp`` with ``cfg.mlp_impl ==
    "pallas"``).  ``batch`` as the train step takes it; ``labels`` are not
    read."""
    from repro_torch.core import hybrid
    return hybrid.make_score_step(cfg, mesh, device=device)
