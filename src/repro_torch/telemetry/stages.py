"""The train step's stages timed one by one (twin of
``repro/telemetry/stages.py``), with their modelled bytes and flops.

The step runs its six stages back to back on one stream, so a clock around
it says nothing of where its time goes.  :func:`profile_stages` runs each
``core.pipeline.Stage`` alone on one staged batch, ``steps`` times, each run
a span on the ``pipeline_stages`` track: with ``barrier=True`` (the
default) a ``torch.cuda.synchronize()`` closes each run, so a span is the
stage's own device time; with ``barrier=False`` it is what the host pays to
issue the stage.  The stages so timed add up to more than the step, whose
stages overlap host and device work.

Each span also carries the stage's modelled bytes and flops at ``ranks``
ranks, from the reference's analytic formulas (properties of the algorithm:
int32 index streams, fp32 bags, bf16 dense parameters), and the time they
would take on a card (:data:`H100_SXM`, the data sheet's figures at 700 W).
On one rank the collectives are the identity, and the model is the only
cross-rank number: measure compute here, model communication.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CardSpec:
    """The peaks a modelled time is taken against."""

    name: str
    peak_flops_bf16: float  # FLOP/s, dense bf16 tensor
    hbm_bw: float           # bytes/s, device memory
    link_bw: float          # bytes/s, one direction, all of a card's links


#: NVIDIA H100 SXM at 700 W, from its data sheet: HBM3 3.35 TB/s, 989 TFLOP/s
#: dense bf16, NVLink 900 GB/s both ways (450 GB/s a direction)
H100_SXM = CardSpec(name="h100-sxm", peak_flops_bf16=989e12, hbm_bw=3.35e12, link_bw=450e9)


def _median_ms(durs: list) -> float:
    return float(np.median(np.asarray(durs))) * 1e3


def modeled_stage_costs(cfg, layout=None, ranks: int = 64, card: CardSpec = H100_SXM) -> dict:
    """Per stage, the bytes and flops one of ``ranks`` ranks moves and does
    (the reference's formulas: the fabric's bytes for a stage with a
    collective, device memory's for the others) and ``modeled_us``, the
    larger of the bytes over the card's rate (its links' or its memory's)
    and the flops over its bf16 peak."""
    from repro_torch.core.hybrid import dense_sizes

    B, Pq, E = cfg.batch, cfg.pooling, cfg.spec.dim
    S = layout.num_orig_slots if layout is not None else cfg.spec.num_tables
    n_dense = dense_sizes(cfg)
    r = max(int(ranks), 1)
    shrink = (r - 1) / r            # a rank's own block never crosses the fabric
    idx_bytes = B * S * Pq * 4      # the global int32 index stream
    bag_bytes = B * S * E * 4       # the global fp32 bags
    row_bytes = B * S * Pq * E * 4  # the rows read, duplicates included
    costs = {
        "index_exchange": dict(bytes=idx_bytes * shrink, flops=0.0, comm="all_gather(idx)"),
        "embedding_fwd": dict(bytes=row_bytes / r + bag_bytes / r * shrink,
                              flops=2.0 * B * S * Pq * E / r, comm="all_to_all"),
        "dense_fwd_bwd": dict(bytes=3.0 * n_dense * 2, flops=6.0 * n_dense * B / r, comm="none"),
        "dY_exchange": dict(bytes=bag_bytes / r * shrink, flops=0.0, comm="all_to_all(dY)"),
        "sparse_update": dict(bytes=2.0 * row_bytes / r, flops=2.0 * B * S * Pq * E / r,
                              comm="none"),
        "dense_update": dict(bytes=(4.0 + 2.0) * n_dense * shrink, flops=2.0 * n_dense / r,
                             comm="rs+ag"),
    }
    for c in costs.values():
        bw = card.link_bw if c["comm"] != "none" else card.hbm_bw
        c["modeled_us"] = max(c["bytes"] / bw, c["flops"] / card.peak_flops_bf16) * 1e6
    return costs


def synthetic_batch(cfg, fields: dict, seed: int = 0, device="cpu") -> dict:
    """A random batch of ``fields`` (``core.hybrid.batch_struct``), drawn as the
    reference draws it: integer fields valid row ids below the smallest
    table's rows, float fields uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    cap = int(min(cfg.spec.table_rows))
    out = {}
    for name, (shape, dtype) in fields.items():
        if not dtype.is_floating_point:
            a = torch.from_numpy(rng.integers(0, cap, size=shape, dtype=np.int64)).to(dtype)
        else:
            a = torch.from_numpy(rng.random(size=shape, dtype=np.float64)).to(dtype)
        out[name] = a.to(device)
    return out


def profile_stages(cfg, mesh=None, *, steps: int = 3, warmup: int = 1, barrier: bool = True,
                   tracer=None, ranks_model: int = 64, card: CardSpec = H100_SXM, seed: int = 0,
                   device="cuda") -> dict:
    """Each stage of ``cfg``'s train step run alone on a synthetic batch and
    timed (the median of ``steps`` runs after ``warmup``).  Returns
    ``{"stages": {name: {"ms", "bytes", "flops", "modeled_us", "comm"}},
    "mesh", "barrier", "steps", "ranks_model", "chip", "dense_params"}`` and,
    with the tracer on, one span a timed run on the ``pipeline_stages``
    track, the modelled costs in its args.  ``mesh``: this rank's mesh
    (None: one rank on ``device``); the state is ``core.hybrid.init_state``'s
    from ``seed``."""
    from repro_torch.core import hybrid, pipeline
    from repro_torch.core.dlrm import init_state
    from repro_torch.data.pipeline import PSORT_KEYS
    from repro_torch.launch.mesh import resolve_mesh
    from repro_torch.optim import row as row_optim

    if tracer is None:
        from repro_torch.telemetry.tracer import get_tracer
        tracer = get_tracer()
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    pipeline.validate_pipeline(cfg, mesh, 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_state(cfg, gen, mesh=mesh)
    layout = hybrid.make_layout(cfg, mesh)
    glob = synthetic_batch(cfg, hybrid.batch_struct(cfg, mesh, layout), seed)
    batch = {k: v.to(dev) for k, v in hybrid.local_batch(cfg, mesh, glob).items()}
    stages = pipeline.build_stages(cfg, layout, mesh)
    opt = row_optim.resolve(cfg)
    costs = modeled_stage_costs(cfg, layout, ranks=ranks_model, card=card)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    result = {}

    def timed(name, fn, *args):
        out = None
        for _ in range(max(warmup, 1)):
            out = fn(*args)
        sync()
        durs = []
        c = costs[name]
        for _ in range(max(steps, 1)):
            t0 = time.perf_counter()
            with tracer.span(f"stage/{name}", cat="pipeline", track="pipeline_stages",
                             comm=c["comm"], modeled_bytes=c["bytes"], modeled_flops=c["flops"],
                             modeled_us=c["modeled_us"], ranks_model=ranks_model, chip=card.name):
                out = fn(*args)
                if barrier:
                    sync()
            durs.append(time.perf_counter() - t0)
        result[name] = {"ms": _median_ms(durs), "bytes": c["bytes"], "flops": c["flops"],
                        "modeled_us": c["modeled_us"], "comm": c["comm"]}
        return out

    sr = state.get("sr")
    W_fwd = row_optim.fwd_weights(opt, state["emb"])
    idx_fwd, idx_upd = timed("index_exchange", stages.index_exchange, batch["idx"])
    wgt_fwd, wgt_upd = (stages.index_exchange(batch["weights"]) if cfg.weighted
                        else (None, None))
    emb_out = timed("embedding_fwd", stages.embedding_fwd, W_fwd, idx_fwd, wgt_fwd)
    mb = {k: v for k, v in batch.items() if k not in PSORT_KEYS}
    _, g_dense, d_emb = timed("dense_fwd_bwd", stages.dense_fwd_bwd, state["dense"]["hi"],
                              emb_out, mb)
    dY = timed("dY_exchange", stages.dY_exchange, d_emb, sr, 0)
    timed("sparse_update", stages.sparse_update, state["emb"], idx_upd, dY, wgt_upd, sr)
    timed("dense_update", stages.dense_update, state["dense"], g_dense, sr)
    return {"stages": result, "mesh": dict(mesh.shape), "barrier": barrier, "steps": steps,
            "ranks_model": ranks_model, "chip": card.name,
            "dense_params": hybrid.dense_sizes(cfg)}
