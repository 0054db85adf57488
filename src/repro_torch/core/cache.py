"""The hot-row embedding cache (twin of ``repro/core/cache.py``): a
replicated mirror of the ``hot_rows`` most-touched rows of each table, in
front of the sharded store.

* The store stays authoritative: every update lands there through the
  sparse update (write-through); the cache never takes a gradient.
* Table mode with the batch-sharded index stream: a bag whose lookups all
  hit the hot set is summed on the rank that holds the bag's sample, from
  the mirror, and put in place of the bag that came through the all-to-all
  (:func:`hot_bag_local`).  On the card the hot bags are one launch of the
  embedding_bag kernel over the mirror, whose list of a bag's distinct rows
  depends on id equality and lane order alone; gid -> mirror position is
  one to one, so a hit bag is the owner's bag bit for bit.
* Every ``promote_every`` steps the hot set is ranked again from the touch
  counts ``cnt`` (``optim.row``) in the total order (count descending,
  ``hash32(gid ^ seed)`` ascending), the same on every rank and every
  layout (:func:`select_hot`).

``hot_sync``: ``"allreduce"`` refreshes the mirror from the updated store
every step (an exact integer ``psum`` of the owners' bit patterns), so a
step is bit for bit the step with ``hot_rows=0``; ``"deferred:N"`` every N
steps and at each promotion, so hot bags read rows up to N steps old.

Members are keyed on the spec's global row ids
(``core.sharded_embedding.layout_gid_maps``), not on layout positions, so
the cache carries across a checkpoint and an elastic reshard unchanged.
The step reads none of it on the host: promotion and refresh are computed
every step and chosen by ``torch.where`` on the tick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sharded_embedding as se
from repro_torch.dist import comm
from repro_torch.kernels import ops
from repro_torch.optim import row as row_optim
from repro_torch.optim.stochastic import MASK32, mix32


def parse_hot_sync(mode: str) -> int:
    """The refresh cadence in steps: ``"allreduce"`` -> 1, ``"deferred:N"``
    -> N (N >= 1).  Raises ValueError on anything else."""
    if mode == "allreduce":
        return 1
    if isinstance(mode, str) and mode.startswith("deferred:"):
        try:
            n = int(mode.split(":", 1)[1])
        except ValueError:
            n = 0
        if n >= 1:
            return n
    raise ValueError(f"unknown hot_sync {mode!r}; expected 'allreduce' or 'deferred:N' with N >= 1")


def hash32(x, seed: int) -> torch.Tensor:
    """The promotion's tiebreak, ``hash32(x ^ seed)`` of the reference: the
    lowbias32 avalanche of the 32-bit patterns, as int64 in [0, 2^32)."""
    x = torch.as_tensor(x).to(torch.int64) & MASK32
    return mix32(x ^ (int(seed) & MASK32))


def spec_gid_to_table(spec) -> np.ndarray:
    """gid -> table id ([spec.total_rows] int32, -1 in the ``row_pad`` gaps)."""
    out = np.full(spec.total_rows, -1, np.int32)
    for t, rows_t in enumerate(spec.table_rows):
        base = int(spec.row_offsets[t])
        out[base:base + rows_t] = t
    return out


def cache_struct(cfg, layout: se.ShardedEmbeddingLayout, opt) -> dict:
    """``(shape, dtype)`` of the replicated cache: ``hot_w`` [K, E] mirrors
    the forward slab (bf16 ``hi`` for Split-SGD, else fp32 ``w``), ``hot_ids``
    [K] the members' gids (-1: empty), ``hot_pos`` [spec rows] their mirror
    positions (-1: cold), ``tick`` the steps taken; K = ``hot_rows`` x tables."""
    K = int(cfg.hot_rows) * layout.spec.num_tables
    return {"hot_w": ((K, layout.spec.dim),
                      torch.bfloat16 if row_optim.make(opt).split else torch.float32),
            "hot_ids": ((K,), torch.int32),
            "hot_pos": ((layout.spec.total_rows,), torch.int32),
            "tick": ((), torch.int32)}


def init_cache(cfg, layout: se.ShardedEmbeddingLayout, opt, device) -> dict:
    """The empty cache: no member, so every bag misses until the first
    promotion fills it."""
    s = cache_struct(cfg, layout, opt)
    return {"hot_w": torch.zeros(s["hot_w"][0], dtype=s["hot_w"][1], device=device),
            "hot_ids": torch.full(s["hot_ids"][0], -1, dtype=torch.int32, device=device),
            "hot_pos": torch.full(s["hot_pos"][0], -1, dtype=torch.int32, device=device),
            "tick": torch.zeros((), dtype=torch.int32, device=device)}


@dataclasses.dataclass(frozen=True)
class HotPlan:
    """What :func:`select_hot` needs of a layout and a seed, made once:
    ``pos`` [T, C] int64 each table's layout positions (C the largest table,
    at least ``hot_rows``; 0 past a table's rows), ``tie`` [T, C] int64
    ``2^32 - 1 - hash32(gid ^ seed)`` (-1 past a table's rows), ``base`` [T, 1]
    int64 each table's first gid."""

    pos: torch.Tensor
    tie: torch.Tensor
    base: torch.Tensor


def hot_plan(layout: se.ShardedEmbeddingLayout, hot_rows: int, seed: int, device) -> HotPlan:
    """The :class:`HotPlan` of ``layout``'s tables at ``hot_rows`` and ``seed``
    on ``device``."""
    spec = layout.spec
    _, g2l = se.layout_gid_maps(layout)
    T, C = spec.num_tables, max(max(spec.table_rows), int(hot_rows))
    pos = np.zeros((T, C), np.int64)
    tie = np.full((T, C), -1, np.int64)
    for t, rows_t in enumerate(spec.table_rows):
        gids = int(spec.row_offsets[t]) + np.arange(rows_t, dtype=np.int64)
        pos[t, :rows_t] = g2l[gids]
        tie[t, :rows_t] = MASK32 - hash32(torch.from_numpy(gids), seed).numpy()
    dev = torch.device(device)
    return HotPlan(pos=torch.from_numpy(pos).to(dev), tie=torch.from_numpy(tie).to(dev),
                   base=torch.as_tensor(spec.row_offsets, dtype=torch.int64, device=dev)[:, None])


def select_hot(layout: se.ShardedEmbeddingLayout, cnt_full: torch.Tensor, hot_rows: int,
               seed: int, plan: HotPlan | None = None) -> torch.Tensor:
    """The ``hot_rows`` most-touched rows of each table -> hot_ids
    [tables x hot_rows] int32 (gids; -1 where a table has fewer touched
    rows), from ``cnt_full`` [layout.total_rows], the counts in layout order.

    The order is the reference's total order, count descending then
    ``hash32(gid ^ seed)`` ascending (the hash of distinct gids never ties),
    so the set and its order depend on (count, gid, seed) alone.  The
    reference takes it with a stable sort of every row a table; here each
    row's key is ``count << 32 | (2^32 - 1 - hash)`` and one ``topk`` over
    the tables' rows takes the largest keys: the same rows in the same
    order.  ``plan``: :func:`hot_plan` of the layout (made here if None)."""
    plan = plan or hot_plan(layout, hot_rows, seed, cnt_full.device)
    cnt = cnt_full.reshape(-1).to(torch.int64)[plan.pos]
    key = (cnt << 32) | plan.tie  # past a table's rows: -1, below every row's key
    top, col = torch.topk(key, int(hot_rows), dim=1)
    ids = torch.where(top >= 1 << 32, plan.base + col, -1)
    return ids.reshape(-1).to(torch.int32)


def hot_positions(spec_total: int, hot_ids: torch.Tensor) -> torch.Tensor:
    """gid -> mirror position ([spec_total] int32, -1 for a cold row).  An
    empty slot (-1) is sent to a spare last entry, which is cut off."""
    tgt = torch.where(hot_ids >= 0, hot_ids, spec_total).to(torch.int64)
    pos = torch.full((spec_total + 1,), -1, dtype=torch.int32, device=hot_ids.device)
    pos.scatter_(0, tgt, torch.arange(hot_ids.shape[0], dtype=torch.int32, device=hot_ids.device))
    return pos[:spec_total]


def refresh_hot_slab(layout: se.ShardedEmbeddingLayout, W_local: torch.Tensor,
                     hot_ids: torch.Tensor, g2l: torch.Tensor, group: comm.Group) -> torch.Tensor:
    """The rows ``hot_ids`` names, out of the sharded forward slab
    ``W_local`` (this shard's rows), on every rank of the embedding
    ``group``: each row's one owner hands in its bit pattern, every other
    rank zero, and the ``psum`` adds the patterns as int32 (bf16's
    sign-extended), so the sum is the owner's bits exactly.  ``g2l``: the
    layout's gid -> position map on the slab's device."""
    glob = g2l[hot_ids.clamp_min(0).long()]
    R = layout.rows_per_shard
    local = glob - group.index * R
    own = (hot_ids >= 0) & (glob >= 0) & (local >= 0) & (local < R)
    rows = W_local[local.clamp(0, R - 1).long()]
    if rows.dtype == torch.bfloat16:
        bits = torch.where(own[:, None], rows.view(torch.int16).to(torch.int32), 0)
        return comm.psum(bits, group).to(torch.int16).view(torch.bfloat16)
    bits = torch.where(own[:, None], rows.float().view(torch.int32), 0)
    return comm.psum(bits, group).view(torch.float32)


def hot_lookups(layout: se.ShardedEmbeddingLayout, hot_pos: torch.Tensor, idx: torch.Tensor,
                offsets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(each lookup's mirror position [b, S, P] int32, -1 cold; whether it
    hits [b, S, P]) of an original-slot block ``idx`` [b, S, P];
    ``offsets`` [S] int32 the slots' first gids."""
    total = layout.spec.total_rows
    gid = idx + offsets[None, :, None]
    ok = (gid >= 0) & (gid < total)
    pos = hot_pos[gid.clamp(0, total - 1).long()]
    return pos, ok & (pos >= 0)


def hot_bag_local(layout: se.ShardedEmbeddingLayout, hot_w: torch.Tensor, hot_pos: torch.Tensor,
                  idx: torch.Tensor, weights=None, offsets=None,
                  layout_bags: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit [b, S] bool, bag [b, S, E] fp32) of this rank's own block of the
    batch, ``idx`` [b, S, P] original-slot ids (``weights`` in its layout),
    read from the mirror alone.  A bag hits only when all its lookups hit.
    The bags are the embedding_bag wrapper's (``ops.embedding_bag``) over
    the mirror with the lookups' mirror positions as ids: on the card one
    launch of the kernel that sums the owner's bags, in the kernel layout a
    launch of ``layout_bags`` bags takes (the owner's bag count; None: this
    launch's own), so a hit bag is the owner's bag bit for bit; on the CPU
    its plain version, which is also the owner's.  ``offsets``: the slots'
    first gids as int32 on idx's device (made here if None).  The caller
    puts the hit bags in place: ``torch.where(hit[..., None], bag, out)``."""
    if offsets is None:
        offsets = torch.as_tensor(layout.spec.row_offsets[layout.slot_to_table],
                                  dtype=torch.int32, device=idx.device)
    pos, lk_hit = hot_lookups(layout, hot_pos, idx, offsets)
    bag = ops.embedding_bag(hot_w, pos.to(torch.int32).contiguous(), hot_w.shape[0],
                            weights, layout_bags=layout_bags)
    return lk_hit.all(dim=2), bag


class CacheEpilogue:
    """The cache's step epilogue on this rank, built once with the step: the
    promotion plan, the gid map and the cadence.  ``__call__(cache,
    new_emb)`` advances the cache one step from the updated store."""

    def __init__(self, cfg, layout: se.ShardedEmbeddingLayout, opt, group: comm.Group, device):
        self.layout, self.opt, self.group = layout, row_optim.make(opt), group
        self.sync_n = parse_hot_sync(getattr(cfg, "hot_sync", "allreduce"))
        self.every = int(getattr(cfg, "promote_every", 1))
        self.hot_rows = int(cfg.hot_rows)
        self.seed = int(getattr(cfg, "sr_seed", 0))
        self.plan = hot_plan(layout, self.hot_rows, self.seed, device)
        self.g2l = torch.as_tensor(se.layout_gid_maps(layout)[1], dtype=torch.int32,
                                   device=device)

    def __call__(self, cache: dict, new_emb: dict) -> dict:
        """Promotion (every ``promote_every`` ticks: the hot set ranked again
        from the gathered counts, and a refresh) and the refresh on the
        ``hot_sync`` cadence are computed every step and chosen by
        ``torch.where``, so every rank issues the same collectives."""
        tick = cache["tick"] + 1
        cnt_full = comm.all_gather(new_emb["cnt"][:, 0].contiguous(), self.group)
        new_ids = select_hot(self.layout, cnt_full, self.hot_rows, self.seed, self.plan)
        promote = torch.remainder(tick, self.every) == 0
        ids = torch.where(promote, new_ids, cache["hot_ids"])
        refresh = promote | (torch.remainder(tick, self.sync_n) == 0)
        slab = refresh_hot_slab(self.layout, row_optim.fwd_weights(self.opt, new_emb), ids,
                                self.g2l, self.group)
        return {"hot_w": torch.where(refresh, slab, cache["hot_w"]), "hot_ids": ids,
                "hot_pos": hot_positions(self.layout.spec.total_rows, ids), "tick": tick}


def step_cache(cfg, layout: se.ShardedEmbeddingLayout, opt, cache: dict, new_emb: dict,
               group: comm.Group | None = None) -> dict:
    """One step of the cache (the reference's ``step_cache``), with an
    epilogue made for this call; the train step keeps one
    :class:`CacheEpilogue`."""
    group = comm.local_group() if group is None else group
    return CacheEpilogue(cfg, layout, opt, group, cache["tick"].device)(cache, new_emb)
