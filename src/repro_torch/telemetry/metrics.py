"""In-graph step metrics (twin of ``repro/telemetry/metrics.py``): a
replicated fp32 vector in the train state, which the step adds to on the
device and the host reads every ``metrics_every`` steps, one device -> host
copy a window (:func:`drain`) and no sync between.

Slots (cumulative since the state was made):

====================  ======================================================
``steps``             steps added
``hit_lookups``       lookups served from the hot-row mirror (the bypass)
``skipped_bags``      bags served from the mirror alone: they shipped no
                      all-to-all payload
``bags``              bags (batch x slots)
``rows_touched``      lookups of an in-range id, duplicates included: the
                      forward's row traffic
``exchange_payload_bytes``  the forward all-to-all's effective payload,
                      ``(bags - skipped_bags) * E * 4``
====================  ======================================================

The vector is invisible to training: its counts read the index stream and
the hot set, and write only its own slot; with ``step_metrics=False`` the
state has no ``metrics`` and the step adds nothing.  ``hit_rate`` of a
drain is ``skipped_bags / bags`` in fp32, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

METRIC_NAMES = (
    "steps",
    "hit_lookups",
    "skipped_bags",
    "bags",
    "rows_touched",
    "exchange_payload_bytes",
)
NUM_METRICS = len(METRIC_NAMES)


def metrics_struct() -> tuple:
    return (NUM_METRICS,), torch.float32


def init_metrics(device="cuda") -> torch.Tensor:
    return torch.zeros((NUM_METRICS,), dtype=torch.float32, device=device)


def pack(device=None, **slots) -> torch.Tensor:
    """The metrics vector from named slot values (0-d tensors or numbers;
    an unnamed slot is 0), on ``device`` (None: the first tensor's, or the
    card).  Numbers are filled in on the device, so nothing is copied from
    the host."""
    vals = [slots.pop(name, 0.0) for name in METRIC_NAMES]
    if slots:
        raise ValueError(f"unknown metric slots {sorted(slots)}; have {METRIC_NAMES}")
    if device is None:
        device = next((v.device for v in vals if isinstance(v, torch.Tensor)), "cuda")
    return torch.stack([v.to(device=device, dtype=torch.float32).reshape(())
                        if isinstance(v, torch.Tensor)
                        else torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in vals])


def slot_caps(layout) -> np.ndarray:
    """Each original slot's table rows [S] int32: an id in [0, cap) is valid."""
    return np.asarray(layout.spec.table_rows, np.int32)[np.asarray(layout.slot_to_table)]


def padded_caps(layout) -> np.ndarray:
    """Each padded slot's table rows [num_padded_slots] int32 (0 for a dummy)."""
    ps = np.asarray(layout.padded_slots)
    s2t = np.asarray(layout.slot_to_table)
    return np.where(ps >= 0, np.asarray(layout.spec.table_rows, np.int64)[s2t[np.clip(ps, 0, None)]],
                    0).astype(np.int32)


def valid_lookups(layout, idx: torch.Tensor, caps: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 count of in-range lookups in an original-slot block [..., S, P]:
    the step's row traffic.  ``caps``: :func:`slot_caps` on idx's device."""
    if caps is None:
        caps = torch.as_tensor(slot_caps(layout), device=idx.device)
    ok = (idx >= 0) & (idx < caps[:, None])
    return ok.sum(dtype=torch.float32)


def valid_lookups_padded(layout, idx_local: torch.Tensor, model_index: int,
                         caps: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 count of in-range lookups in this model shard's padded-slot block
    [b, slots_per_shard, P] (the replicated loader's layout; a dummy slot
    counts nothing).  ``caps``: :func:`padded_caps` on idx's device."""
    if caps is None:
        caps = torch.as_tensor(padded_caps(layout), device=idx_local.device)
    K = layout.slots_per_shard
    cap = caps[model_index * K:(model_index + 1) * K]
    ok = (idx_local >= 0) & (idx_local < cap[:, None])
    return ok.sum(dtype=torch.float32)


def cache_hit_counts(layout, hot_pos: torch.Tensor, idx: torch.Tensor,
                     offsets: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit_lookups, hit_bags) fp32 of an original-slot block [b, S, P], by
    ``core.cache.hot_bag_local``'s test: a lookup hits when its gid is in
    the hot set; a bag when all its lookups do."""
    from repro_torch.core.cache import hot_lookups
    if offsets is None:
        offsets = torch.as_tensor(layout.spec.row_offsets[layout.slot_to_table],
                                  dtype=torch.int32, device=idx.device)
    _, lk_hit = hot_lookups(layout, hot_pos, idx, offsets)
    return lk_hit.sum(dtype=torch.float32), lk_hit.all(dim=2).sum(dtype=torch.float32)


def drain(state) -> dict | None:
    """The cumulative metrics as name -> float (one device -> host copy);
    None when the state carries no metrics vector."""
    m = state.get("metrics") if isinstance(state, dict) else None
    if m is None:
        return None
    vals = m.detach().to("cpu").numpy().astype(np.float32) if isinstance(m, torch.Tensor) \
        else np.asarray(m, np.float32)
    return {name: float(vals[i]) for i, name in enumerate(METRIC_NAMES)}


def window(cur: dict, prev: dict | None) -> dict:
    """The deltas between two drains (``prev`` None: since the start)."""
    if prev is None:
        return dict(cur)
    return {k: cur[k] - prev.get(k, 0.0) for k in cur}


def hit_rate(m: dict) -> float:
    """``skipped_bags / bags`` in fp32, one fp32 division, as the
    reference's (equal to the mean of the hit mask whenever ``bags`` is a
    power of two)."""
    bags = np.float32(m.get("bags", 0.0))
    if bags == 0:
        return 0.0
    return float(np.float32(m.get("skipped_bags", 0.0)) / bags)


def emit(tracer, m: dict, name: str = "repro.metrics") -> None:
    """A drained metrics dict as a counter event of ``tracer`` (the
    summary reads these back; cumulative values, one a drain).  The name
    is the reference's, so either package's summary reads either's trace."""
    tracer.counter(name, m)
