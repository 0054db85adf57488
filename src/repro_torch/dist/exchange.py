"""The configuration of the hybrid step's collectives (twin of
``repro/dist/exchange.py``).

:class:`ExchangeConfig` holds the index exchange's lowering, the wire
format of the cotangent exchange and of the dense reduce-scatter, the dense
error feedback and the Split-SGD bucketing; :func:`resolve_exchange` reads
it from a config, as the reference does.

Wire formats (``dY_dtype`` for the cotangent exchange, ``dense_dtype`` for
the dense reduce-scatter):

``"fp32"``
    The default.  In row mode the forward reduce-scatter and the cotangent
    all-gather carry bf16 all the same, as the reference's do.
``"bf16"``
    Rounded to nearest: halves table mode's cotangent all-to-all (and its
    replica all-gather) and the dense reduce-scatter.  On the dense path
    each rank's fp32 residual of its own slice is carried to the next step
    in the ``err`` slab (``error_feedback``).
``"bf16_sr"``
    Rounded stochastically under a counter-based dither of ``(sr, tag,
    element)`` (``optim.stochastic.wire_noise``), the tag from
    :func:`wire_tag`: every rank computes the same bits for a payload, and
    a run resumed from a checkpoint replays them.

A value bf16 holds exactly (zero too) passes every wire unchanged.  The
index exchange is one all-gather (``"fused"``) or a ring of point-to-point
shifts a mesh axis (``"ring"``, ``core.pipeline.ring_all_gather``), with
the same result bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim import stochastic

WIRE_DTYPES = ("fp32", "bf16", "bf16_sr")
EXCHANGE_IMPLS = ("fused", "ring")
# bytes per element each wire format moves
WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "bf16_sr": 2}

# the stream bases of the two wire-dither tag namespaces (the cotangent
# exchange tags its payloads by microbatch, the dense reduce-scatter by bucket)
TAG_DY = 0xDE100000
TAG_DENSE = 0xD5E00000


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """The reference's ``ExchangeConfig``: ``impl`` the index exchange's
    lowering, ``dY_dtype`` / ``dense_dtype`` the wire formats of the
    cotangent exchange and of the dense reduce-scatter, ``error_feedback``
    the dense ``"bf16"`` wire's residual, ``num_buckets`` the Split-SGD
    bucketing of the flat dense gradient."""

    impl: str = "fused"
    dY_dtype: str = "fp32"
    dense_dtype: str = "fp32"
    error_feedback: bool = True
    num_buckets: int = 4

    def __post_init__(self):
        if self.impl not in EXCHANGE_IMPLS:
            raise ValueError(f"unknown exchange_impl {self.impl!r}; expected 'fused' "
                             "(one all_gather) or 'ring' (ppermute-chunked)")
        for field, v in (("dY_dtype", self.dY_dtype), ("dense_dtype", self.dense_dtype)):
            if v not in WIRE_DTYPES:
                raise ValueError(f"unknown {field} {v!r}; expected one of {WIRE_DTYPES}")
        if self.num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, got {self.num_buckets}")

    @property
    def needs_sr(self) -> bool:
        """Whether a wire format reads the per-step ``sr`` seed."""
        return "bf16_sr" in (self.dY_dtype, self.dense_dtype)

    @property
    def needs_err(self) -> bool:
        """Whether the dense state carries the error-feedback ``err`` slab."""
        return self.dense_dtype == "bf16" and self.error_feedback


def resolve_exchange(cfg) -> ExchangeConfig:
    """The one reader of a config's collective settings: a typed
    ``exchange=ExchangeConfig(...)``, or else ``exchange_dtype`` setting both
    wire formats (``"fp32"`` when unset), as the reference reads them; not
    both."""
    typed = getattr(cfg, "exchange", None)
    sugar = getattr(cfg, "exchange_dtype", None)
    if typed is not None:
        if not isinstance(typed, ExchangeConfig):
            raise TypeError(f"exchange must be an ExchangeConfig, got {type(typed).__name__}")
        if sugar is not None:
            raise ValueError("pass either exchange=ExchangeConfig(...) or exchange_dtype, not "
                             "both")
        return typed
    wire = sugar if sugar is not None else "fp32"
    return ExchangeConfig(dY_dtype=wire, dense_dtype=wire)


def wire_tag(base: int, site: int, rank: int) -> int:
    """The uint32 stream tag of one wire payload: the stream base
    (:data:`TAG_DY` / :data:`TAG_DENSE`), the site within the step
    (microbatch or bucket) and the sender's rank, as the reference mixes
    them (``repro/dist/exchange.py::wire_tag``)."""
    return (base ^ ((site * 0x9E3779B1) & 0xFFFFFFFF) ^ ((rank * 0x85EBCA6B) & 0xFFFFFFFF)) \
        & 0xFFFFFFFF


def wire_encode(x: torch.Tensor, dtype: str, seed=None, tag: int = 0) -> torch.Tensor:
    """fp32 -> the payload of wire ``dtype``: ``"fp32"`` as it is, ``"bf16"``
    rounded to nearest, ``"bf16_sr"`` rounded under the dither of ``seed``
    (the state's ``sr``; None: 0) and ``tag`` (:func:`wire_tag`)."""
    if dtype == "fp32":
        return x
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype != "bf16_sr":
        raise ValueError(f"unknown wire dtype {dtype!r}; expected one of {WIRE_DTYPES}")
    return stochastic.sr_round_bf16_wire(x, 0 if seed is None else seed, tag)


def wire_decode(x: torch.Tensor) -> torch.Tensor:
    """A wire payload -> fp32 (bf16 widens exactly)."""
    return x.float()
