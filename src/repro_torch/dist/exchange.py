"""The configuration of the hybrid step's collectives (twin of
``repro/dist/exchange.py``).

:class:`ExchangeConfig` holds the index exchange's lowering, the wire
format of the cotangent exchange and of the dense reduce-scatter, the dense
error feedback and the Split-SGD bucketing; :func:`resolve_exchange` reads
it from a config, as the reference does.  The port runs the ``"fp32"``
wire, the reference's default (in row mode the forward reduce-scatter and
the cotangent all-gather carry bf16 all the same, as the reference's do),
and the ``"fused"`` index exchange.  The ``"bf16"`` and ``"bf16_sr"`` wires,
the ``"ring"`` exchange and the dense error feedback are refused with
:class:`NotImplementedError` (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import dataclasses

WIRE_DTYPES = ("fp32", "bf16", "bf16_sr")
EXCHANGE_IMPLS = ("fused", "ring")
# bytes per element each wire format moves
WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "bf16_sr": 2}

# the stream bases of the two wire-dither tag namespaces (the cotangent
# exchange tags its payloads by microbatch, the dense reduce-scatter by bucket)
TAG_DY = 0xDE100000
TAG_DENSE = 0xD5E00000

_LATER = "ROADMAP queue 1 item 4"


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

    def check_ported(self) -> "ExchangeConfig":
        """``self``, or :class:`NotImplementedError` for what the port does
        not run yet."""
        if self.impl != "fused":
            raise NotImplementedError(f"exchange_impl {self.impl!r}: the port runs the 'fused' "
                                      f"index exchange ({_LATER})")
        for field, v in (("dY_dtype", self.dY_dtype), ("dense_dtype", self.dense_dtype)):
            if v != "fp32":
                raise NotImplementedError(f"{field} {v!r}: the port runs the 'fp32' wire "
                                          f"({_LATER})")
        return self


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
