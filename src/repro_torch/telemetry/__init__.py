"""Telemetry the serving and train loops need: the latency histogram and the
span tracer (stdlib only, copies of the reference's)."""

from repro_torch.telemetry.hist import LatencyHistogram
from repro_torch.telemetry.tracer import (Tracer, configure, get_tracer, instant, set_track,
                                          span)

__all__ = ["LatencyHistogram", "Tracer", "configure", "get_tracer", "instant", "set_track",
           "span"]
