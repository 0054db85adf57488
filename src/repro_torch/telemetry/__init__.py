"""Telemetry the serving and train loops need: the latency histogram and the
span tracer (stdlib only, copies of the reference's).  The pieces that need
torch sit in their submodules, imported where used:

* :mod:`repro_torch.telemetry.metrics`: the in-graph step metrics vector;
* :mod:`repro_torch.telemetry.stages`: the train step's stages timed one by
  one, with their modelled bytes and flops;
* :mod:`repro_torch.telemetry.summarize`: a trace's summary, also
  ``python -m repro_torch.telemetry summarize <trace.json>``.
"""

from repro_torch.telemetry.hist import LatencyHistogram
from repro_torch.telemetry.tracer import (Tracer, configure, counter, get_tracer, instant,
                                          set_track, span)

__all__ = ["LatencyHistogram", "Tracer", "configure", "counter", "get_tracer", "instant",
           "set_track", "span"]
