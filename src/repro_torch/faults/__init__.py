"""Deterministic fault injection and the structured failure-event log
(twin of ``repro/faults``): the hook points that the checkpoint manager, the
loader worker and the train loop fire, and the log their recovery actions
write to."""

from repro_torch.faults.log import FailureLog
from repro_torch.faults.plan import (CKPT_SITES, NO_FAULTS, SITES, Fault, FaultPlan, InjectedCrash,
                                     corrupt_checkpoint)

__all__ = ["CKPT_SITES", "NO_FAULTS", "SITES", "FailureLog", "Fault", "FaultPlan", "InjectedCrash",
           "corrupt_checkpoint"]
