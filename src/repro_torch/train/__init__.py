"""The fault-tolerant train loop (twin of ``repro/train``)."""

from repro_torch.train.loop import (DataRebalancer, StragglerMonitor, TrainLoop, TrainLoopConfig,
                                    prefetch_to_device)

__all__ = ["DataRebalancer", "StragglerMonitor", "TrainLoop", "TrainLoopConfig",
           "prefetch_to_device"]
