"""The training driver's fault-tolerance primitives."""

from repro_torch.runtime.fault import (PreemptionHandler, StepMonitor,
                                       elastic_reshard)

__all__ = ["StepMonitor", "PreemptionHandler", "elastic_reshard"]
