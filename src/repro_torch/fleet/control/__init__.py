"""Closed-loop autonomous control: drift-triggered re-scope, warm re-tune,
and mid-trace policy hot-swap over one continuous simulated trace."""
from repro_torch.fleet.control.loop import (ClosedLoopController, ControlEvent,
                                            ControlResult)
from repro_torch.fleet.control.scenario import (DriftCase,
                                                service_degradation_case,
                                                tail_workload)

__all__ = [
    "ClosedLoopController", "ControlEvent", "ControlResult", "DriftCase",
    "service_degradation_case", "tail_workload",
]
