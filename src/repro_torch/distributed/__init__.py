"""Fault tolerance for the trainer (the straggler watchdog and the failure
injector); elastic remesh and multi-device training wait."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FailureInjector,
    SimulatedFailure,
    Watchdog,
)
