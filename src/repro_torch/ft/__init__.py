from repro_torch.ft.failures import (CRASH_KINDS, DEGRADATION_KINDS,
                                     DIRECTIONS, KINDS, Degradation,
                                     FailureInjector, FailureModel,
                                     InjectedFailure, jitter_phase)
from repro_torch.ft.detector import HeartbeatDetector
from repro_torch.ft.elastic import (RecoveryPlan, RescalePlan, plan_recovery,
                                    plan_rescale)
from repro_torch.ft.straggler import StragglerDetector

__all__ = [
    "CRASH_KINDS", "DEGRADATION_KINDS", "DIRECTIONS", "KINDS",
    "Degradation", "FailureModel", "FailureInjector", "InjectedFailure",
    "jitter_phase", "HeartbeatDetector", "plan_recovery", "plan_rescale",
    "RecoveryPlan", "RescalePlan", "StragglerDetector",
]
