from repro_torch.ft.failures import (CRASH_KINDS, DEGRADATION_KINDS,
                                     DIRECTIONS, KINDS, Degradation,
                                     InjectedFailure, jitter_phase)

__all__ = ["CRASH_KINDS", "DEGRADATION_KINDS", "DIRECTIONS", "KINDS",
           "Degradation", "InjectedFailure", "jitter_phase"]
