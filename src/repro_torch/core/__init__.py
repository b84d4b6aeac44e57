"""Khaos core: the paper's contribution (chaos-engineering-driven runtime
optimization of the checkpoint interval).

Phase 1  steady_state     — workload recording analysis, failure-point selection
Phase 2  profiler          — parallel profiling deployments + worst-case failure
                             injection; anomaly-detector recovery measurement
Phase 3  qos_models        — M_L / M_R multivariate regression + rescaling p
         forecast          — TSF deferral rule
         ci_optimizer      — Eq. 8 multi-objective CI selection
         controller        — the runtime optimization loop + the JobHandle
                             protocol every supervised substrate implements
         runtime           — KhaosRuntime, the phase machine sequencing
                             1 -> 2 -> 3 against any JobHandle

The control plane runs host-side (NumPy) — it supervises the PyTorch data
plane (the live trainer), exactly as the paper's controller supervises
Flink from outside the cluster.  Every module is a copy of the JAX
package's ``repro.core`` counterpart and gives the same numbers bit for
bit; the batched-campaign loop (``KhaosRuntime.drive_campaign``) waits
for the port of ``sim/batched.py``.
"""
from repro_torch.core.arima import OnlineARIMA
from repro_torch.core.anomaly import AnomalyDetector
from repro_torch.core.steady_state import select_failure_points, SteadyState
from repro_torch.core.qos_models import (QoSModel, RescalingTracker,
                                         demo_prior_models)
from repro_torch.core.forecast import WorkloadForecaster
from repro_torch.core.ci_optimizer import (optimize_ci, optimize_plan,
                                           default_plan_variants, PlanCandidate,
                                           PlanOptimization)
from repro_torch.core.controller import (Decision, JobHandle, JOB_HANDLE_METHODS,
                                         KhaosController)
from repro_torch.core.young_daly import young_daly_interval
from repro_torch.core.profiler import ProfilingResult, run_profiling
from repro_torch.core.runtime import (KhaosRuntime, PHASES, PhaseError,
                                      PhaseEvent, missing_handle_methods)

__all__ = [
    "OnlineARIMA", "AnomalyDetector", "select_failure_points", "SteadyState",
    "QoSModel", "RescalingTracker", "demo_prior_models",
    "WorkloadForecaster", "optimize_ci",
    "optimize_plan", "default_plan_variants", "PlanCandidate",
    "PlanOptimization", "Decision", "JobHandle", "JOB_HANDLE_METHODS",
    "KhaosController", "young_daly_interval",
    "run_profiling", "ProfilingResult",
    "KhaosRuntime", "missing_handle_methods",
    "PhaseError", "PhaseEvent", "PHASES",
]
