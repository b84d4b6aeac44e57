"""Phase 2 — experimentation & profiling (paper §III-C).

``z`` short-lived deployments (one per candidate CI) replay the recorded
workload; at each of the ``m`` failure points a failure is injected at the
WORST CASE instant — just before the next checkpoint completes — and the
recovery time is measured from the consumer-lag envelope (the online-ARIMA
detector runs alongside on the scalar path as a secondary measurement).
The average latency is sampled just before each injection.

The port profiles on the sequential substrate: one ``Deployment``
(``sim.SimDeployment``) per CI, point by point, via ``run_profiling``.
The JAX package's batched campaign (``run_profiling_campaign`` over
``sim.BatchedDeployment``, the whole grid as lanes of one sweep) comes
with the port of ``sim/batched.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

import numpy as np

from repro_torch.core.steady_state import SteadyState


class Deployment(Protocol):
    """One profiling pipeline with a fixed checkpoint-interval config."""

    def profile_failure(self, failure_time: float, margin: float) -> tuple[float, float]:
        """Replay [failure_time - margin, failure_time + horizon] and inject a
        failure at the worst-case instant near ``failure_time``.

        Returns (avg_latency_before_failure_s, recovery_time_s).
        """
        ...


@dataclass
class ProfilingResult:
    ci_values: np.ndarray      # C  (z,)
    failure_rates: np.ndarray  # TR (m,)
    latencies: np.ndarray      # L  (m, z)
    recoveries: np.ndarray     # R  (m, z)

    def flat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(ci, tr, l, r) flattened for model fitting."""
        m, z = self.latencies.shape
        ci = np.tile(self.ci_values[None, :], (m, 1)).ravel()
        tr = np.tile(self.failure_rates[:, None], (1, z)).ravel()
        return ci, tr, self.latencies.ravel(), self.recoveries.ravel()


def run_profiling(deployment_factory: Callable[[float], Deployment],
                  steady: SteadyState, ci_values, margin: float = 90.0,
                  progress: Callable[[str], None] | None = None) -> ProfilingResult:
    ci_values = np.asarray(ci_values, np.float64)
    m = len(steady.failure_times)
    z = len(ci_values)
    L = np.zeros((m, z))
    R = np.zeros((m, z))
    for j, ci in enumerate(ci_values):
        dep = deployment_factory(float(ci))
        for i, ft in enumerate(steady.failure_times):
            lat, rec = dep.profile_failure(float(ft), margin)
            L[i, j] = lat
            R[i, j] = rec
            if progress:
                progress(f"profiled ci={ci:.0f}s fp#{i} tr={steady.failure_rates[i]:.0f}ev/s "
                         f"-> lat={lat*1e3:.0f}ms rec={rec:.0f}s")
    return ProfilingResult(ci_values, steady.failure_rates.copy(), L, R)
