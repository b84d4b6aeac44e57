"""Phase 2 — experimentation & profiling (paper §III-C).

``z`` short-lived deployments (one per candidate CI) replay the recorded
workload; at each of the ``m`` failure points a failure is injected at the
WORST CASE instant — just before the next checkpoint completes — and the
recovery time is measured from the consumer-lag envelope (the online-ARIMA
detector runs alongside on the scalar path as a secondary measurement).
The average latency is sampled just before each injection.

Two execution substrates implement the profiling contract:

* ``Deployment`` (``sim.SimDeployment``) — one pipeline per CI, profiled
  point-by-point via ``run_profiling``;
* ``CampaignDeployment`` (``sim.BatchedDeployment``) — the whole z x m
  grid as array lanes of ONE vectorized campaign, via
  ``run_profiling_campaign`` (on the NumPy lanes or, with
  ``engine="device"``, on the torch lane engine).

The paper runs deployments in parallel on Kubernetes; the batched campaign
maps those parallel VMs onto simulator lanes, so the full grid advances in
one fused sweep with the same statistics as the sequential path, which
stays as the oracle.
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


class CampaignDeployment(Protocol):
    """All z CIs x m failure points profiled in one batched sweep."""

    def profile_campaign(self, failure_times, ci_values, margin: float
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Returns ((m, z) latencies, (m, z) recoveries) for the full grid."""
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


def run_profiling_campaign(campaign: CampaignDeployment, steady: SteadyState,
                           ci_values, margin: float = 90.0,
                           progress: Callable[[str], None] | None = None
                           ) -> ProfilingResult:
    """Phase 2 in one sweep: every (CI, failure point) cell is a lane of a
    single batched campaign (``sim.BatchedDeployment``), statistics
    identical to the sequential loop above."""
    ci_values = np.asarray(ci_values, np.float64)
    L, R = campaign.profile_campaign(steady.failure_times, ci_values, margin)
    assert L.shape == (len(steady.failure_times), len(ci_values)), L.shape
    if progress:
        progress(f"campaign profiled {L.size} (ci, failure-point) lanes in "
                 f"one sweep: rec {R.min():.0f}-{R.max():.0f}s")
    return ProfilingResult(ci_values, steady.failure_rates.copy(), L, R)
