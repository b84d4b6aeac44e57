"""Admission control: campaign what-if against the fleet's residual
capacity before a job is allowed in.

The fleet owns a finite processing budget (``fleet_capacity_eps``, events
per second across all supervised jobs).  Each admitted job reserves its
peak recorded rate plus headroom; a candidate is admitted only when

1. its reservation fits the residual budget, and
2. a what-if chaos campaign — the candidate's recorded workload replayed
   on a cost model capped at the residual capacity, with a worst-case
   failure injected at the recorded peak — meets the job's own QoS
   constraints (pre-failure latency <= l_const, measured recovery <=
   r_const).

(1) alone would admit a job whose bursts the residual can absorb but
whose post-failure catch-up cannot drain (recovery is where capacity
slack actually matters), so the what-if replays exactly that scenario
through a campaign (``sim.make_campaign``: the NumPy lanes, or the torch
lane engine with ``engine="device"``) + ``measure_profile_lanes`` — the
same machinery Phase 2 profiling trusts.  Infeasible candidates are rejected
outright, or queued (``queueable=True``) to retry when capacity frees up.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.config import KhaosConfig, replace
from repro_torch.data.stream import WorkloadRecording, dense_rates
from repro_torch.sim.batched import (LaneSpec, make_campaign,
                                     measure_profile_lanes)
from repro_torch.sim.costmodel import SimCostModel
from repro_torch.ft.failures import FailureInjector


@dataclass
class AdmissionDecision:
    """The supervisor's verdict on one submitted job."""
    job: str
    action: str                  # admit | admit_transfer | queue | reject
    reason: str
    reserved_eps: float          # reservation this job would take
    residual_eps: float          # fleet budget left BEFORE this job
    whatif_latency_s: float = float("nan")
    whatif_recovery_s: float = float("nan")

    @property
    def admitted(self) -> bool:
        return self.action in ("admit", "admit_transfer")


def reservation_eps(recording: WorkloadRecording,
                    headroom: float = 0.2) -> float:
    """Capacity a job reserves: recorded peak rate plus headroom."""
    return float(np.max(recording.counts)) * (1.0 + headroom)


def whatif_campaign(cost: SimCostModel, recording: WorkloadRecording,
                    cfg: KhaosConfig, residual_eps: float,
                    warmup_s: float = 120.0, margin_s: float = 60.0,
                    max_recovery_s: float = 1800.0,
                    engine: str = "numpy",
                    device=None) -> tuple[float, float]:
    """Replay the candidate on the residual capacity with a worst-case
    failure at the recorded peak; returns (pre-failure latency, measured
    recovery) — the numbers the admission gate checks against l_const /
    r_const.  One lane, a few thousand ticks: cheap relative to a wrong
    admit.  ``engine``/``device`` pick the campaign engine as
    ``make_campaign`` does (``device`` is refused with the NumPy engine)."""
    capped = replace(cost, capacity_eps=float(residual_eps))
    t_peak = float(recording.times[int(np.argmax(recording.counts))])
    t0 = max(float(recording.times[0]), t_peak - margin_s - warmup_s)
    ci = 0.5 * (cfg.ci_min + cfg.ci_max)
    inject_t = FailureInjector().worst_case_time(
        max(t_peak, t0 + margin_s), t0, ci, capped.ckpt_duration_s)
    n = int(np.ceil(inject_t + max_recovery_s - t0))
    lane = LaneSpec(rates=dense_rates(t0, n, recording=recording),
                    ci_s=ci, t0=t0, failures=((inject_t, "node"),),
                    tag={"whatif": True})
    camp = make_campaign(capped, [lane], engine=engine,
                         device=device).run()
    msr = measure_profile_lanes(camp, [inject_t], margin_s,
                                max_recovery_s)[0]
    return msr.latency_s, msr.recovery_s


def decide_admission(job: str, cost: SimCostModel,
                     recording: WorkloadRecording, cfg: KhaosConfig,
                     residual_eps: float, headroom: float = 0.2,
                     queueable: bool = False, transfer_hit: bool = False,
                     engine: str = "numpy",
                     device=None) -> AdmissionDecision:
    """The full admission gate (budget fit, then the what-if campaign)."""
    need = reservation_eps(recording, headroom)
    if need > residual_eps:
        action = "queue" if queueable else "reject"
        return AdmissionDecision(
            job, action,
            f"reservation {need:.0f} ev/s exceeds residual "
            f"{residual_eps:.0f} ev/s", need, residual_eps)
    lat, rec = whatif_campaign(cost, recording, cfg, residual_eps,
                               engine=engine, device=device)
    if lat > cfg.latency_constraint or rec > cfg.recovery_constraint:
        action = "queue" if queueable else "reject"
        return AdmissionDecision(
            job, action,
            f"what-if at residual capacity violates QoS "
            f"(latency {lat:.2f}s vs {cfg.latency_constraint:.2f}s, "
            f"recovery {rec:.0f}s vs {cfg.recovery_constraint:.0f}s)",
            need, residual_eps, lat, rec)
    return AdmissionDecision(
        job, "admit_transfer" if transfer_hit else "admit",
        "fits residual capacity; what-if meets QoS",
        need, residual_eps, lat, rec)
