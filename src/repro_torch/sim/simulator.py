"""Discrete-event (1s-tick) simulator of a checkpointed streaming job.

Models exactly the dynamics the paper measures:
  * variable arrival rate λ(t) from a recording or schedule;
  * service capacity μ with checkpoint overhead (sync pause or async tax);
  * consumer lag queueing and end-to-end latency ≈ base + lag/μ;
  * failures: detect (heartbeat timeout) → restart → restore → offset
    rollback to the last *completed* checkpoint → catch-up at full rate
    while arrivals continue — recovery ends when the job produces results
    at the latest offset again (lag back to steady state);
  * controlled reconfiguration (savepoint + restart, no offset rollback).

The checkpoint plane is a full ``CheckpointPlan``: each trigger writes the
levels due at that trigger (memory/local/remote, full or delta per the
plan's cadences — the same routing ``CheckpointManager`` executes) with
per-kind durations from the cost model, offsets are tracked per level, and
a failure rolls back to the newest offset on a level that *survives its
kind* — so an incremental or multi-level plan prices differently from the
full-sync baseline, which is exactly what the plan optimizer searches over.

The same engine backs Phase-2 profiling deployments (``SimDeployment``),
the paper's static-CI baselines and the Khaos-controlled runs (via
``SimJobHandle`` which implements core.controller.JobHandle).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.policy import CheckpointPolicy
from repro_torch.config import CheckpointPlan
from repro_torch.core.anomaly import AnomalyDetector
from repro_torch.data.stream import RateSchedule, WorkloadRecording, dense_rates
from repro_torch.ft.failures import (CRASH_KINDS, Degradation, FailureInjector,
                                     jitter_phase)
from repro_torch.metrics import MetricsStore
from repro_torch.sim.costmodel import SimCostModel, levels_due

_LEVEL_SPEED = {"memory": 2, "local": 1, "remote": 0}
_RATE_CHUNK = 4096    # ticks of λ(t) precomputed per refill (see rates_until)


@dataclass
class FailureEvent:
    t: float
    kind: str = "node"


class StreamSimulator:
    def __init__(self, cost: SimCostModel, ci_s: float,
                 recording: Optional[WorkloadRecording] = None,
                 schedule: Optional[RateSchedule] = None,
                 t0: float = 0.0, seed: int = 0,
                 flink_semantics: bool = True,
                 plan: Optional[CheckpointPlan] = None):
        assert recording is not None or schedule is not None
        self.cost = cost
        self.recording = recording
        self.schedule = schedule
        # the mechanism half of the plan; ci_s remains the cadence knob
        self.plan = replace(plan or CheckpointPlan(sync=not cost.async_mode),
                            interval_s=ci_s)
        self.policy = CheckpointPolicy(ci_s)
        self.policy.reset(t0)
        self.flink_semantics = flink_semantics
        self.t = t0
        self.metrics = MetricsStore()
        self.lag = 0.0
        self.produced = 0.0
        self.consumed = 0.0
        # checkpoint machinery: per-level completed offsets + one in-flight
        # composite write (end_t, offset, levels written this trigger)
        self.ckpt_in_progress: Optional[tuple[float, float, tuple]] = None
        self.offset_by_level: dict[str, float] = {l: 0.0 for l in self.plan.levels}
        self.last_ckpt_offset = 0.0
        self.last_ckpt_completed_t = t0
        self.ckpt_count = 0
        self.save_count = 0            # trigger index (drives level cadences)
        # failure machinery
        self.down_until: Optional[float] = None
        self.pending_restore_offset: Optional[float] = None
        self.failures: list[FailureEvent] = []
        self.recoveries: list[dict] = []
        self._active_failure: Optional[dict] = None
        self._steady_lag = 0.0
        # gray-failure machinery (ft.failures.DEGRADATION_KINDS): pending
        # windows plus the active-window state each kind bends —
        # capacity scale (straggler), barrier-write penalty (net_delay
        # to_ckpt_store), latency penalty (net_delay to_source), trigger
        # suppression (backpressure).  The batched engine mirrors every
        # field as a per-lane array with identical update order.
        self.degradations: list[Degradation] = []
        self.dg_cap_scale = 1.0
        self.dg_cap_until = -np.inf
        self.dg_ck_delay = 0.0
        self.dg_ck_jitter = 0.0
        self.dg_ck_t0 = 0.0
        self.dg_ck_until = -np.inf
        self.dg_lat_delay = 0.0
        self.dg_lat_jitter = 0.0
        self.dg_lat_t0 = 0.0
        self.dg_lat_until = -np.inf
        self.dg_bp_until = -np.inf
        self.bp_suppressed = 0     # triggers delayed past their cadence slot
        # dense λ(t) buffer: the tick loop reads an array slot instead of
        # paying a Python call per tick (recordings resolve vectorized)
        self._rate_buf: Optional[np.ndarray] = None
        self._rate_idx = 0

    # ------------------------------------------------------------------
    def rate_at(self, t: float) -> float:
        if self.recording is not None:
            return self.recording.rate_at(t)
        return self.schedule(t)

    def rates_until(self, t_end: float) -> np.ndarray:
        """Dense per-tick λ array for [self.t, t_end) — the precomputed form
        both this simulator's tick loop and the batched engine consume."""
        n = max(0, int(np.ceil(t_end - self.t)))
        return dense_rates(self.t, n, self.recording, self.schedule)

    def _next_rate(self) -> float:
        """λ at the current tick, from the dense buffer (refilled in
        ``_RATE_CHUNK``-tick blocks).  The buffer's time grid is exactly the
        tick clock (t advances by exact +1.0 steps), so values match
        per-tick ``rate_at`` calls bit-for-bit."""
        if self._rate_buf is None or self._rate_idx >= len(self._rate_buf):
            self._rate_buf = dense_rates(self.t, _RATE_CHUNK,
                                         self.recording, self.schedule)
            self._rate_idx = 0
        lam = float(self._rate_buf[self._rate_idx])
        self._rate_idx += 1
        return lam

    def inject_failure(self, t: float, kind: str = "node") -> None:
        if kind not in CRASH_KINDS:
            raise ValueError(f"unknown crash kind {kind!r}; expected one of "
                             f"{CRASH_KINDS} (use inject_degradation for "
                             f"gray failures)")
        self.failures.append(FailureEvent(t, kind))
        self.failures.sort(key=lambda f: f.t)

    def inject_degradation(self, t: float, kind: str, duration_s: float,
                           severity: float = 0.0, jitter_s: float = 0.0,
                           direction: str = "to_source") -> None:
        """Schedule a gray-failure window (validated by ``Degradation``)."""
        self.degradations.append(Degradation(
            t=t, kind=kind, duration_s=duration_s, severity=severity,
            jitter_s=jitter_s, direction=direction))
        self.degradations.sort(key=lambda d: d.t)

    def set_ci(self, ci_s: float) -> None:
        """Hot CI change (hot-swap semantics) or controlled restart
        (Flink)."""
        self.policy.set_interval(ci_s, self.t)
        self.plan = replace(self.plan, interval_s=ci_s)
        if self.flink_semantics:
            # savepoint immediately, restart; no offset rollback
            self.ckpt_in_progress = None
            self.last_ckpt_offset = self.consumed
            self.offset_by_level = {l: self.consumed for l in self.plan.levels}
            self.last_ckpt_completed_t = self.t
            self.down_until = self.t + self.cost.reconfig_restart_s
            self.pending_restore_offset = self.consumed  # savepoint: nothing lost

    def set_plan(self, plan: CheckpointPlan) -> None:
        """Controlled mechanism switch (savepoint + restart under Flink
        semantics): the Khaos actuation when the optimizer changes the
        checkpoint *mode*, not just the interval."""
        old_offsets = self.offset_by_level
        self.ckpt_in_progress = None   # in-flight write dies with the switch
        self.plan = plan
        self.offset_by_level = {l: old_offsets.get(l, 0.0) for l in plan.levels}
        self.save_count = 0
        self.set_ci(plan.interval_s)

    # ------------------------------------------------------------------
    def tick(self) -> dict:
        """Advance one second; returns the metrics sample emitted."""
        t = self.t
        lam = self._next_rate()
        self.produced += lam
        cost = self.cost

        # pending failures
        while self.failures and self.failures[0].t <= t:
            ev = self.failures.pop(0)
            self._begin_failure(ev)
        # pending gray-failure windows
        while self.degradations and self.degradations[0].t <= t:
            self._begin_degradation(self.degradations.pop(0))

        if self.down_until is not None:
            # job down: arrivals accumulate, nothing processed
            self.lag += lam
            if t >= self.down_until:
                # restart completes: roll back to checkpointed offset
                ro = self.pending_restore_offset
                if ro is not None and ro < self.consumed:
                    self.lag += self.consumed - ro    # events to reprocess
                    self.consumed = ro
                self.down_until = None
                self.pending_restore_offset = None
                self.policy.reset(t)
            mu = 0.0
            processed = 0.0
        else:
            checkpointing = False
            # checkpoint completion: commit the offset at every level the
            # trigger wrote
            if self.ckpt_in_progress is not None:
                end_t, offset, levels = self.ckpt_in_progress
                if t >= end_t:
                    for level in levels:
                        self.offset_by_level[level] = offset
                    self.last_ckpt_offset = max(self.last_ckpt_offset, offset)
                    self.last_ckpt_completed_t = t
                    self.ckpt_in_progress = None
                    self.ckpt_count += 1
                else:
                    checkpointing = True
            # checkpoint start: the levels due at this trigger index define
            # the composite write's duration (full vs delta, per level)
            if self.ckpt_in_progress is None and self.policy.due(t):
                if t < self.dg_bp_until:
                    # backpressured source: the barrier cannot propagate,
                    # the trigger slips past its cadence slot — lost work
                    # at the next crash grows with the slip
                    self.bp_suppressed += 1
                else:
                    self.policy.mark(t)
                    due = levels_due(self.plan, self.save_count)
                    duration = max(cost.trigger_write_duration(
                        self.plan, self.save_count), 1e-3)
                    if t < self.dg_ck_until:
                        # to-checkpoint-store net delay under the barrier
                        duration = duration + cost.net_delay_barrier_penalty(
                            self.dg_ck_delay, self.dg_ck_jitter,
                            jitter_phase(t, self.dg_ck_t0))
                    self.save_count += 1
                    # barrier semantics: snapshot the offset at start
                    self.ckpt_in_progress = (t + duration, self.consumed,
                                             tuple(l for l, _ in due))
                    checkpointing = True
            if t >= self.dg_cap_until:
                self.dg_cap_scale = 1.0    # straggler window expired
            mu = cost.effective_capacity(checkpointing, sync=self.plan.sync) \
                * self.dg_cap_scale
            processed = min(self.lag + lam, mu)
            self.lag = max(0.0, self.lag + lam - processed)
            self.consumed += processed

        steady_mu = cost.capacity_eps
        latency = cost.base_latency_s + self.lag / max(steady_mu, 1e-9)
        if t < self.dg_lat_until:
            # to-source net delay sits on the source->job path: end-to-end
            # latency inflates, lag does not (arrivals are offset-stamped)
            latency = latency + cost.net_delay_latency_penalty(
                self.dg_lat_delay, self.dg_lat_jitter,
                jitter_phase(t, self.dg_lat_t0))
        self.metrics.record("throughput", t, processed)
        self.metrics.record("consumer_lag", t, self.lag)
        self.metrics.record("latency", t, latency)
        self.metrics.record("arrival_rate", t, lam)

        # recovery bookkeeping (ground truth: caught up == lag back to steady)
        if self._active_failure is not None and self.down_until is None:
            near_steady = self.lag <= max(2.0 * lam, 1.05 * self._steady_lag + 1.0)
            if near_steady:
                self._active_failure["t_end"] = t
                self._active_failure["recovery_s"] = t - self._active_failure["t_start"]
                self.recoveries.append(self._active_failure)
                self._active_failure = None
        elif self._active_failure is None and self.down_until is None:
            self._steady_lag = 0.9 * self._steady_lag + 0.1 * self.lag

        self.t += 1.0
        return {"t": t, "throughput": processed, "consumer_lag": self.lag,
                "latency": latency, "arrival_rate": lam}

    def _begin_degradation(self, d: Degradation) -> None:
        """Activate one gray-failure window.  Overlapping windows of the
        same kind: the newest wins (last-writer semantics, mirrored by the
        batched engine's vectorized activation)."""
        until = d.t + d.duration_s
        if d.kind == "straggler":
            self.dg_cap_scale = self.cost.straggler_capacity_scale(d.severity)
            self.dg_cap_until = until
        elif d.kind == "net_delay":
            if d.direction == "to_ckpt_store":
                self.dg_ck_delay = d.severity
                self.dg_ck_jitter = d.jitter_s
                self.dg_ck_t0 = d.t
                self.dg_ck_until = until
            else:
                self.dg_lat_delay = d.severity
                self.dg_lat_jitter = d.jitter_s
                self.dg_lat_t0 = d.t
                self.dg_lat_until = until
        else:   # backpressure
            self.dg_bp_until = until

    def _begin_failure(self, ev: FailureEvent) -> None:
        if self.down_until is not None:
            return   # already down
        self.ckpt_in_progress = None   # in-flight checkpoint dies with the job
        # roll back to the newest offset on a level that survives this
        # failure kind (ties: fastest level restores)
        surviving = self.cost.surviving_levels(self.plan, ev.kind)
        candidates = [(self.offset_by_level[l], _LEVEL_SPEED[l], l)
                      for l in surviving]
        if candidates:
            offset, _, level = max(candidates)
            # restore_duration_for folds in the delta-apply term and the
            # degraded-partial path (node failure + replicated level-2)
            restore_s = self.cost.restore_duration_for(self.plan, ev.kind,
                                                       level)
        else:
            # nothing survives: cold restart, reprocess everything
            offset, level = 0.0, None
            restore_s = self.cost.restore_duration("remote")
        # the failure destroys the levels it doesn't survive at — derived
        # from the plan's replication factor (an un-replicated plan loses
        # its local level to a node failure)
        for wiped in self.cost.wiped_levels(self.plan, ev.kind):
            if wiped in self.offset_by_level:
                self.offset_by_level[wiped] = 0.0
        self.down_until = ev.t + self.cost.detect_s + self.cost.restart_s \
            + restore_s
        self.pending_restore_offset = offset
        self._active_failure = {"t_start": ev.t, "kind": ev.kind,
                                "ci": self.policy.interval_s,
                                "restore_level": level,
                                "plan": self.plan.name}

    def run_until(self, t_end: float,
                  on_tick: Optional[Callable[[dict], None]] = None) -> None:
        while self.t < t_end:
            sample = self.tick()
            if on_tick:
                on_tick(sample)


# ---------------------------------------------------------------------------
# Phase-2 profiling deployment (implements core.profiler.Deployment)
# ---------------------------------------------------------------------------

class SimDeployment:
    """One short-lived profiling pipeline with a fixed CI.

    Replays the recording around each failure point (the paper's margin
    optimization) and measures recovery with the online-ARIMA anomaly
    detector trained on the pre-failure (positive) window.
    """

    def __init__(self, ci_s: float, recording: WorkloadRecording,
                 cost: SimCostModel, warmup_s: float = 300.0,
                 max_recovery_s: float = 7200.0):
        self.ci_s = ci_s
        self.recording = recording
        self.cost = cost
        self.warmup_s = warmup_s
        self.max_recovery_s = max_recovery_s
        self.injector = FailureInjector()

    def profile_failure(self, failure_time: float, margin: float) -> tuple[float, float]:
        """Recovery per the paper's availability definition (§III-C): from
        the failure instant until the job is producing results at the
        latest offset again.  The primary signal is CONSUMER LAG returning
        to its pre-failure envelope — directly observable at the messaging
        queue, exactly what the paper's detector watches; the online-ARIMA
        detector runs alongside and its interval is kept as a secondary
        measurement (core/anomaly.py has its own tests)."""
        t0 = max(float(self.recording.times[0]),
                 failure_time - margin - self.warmup_s)
        sim = StreamSimulator(self.cost, self.ci_s, recording=self.recording, t0=t0)
        det = AnomalyDetector()
        # worst case: just before the next checkpoint completes (§III-C)
        inject_t = self.injector.worst_case_time(
            failure_time, t0, self.ci_s, self.cost.ckpt_duration_s)
        sim.inject_failure(inject_t)

        lat_samples: list[float] = []
        lag_samples: list[float] = []
        recovery = [None]
        steady = [None]

        def on_tick(s):
            in_failure = inject_t <= s["t"] and recovery[0] is None
            det.observe(s["t"], {"throughput": s["throughput"],
                                 "consumer_lag": s["consumer_lag"]},
                        learn=not in_failure)
            if inject_t - margin <= s["t"] < inject_t:
                lat_samples.append(s["latency"])
                lag_samples.append(s["consumer_lag"])
            if s["t"] >= inject_t and steady[0] is None:
                base = np.mean(lag_samples) if lag_samples else 0.0
                steady[0] = max(2.0 * s["arrival_rate"], 1.2 * base + 1.0)
            if in_failure and s["t"] > inject_t + self.cost.detect_s:
                if s["consumer_lag"] <= steady[0]:
                    recovery[0] = s["t"] - inject_t

        t_end = inject_t + self.max_recovery_s
        while sim.t < t_end and recovery[0] is None:
            on_tick(sim.tick())
        if recovery[0] is None:
            recovery[0] = self.max_recovery_s
        # the paper averages over the 99th percentile to filter outliers; a
        # diverging deployment (capacity < arrival rate at this CI) would
        # otherwise poison M_L — use the median and cap.
        if lat_samples:
            avg_latency = float(min(np.median(lat_samples), 30.0))
        else:
            avg_latency = self.cost.base_latency_s
        return avg_latency, float(recovery[0])


# ---------------------------------------------------------------------------
# JobHandle adapter for the Khaos controller (Phase 3)
# ---------------------------------------------------------------------------

class SimJobHandle:
    """``core.controller.JobHandle`` over a running StreamSimulator — the
    complete protocol (including ``drain``/``reconfigure_plan``), so the
    controller and ``KhaosRuntime`` drive the sim and the live trainer
    identically."""

    def __init__(self, sim: StreamSimulator):
        self.sim = sim
        self.reconfigurations: list[tuple[float, float]] = []
        self.plan_changes: list[tuple[float, str]] = []

    def now(self) -> float:
        return self.sim.t

    def current_ci(self) -> float:
        return self.sim.policy.interval_s

    def current_plan(self) -> CheckpointPlan:
        return self.sim.plan

    def avg_latency(self, window_s: float) -> float:
        return self.sim.metrics.series("latency").mean_over(
            self.sim.t - window_s, self.sim.t)

    def avg_throughput(self, window_s: float) -> float:
        return self.sim.metrics.series("arrival_rate").mean_over(
            self.sim.t - window_s, self.sim.t)

    def healthy(self) -> bool:
        return self.sim.down_until is None and self.sim._active_failure is None

    def drain(self) -> None:
        """No-op by design: the simulator's reconfigure path IS a drain —
        under flink semantics ``set_ci``/``set_plan`` take a savepoint
        (checkpoint-now, no offset rollback) before restarting."""

    def reconfigure(self, new_ci: float) -> None:
        self.reconfigurations.append((self.sim.t, new_ci))
        self.sim.set_ci(new_ci)

    def reconfigure_plan(self, plan: CheckpointPlan) -> None:
        """Mechanism switch: one controlled restart applies mode + CI."""
        self.reconfigurations.append((self.sim.t, plan.interval_s))
        self.plan_changes.append((self.sim.t, plan.name))
        self.sim.set_plan(plan)
