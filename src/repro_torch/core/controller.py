"""Phase 3 — the runtime optimization loop (paper §III-D).

Monitors the production job for violations of the two QoS constraints
(average end-to-end latency vs ``l_const``; predicted worst-case recovery
time vs ``r_const``), defers reconfiguration when the TSF expects the
workload to drop >10%, pre-acts when ``cfg.proactive`` is set and the TSF
forecasts a rise that would breach a constraint within the horizon
(re-optimizing at the predicted peak so the switch lands before the
load), and otherwise solves Eq. 8 for a new CI — or, when
a cost model is attached (``cost``), for a new *checkpoint plan*: the
search then spans mechanism variants (incremental encoding, async commit,
multi-level routing, and the encode placement — device variants priced as
one pack + one fused flat-kernel encode per trigger from the bench_ckpt/3
calibration) in addition to the interval, and a Decision can carry
"switch to incr8-async at CI=42s" instead of just a number.

The control-plane contract is the ``JobHandle`` protocol below: ONE
complete interface every supervised substrate implements in full —
``sim.SimJobHandle`` (scalar simulator), ``sim.BatchedLaneHandle`` (one
lane of a vectorized campaign) and ``runtime.TrainerJobHandle`` (the live
trainer).  There are no optional methods and no capability probing:
a handle that cannot switch plans on its substrate still implements
``reconfigure_plan`` (typically as drain + CI apply) so the controller
code is identical everywhere.  ``core.runtime.KhaosRuntime`` sequences
the three phases and drives this controller against any handle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.config import CheckpointPlan, KhaosConfig
from repro_torch.core.ci_optimizer import optimize_ci, optimize_plan
from repro_torch.core.forecast import WorkloadForecaster
from repro_torch.core.qos_models import QoSModel, RescalingTracker

#: every JobHandle method; the protocol-conformance test asserts each one
#: is present and callable on every registered handle implementation
JOB_HANDLE_METHODS = ("now", "current_ci", "current_plan", "avg_latency",
                      "avg_throughput", "healthy", "drain", "reconfigure",
                      "reconfigure_plan")


@runtime_checkable
class JobHandle(Protocol):
    """The controller's complete view of the supervised production job.

    This is a FULL protocol, not a base class with optional extensions:
    every method below is mandatory.  The controller never probes for
    capabilities — ``KhaosController`` calls ``current_plan`` and
    ``reconfigure_plan`` directly, and ``KhaosRuntime`` drives any handle
    through the same three-phase sequence, so the sim and the live
    trainer are interchangeable supervision targets.
    """

    def now(self) -> float:
        """The job's clock (virtual seconds for sim/trainer substrates)."""
        ...

    def current_ci(self) -> float:
        """The checkpoint interval currently in force."""
        ...

    def current_plan(self) -> CheckpointPlan:
        """The full checkpoint mechanism currently in force (its
        ``interval_s`` must agree with ``current_ci``)."""
        ...

    def avg_latency(self, window_s: float) -> float:
        """Mean end-to-end latency over the trailing window (NaN when the
        window holds no samples)."""
        ...

    def avg_throughput(self, window_s: float) -> float:
        """Mean arrival rate TR over the trailing window."""
        ...

    def healthy(self) -> bool:
        """False while the job is down or catching up after a failure —
        latency samples then reflect the failure, not the (CI, TR) -> L
        mapping, and reconfiguration would be aborted anyway (§IV-D)."""
        ...

    def drain(self) -> None:
        """Checkpoint-now barrier: persist current progress and quiesce
        in-flight commits so a reconfiguration loses nothing.  Substrates
        whose reconfigure path already takes a savepoint (the simulator's
        flink-semantics controlled restart) implement this as a no-op."""
        ...

    def reconfigure(self, new_ci: float) -> None:
        """Controlled reconfiguration of the CI knob only (drain, then
        apply the new interval; the mechanism is unchanged)."""
        ...

    def reconfigure_plan(self, plan: CheckpointPlan) -> None:
        """Controlled mechanism switch: drain, rebuild the checkpoint
        plane from ``plan`` (mode/levels/commit AND interval), resume."""
        ...


@dataclass
class Decision:
    """One optimization-cycle outcome.  ``kind`` is always a member of
    ``Decision.KINDS``:

      none         constraints satisfied (or change below actuation threshold)
      defer        TSF predicts a >10% workload drop -> wait it out
      reconfigure  actuated: ``new_ci`` (and ``new_plan`` when the
                   mechanism search is active) were applied to the job
      proactive    actuated BEFORE any breach: the TSF forecast a rate
                   rise that would violate a constraint within the
                   horizon, so the plan was re-optimized at the predicted
                   peak (``cfg.proactive`` gates this path)
      infeasible   no (CI, plan) satisfies both constraints
      cooldown     a reconfiguration happened too recently
      unhealthy    the job is down/catching up; samples were discarded
    """

    KINDS: ClassVar[tuple[str, ...]] = ("none", "defer", "reconfigure",
                                        "proactive", "infeasible",
                                        "cooldown", "unhealthy")

    t: float
    kind: str
    latency: float
    tr_avg: float
    predicted_recovery: float
    new_ci: Optional[float] = None
    new_plan: Optional[CheckpointPlan] = None

    def __post_init__(self) -> None:
        assert self.kind in self.KINDS, f"unknown Decision kind {self.kind!r}"


@dataclass
class KhaosController:
    cfg: KhaosConfig
    m_l: QoSModel
    m_r: QoSModel
    forecaster: WorkloadForecaster = None
    rescaler: RescalingTracker = None
    # mechanism optimization: attach a sim.costmodel.SimCostModel to let
    # Eq. 8 search checkpoint-plan variants, not just the CI grid
    cost: Optional[Any] = None
    plan_variants: Optional[list] = None
    mtbf_s: float = 3600.0
    decisions: list = field(default_factory=list)
    # fleet-shared decision log: when many controllers supervise many jobs
    # in one process (fleet.FleetSupervisor), every Decision is ALSO
    # appended to ``decision_log`` as ``(label, Decision)`` — one audit
    # trail across the whole fleet, in global decision order.  ``label``
    # names this controller's job in that log.  Both default off, so a
    # solo controller is unchanged.
    label: Optional[str] = None
    decision_log: Optional[list] = None
    _last_reconfig_t: float = -1e18
    _last_opt_t: float = -1e18
    # the M_L evaluation of the most recent due poll — consumers that
    # score the same (CI, TR) point (fleet divergence watchdogs) read it
    # instead of paying a second ``QoSModel.predict``
    last_pred_lat: float = float("nan")
    # error-analysis tracking (Tables II(a)/III(a))
    latency_obs: list = field(default_factory=list)    # (ci, tr, observed)
    recovery_obs: list = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.forecaster is None:
            self.forecaster = WorkloadForecaster(
                horizon=self.cfg.forecast_horizon,
                defer_drop_fraction=self.cfg.defer_drop_fraction)
        if self.rescaler is None:
            self.rescaler = RescalingTracker(k=self.cfg.rescale_history)

    # ------------------------------------------------------------------
    def record_recovery(self, ci: float, tr: float, recovery_s: float) -> None:
        """Called by the runtime when an actual failure recovery was measured."""
        self.recovery_obs.append((ci, tr, recovery_s))

    def initial_ci(self, tr_avg: float) -> Optional[float]:
        """Pick the starting CI from the freshly-fitted models (end of
        Phase 2): the Eq. 8 optimum at the recorded average throughput."""
        res = optimize_ci(self.m_l, self.m_r, tr_avg,
                          self.cfg.latency_constraint,
                          self.cfg.recovery_constraint, 1.0,
                          self.cfg.ci_min, self.cfg.ci_max)
        return res.ci if res.feasible else None

    def maybe_optimize(self, job: JobHandle,
                       shared_pred: Optional[tuple] = None
                       ) -> Optional[Decision]:
        """Run one optimization cycle if the period elapsed. Returns the
        decision made (or None if not yet due).

        ``shared_pred`` is the batched-evaluation hook used by
        ``KhaosRuntime.drive_campaign``: a pre-computed ``(pred_lat,
        pred_rec)`` pair for this job's current (CI, TR), evaluated ONCE
        over all lanes' vectors per period instead of twice per lane.
        ``QoSModel.predict`` is row-independent, so the shared values are
        bit-identical to the per-lane ones and Decisions are unchanged."""
        t = job.now()
        if t - self._last_opt_t < self.cfg.optimization_period:
            return None
        self._last_opt_t = t
        self.last_pred_lat = float("nan")

        if not job.healthy():
            return self._decide(t, "unhealthy", float("nan"), float("nan"),
                                float("nan"))

        window = self.cfg.optimization_period
        lat = job.avg_latency(window)
        tr_avg = job.avg_throughput(window)
        ci_now = job.current_ci()
        self.forecaster.observe(tr_avg)

        if not np.isfinite(lat) or not np.isfinite(tr_avg):
            return self._decide(t, "none", lat, tr_avg, float("nan"))

        # localize M_L predictions to current conditions (rescaling factor p)
        if shared_pred is not None:
            pred_lat, pred_rec = float(shared_pred[0]), float(shared_pred[1])
        else:
            p_l, p_r = self.m_l.predict_pair(self.m_r,
                                             np.array([ci_now]), tr_avg)
            pred_lat, pred_rec = float(p_l[0]), float(p_r[0])
        self.last_pred_lat = pred_lat
        self.rescaler.track(lat, pred_lat)
        self.latency_obs.append((ci_now, tr_avg, lat))

        # violation checks
        lat_violation = lat > self.cfg.latency_constraint
        rec_violation = pred_rec > self.cfg.recovery_constraint
        if not (lat_violation or rec_violation):
            if self.cfg.proactive:
                pre = self._maybe_preact(job, t, lat, tr_avg, ci_now,
                                         pred_rec)
                if pre is not None:
                    return pre
            return self._decide(t, "none", lat, tr_avg, pred_rec)

        # TSF deferral: workload expected to drop > 10% -> defer
        if self.forecaster.should_defer():
            return self._decide(t, "defer", lat, tr_avg, pred_rec)

        if t - self._last_reconfig_t < self.cfg.reconfig_cooldown:
            return self._decide(t, "cooldown", lat, tr_avg, pred_rec)

        if self.cost is not None:
            return self._optimize_mechanism(job, t, lat, tr_avg, ci_now,
                                            pred_rec)

        res = optimize_ci(self.m_l, self.m_r, tr_avg,
                          self.cfg.latency_constraint,
                          self.cfg.recovery_constraint,
                          self.rescaler.p,
                          self.cfg.ci_min, self.cfg.ci_max)
        if not res.feasible or res.ci is None:
            return self._decide(t, "infeasible", lat, tr_avg, pred_rec)
        if abs(res.ci - ci_now) < 1.0:   # no meaningful change
            return self._decide(t, "none", lat, tr_avg, pred_rec)

        job.reconfigure(res.ci)
        self._last_reconfig_t = t
        return self._decide(t, "reconfigure", lat, tr_avg, pred_rec, res.ci)

    def _maybe_preact(self, job: JobHandle, t, lat, tr_avg, ci_now,
                      pred_rec) -> Optional[Decision]:
        """Forecast-driven pre-switching: no constraint is violated *now*,
        but the TSF predicts the rate rising enough within the horizon to
        break one.  Re-optimize at the PREDICTED peak rate and actuate
        immediately, so the switch (and its drain cost) lands before the
        load does — the mirror image of the defer rule, which only ever
        postpones action on downswings.  Returns None to fall through to
        the ordinary "none" decision: an unwarmed forecaster, a flat
        forecast, a peak the current config already satisfies, an active
        cooldown, and an infeasible peak all stay silent — a *forecast*
        never logs "infeasible" or "cooldown", only a breach does."""
        fr = self.forecaster
        if not fr.warmed_up:
            return None
        tr_peak = fr.predicted_peak()
        rise_gate = (1.0 + self.cfg.proactive_rise_fraction) * tr_avg
        if not np.isfinite(tr_peak) or tr_peak <= rise_gate:
            return None
        # would the CURRENT config violate a constraint at the peak rate?
        peak_lat = float(self.m_l.predict(np.array([ci_now]), tr_peak)[0])
        peak_rec = float(self.m_r.predict(np.array([ci_now]), tr_peak)[0])
        if not (peak_lat * self.rescaler.p > self.cfg.latency_constraint
                or peak_rec > self.cfg.recovery_constraint):
            return None
        if t - self._last_reconfig_t < self.cfg.reconfig_cooldown:
            return None
        if self.cost is not None:
            res = optimize_plan(self.m_l, self.m_r, tr_peak,
                                self.cfg.latency_constraint,
                                self.cfg.recovery_constraint,
                                self.rescaler.p,
                                self.cfg.ci_min, self.cfg.ci_max,
                                self.cost, variants=self.plan_variants,
                                mtbf_s=self.mtbf_s)
            if not res.feasible or res.plan is None:
                return None
            same_mechanism = res.plan.name == job.current_plan().name
            if same_mechanism and abs(res.ci - ci_now) < 1.0:
                return None
            if same_mechanism:
                job.reconfigure(res.ci)
                self._last_reconfig_t = t
                return self._decide(t, "proactive", lat, tr_avg, peak_rec,
                                    res.ci)
            job.reconfigure_plan(res.plan)
            self._last_reconfig_t = t
            return self._decide(t, "proactive", lat, tr_avg, peak_rec,
                                res.ci, res.plan)
        res = optimize_ci(self.m_l, self.m_r, tr_peak,
                          self.cfg.latency_constraint,
                          self.cfg.recovery_constraint,
                          self.rescaler.p,
                          self.cfg.ci_min, self.cfg.ci_max)
        if not res.feasible or res.ci is None:
            return None
        if abs(res.ci - ci_now) < 1.0:
            return None
        job.reconfigure(res.ci)
        self._last_reconfig_t = t
        return self._decide(t, "proactive", lat, tr_avg, peak_rec, res.ci)

    def _optimize_mechanism(self, job: JobHandle, t, lat, tr_avg, ci_now,
                            pred_rec) -> Decision:
        """Eq. 8 over (CI x plan variants); actuates through the handle's
        ``reconfigure_plan`` — the protocol guarantees it exists, so there
        is no CI-only fallback path anymore."""
        res = optimize_plan(self.m_l, self.m_r, tr_avg,
                            self.cfg.latency_constraint,
                            self.cfg.recovery_constraint,
                            self.rescaler.p,
                            self.cfg.ci_min, self.cfg.ci_max,
                            self.cost, variants=self.plan_variants,
                            mtbf_s=self.mtbf_s)
        if not res.feasible or res.plan is None:
            return self._decide(t, "infeasible", lat, tr_avg, pred_rec)
        same_mechanism = res.plan.name == job.current_plan().name
        if same_mechanism and abs(res.ci - ci_now) < 1.0:
            return self._decide(t, "none", lat, tr_avg, pred_rec)
        if same_mechanism:
            # mechanism unchanged: the CI knob is the cheap actuation — a
            # plan switch would pay a drain savepoint + manager rebuild
            # for a cadence change the hot path applies in place
            job.reconfigure(res.ci)
            self._last_reconfig_t = t
            return self._decide(t, "reconfigure", lat, tr_avg, pred_rec,
                                res.ci)
        job.reconfigure_plan(res.plan)
        self._last_reconfig_t = t
        return self._decide(t, "reconfigure", lat, tr_avg, pred_rec, res.ci,
                            res.plan)

    def _decide(self, t, kind, lat, tr, rec, new_ci=None,
                new_plan=None) -> Decision:
        d = Decision(t, kind, lat, tr, rec, new_ci, new_plan)
        self.decisions.append(d)
        if self.decision_log is not None:
            self.decision_log.append((self.label, d))
        return d

    # -- post-execution error analysis (paper Tables II(a)/III(a)) -----------
    def error_analysis(self) -> dict:
        out = {}
        if self.latency_obs:
            ci, tr, y = map(np.array, zip(*self.latency_obs))
            out["latency_avg_pct_error"] = self.m_l.avg_percent_error(ci, tr, y)
        if self.recovery_obs:
            ci, tr, y = map(np.array, zip(*self.recovery_obs))
            out["recovery_avg_pct_error"] = self.m_r.avg_percent_error(ci, tr, y)
        return out
