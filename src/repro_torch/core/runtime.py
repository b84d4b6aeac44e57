"""The Khaos control-plane runtime: ONE phase machine driving the paper's
three phases against any ``JobHandle`` — simulator or live trainer.
A copy of the JAX package's ``repro.core.runtime``, fleet hooks
(``adopt_models``, the shared decision log) included.

Before this module every caller (examples, launchers, benchmarks) hand-
stitched the sequence "record -> select failure points -> profile ->
fit M_L/M_R -> build controller -> poll maybe_optimize".  ``KhaosRuntime``
makes the sequence a formal state machine:

    idle ──record_steady_state()──▶ steady_state          (Phase 1, §III-B)
         ──run_profiling()───────▶ profiled               (Phase 2, §III-C)
         ──attach(job)───────────▶ optimizing             (Phase 3, §III-D)

Each transition validates its prerequisites (``PhaseError`` on a skipped
or repeated phase) and appends a ``PhaseEvent`` to ``phase_log`` — the
record the smoke gate (``benchmarks/run.py --smoke``) asserts phase order
against.  ``install_models`` is the explicit escape hatch for callers
that bring pre-fitted QoS models (it logs phases 1-2 as ``skipped``).

Phase 3 runs in two shapes:

  * ``attach(job)`` + ``step()`` — classic single-job supervision: the
    caller ticks its substrate and polls ``step()``, which forwards to
    ``KhaosController.maybe_optimize`` against the attached handle;
  * ``drive_campaign(campaign)`` — controller-IN-THE-LOOP over a
    ``sim.BatchedCampaign`` (or the torch ``sim.DeviceCampaign``): every
    lane gets its own controller and a ``BatchedLaneHandle``, the
    campaign advances in optimization-period chunks, and each chunk
    boundary applies a ``maybe_optimize`` step across all live lanes.
    ``lane_cfgs`` gives selected lanes their own ``KhaosConfig`` so e.g.
    proactive and reactive controllers run as lanes of ONE campaign.

Phase 3 also carries the *mitigation ladder* for gray failures — the
degradations of ``ft.failures`` that slow a job without killing it:

  rung 1  ``attach_anomaly_detector`` + ``observe_metrics``: a sustained
          anomaly on the supervised metrics (the QoS models no longer
          describe the degraded cluster) triggers ``reprofile()`` — a
          legal re-entry into Phase 2 that re-runs the chaos campaign,
          refits M_L/M_R and swaps them onto every live controller;
  rung 2  ``attach_straggler_detector`` + ``observe_host_steps``: a host
          flagged as a persistent straggler escalates to an elastic
          recovery plan (``ft.elastic.plan_recovery`` — replace from hot
          standbys, else rescale down), recorded in ``mitigations``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.core.controller import (JOB_HANDLE_METHODS, Decision, JobHandle,
                                         KhaosController)
from repro_torch.core.profiler import (ProfilingResult, run_profiling,
                                       run_profiling_campaign)
from repro_torch.core.qos_models import QoSModel
from repro_torch.core.steady_state import SteadyState, select_failure_points

#: legal phase order; every transition must advance exactly one slot
PHASES = ("idle", "steady_state", "profiled", "optimizing")


class PhaseError(RuntimeError):
    """A phase was entered out of order (skipped prerequisite or repeat)."""


def missing_handle_methods(job: Any) -> list:
    """The protocol methods ``job`` fails to provide (empty = conformant).
    The single source for every conformance check (``KhaosRuntime.attach``,
    the ``run.py --smoke`` gate, the protocol tests)."""
    return [m for m in JOB_HANDLE_METHODS
            if not callable(getattr(job, m, None))]


@dataclass
class PhaseEvent:
    """One transition of the phase machine (``phase_log`` entry)."""
    phase: str
    info: dict = field(default_factory=dict)


class KhaosRuntime:
    """Sequences Phase 1 -> Phase 2 -> Phase 3 against any ``JobHandle``.

    Construction takes the paper's knobs (``KhaosConfig``) plus the
    optional mechanism-search attachments (``cost``/``plan_variants``/
    ``verifier``/``mtbf_s``) that are forwarded to every controller this
    runtime builds.
    """

    def __init__(self, cfg: KhaosConfig, cost: Optional[Any] = None,
                 plan_variants: Optional[list] = None,
                 mtbf_s: float = 3600.0,
                 verifier: Optional[Callable] = None):
        self.cfg = cfg
        self.cost = cost
        self.plan_variants = plan_variants
        self.mtbf_s = mtbf_s
        self.verifier = verifier
        self.phase: str = "idle"
        self.phase_log: list[PhaseEvent] = []
        # phase artifacts
        self.steady: Optional[SteadyState] = None
        self.profile: Optional[ProfilingResult] = None
        self.m_l: Optional[QoSModel] = None
        self.m_r: Optional[QoSModel] = None
        self.controller: Optional[KhaosController] = None
        self.job: Optional[JobHandle] = None
        # mitigation ladder (gray failures): optional attachments
        self.anomaly: Optional[Any] = None
        self.anomaly_lane: int = 0
        self.straggler: Optional[Any] = None
        self.mesh: Optional[Any] = None
        self.standbys: int = 0
        self.chips_per_host: int = 4
        self.global_batch: Optional[int] = None
        self.mitigations: list = []          # (t, kind, info) escalations
        self._reprofile_source: Optional[tuple] = None
        self._reprofiled_episode = False     # one reprofile per anomaly
        self._active_controllers: list = []  # model-swap targets
        # fleet hooks: every controller this runtime builds logs its
        # Decisions into the shared ``decision_log`` under ``label``
        # (fleet.FleetSupervisor threads one list through N runtimes);
        # ``transferred`` records that Phase 2 was skipped via the
        # QoS-model-transfer fast path (``adopt_models``)
        self.decision_label: Optional[str] = None
        self.decision_log: Optional[list] = None
        self.transferred: bool = False

    # -- phase machinery ----------------------------------------------------
    def _transition(self, to: str, **info) -> None:
        if PHASES.index(to) != PHASES.index(self.phase) + 1:
            raise PhaseError(f"cannot enter phase {to!r} from {self.phase!r} "
                             f"(order is {' -> '.join(PHASES)})")
        self.phase = to
        self.phase_log.append(PhaseEvent(to, info))

    def phase_sequence(self) -> list[str]:
        """The phases entered so far, in order (the smoke-gate assertion)."""
        return [ev.phase for ev in self.phase_log]

    # -- Phase 1: steady state (§III-B) -------------------------------------
    def record_steady_state(self, recording,
                            m: Optional[int] = None) -> SteadyState:
        """Analyze the workload recording and select the ``m`` failure
        points spanning the observed throughput range."""
        steady = select_failure_points(
            recording, m=m or self.cfg.num_failure_points,
            smoothing_window=self.cfg.smoothing_window,
            mode=self.cfg.failure_point_mode)
        self._transition("steady_state",
                         failure_points=len(steady.failure_times),
                         tr_range=[float(steady.failure_rates.min()),
                                   float(steady.failure_rates.max())])
        self.steady = steady
        return steady

    # -- Phase 2: chaos profiling (§III-C) ----------------------------------
    def default_ci_grid(self) -> np.ndarray:
        """The z candidate CIs from the config window."""
        return np.linspace(self.cfg.ci_min, self.cfg.ci_max,
                           self.cfg.num_configs)

    def run_profiling(self, deployment, ci_values=None,
                      margin: Optional[float] = None,
                      progress: Optional[Callable[[str], None]] = None
                      ) -> ProfilingResult:
        """Profile the (CI x failure point) grid and fit M_L / M_R.

        ``deployment`` is either a ``CampaignDeployment`` (has
        ``profile_campaign`` — the whole grid as lanes of one batched
        campaign, e.g. ``sim.BatchedDeployment``) or a per-CI deployment
        factory ``ci -> Deployment`` (the sequential oracle path).
        """
        if self.phase != "steady_state":
            raise PhaseError("run_profiling requires Phase 1 "
                             "(record_steady_state) to have completed")
        ci_values = (self.default_ci_grid() if ci_values is None
                     else np.asarray(ci_values, np.float64))
        margin = self.cfg.profile_margin_seconds if margin is None else margin
        if hasattr(deployment, "profile_campaign"):
            prof = run_profiling_campaign(deployment, self.steady, ci_values,
                                          margin=margin, progress=progress)
            substrate = "campaign"
        else:
            prof = run_profiling(deployment, self.steady, ci_values,
                                 margin=margin, progress=progress)
            substrate = "sequential"
        ci_f, tr_f, L_f, R_f = prof.flat()
        self.m_l = QoSModel(degree=self.cfg.model_degree,
                            ridge_lambda=self.cfg.ridge_lambda
                            ).fit(ci_f, tr_f, L_f)
        self.m_r = QoSModel(degree=self.cfg.model_degree,
                            ridge_lambda=self.cfg.ridge_lambda
                            ).fit(ci_f, tr_f, R_f)
        self._transition("profiled", substrate=substrate,
                         cells=int(prof.latencies.size),
                         m_l_pct_error=self.m_l.avg_percent_error(
                             ci_f, tr_f, L_f),
                         m_r_pct_error=self.m_r.avg_percent_error(
                             ci_f, tr_f, R_f))
        self.profile = prof
        return prof

    def install_models(self, m_l: QoSModel, m_r: QoSModel,
                       steady: Optional[SteadyState] = None) -> None:
        """Skip phases 1-2 with pre-fitted QoS models (production installs
        models fitted on the cluster; demos install priors).  The skipped
        phases are still logged so ``phase_sequence`` stays truthful."""
        if self.phase != "idle":
            raise PhaseError("install_models replaces phases 1-2 and must "
                             "run from 'idle'")
        self.steady = steady
        self._transition("steady_state", skipped=True)
        self._transition("profiled", skipped=True)
        self.m_l, self.m_r = m_l, m_r

    def adopt_models(self, m_l: QoSModel, m_r: QoSModel,
                     source: str = "registry") -> None:
        """The QoS-model TRANSFER fast path (fleet admission): Phase 1 ran
        for real — this job's steady state and failure points are its own —
        but Phase 2 is skipped because a fitted neighbor with a matching
        profile fingerprint already exists (``fleet.QoSModelRegistry``).
        The machine walks ``steady_state -> profiled`` without a campaign;
        the transition is logged with ``transferred=True`` and the donor
        ``source`` so ``phase_sequence`` stays truthful.  Because
        ``steady`` is real, a later divergence-watchdog ``reprofile()`` is
        fully legal — that is the fallback when the transferred models turn
        out not to describe this job after all."""
        if self.phase != "steady_state":
            raise PhaseError("adopt_models is the skip-Phase-2 fast path "
                             "and requires Phase 1 (record_steady_state) "
                             "to have completed")
        self._transition("profiled", transferred=True, source=source)
        self.m_l, self.m_r = m_l, m_r
        self.transferred = True

    def attach_decision_log(self, log: list, label: str) -> None:
        """Arm the fleet-shared decision log: every controller this runtime
        builds (single-job, campaign, or reprofile-rebuilt) appends its
        Decisions to ``log`` as ``(label, Decision)`` — the one audit trail
        a ``FleetSupervisor`` reads across all supervised jobs."""
        self.decision_log = log
        self.decision_label = label
        for ctl in self._active_controllers:
            ctl.decision_log = log
            ctl.label = label

    # -- Phase 3: runtime optimization (§III-D) ------------------------------
    def _make_controller(self, cfg: Optional[KhaosConfig] = None
                         ) -> KhaosController:
        assert self.m_l is not None and self.m_r is not None
        return KhaosController(cfg=cfg or self.cfg, m_l=self.m_l,
                               m_r=self.m_r, cost=self.cost,
                               plan_variants=self.plan_variants,
                               mtbf_s=self.mtbf_s,
                               label=self.decision_label,
                               decision_log=self.decision_log)

    def initial_ci(self, tr_avg: float) -> Optional[float]:
        """The Eq.-8 optimum at the recorded average throughput (the CI the
        job should start Phase 3 with); None when infeasible."""
        if self.m_l is None:
            raise PhaseError("initial_ci requires fitted models (Phase 2)")
        return self._make_controller().initial_ci(tr_avg)

    def attach(self, job: JobHandle) -> KhaosController:
        """Enter Phase 3 supervising ``job``; returns the controller."""
        if self.phase != "profiled":
            raise PhaseError("attach requires Phase 2 (run_profiling or "
                             "install_models) to have completed")
        missing = missing_handle_methods(job)
        if missing:
            raise TypeError(f"{type(job).__name__} does not implement the "
                            f"JobHandle protocol: missing {missing}")
        self.controller = self._make_controller()
        self._active_controllers = [self.controller]
        self.job = job
        self._transition("optimizing", handle=type(job).__name__)
        return self.controller

    def step(self) -> Optional[Decision]:
        """One optimization poll against the attached job (call after each
        substrate tick; the controller gates itself on the period)."""
        if self.phase != "optimizing" or self.controller is None:
            raise PhaseError("step requires attach() (Phase 3)")
        return self.controller.maybe_optimize(self.job)

    # -- Phase 3, mitigation ladder (gray failures) ---------------------------
    def attach_anomaly_detector(self, detector, lane: int = 0) -> None:
        """Arm rung 1: ``detector`` (``core.anomaly.AnomalyDetector``) is
        fed by ``observe_metrics`` — directly or, under ``drive_campaign``,
        from the supervised lane ``lane`` at every chunk boundary.  Its
        metric names must come from {"throughput", "latency"} on the
        campaign path (those are the observables a lane exposes)."""
        self.anomaly = detector
        self.anomaly_lane = lane

    def attach_straggler_detector(self, detector, mesh=None, standbys: int = 0,
                                  chips_per_host: int = 4,
                                  global_batch: Optional[int] = None) -> None:
        """Arm rung 2: ``detector`` (``ft.straggler.StragglerDetector``)
        is fed by ``observe_host_steps``; a newly-flagged host escalates
        to ``ft.elastic.plan_recovery`` against ``mesh``/``standbys``
        (escalation is recorded but not actuated when ``mesh`` is None)."""
        self.straggler = detector
        self.mesh = mesh
        self.standbys = standbys
        self.chips_per_host = chips_per_host
        self.global_batch = global_batch

    def enable_reprofiling(self, deployment, ci_values=None) -> None:
        """Store the chaos-campaign substrate ``reprofile()`` re-runs when
        the anomaly rung fires (same contract as ``run_profiling``)."""
        self._reprofile_source = (deployment, ci_values)

    def reprofile(self, deployment=None, ci_values=None,
                  reason: str = "anomaly") -> ProfilingResult:
        """Anomaly-triggered re-entry into Phase 2: the QoS models no
        longer describe the (degraded) cluster, so re-run the chaos
        campaign, refit M_L/M_R and swap the fresh models onto every live
        controller.  Legal only from ``optimizing``; the detour is logged
        as a ``reprofile`` event so ``phase_log`` stays truthful, then the
        machine re-walks steady_state -> profiled -> optimizing."""
        if self.phase != "optimizing":
            raise PhaseError("reprofile is a Phase-3 mitigation and "
                             "requires phase 'optimizing'")
        if self.steady is None:
            raise PhaseError("reprofile requires a recorded steady state "
                             "(install_models skipped Phase 1)")
        if deployment is None:
            if self._reprofile_source is None:
                raise PhaseError("reprofile needs a deployment: pass one "
                                 "or call enable_reprofiling first")
            deployment, ci_values = self._reprofile_source
        self.phase_log.append(PhaseEvent("reprofile", {"reason": reason}))
        self.phase = "steady_state"
        prof = self.run_profiling(deployment, ci_values=ci_values)
        self._transition("optimizing", handle="reprofile", reason=reason)
        for ctl in self._active_controllers:
            ctl.m_l, ctl.m_r = self.m_l, self.m_r
        return prof

    def observe_metrics(self, t: float, values: dict,
                        healthy: bool = True) -> bool:
        """Rung 1 feed: one supervised-metrics sample for the anomaly
        detector (``healthy=False`` freezes learning so a failure is not
        learned as normal).  The FIRST observation of a sustained anomaly
        triggers ``reprofile()`` — once per anomaly episode, and only when
        a reprofiling substrate is armed.  Returns True when it fired."""
        if self.anomaly is None:
            return False
        anomalous = self.anomaly.observe(t, values, learn=healthy)
        if not anomalous:
            self._reprofiled_episode = False
            return False
        if (self._reprofiled_episode or self._reprofile_source is None
                or self.phase != "optimizing"):
            return False
        self._reprofiled_episode = True
        self.mitigations.append((t, "reprofile", {"reason": "anomaly"}))
        self.reprofile(reason="anomaly")
        return True

    def observe_host_steps(self, t: float, host_step_times: dict) -> list:
        """Rung 2 feed: per-host step times for the straggler detector.
        Every host it newly flags escalates to an elastic recovery plan —
        replace it from hot standbys when any remain, else rescale down —
        appended to ``mitigations``.  Returns the plans (None entries when
        no mesh was attached to plan against)."""
        if self.straggler is None:
            return []
        plans = []
        for host in self.straggler.observe_step(t, host_step_times):
            plan = None
            if self.mesh is not None:
                from repro_torch.ft.elastic import plan_recovery   # local: core
                # must stay importable without the ft package loaded first
                plan = plan_recovery(self.mesh, hosts_lost=1,
                                     standbys=self.standbys,
                                     chips_per_host=self.chips_per_host,
                                     global_batch=self.global_batch)
                self.standbys = plan.standbys_left
                self.mesh = plan.mesh
            self.mitigations.append((t, "straggler_evict",
                                     {"host": host, "plan": plan}))
            plans.append(plan)
        return plans

    # -- Phase 3, vectorized: controller-in-the-loop campaigns ---------------
    def drive_campaign(self, campaign,
                       lanes: Optional[Sequence[int]] = None,
                       period_ticks: Optional[int] = None,
                       lane_cfgs: Optional[dict] = None
                       ) -> "CampaignSupervision":
        """Run Phase 3 across every lane of a ``sim.BatchedCampaign``.

        Each selected lane gets its own ``KhaosController`` and a
        ``BatchedLaneHandle``; the campaign advances in chunks of
        ``period_ticks`` and each chunk boundary applies one
        ``maybe_optimize`` step per live lane — a vectorized substrate
        under N independent scalar control loops.  The default chunk is
        the optimization period, so decisions fire at t0 + k*period;
        the scalar loop, polling after every tick, fires its first
        decision one tick after t0 and then every period from there.
        Pass ``period_ticks=1`` to poll every tick and reproduce the
        scalar decision clock exactly (bit-exact per lane, at more
        Python overhead per tick).  Requires the campaign to record
        history (the handles' latency windows read it).

        ``lane_cfgs`` maps lane id -> ``KhaosConfig`` override for that
        lane's controller (lanes absent from the map use the runtime's
        config) — the head-to-head harness: proactive vs reactive
        controllers supervising twin lanes of the SAME campaign.  When an
        anomaly detector is attached, the supervised lane's metrics are
        fed to it at every chunk boundary and a sustained anomaly fires
        the reprofile rung mid-campaign.
        """
        if self.phase not in ("profiled", "optimizing"):
            raise PhaseError("drive_campaign requires Phase 2 to have "
                             "completed")
        from repro_torch.sim.batched import BatchedLaneHandle   # local: core must
        # stay importable without the sim package loaded first
        lane_ids = list(range(campaign.n_lanes)) if lanes is None \
            else list(lanes)
        handles = [BatchedLaneHandle(campaign, i) for i in lane_ids]
        controllers = [self._make_controller((lane_cfgs or {}).get(i))
                       for i in lane_ids]
        self._active_controllers = list(controllers)
        period = max(1, int(period_ticks if period_ticks is not None
                            else round(self.cfg.optimization_period)))
        if self.phase == "profiled":
            self._transition("optimizing", handle="BatchedLaneHandle",
                             lanes=len(lane_ids))
        while not campaign.done:
            campaign.run(n_ticks=period)
            live = [(ctl, h) for ctl, h in zip(controllers, handles)
                    if h.alive()]
            preds = self._shared_predictions(live)
            for (ctl, h), pred in zip(live, preds):
                ctl.maybe_optimize(h, shared_pred=pred)
            if self.anomaly is not None:
                self._feed_campaign_anomaly(handles, lane_ids)
        # the scalar loop polls once more after its final tick (alive()
        # is already False there, so the in-loop polls skip it); actuation
        # on a finished lane is as inert as the scalar's post-loop one
        pairs = list(zip(controllers, handles))
        for (ctl, h), pred in zip(pairs, self._shared_predictions(pairs)):
            ctl.maybe_optimize(h, shared_pred=pred)
        return CampaignSupervision(campaign, lane_ids, handles, controllers)

    def _feed_campaign_anomaly(self, handles, lane_ids) -> None:
        """One anomaly-detector sample from the supervised lane's trailing
        window (skipped while the window is empty or the lane finished)."""
        if self.anomaly_lane not in lane_ids:
            return
        h = handles[lane_ids.index(self.anomaly_lane)]
        tr = h.avg_throughput(self.cfg.optimization_period)
        lat = h.avg_latency(self.cfg.optimization_period)
        if not (np.isfinite(tr) and np.isfinite(lat)):
            return
        vals = {m: {"throughput": tr, "latency": lat}[m]
                for m in self.anomaly.metrics}
        self.observe_metrics(h.now(), vals, healthy=h.healthy())

    def _shared_predictions(self, pairs: Sequence[tuple]) -> list:
        """One ``QoSModel.predict`` over ALL lanes' (CI, TR) vectors per
        optimization period, instead of two scalar evaluations per lane —
        the vectorized-controller cut for very wide supervised campaigns.
        Only lanes whose ``maybe_optimize`` will actually reach the
        prediction site are evaluated (the gating predicates below mirror
        its early exits exactly), and ``QoSModel.predict`` is
        row-independent, so per-lane Decisions are BIT-identical to the
        per-lane evaluation loop (asserted in tests).  Gating reads each
        controller's OWN config (``lane_cfgs`` lanes may differ from the
        runtime's)."""
        rows: list[tuple[int, float, float]] = []
        for i, (ctl, h) in enumerate(pairs):
            if h.now() - ctl._last_opt_t < ctl.cfg.optimization_period:
                continue                      # not due: returns None
            if not h.healthy():
                continue                      # "unhealthy" decision
            lat = h.avg_latency(ctl.cfg.optimization_period)
            tr = h.avg_throughput(ctl.cfg.optimization_period)
            if not (np.isfinite(lat) and np.isfinite(tr)):
                continue                      # empty-window "none" decision
            rows.append((i, h.current_ci(), tr))
        preds: list = [None] * len(pairs)
        if rows:
            idx, ci, tr = zip(*rows)
            p_l, p_r = self.m_l.predict_pair(self.m_r,
                                             np.asarray(ci, np.float64),
                                             np.asarray(tr, np.float64))
            for j, i in enumerate(idx):
                preds[i] = (float(p_l[j]), float(p_r[j]))
        return preds


@dataclass
class CampaignSupervision:
    """Result of a controller-in-the-loop campaign run."""
    campaign: Any
    lane_ids: list
    handles: list
    controllers: list

    def decisions(self, lane: int) -> list:
        return self.controllers[self.lane_ids.index(lane)].decisions

    def reconfigurations(self, lane: int) -> list:
        return self.handles[self.lane_ids.index(lane)].reconfigurations

    def summary(self) -> dict:
        kinds: dict[str, int] = {}
        for ctl in self.controllers:
            for d in ctl.decisions:
                kinds[d.kind] = kinds.get(d.kind, 0) + 1
        return {
            "lanes": len(self.lane_ids),
            "decisions_by_kind": kinds,
            "reconfigured_lanes": sum(1 for h in self.handles
                                      if h.reconfigurations),
            "plan_switched_lanes": sum(1 for h in self.handles
                                       if h.plan_changes),
        }
