"""The Khaos control-plane runtime: ONE phase machine driving the paper's
three phases against any ``JobHandle`` — simulator or live trainer.
A copy of the JAX package's ``repro.core.runtime`` without its batched-
campaign loop.

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

Phase 3 is ``attach(job)`` + ``step()``: the caller ticks its substrate
and polls ``step()``, which forwards to ``KhaosController.maybe_optimize``
against the attached handle.  (The JAX package's ``drive_campaign``, the
controller-in-the-loop run over a batched lane campaign, comes with the
port of ``sim/batched.py``.)

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
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.core.controller import (JOB_HANDLE_METHODS, Decision, JobHandle,
                                         KhaosController)
from repro_torch.core.profiler import ProfilingResult, run_profiling
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
    ``mtbf_s``) that are forwarded to every controller this
    runtime builds.
    """

    def __init__(self, cfg: KhaosConfig, cost: Optional[Any] = None,
                 plan_variants: Optional[list] = None,
                 mtbf_s: float = 3600.0):
        self.cfg = cfg
        self.cost = cost
        self.plan_variants = plan_variants
        self.mtbf_s = mtbf_s
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

        ``deployment`` is a per-CI deployment factory ``ci -> Deployment``
        (the sequential path; the JAX package also takes a batched
        campaign here, which comes with the port of ``sim/batched.py``).
        """
        if self.phase != "steady_state":
            raise PhaseError("run_profiling requires Phase 1 "
                             "(record_steady_state) to have completed")
        ci_values = (self.default_ci_grid() if ci_values is None
                     else np.asarray(ci_values, np.float64))
        margin = self.cfg.profile_margin_seconds if margin is None else margin
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

    # -- Phase 3: runtime optimization (§III-D) ------------------------------
    def _make_controller(self, cfg: Optional[KhaosConfig] = None
                         ) -> KhaosController:
        assert self.m_l is not None and self.m_r is not None
        return KhaosController(cfg=cfg or self.cfg, m_l=self.m_l,
                               m_r=self.m_r, cost=self.cost,
                               plan_variants=self.plan_variants,
                               mtbf_s=self.mtbf_s)

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
