"""``FleetSupervisor`` — one control plane over many Khaos jobs.

Architecture (the supervisor / monitor split)
---------------------------------------------

One process, two planes:

* the SUPERVISOR plane owns the control loop: one ``KhaosRuntime`` phase
  machine PER JOB (each job walks idle -> steady_state -> profiled ->
  optimizing on its own legality rules), but ONE scheduler tick driving
  them all, ONE pooled ``BatchedCampaign`` substrate for every
  lane-backed job, and ONE shared decision log every controller appends
  to (``KhaosRuntime.attach_decision_log``).  Heterogeneous substrates
  multiplex onto the same tick: lane jobs advance with the pooled
  campaign, scalar jobs (``StreamSimulator``/``SimJobHandle``) and
  external handles (e.g. ``TrainerJobHandle`` + a ticker callable)
  advance alongside, and every job's controller is polled at each chunk
  boundary.

* the MONITOR plane owns observation: a bounded ``MetricsStore`` (ring
  buffer + rollup-on-eviction, so supervising many jobs for days holds
  memory flat) with per-job series (``<job>/latency``,
  ``<job>/throughput``) and per-fleet rollups (``fleet/latency``,
  ``fleet/jobs_optimizing``), plus per-job ``DivergenceWatchdog``s
  guarding transferred QoS models.

Admission flow (in prose)
-------------------------

A submitted job is recorded first (Phase 1 runs unconditionally — the
steady state and failure points are always the job's own).  Its profile
fingerprint (state bytes, arrival-rate envelope, plan dimensions) is
looked up in the ``QoSModelRegistry``.  Admission then gates on fleet
capacity: the job's reservation (peak rate + headroom) must fit the
residual budget, and a what-if chaos campaign — the job's workload
replayed at the residual capacity with a worst-case failure at the
recorded peak — must meet the job's own QoS constraints.  Infeasible
jobs are rejected (or queued, to retry when capacity frees).  Admitted
jobs with a registry hit run a one-lane validation probe; if the donor
models predict the probe within tolerance the job ADOPTS them
(``KhaosRuntime.adopt_models`` — the steady_state -> profiled fast path,
no campaign) and is armed with a divergence watchdog whose trip wire is
a real ``reprofile()``.  Admitted jobs without a hit (or whose probe
fails) stay cold: their z x m profiling grids are POOLED — all cold
jobs' lanes concatenated into one ``BatchedCampaign`` sweep
(``run_profiling_pooled``), measurements scattered back per job, models
fitted per job and filed in the registry for the next neighbor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.config import CheckpointPlan, KhaosConfig
from repro_torch.core.runtime import KhaosRuntime
from repro_torch.data.stream import (RateSchedule, WorkloadRecording,
                                     dense_rates, record_workload)
from repro_torch.fleet.admission import AdmissionDecision, decide_admission
from repro_torch.fleet.registry import (DivergenceWatchdog, JobFingerprint,
                                        QoSModelRegistry, fingerprint)
from repro_torch.ft.failures import FailureInjector
from repro_torch.metrics import MetricsStore
from repro_torch.sim.batched import (BatchedCampaign, BatchedDeployment,
                                     BatchedLaneHandle, LaneSpec,
                                     build_profile_lanes, make_campaign,
                                     measure_profile_lanes,
                                     scatter_profile_results)
from repro_torch.sim.costmodel import SimCostModel
from repro_torch.sim.simulator import SimJobHandle, StreamSimulator


@dataclass
class FleetJobSpec:
    """Everything the supervisor needs to admit and drive one job."""
    name: str
    cost: SimCostModel
    cfg: KhaosConfig
    schedule: Optional[RateSchedule] = None
    recording: Optional[WorkloadRecording] = None   # pre-recorded Phase 1
    substrate: str = "lane"          # lane | scalar | handle
    handle: Any = None               # substrate="handle": external JobHandle
    ticker: Optional[Callable[[float], None]] = None  # advance handle by dt
    horizon_s: float = 1800.0        # Phase-3 supervision horizon
    failures: Sequence[tuple] = ()   # (t, kind) chaos during supervision
    plan_variants: Optional[list] = None
    queueable: bool = False
    seed: int = 0
    profile_warmup_s: float = 120.0
    profile_max_recovery_s: float = 1800.0

    def __post_init__(self) -> None:
        assert self.substrate in ("lane", "scalar", "handle"), self.substrate
        if self.substrate == "handle":
            assert self.handle is not None, "substrate='handle' needs one"
        else:
            assert self.schedule is not None or self.recording is not None, \
                f"job {self.name!r} needs a schedule or a recording"


@dataclass
class FleetJob:
    """Supervisor-side state of one submitted job."""
    spec: FleetJobSpec
    status: str                          # rejected|queued|admitted|optimizing|done
    admission: AdmissionDecision
    recording: Optional[WorkloadRecording] = None
    fp: Optional[JobFingerprint] = None
    runtime: Optional[KhaosRuntime] = None
    handle: Any = None
    sim: Optional[StreamSimulator] = None    # scalar substrate
    lane: Optional[int] = None               # lane substrate: pooled index
    campaign: Optional[BatchedCampaign] = None
    transferred: bool = False
    transfer_source: Optional[str] = None
    watchdog: Optional[DivergenceWatchdog] = None
    profiling_lane_ticks: int = 0        # substrate ticks spent on Phase 2
    reprofiles: int = 0

    @property
    def name(self) -> str:
        return self.spec.name


class _PrecomputedCampaign:
    """``core.profiler.CampaignDeployment`` over measurements that already
    happened — the adapter that lets ``KhaosRuntime.run_profiling`` (and
    its phase-legality bookkeeping) consume one job's slice of the POOLED
    multi-job campaign instead of running its own."""

    def __init__(self, L: np.ndarray, R: np.ndarray):
        self._L, self._R = L, R

    def profile_campaign(self, failure_times, ci_values, margin: float
                         ) -> tuple[np.ndarray, np.ndarray]:
        assert self._L.shape == (len(failure_times), len(ci_values)), \
            (self._L.shape, len(failure_times), len(ci_values))
        return self._L, self._R


def lane_violation_seconds(camp: BatchedCampaign, lane: int, l_const: float,
                           r_const: float) -> dict:
    """QoS-violation seconds for one supervised lane: recovery excess over
    r_const plus the count of ticks whose latency exceeded l_const (the
    bench_proactive scoring, shared here for fleet twins)."""
    recs = [r["recovery_s"] for r in camp.recoveries[lane]]
    rec_viol = float(sum(max(0.0, r - r_const) for r in recs))
    ts = camp.times(lane)
    lat = camp.latency_history()[lane, :len(ts)]
    lat_viol = float(np.sum(lat > l_const))
    return {"recovery_violation_s": rec_viol,
            "latency_violation_s": lat_viol,
            "qos_violation_s": rec_viol + lat_viol}


def _cost_key(cost: SimCostModel) -> tuple:
    """Hashable identity of a cost model (campaigns share one cost model,
    so pooling groups lanes by cost-model value)."""
    return tuple(sorted((k, str(v)) for k, v in
                        dataclasses.asdict(cost).items()))


class FleetSupervisor:
    """One control plane over N jobs: admission, QoS-model transfer,
    pooled profiling, and a single multiplexed Phase-3 tick.

    ``fleet_capacity_eps`` is the total processing budget (events/s)
    admission reserves against.  ``registry`` carries fitted QoS surfaces
    across jobs (and, via save/load, across fleet restarts).
    """

    def __init__(self, fleet_capacity_eps: float,
                 registry: Optional[QoSModelRegistry] = None,
                 headroom: float = 0.2,
                 probe_tolerance: float = 0.75,
                 divergence_threshold: float = 0.5,
                 divergence_patience: int = 3,
                 metrics_maxlen: Optional[int] = 512,
                 engine: str = "numpy", device=None):
        self.fleet_capacity_eps = float(fleet_capacity_eps)
        self.registry = registry if registry is not None else QoSModelRegistry()
        # the engine (and torch device of the "device" engine) of every
        # campaign the supervisor runs: what-ifs, transfer probes, pooled
        # Phase 2, the shared Phase-3 campaigns and reprofiles
        self.engine = engine
        self.device = device
        self.headroom = headroom
        self.probe_tolerance = probe_tolerance
        self.divergence_threshold = divergence_threshold
        self.divergence_patience = divergence_patience
        self.jobs: dict[str, FleetJob] = {}
        self.decision_log: list = []          # (job, Decision) shared audit
        self.metrics = MetricsStore(maxlen=metrics_maxlen)
        self.reserved_eps = 0.0
        self.t = 0.0                          # fleet clock (Phase-3 seconds)
        self._campaigns: dict[tuple, BatchedCampaign] = {}
        self._started = False

    # -- capacity ------------------------------------------------------------
    @property
    def residual_eps(self) -> float:
        return self.fleet_capacity_eps - self.reserved_eps

    # -- admission (Phase 1 + gate + transfer fast path) ---------------------
    def submit(self, spec: FleetJobSpec) -> AdmissionDecision:
        assert spec.name not in self.jobs, f"duplicate job {spec.name!r}"
        recording = spec.recording if spec.recording is not None else \
            record_workload(spec.schedule, duration=spec.cfg.record_seconds,
                            seed=spec.seed)
        fp = fingerprint(spec.cfg, recording, spec.cost.state_bytes)
        dec = decide_admission(spec.name, spec.cost, recording, spec.cfg,
                               self.residual_eps, headroom=self.headroom,
                               queueable=spec.queueable, engine=self.engine,
                               device=self.device)
        if not dec.admitted:
            status = "queued" if dec.action == "queue" else "rejected"
            self.jobs[spec.name] = FleetJob(spec, status, dec,
                                            recording=recording, fp=fp)
            return dec

        rt = KhaosRuntime(spec.cfg, cost=spec.cost,
                          plan_variants=spec.plan_variants)
        rt.attach_decision_log(self.decision_log, spec.name)
        rt.record_steady_state(recording)
        job = FleetJob(spec, "admitted", dec, recording=recording, fp=fp,
                       runtime=rt)
        self.jobs[spec.name] = job
        self.reserved_eps += dec.reserved_eps

        entry = self.registry.lookup(fp)
        if entry is not None and self._transfer_probe(job, entry):
            rt.adopt_models(entry.m_l, entry.m_r, source=entry.source_job)
            job.transferred = True
            job.transfer_source = entry.source_job
            job.watchdog = DivergenceWatchdog(
                rel_err_threshold=self.divergence_threshold,
                patience=self.divergence_patience)
            dec = dataclasses.replace(dec, action="admit_transfer",
                                      reason=dec.reason +
                                      f"; QoS models adopted from "
                                      f"{entry.source_job!r}")
            job.admission = dec
        # either way, arm the reprofiling fallback (divergence watchdog /
        # anomaly rung) with the job's own chaos substrate
        rt.enable_reprofiling(
            BatchedDeployment(spec.cost, recording,
                              warmup_s=spec.profile_warmup_s,
                              max_recovery_s=spec.profile_max_recovery_s,
                              engine=self.engine, device=self.device))
        return dec

    def _transfer_probe(self, job: FleetJob, entry) -> bool:
        """Validate a registry hit with ONE lane before adopting: replay
        the worst-case injection at the recorded peak and require the
        donor models to predict the measured latency and recovery within
        ``probe_tolerance`` relative error.  The probe's ticks are the
        transfer job's entire Phase-2 bill (vs the cold z x m grid)."""
        spec, rec = job.spec, job.recording
        cfg, cost = spec.cfg, spec.cost
        margin = cfg.profile_margin_seconds
        t_peak = float(rec.times[int(np.argmax(rec.counts))])
        t0 = max(float(rec.times[0]),
                 t_peak - margin - spec.profile_warmup_s)
        ci = 0.5 * (cfg.ci_min + cfg.ci_max)
        inject_t = FailureInjector().worst_case_time(
            max(t_peak, t0 + margin), t0, ci, cost.ckpt_duration_s)
        n = int(np.ceil(inject_t + spec.profile_max_recovery_s - t0))
        lane = LaneSpec(rates=dense_rates(t0, n, recording=rec), ci_s=ci,
                        t0=t0, failures=((inject_t, "node"),),
                        tag={"job": job.name, "probe": True})
        camp = make_campaign(cost, [lane], engine=self.engine,
                             device=self.device).run()
        msr = measure_profile_lanes(camp, [inject_t], margin,
                                    spec.profile_max_recovery_s)[0]
        job.profiling_lane_ticks += n
        tr = float(rec.counts.max())
        pred_l = float(entry.m_l.predict(np.array([ci]), np.array([tr]))[0])
        pred_r = float(entry.m_r.predict(np.array([ci]), np.array([tr]))[0])
        err_l = abs(msr.latency_s - pred_l) / max(abs(msr.latency_s), 1e-9)
        err_r = abs(msr.recovery_s - pred_r) / max(abs(msr.recovery_s), 1e-9)
        return err_l <= self.probe_tolerance and err_r <= self.probe_tolerance

    def retry_queued(self) -> list[AdmissionDecision]:
        """Re-run admission for queued jobs against the current residual
        (call after capacity frees up, e.g. a job finished)."""
        out = []
        for name, job in list(self.jobs.items()):
            if job.status != "queued":
                continue
            del self.jobs[name]
            out.append(self.submit(job.spec))
        return out

    # -- Phase 2, pooled ------------------------------------------------------
    def run_profiling_pooled(self) -> dict:
        """One ``BatchedCampaign`` sweep over EVERY cold admitted job's
        z x m profiling grid: lanes are built per job (each against its
        own steady state and CI grid), tagged with the job name,
        concatenated per cost model, run together, and the measurements
        scattered back into per-job (L, R) matrices that each job's
        ``KhaosRuntime.run_profiling`` consumes through the
        ``_PrecomputedCampaign`` adapter — N jobs profiled for the
        wall-clock of the widest grid, each phase machine still walking
        its own legal transitions."""
        cold = [j for j in self.jobs.values()
                if j.status == "admitted" and j.runtime is not None
                and j.runtime.phase == "steady_state"]
        if not cold:
            return {"jobs_profiled": 0, "pooled_lanes": 0}
        # group per cost model: a campaign prices all lanes with one cost
        groups: dict[tuple, list[FleetJob]] = {}
        for j in cold:
            groups.setdefault(_cost_key(j.spec.cost), []).append(j)
        total_lanes = 0
        for members in groups.values():
            plan: list[tuple[FleetJob, list, list, np.ndarray]] = []
            all_lanes: list[LaneSpec] = []
            all_injects: list[float] = []
            for j in members:
                cfg, rt = j.spec.cfg, j.runtime
                grid = rt.default_ci_grid()
                lanes, injects = build_profile_lanes(
                    j.spec.cost, j.recording, rt.steady.failure_times,
                    grid, cfg.profile_margin_seconds,
                    warmup_s=j.spec.profile_warmup_s,
                    max_recovery_s=j.spec.profile_max_recovery_s,
                    job=j.name)
                plan.append((j, lanes, injects, grid))
                all_lanes.extend(lanes)
                all_injects.extend(injects)
                j.profiling_lane_ticks += sum(len(l.rates) for l in lanes)
            camp = make_campaign(members[0].spec.cost, all_lanes,
                                 engine=self.engine,
                                 device=self.device).run()
            total_lanes += len(all_lanes)
            off = 0
            for j, lanes, injects, grid in plan:
                margin = j.spec.cfg.profile_margin_seconds
                meas = measure_profile_lanes(
                    camp, injects, margin, j.spec.profile_max_recovery_s,
                    lanes=range(off, off + len(lanes)))
                L, R = scatter_profile_results(
                    lanes, meas, len(j.runtime.steady.failure_times),
                    len(grid))
                j.runtime.run_profiling(_PrecomputedCampaign(L, R),
                                        ci_values=grid, margin=margin)
                self.registry.put(j.fp, j.runtime.m_l, j.runtime.m_r, j.name)
                off += len(lanes)
        return {"jobs_profiled": len(cold), "pooled_lanes": total_lanes}

    # -- Phase 3, multiplexed -------------------------------------------------
    def start(self) -> None:
        """Enter Phase 3 for every profiled job: build the shared
        supervision campaign(s) — one lane per lane-substrate job, grouped
        by cost model — instantiate scalar sims, and ``attach`` every
        job's handle to its runtime."""
        assert not self._started, "start() already ran"
        ready = [j for j in self.jobs.values()
                 if j.runtime is not None and j.runtime.phase == "profiled"]
        lane_groups: dict[tuple, list[FleetJob]] = {}
        for j in ready:
            if j.spec.substrate == "lane":
                lane_groups.setdefault(_cost_key(j.spec.cost), []).append(j)
        for key, members in lane_groups.items():
            lanes = []
            for i, j in enumerate(members):
                n = int(j.spec.horizon_s)
                rates = dense_rates(0.0, n, recording=None,
                                    schedule=j.spec.schedule) \
                    if j.spec.schedule is not None else \
                    dense_rates(float(j.recording.times[0]), n,
                                recording=j.recording)
                t0 = 0.0 if j.spec.schedule is not None \
                    else float(j.recording.times[0])
                lanes.append(LaneSpec(
                    rates=rates, ci_s=self._initial_ci(j), t0=t0,
                    failures=tuple(j.spec.failures),
                    tag={"job": j.name}))
                j.lane = i
            # hot reconfiguration on the supervised substrate (same choice
            # as the drive_campaign benches): a controller-in-the-loop
            # plan switch must not pay a savepoint-restart, or every
            # post-failure reconfigure compounds the very backlog it is
            # trying to drain
            camp = make_campaign(members[0].spec.cost, lanes,
                                 engine=self.engine, device=self.device,
                                 flink_semantics=False)
            self._campaigns[key] = camp
            for j in members:
                j.campaign = camp
                j.handle = BatchedLaneHandle(camp, j.lane)
        for j in ready:
            if j.spec.substrate == "scalar":
                sim = StreamSimulator(j.spec.cost,
                                      ci_s=self._initial_ci(j),
                                      schedule=j.spec.schedule,
                                      recording=j.spec.recording,
                                      seed=j.spec.seed)
                for t, kind in j.spec.failures:
                    sim.inject_failure(float(t), kind)
                j.sim = sim
                j.handle = SimJobHandle(sim)
            elif j.spec.substrate == "handle":
                j.handle = j.spec.handle
            j.runtime.attach(j.handle)
            j.status = "optimizing"
        self._started = True

    def _initial_ci(self, job: FleetJob) -> float:
        """Eq.-8 optimum at the recorded mean rate, falling back to the
        grid midpoint when infeasible there."""
        tr = float(np.mean(job.recording.counts)) if job.recording is not \
            None else 0.0
        ci = job.runtime.initial_ci(tr) if tr > 0 else None
        cfg = job.spec.cfg
        return float(ci) if ci is not None else \
            0.5 * (cfg.ci_min + cfg.ci_max)

    def run(self, duration_s: float, chunk_s: float = 60.0) -> dict:
        """The multiplexed controller tick: advance every substrate by
        ``chunk_s`` fleet-seconds, then poll every optimizing job's
        controller once, feed the monitor plane, and let divergence
        watchdogs trip transferred jobs into ``reprofile()``."""
        assert self._started, "call start() first"
        t_end = self.t + duration_s
        while self.t < t_end:
            self.t += chunk_s
            for camp in self._campaigns.values():
                if not camp.done:
                    camp.run(n_ticks=int(chunk_s))
            n_live = 0
            lat_sum = 0.0
            for j in self.jobs.values():
                if j.status != "optimizing":
                    continue
                if j.spec.substrate == "scalar":
                    j.sim.run_until(self.t)
                elif j.spec.substrate == "handle" and j.spec.ticker:
                    j.spec.ticker(chunk_s)
                dec = j.runtime.step()
                if dec is not None and np.isfinite(dec.latency) \
                        and np.isfinite(dec.tr_avg):
                    # the controller just measured this window — reuse
                    # its observations instead of slicing twice
                    lat, tr = dec.latency, dec.tr_avg
                else:
                    lat = j.handle.avg_latency(
                        j.spec.cfg.optimization_period)
                    tr = j.handle.avg_throughput(
                        j.spec.cfg.optimization_period)
                if np.isfinite(lat):
                    self.metrics.record(f"{j.name}/latency", self.t, lat)
                    lat_sum += lat
                    n_live += 1
                if np.isfinite(tr):
                    self.metrics.record(f"{j.name}/throughput", self.t, tr)
                self._feed_watchdog(j, lat, tr, fresh_poll=dec is not None)
                if j.spec.substrate == "lane" and j.campaign.done:
                    self._finish(j)
                elif j.spec.substrate == "scalar" and \
                        self.t >= j.spec.horizon_s:
                    self._finish(j)
            if n_live:
                self.metrics.record("fleet/latency", self.t,
                                    lat_sum / n_live)
            self.metrics.record("fleet/jobs_optimizing", self.t,
                                float(n_live))
        return self.status()

    def _feed_watchdog(self, job: FleetJob, lat: float, tr: float,
                       fresh_poll: bool = False) -> None:
        """Compare the adopted M_L against the observed latency; a
        sustained divergence means the donor surface does not describe
        this job — fall back to a REAL reprofile (the legal Phase-2
        re-entry), disarm the watchdog, and file the self-fitted models
        so the registry heals."""
        if job.watchdog is None or not np.isfinite(lat) \
                or not np.isfinite(tr):
            return
        if not job.handle.healthy():
            # downtime + backlog drain is chaos, not model divergence —
            # the same freeze the runtime's anomaly detector applies to
            # unhealthy samples (``observe_metrics(healthy=False)``)
            job.watchdog.reset()
            return
        if job.handle.current_plan().name != CheckpointPlan().name:
            # the fitted surfaces (donor's AND a cold job's own) are
            # measured under the full-sync baseline; once the controller
            # switches the checkpoint mechanism, a misprediction can no
            # longer separate "donor surface wrong for this job" from
            # "any baseline-fitted surface wrong for this plan" — the
            # cold twin's self-fitted M_L mispredicts identically.
            # Divergence judgment is only valid in the surface's domain.
            job.watchdog.reset()
            return
        rt = job.runtime
        pred = rt.controller.last_pred_lat if fresh_poll else float("nan")
        if not np.isfinite(pred):
            # no fresh controller evaluation this poll — pay our own
            pred = float(rt.m_l.predict(
                np.array([float(job.handle.current_ci())]),
                np.array([tr]))[0])
        if job.watchdog.observe(lat, pred):
            rt.reprofile(reason="transfer-divergence")
            job.reprofiles += 1
            job.transferred = False
            job.watchdog = None
            self.registry.put(job.fp, rt.m_l, rt.m_r, job.name)

    def _finish(self, job: FleetJob) -> None:
        job.status = "done"
        self.reserved_eps -= job.admission.reserved_eps

    # -- monitor-plane queries -----------------------------------------------
    def qos_violations(self, name: str, l_const: Optional[float] = None,
                       r_const: Optional[float] = None) -> dict:
        """QoS-violation seconds for one supervised lane job."""
        j = self.jobs[name]
        assert j.spec.substrate == "lane" and j.campaign is not None, \
            "violation scoring reads lane histories"
        cfg = j.spec.cfg
        return lane_violation_seconds(
            j.campaign, j.lane,
            cfg.latency_constraint if l_const is None else l_const,
            cfg.recovery_constraint if r_const is None else r_const)

    def status(self) -> dict:
        kinds: dict[str, int] = {}
        for _label, d in self.decision_log:
            kinds[d.kind] = kinds.get(d.kind, 0) + 1
        return {
            "t": self.t,
            "jobs": {n: {
                "status": j.status,
                "phase": j.runtime.phase if j.runtime else None,
                "admission": j.admission.action,
                "transferred": j.transferred,
                "transfer_source": j.transfer_source,
                "profiling_lane_ticks": j.profiling_lane_ticks,
                "reprofiles": j.reprofiles,
            } for n, j in self.jobs.items()},
            "reserved_eps": self.reserved_eps,
            "residual_eps": self.residual_eps,
            "decisions_by_kind": kinds,
            "shared_campaigns": len(self._campaigns),
        }
