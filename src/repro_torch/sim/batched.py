"""Lane-batched chaos campaigns — the vectorized twin of StreamSimulator
(a copy of the JAX package's ``repro.sim.batched``, statement for
statement: the lanes equal the reference's bit for bit).

Khaos exploits "the parallel processing capabilities of virtual cloud
automation" to run many chaos experiments concurrently (paper §III-C).
This module maps the paper's parallel VMs onto ARRAY LANES: one
``BatchedCampaign`` advances N independent simulator lanes (CI grid x
failure-kind mix x worst-case injection points x mechanism variants x
workload schedules) with one fused NumPy tick over all lanes.  Per-lane
state — ``(t, lag, offset_by_level, ckpt_in_flight, recovery_state)`` — is
held as ``(N,)`` / ``(N, 3)`` arrays; λ(t) schedules are precomputed into
dense per-tick rate matrices (``data.stream.dense_rates``) so the hot loop
contains no per-tick Python calls at all.

The scalar ``StreamSimulator`` stays as the oracle: every update below
mirrors its ``tick``/``_begin_failure`` statement-for-statement IN THE
SAME FLOATING-POINT ORDER, so a fixed-seed lane reproduces its scalar twin
bit-for-bit (tests/test_torch_batched_sim.py asserts it against the
reference engine).  On top of the raw engine sit:

  * ``BatchedDeployment`` — the Phase-2 profiler substrate that runs all
    z CIs x m failure points as lanes of ONE campaign;
  * ``make_plan_verifier`` — the ``optimize_plan`` simulate-to-verify hook
    that replays top-k plan candidates through a campaign instead of
    trusting re-priced QoS surfaces alone;
  * ``BatchedLaneHandle`` — the full ``core.controller.JobHandle`` over
    ONE lane, with real per-lane actuation (``lane_set_ci``/
    ``lane_set_plan`` mirror the scalar ``set_ci``/``set_plan`` savepoint
    + restart statement-for-statement), so ``KhaosRuntime.drive_campaign``
    runs Phase 3 controller-IN-THE-LOOP across every lane at once.

Lane-level early exit: ``run`` periodically COMPACTS finished lanes out of
the array state — terminal lanes (past their own horizon) always,
recovered chaos lanes too when ``early_exit=True`` — so mixed-horizon
grids stop paying the longest lane's tail.  Compaction is invisible to
results: dropped lanes' final state is parked in full-size master arrays
and scattered back on completion, and per-lane arithmetic is elementwise,
so fixed-seed lanes stay bit-exact against their scalar twins.
``compactions``/``lanes_compacted`` count the events.

This engine is the middle tier of the sim package's three-engine
hierarchy: ``StreamSimulator`` (the scalar oracle — authoritative for
tick SEMANTICS) -> ``BatchedCampaign`` (NumPy lanes — authoritative for
the vectorized floating-point ORDER, bit-exact against the oracle) ->
``sim.device.DeviceCampaign`` (the torch engine: the same tick on f64
tensors on the CUDA device for 10^5+-lane mega-campaigns, bit-exact
against THIS engine).  Campaign consumers select a tier with
``make_campaign(..., engine=)`` / ``BatchedDeployment(engine=)`` /
``make_plan_verifier(engine=)``; ``device=`` names the torch device of
the device engine (default: the CUDA device).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from math import lcm
from typing import Optional, Sequence

import numpy as np

from repro_torch.config import CheckpointPlan
from repro_torch.data.stream import (RateSchedule, WorkloadRecording,
                                     dense_rates)
from repro_torch.ft.failures import (DEGRADATION_KINDS, DIRECTIONS,
                                     Degradation, FailureInjector,
                                     jitter_phase)
from repro_torch.sim.costmodel import SimCostModel

#: fixed level order; column index == level, ordered fastest-restore first
#: (matches simulator._LEVEL_SPEED: memory=2, local=1, remote=0)
LEVELS = ("memory", "local", "remote")
KINDS = ("task", "node", "cluster")
_KIND_ID = {k: i for i, k in enumerate(KINDS)}
# gray failures ride a separate event stream: they never touch the
# wipe/survival/restore tables (the job stays up), they bend the tick
# dynamics through per-lane window state instead
_DEG_ID = {k: i for i, k in enumerate(DEGRADATION_KINDS)}
_DIR_ID = {d: i for i, d in enumerate(DIRECTIONS)}
# NOTE: the per-kind wipe/survival/restore tables are PER PLAN now — the
# replication factor decides whether a node failure takes the local level
# with it — so they live in ``_PlanTable`` (built from the same
# ``cost.wiped_levels``/``restore_duration_for`` the scalar oracle calls)
# instead of module-level constants.


@dataclass
class LaneSpec:
    """One scenario lane: a (CI, plan, workload, injection) combination.

    ``rates`` is the dense per-tick λ array starting at ``t0`` (tick = 1s);
    build it with ``data.stream.dense_rates`` / ``WorkloadRecording.
    rates_until``.  ``failures`` are (time, kind) injections, matching
    ``StreamSimulator.inject_failure``.  ``tag`` is free-form caller
    bookkeeping (e.g. which (ci, failure-point) cell the lane measures).
    """
    rates: np.ndarray
    ci_s: float = 60.0
    t0: float = 0.0
    plan: Optional[CheckpointPlan] = None
    failures: Sequence[tuple[float, str]] = ()
    degradations: Sequence[Degradation] = ()
    tag: Optional[dict] = None

    def resolved_plan(self, cost: SimCostModel) -> CheckpointPlan:
        # identical plan resolution to StreamSimulator.__init__
        return replace(self.plan or CheckpointPlan(sync=not cost.async_mode),
                       interval_s=self.ci_s)


class _PlanTable:
    """Per-distinct-plan pricing, precomputed once per campaign.

    Trigger durations / level routing are produced by the SAME cost-model
    methods the scalar simulator calls per trigger
    (``trigger_write_duration`` / ``levels_due``), folded over one cadence
    period (lcm of the every-Nth counts) into dense lookup tables the tick
    loop gathers from.
    """

    def __init__(self, cost: SimCostModel, plans: list[CheckpointPlan]):
        P = len(plans)
        self.plans = plans
        self.names = [p.name for p in plans]
        self.period = np.array(
            [lcm(max(p.full_every, 1), max(p.local_every, 1),
                 max(p.remote_every, 1)) for p in plans], dtype=np.int64)
        maxp = int(self.period.max()) if P else 1
        self.trig_dur = np.zeros((P, maxp))
        self.trig_lvls = np.zeros((P, maxp, 3), dtype=bool)
        self.sync = np.array([p.sync for p in plans], dtype=bool)
        self.level_mask = np.zeros((P, 3), dtype=bool)   # plan.levels, by column
        # restore duration is (plan, KIND, level): a node failure restoring
        # from replicated level-2 is a degraded partial restore with its
        # own price (cost.restore_duration_for)
        self.restore_dur = np.zeros((P, len(KINDS), 3))
        self.cold_restore = np.zeros(P)
        self.surviving = np.zeros((P, len(KINDS), 3), dtype=bool)
        # levels each kind destroys under this plan (replication-derived)
        self.wipes = np.zeros((P, len(KINDS), 3), dtype=bool)
        for pi, plan in enumerate(plans):
            for level in plan.levels:
                self.level_mask[pi, LEVELS.index(level)] = True
            for i in range(int(self.period[pi])):
                self.trig_dur[pi, i] = max(
                    cost.trigger_write_duration(plan, i), 1e-3)
                for level, _kind in plan.levels_due(i):
                    self.trig_lvls[pi, i, LEVELS.index(level)] = True
            for ki, kind in enumerate(KINDS):
                for li, level in enumerate(LEVELS):
                    self.restore_dur[pi, ki, li] = \
                        cost.restore_duration_for(plan, kind, level)
                for level in cost.surviving_levels(plan, kind):
                    self.surviving[pi, ki, LEVELS.index(level)] = True
                for level in cost.wiped_levels(plan, kind):
                    self.wipes[pi, ki, LEVELS.index(level)] = True
            self.cold_restore[pi] = cost.restore_duration("remote")


class BatchedCampaign:
    """N independent StreamSimulator lanes advanced by one fused tick.

    All lanes share one ``SimCostModel``; everything else (CI, plan,
    workload, t0, injections) varies per lane.  ``run()`` advances every
    lane to the end of its rate array; per-lane results are then read from
    the history matrices (``lag_history`` and the derived
    ``latency_history``) and the ``recoveries`` lists, which carry the same
    records ``StreamSimulator.recoveries`` does.

    ``flink_semantics`` governs the per-lane actuation (``lane_set_ci``/
    ``lane_set_plan``): savepoint + controlled restart (the scalar
    default) vs hot swap.  ``early_exit=True`` additionally lets the
    periodic compaction (every ``compact_every`` ticks) retire lanes whose
    chaos is fully resolved — all injections fired and recovered — before
    their horizon; lag histories and event tallies of retired lanes are
    then truncated at retirement, so leave it off when post-hoc
    trajectory measurement (``measure_profile_lanes``) must cover the
    full horizon.
    """

    def __init__(self, cost: SimCostModel, lanes: Sequence[LaneSpec],
                 record_history: bool = True, flink_semantics: bool = True,
                 early_exit: bool = False, compact_every: int = 256):
        assert lanes, "a campaign needs at least one lane"
        self.cost = cost
        self.lanes = list(lanes)
        self.flink_semantics = flink_semantics
        self.early_exit = early_exit
        self.compact_every = int(compact_every)
        N = self.n_lanes = len(self.lanes)
        self._ar = np.arange(N)

        # -- plan tables (dedup by value; interval is a per-lane array) -----
        resolved = [l.resolved_plan(cost) for l in self.lanes]
        keys = [replace(p, interval_s=0.0, levels=tuple(p.levels))
                for p in resolved]
        uniq: dict = {}
        self.plan_id = np.zeros(N, dtype=np.int64)
        for i, k in enumerate(keys):
            self.plan_id[i] = uniq.setdefault(k, len(uniq))
        self._plan_keys = uniq              # grows when lane_set_plan adds one
        self.table = _PlanTable(cost, list(uniq.keys()))
        self.lane_plan_name = [self.table.names[pid] for pid in self.plan_id]
        self._period = self.table.period[self.plan_id]
        self._sync = self.table.sync[self.plan_id]

        # -- dense λ matrix, padded past each lane's horizon ----------------
        # time-major layout: the per-step row read/write is contiguous
        self.lane_ticks = np.array([len(l.rates) for l in self.lanes],
                                   dtype=np.int64)
        T = self.horizon = int(self.lane_ticks.max())
        self._min_ticks = int(self.lane_ticks.min())
        self._rates_tm = np.zeros((T, N))
        for i, l in enumerate(self.lanes):
            r = np.asarray(l.rates, dtype=np.float64)
            self._rates_tm[:len(r), i] = r
            if len(r) < T and len(r):
                self._rates_tm[len(r):, i] = r[-1]

        # -- per-lane scalar-simulator state --------------------------------
        self.t0 = np.array([l.t0 for l in self.lanes])
        self.t = self.t0.copy()
        self.interval = np.array([l.ci_s for l in self.lanes])
        self.lag = np.zeros(N)
        self.produced = np.zeros(N)
        self.consumed = np.zeros(N)
        self.processed_total = np.zeros(N)   # scalar: throughput-series sum
                                             # (consumed net of rollbacks)
        self.pol_last = self.t0.copy()            # CheckpointPolicy.reset(t0)
        self.off_lvl = np.zeros((N, 3))           # offset_by_level
        self.last_off = np.zeros(N)
        self.ck_active = np.zeros(N, dtype=bool)  # ckpt_in_progress is not None
        self.ck_end = np.zeros(N)
        self.ck_off = np.zeros(N)
        self.ck_lvls = np.zeros((N, 3), dtype=bool)
        self.ckpt_count = np.zeros(N, dtype=np.int64)
        self.save_count = np.zeros(N, dtype=np.int64)
        self.down = np.zeros(N, dtype=bool)       # down_until is not None
        self.down_until = np.zeros(N)
        self.pending_ro = np.zeros(N)
        self.steady_lag = np.zeros(N)
        # active-failure bookkeeping (scalar's _active_failure dict)
        self.af_active = np.zeros(N, dtype=bool)
        self.af_t0 = np.zeros(N)
        self.af_kind = np.zeros(N, dtype=np.int64)
        self.af_ci = np.zeros(N)
        self.af_level = np.full(N, -1, dtype=np.int64)
        self.recoveries: list[list[dict]] = [[] for _ in range(N)]

        # -- injections: (N, K) time/kind arrays, +inf padded ---------------
        K = max(1, max((len(l.failures) for l in self.lanes), default=1))
        self.fail_t = np.full((N, K), np.inf)
        self.fail_kind = np.zeros((N, K), dtype=np.int64)
        self._n_fail = K
        for i, l in enumerate(self.lanes):
            for j, (ft, kind) in enumerate(sorted(l.failures)):
                self.fail_t[i, j] = ft
                self.fail_kind[i, j] = _KIND_ID[kind]
        self.fptr = np.zeros(N, dtype=np.int64)
        self._next_fail = self.fail_t[:, 0].copy()   # fail_t[i, fptr[i]] cache

        # -- gray-failure injections: per-lane event queues + window state --
        # (mirrors StreamSimulator.degradations / dg_* scalars exactly)
        D = max(1, max((len(l.degradations) for l in self.lanes), default=1))
        self.deg_t = np.full((N, D), np.inf)
        self.deg_kind = np.zeros((N, D), dtype=np.int64)
        self.deg_dur = np.zeros((N, D))
        self.deg_sev = np.zeros((N, D))
        self.deg_jit = np.zeros((N, D))
        self.deg_dir = np.zeros((N, D), dtype=np.int64)
        self._n_deg = D
        for i, l in enumerate(self.lanes):
            for j, d in enumerate(sorted(l.degradations, key=lambda d: d.t)):
                self.deg_t[i, j] = d.t
                self.deg_kind[i, j] = _DEG_ID[d.kind]
                self.deg_dur[i, j] = d.duration_s
                self.deg_sev[i, j] = d.severity
                self.deg_jit[i, j] = d.jitter_s
                self.deg_dir[i, j] = _DIR_ID[d.direction]
        self.dptr = np.zeros(N, dtype=np.int64)
        self._next_deg = self.deg_t[:, 0].copy()
        self._any_deg = bool(np.isfinite(self.deg_t).any())
        self.dg_cap_scale = np.ones(N)
        self.dg_cap_until = np.full(N, -np.inf)
        self.dg_ck_delay = np.zeros(N)
        self.dg_ck_jitter = np.zeros(N)
        self.dg_ck_t0 = np.zeros(N)
        self.dg_ck_until = np.full(N, -np.inf)
        self.dg_lat_delay = np.zeros(N)
        self.dg_lat_jitter = np.zeros(N)
        self.dg_lat_t0 = np.zeros(N)
        self.dg_lat_until = np.full(N, -np.inf)
        self.dg_bp_until = np.full(N, -np.inf)
        self.bp_suppressed = np.zeros(N, dtype=np.int64)

        self.record_history = record_history
        self._lag_hist_tm = np.zeros((T, N)) if record_history else None
        # to-source net delay inflates reported latency without touching
        # lag; its per-tick penalty needs its own history column so the
        # derived latency_history stays exact (allocated only when a lane
        # actually carries one)
        lat_deg = any(d.kind == "net_delay" and d.direction == "to_source"
                      for l in self.lanes for d in l.degradations)
        self._lat_extra_tm = np.zeros((T, N)) \
            if (record_history and lat_deg) else None
        self._step_idx = 0
        # hoisted per-step constants
        self._mu_ck = np.where(
            self._sync, cost.capacity_eps * (1.0 - cost.ckpt_sync_penalty),
            cost.capacity_eps * (1.0 - cost.async_overhead))
        self._all = np.ones(N, dtype=bool)

        # -- compaction state (lane-level early exit) -----------------------
        # working arrays hold only the ACTIVE lanes; `_active` maps compact
        # column -> original lane index, `_pos` the inverse (-1 = retired).
        # `_final` (allocated at first compaction) parks full-size masters
        # that retired lanes' terminal state is scattered into; on
        # completion `_finalize` restores every public array to full size
        # in original lane order, so results are read exactly as before.
        self._active = np.arange(N)
        self._pos = np.arange(N)
        self._final: Optional[dict] = None
        self._finished = False
        self._exec_override = np.full(N, -1, dtype=np.int64)
        self._had_fail = np.isfinite(self.fail_t).any(axis=1)
        self._t0_all = self.t0
        self._lane_ticks_all = self.lane_ticks
        self.compactions = 0
        self.lanes_compacted = 0

    #: per-lane working arrays compaction slices / finalize restores
    _PER_LANE = ("lane_ticks", "t0", "t", "interval", "lag", "produced",
                 "consumed", "processed_total",
                 "pol_last", "off_lvl", "last_off", "ck_active",
                 "ck_end", "ck_off", "ck_lvls", "ckpt_count", "save_count",
                 "down", "down_until", "pending_ro", "steady_lag",
                 "af_active", "af_t0", "af_kind", "af_ci", "af_level",
                 "plan_id", "_period", "_sync", "_mu_ck",
                 "fail_t", "fail_kind", "fptr", "_next_fail", "_had_fail",
                 "deg_t", "deg_kind", "deg_dur", "deg_sev", "deg_jit",
                 "deg_dir", "dptr", "_next_deg",
                 "dg_cap_scale", "dg_cap_until", "dg_ck_delay",
                 "dg_ck_jitter", "dg_ck_t0", "dg_ck_until", "dg_lat_delay",
                 "dg_lat_jitter", "dg_lat_t0", "dg_lat_until",
                 "dg_bp_until", "bp_suppressed")

    # -- compaction -----------------------------------------------------
    def _refresh_lane_cache(self) -> None:
        n = self._active.size
        self._ar = np.arange(n)
        self._all = np.ones(n, dtype=bool)
        self._min_ticks = int(self.lane_ticks.min()) if n else 0

    def _maybe_compact(self) -> None:
        if not self._active.size:
            return
        drop = self._step_idx >= self.lane_ticks          # past own horizon
        if self.early_exit:
            # chaos resolved: every injection fired and recovered, no
            # degradation pending or still bending capacity
            drop = drop | (self._had_fail & np.isinf(self._next_fail)
                           & ~self.down & ~self.af_active
                           & np.isinf(self._next_deg)
                           & (self.t >= self.dg_cap_until))
        nd = int(drop.sum())
        if nd == 0 or nd * 8 < drop.size:                 # amortize copies
            return
        self._compact(drop)

    def _compact(self, drop: np.ndarray) -> None:
        full_idx = self._active
        dropped = full_idx[drop]
        self._exec_override[dropped] = np.minimum(self.lane_ticks[drop],
                                                  self._step_idx)
        if self._final is None:
            # first compaction: the working arrays ARE the full-size
            # masters — park them (retired entries keep terminal values)
            self._final = {n: getattr(self, n) for n in self._PER_LANE}
            self._final["_rates_tm"] = self._rates_tm
        else:
            for n in self._PER_LANE:
                self._final[n][full_idx] = getattr(self, n)
            # λ columns are immutable: the master already holds every lane
        self._active = full_idx[~drop]
        self._pos = np.full(self.n_lanes, -1, dtype=np.int64)
        self._pos[self._active] = np.arange(self._active.size)
        for n in self._PER_LANE:
            setattr(self, n, self._final[n][self._active].copy())
        self._rates_tm = np.ascontiguousarray(
            self._final["_rates_tm"][:, self._active])
        self._refresh_lane_cache()
        self.compactions += 1
        self.lanes_compacted += len(dropped)

    def _finalize(self) -> None:
        """Restore full-size arrays in original lane order once stepping is
        over (results are then indexed exactly as in a compaction-free
        run)."""
        if self._finished:
            return
        self._finished = True
        if self._final is None:
            return
        full_idx = self._active
        for n in self._PER_LANE:
            self._final[n][full_idx] = getattr(self, n)
            setattr(self, n, self._final[n])
        self._rates_tm = self._final["_rates_tm"]
        self._final = None
        self._active = np.arange(self.n_lanes)
        self._pos = np.arange(self.n_lanes)
        self._refresh_lane_cache()

    def _lane_value(self, name: str, lane: int):
        """Read a per-lane field by ORIGINAL lane index, live or retired."""
        pos = int(self._pos[lane])
        if pos >= 0:
            return getattr(self, name)[pos]
        return self._final[name][lane]

    # ------------------------------------------------------------------
    def _begin_failure(self, mask: np.ndarray, kind: np.ndarray,
                       ev_t: np.ndarray) -> None:
        """Vectorized StreamSimulator._begin_failure for lanes in ``mask``
        (already-down lanes consume the event but take no action).
        ``ev_t`` is the injection instant — possibly fractional, strictly
        earlier than the tick that pops it, exactly as the scalar event."""
        act = mask & ~self.down
        if not act.any():
            return
        cost, tbl = self.cost, self.table
        self.ck_active &= ~act       # in-flight checkpoint dies with the job
        surv = tbl.surviving[self.plan_id, kind]          # (N, 3)
        offs = np.where(surv, self.off_lvl, -np.inf)
        best = offs.max(axis=1)
        has = surv.any(axis=1)
        # columns are ordered fastest-first, so first argmax == the scalar's
        # max((offset, speed, level)) tie-break toward the fastest level
        lvl = np.argmax(offs == best[:, None], axis=1)
        restore = np.where(has, tbl.restore_dur[self.plan_id, kind, lvl],
                           tbl.cold_restore[self.plan_id])
        offset = np.where(has, best, 0.0)
        # the failure destroys the levels it doesn't survive at (per-plan:
        # replication decides whether node loss takes local disk)
        wipe = tbl.wipes[self.plan_id, kind]              # (N, 3)
        self.off_lvl = np.where(act[:, None] & wipe, 0.0, self.off_lvl)
        self.down_until = np.where(
            act, ev_t + cost.detect_s + cost.restart_s + restore,
            self.down_until)
        self.pending_ro = np.where(act, offset, self.pending_ro)
        self.down |= act
        self.af_active |= act
        self.af_t0 = np.where(act, ev_t, self.af_t0)
        self.af_kind = np.where(act, kind, self.af_kind)
        self.af_ci = np.where(act, self.interval, self.af_ci)
        self.af_level = np.where(act, np.where(has, lvl, -1), self.af_level)

    def _begin_degradation(self, mask: np.ndarray, cur: np.ndarray) -> None:
        """Vectorized StreamSimulator._begin_degradation for lanes in
        ``mask``: activate each lane's current queued window (last-writer
        semantics on overlap, exactly as the scalar's sorted pop)."""
        ar = self._ar
        kind = self.deg_kind[ar, cur]
        ev_t = self.deg_t[ar, cur]
        until = ev_t + self.deg_dur[ar, cur]
        sev = self.deg_sev[ar, cur]
        jit = self.deg_jit[ar, cur]
        dirn = self.deg_dir[ar, cur]
        m = mask & (kind == _DEG_ID["straggler"])
        if m.any():
            self.dg_cap_scale = np.where(
                m, self.cost.straggler_capacity_scale(sev),
                self.dg_cap_scale)
            self.dg_cap_until = np.where(m, until, self.dg_cap_until)
        nd = mask & (kind == _DEG_ID["net_delay"])
        m = nd & (dirn == _DIR_ID["to_ckpt_store"])
        if m.any():
            self.dg_ck_delay = np.where(m, sev, self.dg_ck_delay)
            self.dg_ck_jitter = np.where(m, jit, self.dg_ck_jitter)
            self.dg_ck_t0 = np.where(m, ev_t, self.dg_ck_t0)
            self.dg_ck_until = np.where(m, until, self.dg_ck_until)
        m = nd & (dirn == _DIR_ID["to_source"])
        if m.any():
            self.dg_lat_delay = np.where(m, sev, self.dg_lat_delay)
            self.dg_lat_jitter = np.where(m, jit, self.dg_lat_jitter)
            self.dg_lat_t0 = np.where(m, ev_t, self.dg_lat_t0)
            self.dg_lat_until = np.where(m, until, self.dg_lat_until)
        m = mask & (kind == _DEG_ID["backpressure"])
        if m.any():
            self.dg_bp_until = np.where(m, until, self.dg_bp_until)

    def _step(self) -> None:
        k = self._step_idx
        all_alive = k < self._min_ticks
        alive = self._all if all_alive else (k < self.lane_ticks)
        if not all_alive and not alive.any():
            self._step_idx += 1
            return
        t = self.t
        lam = self._rates_tm[k] if all_alive \
            else np.where(alive, self._rates_tm[k], 0.0)
        self.produced += lam

        # pending failures (cheap compare against the cached next event)
        if self._n_fail:
            while True:
                pend = self._next_fail <= t
                if not all_alive:
                    pend &= alive
                if not pend.any():
                    break
                cur = np.minimum(self.fptr, self._n_fail - 1)
                self._begin_failure(pend, self.fail_kind[self._ar, cur],
                                    self._next_fail)
                self.fptr = np.where(pend, self.fptr + 1, self.fptr)
                nxt = np.minimum(self.fptr, self._n_fail - 1)
                self._next_fail = np.where(
                    self.fptr < self._n_fail, self.fail_t[self._ar, nxt],
                    np.inf)

        # pending gray-failure windows (mirrors the scalar's second pop)
        if self._any_deg:
            while True:
                pend = self._next_deg <= t
                if not all_alive:
                    pend &= alive
                if not pend.any():
                    break
                cur = np.minimum(self.dptr, self._n_deg - 1)
                self._begin_degradation(pend, cur)
                self.dptr = np.where(pend, self.dptr + 1, self.dptr)
                nxt = np.minimum(self.dptr, self._n_deg - 1)
                self._next_deg = np.where(
                    self.dptr < self._n_deg, self.deg_t[self._ar, nxt],
                    np.inf)

        down_any = self.down.any()
        if down_any:
            down = self.down if all_alive else (alive & self.down)
            up = ~self.down if all_alive else (alive & ~self.down)
            # job down: arrivals accumulate, nothing processed
            self.lag = np.where(down, self.lag + lam, self.lag)
            restart = down & (t >= self.down_until)
            if restart.any():
                # restart completes: roll back to checkpointed offset
                # (parenthesized as the scalar's `lag += consumed - ro` so
                # the FP rounding matches bit-for-bit)
                rb = restart & (self.pending_ro < self.consumed)
                self.lag = np.where(rb, self.lag + (self.consumed
                                                    - self.pending_ro),
                                    self.lag)
                self.consumed = np.where(rb, self.pending_ro, self.consumed)
                self.down &= ~restart
                self.pol_last = np.where(restart, t, self.pol_last)
        else:
            up = alive

        up_all = all_alive and not down_any    # every mask below collapses
        if down_any and not up.any():
            pass
        else:
            # checkpoint completion: commit the offset at every level the
            # trigger wrote (sparse — only the few completing lanes touched)
            comp = (t >= self.ck_end) & self.ck_active if up_all \
                else up & self.ck_active & (t >= self.ck_end)
            ci_ = np.flatnonzero(comp)
            if ci_.size:
                off = self.ck_off[ci_]
                self.off_lvl[ci_] = np.where(self.ck_lvls[ci_], off[:, None],
                                             self.off_lvl[ci_])
                self.last_off[ci_] = np.maximum(self.last_off[ci_], off)
                self.ckpt_count[ci_] += 1
                self.ck_active[ci_] = False
            # checkpoint start: levels due at this trigger index define the
            # composite write's duration (gathered from the plan table)
            due = (t - self.pol_last >= self.interval) & ~self.ck_active
            if not up_all:
                due &= up
            if self._any_deg:
                # backpressured lanes: the barrier cannot propagate, the
                # trigger slips past its cadence slot (counted per lane)
                bp = due & (t < self.dg_bp_until)
                if bp.any():
                    self.bp_suppressed += bp
                    due &= ~bp
            di = np.flatnonzero(due)
            if di.size:
                td = t[di]
                self.pol_last[di] = td
                pid = self.plan_id[di]
                idx = self.save_count[di] % self._period[di]
                self.save_count[di] += 1
                dur = self.table.trig_dur[pid, idx]
                if self._any_deg:
                    ckd = td < self.dg_ck_until[di]
                    if ckd.any():
                        # to-checkpoint-store net delay under the barrier
                        dur = dur + np.where(
                            ckd, self.cost.net_delay_barrier_penalty(
                                self.dg_ck_delay[di], self.dg_ck_jitter[di],
                                jitter_phase(td, self.dg_ck_t0[di])), 0.0)
                # barrier semantics: snapshot the offset at start
                self.ck_end[di] = td + dur
                self.ck_off[di] = self.consumed[di]
                self.ck_lvls[di] = self.table.trig_lvls[pid, idx]
                self.ck_active[di] = True
            # in-flight writes after both transitions == the scalar's
            # per-tick `checkpointing` flag
            checkpointing = self.ck_active if up_all else up & self.ck_active
            if self._any_deg:
                # straggler window expiry + capacity scale (x1.0 exact
                # identity on undegraded lanes, matching the scalar)
                reset = (t >= self.dg_cap_until) if up_all \
                    else (up & (t >= self.dg_cap_until))
                self.dg_cap_scale = np.where(reset, 1.0, self.dg_cap_scale)
                mu = np.where(checkpointing, self._mu_ck,
                              self.cost.capacity_eps) * self.dg_cap_scale
            else:
                mu = np.where(checkpointing, self._mu_ck,
                              self.cost.capacity_eps)
            inflow = self.lag + lam
            if down_any or not all_alive:
                processed = np.where(up, np.minimum(inflow, mu), 0.0)
                self.lag = np.where(up, np.maximum(0.0, inflow - processed),
                                    self.lag)
            else:
                processed = np.minimum(inflow, mu)
                self.lag = np.maximum(0.0, inflow - processed)
            self.consumed += processed
            self.processed_total += processed

        if self._lag_hist_tm is not None:
            if self._final is None:
                self._lag_hist_tm[k] = self.lag
            else:      # compacted: scatter into the full-width history row
                self._lag_hist_tm[k, self._active] = self.lag
        if self._lat_extra_tm is not None:
            la = t < self.dg_lat_until
            if not all_alive:
                la &= alive
            if la.any():
                # to-source net delay: latency penalty recorded alongside
                # lag (the scalar adds it to its per-tick latency metric)
                pen = np.where(la, self.cost.net_delay_latency_penalty(
                    self.dg_lat_delay, self.dg_lat_jitter,
                    jitter_phase(t, self.dg_lat_t0)), 0.0)
                if self._final is None:
                    self._lat_extra_tm[k] = pen
                else:
                    self._lat_extra_tm[k, self._active] = pen

        # recovery bookkeeping (ground truth: lag back to steady envelope)
        if self.af_active.any():
            # EWMA update set decided BEFORE clearing: a lane recovering this
            # tick skips the update (the scalar's if/elif)
            env = self.lag <= np.maximum(2.0 * lam,
                                         1.05 * self.steady_lag + 1.0)
            if not down_any and all_alive:
                upd = ~self.af_active
                near = self.af_active & env
            else:
                settled = ~self.down if all_alive else (alive & ~self.down)
                upd = settled & ~self.af_active
                near = self.af_active & settled & env
            if near.any():
                for i in np.flatnonzero(near):
                    lvl = int(self.af_level[i])
                    oi = int(self._active[i])     # original lane index
                    self.recoveries[oi].append({
                        "t_start": float(self.af_t0[i]),
                        "kind": KINDS[int(self.af_kind[i])],
                        "ci": float(self.af_ci[i]),
                        "restore_level": LEVELS[lvl] if lvl >= 0 else None,
                        "plan": self.lane_plan_name[oi],
                        "t_end": float(t[i]),
                        "recovery_s": float(t[i] - self.af_t0[i]),
                    })
                self.af_active &= ~near
            self.steady_lag = np.where(
                upd, 0.9 * self.steady_lag + 0.1 * self.lag, self.steady_lag)
        elif not down_any and all_alive:
            self.steady_lag *= 0.9
            self.steady_lag += 0.1 * self.lag
        else:
            upd = (~self.down if all_alive else (alive & ~self.down))
            self.steady_lag = np.where(
                upd, 0.9 * self.steady_lag + 0.1 * self.lag, self.steady_lag)

        if all_alive:
            self.t += 1.0          # in-place: nothing holds the old clock
        else:
            self.t = np.where(alive, t + 1.0, t)
        self._step_idx += 1

    def run(self, n_ticks: Optional[int] = None) -> "BatchedCampaign":
        end = self.horizon if n_ticks is None \
            else min(self.horizon, self._step_idx + n_ticks)
        ce = self.compact_every
        while self._step_idx < end and self._active.size:
            self._step()
            if ce and self._step_idx % ce == 0:
                self._maybe_compact()
        if self.done:
            self._finalize()
        return self

    @property
    def done(self) -> bool:
        """True once no lane has work left (horizon reached, or every lane
        retired by compaction)."""
        return (self._finished or self._step_idx >= self.horizon
                or not self._active.size)

    # -- results --------------------------------------------------------
    @property
    def rates(self) -> np.ndarray:
        """(N, T) dense λ matrix (lane-major view of the time-major store)."""
        src = self._final["_rates_tm"] if self._final is not None \
            else self._rates_tm
        return src.T

    @property
    def lag_hist(self) -> Optional[np.ndarray]:
        """(N, T) consumer-lag history, one row per lane."""
        return None if self._lag_hist_tm is None else self._lag_hist_tm.T

    @property
    def ticks_run(self) -> int:
        """Total alive lane-ticks advanced so far (the throughput unit);
        early-exited lanes count the ticks they actually executed."""
        executed = np.where(self._exec_override >= 0, self._exec_override,
                            np.minimum(self._lane_ticks_all, self._step_idx))
        return int(executed.sum())

    def times(self, lane: int) -> np.ndarray:
        """The tick clock of ``lane`` (t values its samples were taken at)."""
        return self._t0_all[lane] + np.arange(int(self._lane_ticks_all[lane]))

    def latency_history(self) -> np.ndarray:
        """(N, T) end-to-end latency, derived exactly as the scalar tick
        derives its 'latency' metric from lag."""
        assert self._lag_hist_tm is not None, \
            "campaign ran with record_history=False"
        steady_mu = max(self.cost.capacity_eps, 1e-9)
        lat = self.cost.base_latency_s + self.lag_hist / steady_mu
        if self._lat_extra_tm is not None:
            lat = lat + self._lat_extra_tm.T   # to-source net-delay penalty
        return lat

    def lane_recovery(self, lane: int) -> Optional[float]:
        """First recorded recovery_s of ``lane`` (scalar: recoveries[0])."""
        r = self.recoveries[lane]
        return float(r[0]["recovery_s"]) if r else None

    def lane_rates(self, lane: int) -> np.ndarray:
        """(T,) dense λ column for an ORIGINAL lane index (valid whether or
        not the lane is currently compacted away — λ is immutable)."""
        src = self._final["_rates_tm"] if self._final is not None \
            else self._rates_tm
        return src[:, lane]

    def lane_plan(self, lane: int) -> CheckpointPlan:
        """The plan currently in force on ``lane`` (original index), with
        its live interval."""
        pid = int(self._lane_value("plan_id", lane))
        ci = float(self._lane_value("interval", lane))
        return replace(self.table.plans[pid], interval_s=ci)

    # -- per-lane actuation (the controller's knobs) --------------------
    def _plan_index(self, plan: CheckpointPlan) -> int:
        """Table id for ``plan``, extending the pricing tables when the
        controller actuates a mechanism the campaign has not seen yet."""
        key = replace(plan, interval_s=0.0, levels=tuple(plan.levels))
        pid = self._plan_keys.get(key)
        if pid is None:
            pid = self._plan_keys.setdefault(key, len(self._plan_keys))
            self.table = _PlanTable(self.cost, list(self._plan_keys.keys()))
        return pid

    def lane_set_ci(self, lane: int, ci_s: float) -> None:
        """Per-lane ``StreamSimulator.set_ci``: hot CI change, or savepoint
        + controlled restart under flink semantics — statement-for-
        statement the scalar actuation, so a controller-in-the-loop lane
        stays bit-exact against its scalar twin.

        Actuating a RETIRED lane (past its horizon and compacted out) is
        an inert no-op: the scalar runtime's post-loop actuation on a
        finished job changes nothing either, so supervisors holding
        ``BatchedLaneHandle``s can keep polling/actuating while the pooled
        campaign compacts finished lanes away."""
        i = int(self._pos[lane])
        if i < 0:
            return
        self.interval[i] = float(ci_s)
        if self.flink_semantics:
            # savepoint immediately, restart; no offset rollback
            self.ck_active[i] = False
            self.last_off[i] = self.consumed[i]
            lvls = self.table.level_mask[self.plan_id[i]]
            self.off_lvl[i, lvls] = self.consumed[i]
            self.down[i] = True
            self.down_until[i] = self.t[i] + self.cost.reconfig_restart_s
            self.pending_ro[i] = self.consumed[i]   # savepoint: nothing lost

    def lane_set_plan(self, lane: int, plan: CheckpointPlan) -> None:
        """Per-lane ``StreamSimulator.set_plan``: controlled mechanism
        switch (savepoint + restart under flink semantics).  Inert on
        retired lanes, exactly as ``lane_set_ci``."""
        i = int(self._pos[lane])
        if i < 0:
            return
        pid = self._plan_index(plan)
        self.ck_active[i] = False      # in-flight write dies with the switch
        # levels absent from the new plan drop their offsets (the scalar
        # rebuilds its offset dict over plan.levels; missing levels read 0)
        self.off_lvl[i, ~self.table.level_mask[pid]] = 0.0
        self.plan_id[i] = pid
        self._period[i] = self.table.period[pid]
        self._sync[i] = self.table.sync[pid]
        self._mu_ck[i] = self.cost.capacity_eps * (
            1.0 - (self.cost.ckpt_sync_penalty if self.table.sync[pid]
                   else self.cost.async_overhead))
        self.lane_plan_name[lane] = self.table.names[pid]
        self.save_count[i] = 0
        self.lane_set_ci(lane, plan.interval_s)


#: campaign engine registry (see the module docstring's three-engine
#: hierarchy); "device" resolves lazily, so importing this module never
#: touches a device
CAMPAIGN_ENGINES = ("numpy", "device")


def make_campaign(cost: SimCostModel, lanes: Sequence[LaneSpec],
                  engine: str = "numpy", device=None,
                  **kwargs) -> BatchedCampaign:
    """Construct a campaign on the requested engine: ``"numpy"`` (the
    ``BatchedCampaign`` reference) or ``"device"`` (the torch
    ``sim.device.DeviceCampaign`` on ``device``, default the CUDA device,
    bit-exact against it).  ``device`` is refused with the NumPy engine."""
    if engine == "device":
        from repro_torch.sim.device import DeviceCampaign
        return DeviceCampaign(cost, lanes, device=device, **kwargs)
    if engine != "numpy":
        raise ValueError(f"unknown campaign engine {engine!r} "
                         f"(expected one of {CAMPAIGN_ENGINES})")
    if device is not None:
        raise ValueError("device= names the device engine's torch device; "
                         "the numpy engine runs on the host")
    return BatchedCampaign(cost, lanes, **kwargs)


class BatchedLaneHandle:
    """``core.controller.JobHandle`` over ONE lane of a running campaign.

    N of these under N independent ``KhaosController`` instances turn a
    fixed-plan campaign into a controller-IN-THE-LOOP one
    (``core.runtime.KhaosRuntime.drive_campaign``): the campaign advances
    all lanes with the fused tick, and at optimization-period boundaries
    each lane's controller observes its windows and actuates its knobs —
    the vectorized twin of the scalar ``SimJobHandle`` loop.  Requires the
    campaign to record history (the latency window reads it).
    """

    def __init__(self, camp: BatchedCampaign, lane: int):
        assert camp._lag_hist_tm is not None, \
            "controller-in-the-loop lanes need record_history=True"
        self.camp = camp
        self.lane = int(lane)
        self.reconfigurations: list[tuple[float, float]] = []
        self.plan_changes: list[tuple[float, str]] = []

    def alive(self) -> bool:
        """Lane still stepping (not past its horizon, not compacted out)."""
        i = int(self.camp._pos[self.lane])
        return i >= 0 and self.camp._step_idx < int(self.camp.lane_ticks[i])

    # -- observation ----------------------------------------------------
    def now(self) -> float:
        return float(self.camp._lane_value("t", self.lane))

    def current_ci(self) -> float:
        return float(self.camp._lane_value("interval", self.lane))

    def current_plan(self) -> CheckpointPlan:
        return self.camp.lane_plan(self.lane)

    def _window(self, window_s: float) -> slice:
        """Sample indices with t in [now - window, now] — the same
        inclusive window ``TimeSeries.mean_over`` resolves for the scalar
        handle (samples land on the tick clock t0 + k)."""
        camp, lane = self.camp, self.lane
        n = min(camp._step_idx, int(camp._lane_ticks_all[lane]))
        t_now = self.now()
        t0 = float(camp._t0_all[lane])
        lo = max(0, int(np.ceil(t_now - window_s - t0)))
        hi = min(n, int(np.floor(t_now - t0)) + 1)
        return slice(lo, max(lo, hi))

    def avg_latency(self, window_s: float) -> float:
        camp = self.camp
        sl = self._window(window_s)
        lag = camp._lag_hist_tm[sl, self.lane]
        if not lag.size:
            return float("nan")
        steady_mu = max(camp.cost.capacity_eps, 1e-9)
        vals = camp.cost.base_latency_s + lag / steady_mu
        if camp._lat_extra_tm is not None:
            vals = vals + camp._lat_extra_tm[sl, self.lane]
        return float(np.mean(vals))

    def avg_throughput(self, window_s: float) -> float:
        lam = self.camp.lane_rates(self.lane)[self._window(window_s)]
        return float(np.mean(lam)) if lam.size else float("nan")

    def healthy(self) -> bool:
        i = int(self.camp._pos[self.lane])
        if i < 0:
            return True
        return not (self.camp.down[i] or self.camp.af_active[i])

    # -- actuation ------------------------------------------------------
    def drain(self) -> None:
        """No-op by design: the flink-semantics controlled restart in
        ``reconfigure``/``reconfigure_plan`` takes the savepoint."""

    def reconfigure(self, new_ci: float) -> None:
        self.reconfigurations.append((self.now(), new_ci))
        self.camp.lane_set_ci(self.lane, new_ci)

    def reconfigure_plan(self, plan: CheckpointPlan) -> None:
        self.reconfigurations.append((self.now(), plan.interval_s))
        self.plan_changes.append((self.now(), plan.name))
        self.camp.lane_set_plan(self.lane, plan)


# ---------------------------------------------------------------------------
# Profile-style measurement (SimDeployment.profile_failure semantics)
# ---------------------------------------------------------------------------

@dataclass
class LaneMeasurement:
    latency_s: float
    recovery_s: float
    recovered: bool


def measure_profile_lanes(camp: BatchedCampaign, inject_ts: Sequence[float],
                          margin: float, max_recovery_s: float,
                          lanes: Optional[Sequence[int]] = None
                          ) -> list[LaneMeasurement]:
    """Post-hoc replication of ``SimDeployment.profile_failure``'s on_tick
    measurement over a finished campaign: per lane, pre-failure latency
    (capped median over the margin window) and recovery (consumer lag back
    inside the pre-failure envelope, after the detection timeout).  The
    scalar path computes these inside the tick loop; with full lag
    histories recorded they are pure array reductions.

    The recovery scan runs as ONE NumPy pass over an (M, T) time matrix
    (the per-lane Python loop was a measurable fraction of large-campaign
    post-processing); only the short pre-window ``mean``/``median``
    reductions stay per lane, on the SAME contiguous slices the scan
    identifies — NumPy's pairwise summation makes a masked full-row
    reduction group differently, so slicing is what keeps results
    bit-identical to the per-lane reference
    (``_measure_profile_lanes_loop``, asserted in tests).

    ``lanes`` selects which campaign lanes ``inject_ts`` refers to
    (default: lanes 0..len(inject_ts)-1) — the pooled multi-job profiling
    path measures each job's contiguous lane slice with that job's own
    margin/horizon.
    """
    cost = camp.cost
    lane_ids = np.asarray(list(range(len(inject_ts)) if lanes is None
                               else lanes), dtype=np.int64)
    inj = np.asarray(inject_ts, dtype=np.float64)
    M = min(lane_ids.size, inj.size)          # zip() truncation semantics
    lane_ids, inj = lane_ids[:M], inj[:M]
    if M == 0:
        return []
    lat_hist = camp.latency_history()[lane_ids]
    lag_hist = camp.lag_hist[lane_ids]
    ns = camp._lane_ticks_all[lane_ids]
    T = int(ns.max())
    k = np.arange(T)
    ts = camp._t0_all[lane_ids][:, None] + k          # (M, T) tick clocks
    valid = k < ns[:, None]
    lag = lag_hist[:, :T]
    rows = np.arange(M)
    inj_c = inj[:, None]
    # pre-failure margin window: monotone clocks make the mask one
    # contiguous run per lane — reduce it to (start, count) slice bounds
    pre = (ts >= inj_c - margin) & (ts < inj_c) & valid
    pre_lo = pre.argmax(axis=1)
    pre_n = pre.sum(axis=1)
    # steady threshold fixed at the first post-injection tick
    post = (ts >= inj_c) & valid
    has_post = post.any(axis=1)
    k0 = post.argmax(axis=1)
    base = np.zeros(M)
    for i in np.flatnonzero(pre_n):
        base[i] = np.mean(lag[i, pre_lo[i]:pre_lo[i] + pre_n[i]])
    lam_k0 = camp.rates[lane_ids][rows, k0]
    steady = np.maximum(2.0 * lam_k0, 1.2 * base + 1.0)
    ok = (ts > inj_c + cost.detect_s) & (ts >= inj_c) \
        & (ts < inj_c + max_recovery_s) & (lag <= steady[:, None]) & valid
    hit = ok.any(axis=1) & has_post
    first = ok.argmax(axis=1)
    recovery = np.where(hit, ts[rows, first] - inj,
                        float(max_recovery_s))
    out: list[LaneMeasurement] = []
    for i in range(M):
        if pre_n[i]:
            sl = lat_hist[i, pre_lo[i]:pre_lo[i] + pre_n[i]]
            latency = float(min(np.median(sl), 30.0))
        else:
            latency = cost.base_latency_s
        out.append(LaneMeasurement(latency, float(recovery[i]),
                                   bool(hit[i])))
    return out


def _measure_profile_lanes_loop(camp: BatchedCampaign,
                                inject_ts: Sequence[float],
                                margin: float, max_recovery_s: float,
                                lanes: Optional[Sequence[int]] = None
                                ) -> list[LaneMeasurement]:
    """Per-lane reference implementation of ``measure_profile_lanes``
    (kept verbatim; the vectorized pass must match it bit-for-bit)."""
    cost = camp.cost
    lat_hist = camp.latency_history()
    out: list[LaneMeasurement] = []
    lane_ids = range(len(inject_ts)) if lanes is None else lanes
    for i, inject_t in zip(lane_ids, inject_ts):
        ts = camp.times(i)
        n = len(ts)
        lag = camp.lag_hist[i, :n]
        lam = camp.rates[i, :n]
        pre = (ts >= inject_t - margin) & (ts < inject_t)
        lat_samples = lat_hist[i, :n][pre]
        lag_samples = lag[pre]
        # steady threshold fixed at the first post-injection tick
        post = np.flatnonzero(ts >= inject_t)
        recovery, recovered = max_recovery_s, False
        if post.size:
            k0 = post[0]
            base = float(np.mean(lag_samples)) if lag_samples.size else 0.0
            steady = max(2.0 * float(lam[k0]), 1.2 * base + 1.0)
            t_end = inject_t + max_recovery_s
            ok = (ts > inject_t + cost.detect_s) & (ts >= inject_t) \
                & (ts < t_end) & (lag <= steady)
            hit = np.flatnonzero(ok)
            if hit.size:
                recovery, recovered = float(ts[hit[0]] - inject_t), True
        if lat_samples.size:
            latency = float(min(np.median(lat_samples), 30.0))
        else:
            latency = cost.base_latency_s
        out.append(LaneMeasurement(latency, recovery, recovered))
    return out


# ---------------------------------------------------------------------------
# Phase-2 profiling over lanes (implements core.profiler.CampaignDeployment)
# ---------------------------------------------------------------------------

def build_profile_lanes(cost: SimCostModel, recording: WorkloadRecording,
                        failure_times, ci_values, margin: float,
                        warmup_s: float = 300.0,
                        max_recovery_s: float = 7200.0,
                        job: Optional[str] = None
                        ) -> tuple[list[LaneSpec], list[float]]:
    """Lane specs + injection times for one job's z x m Phase-2 grid.

    Module-level (rather than a ``BatchedDeployment`` method) so a fleet
    supervisor can build grids for MANY jobs, concatenate the lanes into
    one pooled ``BatchedCampaign``, and scatter the measurements back per
    job via the ``job`` tag each lane carries.
    """
    ci_values = np.asarray(ci_values, dtype=np.float64)
    failure_times = np.asarray(failure_times, dtype=np.float64)
    injector = FailureInjector()
    lanes: list[LaneSpec] = []
    inject_ts: list[float] = []
    for j, ci in enumerate(ci_values):
        for i, ft in enumerate(failure_times):
            t0 = max(float(recording.times[0]),
                     float(ft) - margin - warmup_s)
            # worst case: just before the next checkpoint completes
            inject_t = injector.worst_case_time(
                float(ft), t0, float(ci), cost.ckpt_duration_s)
            n = int(np.ceil(inject_t + max_recovery_s - t0))
            tag = {"ci_index": j, "fp_index": i}
            if job is not None:
                tag["job"] = job
            lanes.append(LaneSpec(
                rates=dense_rates(t0, n, recording=recording),
                ci_s=float(ci), t0=t0, failures=((inject_t, "node"),),
                tag=tag))
            inject_ts.append(inject_t)
    return lanes, inject_ts


def scatter_profile_results(lanes: Sequence[LaneSpec],
                            meas: Sequence[LaneMeasurement],
                            n_failure_points: int, n_ci: int
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Scatter per-lane measurements back into (m, z) latency / recovery
    matrices using each lane's grid-index tag.  In the pooled multi-job
    case, call once per job with that job's lane/measurement slice."""
    L = np.zeros((n_failure_points, n_ci))
    R = np.zeros((n_failure_points, n_ci))
    for lane, msr in zip(lanes, meas):
        L[lane.tag["fp_index"], lane.tag["ci_index"]] = msr.latency_s
        R[lane.tag["fp_index"], lane.tag["ci_index"]] = msr.recovery_s
    return L, R


class BatchedDeployment:
    """All z CIs x m failure points profiled in ONE batched sweep.

    The paper runs its profiling deployments in parallel on Kubernetes;
    here each (CI, failure point) pair is one lane of a single
    ``BatchedCampaign``, so the whole Phase-2 grid advances together —
    statistics identical to the sequential ``SimDeployment`` loop (same
    worst-case injection, same lag-envelope recovery signal), wall-clock
    divided by the lane count.  ``engine``/``device`` pick the campaign
    engine as ``make_campaign`` does.
    """

    def __init__(self, cost: SimCostModel, recording: WorkloadRecording,
                 warmup_s: float = 300.0, max_recovery_s: float = 7200.0,
                 engine: str = "numpy", device=None):
        self.cost = cost
        self.recording = recording
        self.warmup_s = warmup_s
        self.max_recovery_s = max_recovery_s
        self.engine = engine
        self.device = device
        self.last_campaign: Optional[BatchedCampaign] = None

    def profile_campaign(self, failure_times, ci_values, margin: float
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(m, z) latency and recovery matrices for the full grid."""
        lanes, inject_ts = build_profile_lanes(
            self.cost, self.recording, failure_times, ci_values, margin,
            warmup_s=self.warmup_s, max_recovery_s=self.max_recovery_s)
        camp = make_campaign(self.cost, lanes, engine=self.engine,
                             device=self.device).run()
        self.last_campaign = camp
        meas = measure_profile_lanes(camp, inject_ts, margin,
                                     self.max_recovery_s)
        return scatter_profile_results(lanes, meas, len(failure_times),
                                       len(ci_values))


# ---------------------------------------------------------------------------
# optimize_plan simulate-to-verify hook
# ---------------------------------------------------------------------------

def make_plan_verifier(cost: SimCostModel,
                       recording: Optional[WorkloadRecording] = None,
                       schedule: Optional[RateSchedule] = None,
                       failure_mix: Sequence[tuple[str, float]] = (
                           ("task", 0.30), ("node", 0.65), ("cluster", 0.05)),
                       warmup_s: float = 300.0, margin_s: float = 90.0,
                       max_recovery_s: float = 3600.0,
                       engine: str = "numpy", device=None):
    """Build the ``optimize_plan(verifier=...)`` callback: top-k plan
    candidates are replayed through one batched campaign — one lane per
    (candidate, failure kind) with worst-case injection — and scored by
    MEASURED pre-failure latency and kind-mixed recovery, instead of the
    re-priced QoS surfaces alone.

    ``engine`` picks the campaign engine (it is also exposed as a mutable
    ``verify.engine`` attribute, which ``optimize_plan(engine=...)`` sets
    — an exhaustive sweep over the full candidate grid wants the device
    engine; both engines measure bit-identically).  ``device`` is the
    torch device the device engine runs on (default: the CUDA device);
    the NumPy engine ignores it."""
    assert recording is not None or schedule is not None

    def verify(cands: Sequence[tuple[CheckpointPlan, float]]) -> list[dict]:
        lanes, inject_ts = [], []
        injector = FailureInjector()
        for plan, ci in cands:
            t_req = warmup_s + 3.0 * ci + 5.0
            inject_t = injector.worst_case_time(t_req, 0.0, ci,
                                                cost.ckpt_duration_s)
            n = int(np.ceil(inject_t + max_recovery_s))
            rates = dense_rates(0.0, n, recording, schedule)
            for kind, _w in failure_mix:
                lanes.append(LaneSpec(
                    rates=rates, ci_s=float(ci), plan=plan,
                    failures=((inject_t, kind),), tag={"kind": kind}))
                inject_ts.append(inject_t)
        dev = device if verify.engine == "device" else None
        camp = make_campaign(cost, lanes, engine=verify.engine,
                             device=dev).run()
        meas = measure_profile_lanes(camp, inject_ts, margin_s,
                                     max_recovery_s)
        out: list[dict] = []
        k = len(failure_mix)
        for c in range(len(cands)):
            block = meas[c * k:(c + 1) * k]
            per_kind = {kind: block[j].recovery_s
                        for j, (kind, _w) in enumerate(failure_mix)}
            recovery = sum(w * block[j].recovery_s
                           for j, (_kind, w) in enumerate(failure_mix))
            out.append({"latency_s": block[0].latency_s,
                        "recovery_s": float(recovery),
                        "per_kind": per_kind})
        return out

    verify.engine = engine
    return verify
