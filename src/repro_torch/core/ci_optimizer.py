"""Phase 3 optimization step — Eq. 8 (paper §III-D):

    min_C   Q_R + Q_L* + |Q_R - Q_L*|
    s.t.    Q_R < 1,  Q_L* < 1,  Q_R, Q_L* > 0

with Q_R = M_R(C, TR_avg)/r_const and Q_L* = p * M_L(C, TR_avg)/l_const.
The objective prefers the CI with the furthest *balanced* distance from
both upper bounds.

``optimize_ci`` is the paper's literal knob (CI only, mechanism fixed).
``optimize_plan`` extends the search to the cross-product of the CI grid
and checkpoint-*mechanism* variants (full vs incremental encoding, sync vs
async commit, multi-level routing with Young/Daly-seeded level cadences):
the fitted M_L/M_R surfaces — measured under the full-sync baseline — are
re-priced per variant with the cost model's duty-cycle and restore-path
deltas, so a Decision can switch mode ("go incremental with full_every=8")
when latency is the binding constraint, not only stretch the interval.

The search is only as honest as the cost model it prices against: pass a
``SimCostModel.from_calibration("BENCH_ckpt.json")`` (measured delta
fractions AND the per-byte host encode CPU) rather than defaults, or the
optimizer will happily pick a delta plan whose encode cost exceeds its
write win on small states.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.config import CheckpointPlan
from repro_torch.core.qos_models import QoSModel
from repro_torch.core.young_daly import young_daly_interval

# P(failure kind) — matches ft.failures.FailureModel.kinds
FAILURE_MIX = (("task", 0.30), ("node", 0.65), ("cluster", 0.05))


@dataclass
class CIOptimization:
    ci: Optional[float]
    feasible: bool
    q_r: float
    q_l: float
    objective: float


def optimize_ci(m_l: QoSModel, m_r: QoSModel, tr_avg: float,
                l_const: float, r_const: float, p: float,
                ci_min: float, ci_max: float, grid: int = 256) -> CIOptimization:
    ci = np.linspace(ci_min, ci_max, grid)
    q_r = m_r.predict(ci, tr_avg) / r_const
    q_l = p * m_l.predict(ci, tr_avg) / l_const
    obj = q_r + q_l + np.abs(q_r - q_l)
    feas = (q_r < 1.0) & (q_l < 1.0) & (q_r > 0.0) & (q_l > 0.0)

    if feas.any():
        masked = np.where(feas, obj, np.inf)
        i = int(np.argmin(masked))
        return CIOptimization(float(ci[i]), True, float(q_r[i]), float(q_l[i]),
                              float(obj[i]))
    # No feasible CI: the paper requires a constraint to be satisfiable to
    # optimize ("reconfigurations are applied sparsely ... CI updates were
    # aborted"); report the least-violating point but flag infeasible.
    viol = np.maximum(q_r - 1, 0) + np.maximum(q_l - 1, 0) + \
        np.maximum(-q_r, 0) + np.maximum(-q_l, 0)
    i = int(np.argmin(viol))
    return CIOptimization(None, False, float(q_r[i]), float(q_l[i]), float(obj[i]))


# ---------------------------------------------------------------------------
# Plan-space optimization (mechanism x CI)
# ---------------------------------------------------------------------------

@dataclass
class PlanCandidate:
    plan: CheckpointPlan
    ci: Optional[float]
    feasible: bool
    q_r: float
    q_l: float
    objective: float
    overhead: float        # modeled steady-state checkpoint overhead fraction
    sim: Optional[dict] = None   # simulate-to-verify measurement, if replayed


#: the optimize_plan(verifier=...) contract: given [(plan, ci), ...] return
#: one dict per candidate with measured {"latency_s", "recovery_s", ...} —
#: sim.batched.make_plan_verifier builds one over a BatchedCampaign
PlanVerifier = Callable[[Sequence[tuple[CheckpointPlan, float]]], list]


@dataclass
class PlanOptimization:
    """Best (mechanism, CI) pair plus the full per-variant table; the
    full-sync baseline is kept for the before/after comparison."""
    plan: Optional[CheckpointPlan]
    ci: Optional[float]
    feasible: bool
    q_r: float
    q_l: float
    objective: float
    overhead: float
    baseline: PlanCandidate
    candidates: list
    verified: bool = False   # True when a simulate-to-verify pass re-ranked


def default_plan_variants(cost, ci_ref: float,
                          mtbf_s: float = 3600.0) -> list[CheckpointPlan]:
    """The mechanism grid: full/incremental x sync/async x single/multi
    level x (encode placement x delta codec).  Level cadences are seeded
    with the Young/Daly optimum for that level's write cost — e.g. the
    remote level writes every round(W_yd(remote_cost, MTBF) / CI)-th
    trigger.  The device-placement variants move the ckpt_delta encode in
    front of D2H — priced as one pack dispatch + ONE fused flat-kernel
    encode (``device_pack_s* + device_encode_s*``) instead of the
    per-trigger host-CPU encode, with (for int8) ~4x fewer bytes on the
    link — the dimension a Decision uses to switch a job onto an
    int8-delta plan when the QoS objective favors it; the multi-level
    device variant routes those fused deltas through the memory/local/
    remote cadence as well.  ``replication_factor`` is a searched
    dimension too: the rep0 variant drops peer replication (node
    failures degrade to the remote level — no replica traffic, slower
    node recovery, so it leans on a denser remote cadence), the rep2
    variant pays double replica traffic to tolerate two simultaneous
    host losses — the optimizer genuinely trades replication traffic
    against recovery time."""
    def yd_every(level: str) -> int:
        w = young_daly_interval(cost.write_duration("full", level), mtbf_s)
        return int(np.clip(round(w / max(ci_ref, 1e-9)), 2, 32))

    ml_levels = ("memory", "local", "remote")
    return [
        CheckpointPlan(),                                        # full-sync baseline
        CheckpointPlan(sync=False),                              # full-async
        CheckpointPlan(mode="incremental", full_every=4),
        CheckpointPlan(mode="incremental", full_every=8),
        CheckpointPlan(mode="incremental", full_every=8, sync=False),
        CheckpointPlan(mode="incremental", full_every=8,
                       encode_placement="device"),
        CheckpointPlan(mode="incremental", full_every=8,
                       encode_placement="device", delta_codec="int8"),
        CheckpointPlan(mode="incremental", full_every=8, sync=False,
                       encode_placement="device", delta_codec="int8"),
        CheckpointPlan(levels=ml_levels, local_every=max(1, yd_every("local") // 2),
                       remote_every=yd_every("remote")),
        CheckpointPlan(mode="incremental", full_every=8, levels=ml_levels,
                       local_every=1, remote_every=yd_every("remote")),
        CheckpointPlan(mode="incremental", full_every=8, levels=ml_levels,
                       local_every=1, remote_every=yd_every("remote"),
                       encode_placement="device", delta_codec="int8"),
        # replication dimension: rep0 has no peer replicas, so node
        # failures fall through to remote — it compensates with a denser
        # remote cadence; rep2 survives a simultaneous two-host loss at
        # double the replica traffic
        CheckpointPlan(levels=ml_levels, replication_factor=0,
                       local_every=max(1, yd_every("local") // 2),
                       remote_every=max(2, yd_every("remote") // 2)),
        CheckpointPlan(levels=ml_levels, replication_factor=2,
                       local_every=max(1, yd_every("local") // 2),
                       remote_every=yd_every("remote")),
    ]


def _variant_predictions(m_l: QoSModel, m_r: QoSModel, cost,
                         plans: Sequence[CheckpointPlan], ci: np.ndarray,
                         tr_avg: float, baseline: CheckpointPlan,
                         failure_mix=FAILURE_MIX
                         ) -> tuple[list, list, list]:
    """Re-price the fitted (full-sync) QoS surfaces for EVERY plan variant.

    Latency: the excess over the base latency is driven by the checkpoint
    duty cycle (capacity lost to sync pauses / the async tax), so it is
    scaled by each variant's overhead relative to the baseline's.

    Recovery: lost work is bounded by the cadence of the fastest level
    surviving each failure kind (a cluster failure replays back to the
    last remote full), so M_R is evaluated at the per-kind effective CI
    and shifted by the restore-path downtime delta; kinds are mixed with
    the failure model's probabilities.

    Evaluation is batched across variants: the variant-independent
    pieces (M_L at the grid, the baseline overhead) are computed once,
    and the (variant x kind) M_R reads go through ONE stacked
    ``QoSModel.predict`` — its reduction is row-independent, so the
    per-variant values are bit-identical to per-variant calls.
    """
    if hasattr(cost, "plan_overhead_fractions"):   # vectorized fast path
        o_base = np.asarray(cost.plan_overhead_fractions(baseline, ci))
        o_vs = [np.asarray(cost.plan_overhead_fractions(p, ci))
                for p in plans]
    else:
        o_base = np.array([cost.plan_overhead_fraction(baseline, c)
                           for c in ci])
        o_vs = [np.array([cost.plan_overhead_fraction(p, c) for c in ci])
                for p in plans]
    o_floor = np.maximum(o_base, 1e-9)
    excess = np.maximum(m_l.predict(ci, tr_avg) - cost.base_latency_s, 0.0)
    lats = [cost.base_latency_s + excess * (o_v / o_floor) for o_v in o_vs]

    ci_hi = float(ci.max())
    rows: list[tuple[int, float, float]] = []   # (plan idx, weight, dt)
    ci_effs: list[np.ndarray] = []
    for pi, plan in enumerate(plans):
        for kind, w in failure_mix:
            mult = cost.plan_lost_work_multiplier(plan, kind)
            if not np.isfinite(mult):
                # nothing survives this kind: replay-from-zero — price it
                # as the worst the fitted surface has seen, four CIs out
                ci_effs.append(np.full_like(ci, 4.0 * ci_hi))
            else:
                # avoid wild polynomial extrapolation beyond the fit range
                ci_effs.append(np.minimum(ci * mult, 4.0 * ci_hi))
            rows.append((pi, w, cost.plan_downtime_s(plan, kind)
                         - cost.plan_downtime_s(baseline, kind)))
    preds = m_r.predict(np.concatenate(ci_effs),
                        tr_avg).reshape(len(rows), len(ci))
    recs = [np.zeros_like(ci) for _ in plans]
    for (pi, w, d_downtime), pred in zip(rows, preds):
        recs[pi] = recs[pi] + w * (pred + d_downtime)
    return lats, recs, o_vs


def optimize_plan(m_l: QoSModel, m_r: QoSModel, tr_avg: float,
                  l_const: float, r_const: float, p: float,
                  ci_min: float, ci_max: float, cost,
                  variants: Optional[Sequence[CheckpointPlan]] = None,
                  mtbf_s: float = 3600.0, grid: int = 128,
                  verifier: Optional[PlanVerifier] = None,
                  verify_top_k: int = 3, exhaustive: bool = False,
                  engine: Optional[str] = None) -> PlanOptimization:
    """Eq. 8 over the (CI grid x plan variants) cross-product.

    ``cost`` is a ``sim.costmodel.SimCostModel`` (any object with the
    plan-pricing methods works).  Ties between feasible variants at equal
    objective break toward lower modeled checkpoint overhead.

    With a ``verifier`` (``sim.batched.make_plan_verifier``), the top-k
    feasible candidates are replayed through the batched chaos campaign and
    re-ranked by their MEASURED Eq.-8 objective — the re-priced surfaces
    pick the shortlist, the simulator picks the winner.  Candidates that
    were replayed carry the measurement in ``PlanCandidate.sim``.

    ``exhaustive=True`` drops the shortlist: EVERY feasible variant is
    replayed and ranked by its measured objective.  That many replay lanes
    is what the device engine exists for — pass ``engine="device"`` to
    route the verifier's campaigns through ``sim.device.DeviceCampaign``
    (any verifier exposing a mutable ``engine`` attribute honors it; the
    one from ``make_plan_verifier`` does).  Because exhaustive mode scores
    a superset of the top-k shortlist with the same measurements, its pick
    can only match or improve on the top-k pick's measured objective.
    """
    ci = np.linspace(ci_min, ci_max, grid)
    baseline = CheckpointPlan()
    if variants is None:
        variants = default_plan_variants(cost, ci_ref=float(np.median(ci)),
                                         mtbf_s=mtbf_s)

    candidates: list[PlanCandidate] = []
    lats, recs, o_vs = _variant_predictions(m_l, m_r, cost, list(variants),
                                            ci, tr_avg, baseline)
    for plan, lat, rec, o_v in zip(variants, lats, recs, o_vs):
        q_r = rec / r_const
        q_l = p * lat / l_const
        obj = q_r + q_l + np.abs(q_r - q_l)
        feas = (q_r < 1.0) & (q_l < 1.0) & (q_r > 0.0) & (q_l > 0.0)
        if feas.any():
            masked = np.where(feas, obj, np.inf)
            i = int(np.argmin(masked))
            candidates.append(PlanCandidate(
                replace(plan, interval_s=float(ci[i])), float(ci[i]), True,
                float(q_r[i]), float(q_l[i]), float(obj[i]), float(o_v[i])))
        else:
            viol = np.maximum(q_r - 1, 0) + np.maximum(q_l - 1, 0) + \
                np.maximum(-q_r, 0) + np.maximum(-q_l, 0)
            i = int(np.argmin(viol))
            candidates.append(PlanCandidate(
                plan, None, False, float(q_r[i]), float(q_l[i]),
                float(obj[i]), float(o_v[i])))

    base_cand = candidates[0] if variants and variants[0].name == baseline.name \
        else next((c for c in candidates if c.plan.name == baseline.name),
                  candidates[0])
    feasible = [c for c in candidates if c.feasible]
    if feasible:
        best = min(feasible, key=lambda c: (c.objective, c.overhead))
        verified = False
        if verifier is not None and engine is not None \
                and hasattr(verifier, "engine"):
            verifier.engine = engine
        if exhaustive:
            verify_top_k = len(feasible)
        if verifier is not None and verify_top_k > 0:
            sim_best = _verify_candidates(
                feasible, verifier, verify_top_k, l_const, r_const, p)
            # only claim a verified pick when the simulator accepted one;
            # otherwise keep the surface winner, unverified
            if sim_best is not None:
                best, verified = sim_best, True
        return PlanOptimization(best.plan, best.ci, True, best.q_r, best.q_l,
                                best.objective, best.overhead, base_cand,
                                candidates, verified=verified)
    least = min(candidates, key=lambda c: c.objective)
    return PlanOptimization(None, None, False, least.q_r, least.q_l,
                            least.objective, least.overhead, base_cand,
                            candidates)


def _verify_candidates(feasible: list, verifier: PlanVerifier, top_k: int,
                       l_const: float, r_const: float, p: float
                       ) -> Optional[PlanCandidate]:
    """Simulate-to-verify: replay the surface-ranked top-k through the
    batched campaign, score the measurements with the same Eq.-8 objective,
    and pick the sim-best among the sim-feasible (falling back to the
    surface ranking when the simulator rejects every shortlisted plan)."""
    short = sorted(feasible, key=lambda c: (c.objective, c.overhead))[:top_k]
    results = verifier([(c.plan, c.ci) for c in short])
    sim_ranked: list[tuple[float, PlanCandidate]] = []
    for cand, meas in zip(short, results):
        q_r = meas["recovery_s"] / r_const
        q_l = p * meas["latency_s"] / l_const
        obj = q_r + q_l + abs(q_r - q_l)
        feas = 0.0 < q_r < 1.0 and 0.0 < q_l < 1.0
        cand.sim = dict(meas, q_r=q_r, q_l=q_l, objective=obj, feasible=feas)
        if feas:
            sim_ranked.append((obj, cand))
    if not sim_ranked:
        return None
    return min(sim_ranked, key=lambda t: (t[0], t[1].overhead))[1]
