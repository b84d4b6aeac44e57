"""The port's NumPy lane engine (``repro_torch.sim.batched``) against the
JAX package's (``repro.sim.batched``): the same lanes give the same lag
and latency histories, recovery records, counters and measurements BIT
FOR BIT (``assert_array_equal``, no tolerance).  One case per case of
``tests/test_batched_sim.py``, plus mid-run actuation, the controller-in-
the-loop ``drive_campaign`` and the simulate-to-verify ``optimize_plan``
picks.
"""
from types import SimpleNamespace

import numpy as np
import pytest

import repro.config as jconfig
import repro.core as jcore
import repro.data.stream as jstream
import repro.ft.failures as jfail
import repro.sim as jsim
import repro.sim.batched as jbatched
import repro_torch.config as tconfig
import repro_torch.core as tcore
import repro_torch.data.stream as tstream
import repro_torch.ft.failures as tfail
import repro_torch.sim as tsim
import repro_torch.sim.batched as tbatched


def _pkg(config, core, stream, fail, sim, batched):
    return SimpleNamespace(
        Plan=config.CheckpointPlan, KhaosConfig=config.KhaosConfig,
        core=core, stream=stream, Degradation=fail.Degradation,
        FailureInjector=fail.FailureInjector, sim=sim, batched=batched)


J = _pkg(jconfig, jcore, jstream, jfail, jsim, jbatched)
T = _pkg(tconfig, tcore, tstream, tfail, tsim, tbatched)
PKGS = (J, T)

COST_KW = dict(capacity_eps=4600.0, base_latency_s=0.5, ckpt_duration_s=3.0,
               ckpt_sync_penalty=0.6)
KINDS = ("task", "node", "cluster")
#: the four plans of the reference's matrix, as keyword sets (None: default)
PLAN_KW = (None, dict(sync=False),
           dict(mode="incremental", full_every=8, sync=False),
           dict(mode="incremental", full_every=4,
                levels=("memory", "local", "remote"), local_every=1,
                remote_every=8))
DEG_KW = {
    "straggler": [dict(t=300.0, kind="straggler", duration_s=400.0,
                       severity=1.8)],
    "net_delay_source": [dict(t=250.0, kind="net_delay", duration_s=500.0,
                              severity=3.0, jitter_s=0.8,
                              direction="to_source")],
    "net_delay_store": [dict(t=250.0, kind="net_delay", duration_s=600.0,
                             severity=4.0, jitter_s=1.0,
                             direction="to_ckpt_store")],
    "backpressure": [dict(t=200.0, kind="backpressure", duration_s=150.0)],
}
#: every per-lane array a campaign ends with (results read from these)
FINAL = ("lag", "produced", "consumed", "processed_total", "ckpt_count",
         "save_count", "steady_lag", "down", "t", "off_lvl", "last_off",
         "pol_last", "interval", "plan_id", "bp_suppressed", "fptr", "dptr",
         "af_active", "dg_cap_scale")


def _cost(P, **kw):
    return P.sim.SimCostModel(**(kw or COST_KW))


def _plan(P, kw):
    return None if kw is None else P.Plan(**kw)


def _worst(P, ci):
    return P.FailureInjector().worst_case_time(3 * ci + 5.0, 0.0, ci,
                                               COST_KW["ckpt_duration_s"])


def assert_same_campaign(a, b) -> None:
    """Every result surface of two campaigns equal, bit for bit."""
    assert a.n_lanes == b.n_lanes and a.horizon == b.horizon
    if a.lag_hist is not None:
        np.testing.assert_array_equal(a.lag_hist, b.lag_hist)
        np.testing.assert_array_equal(a.latency_history(),
                                      b.latency_history())
    for name in FINAL:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.recoveries == b.recoveries
    assert a.lane_plan_name == b.lane_plan_name
    assert (a.ticks_run, a.compactions, a.lanes_compacted) == \
        (b.ticks_run, b.compactions, b.lanes_compacted)


def _both(build, **kw):
    """Build and run one scenario in each package: (reference, port)."""
    return tuple(build(P, **kw) for P in PKGS)


# -- lanes across plans, kinds and schedules ---------------------------------

def _matrix(P):
    T_ = 4000
    sched = P.stream.constant_rate(3000.0)
    lanes = []
    for ci in (30.0, 90.0):
        for kw in PLAN_KW:
            for kind in KINDS:
                lanes.append(P.batched.LaneSpec(
                    rates=P.stream.dense_rates(0.0, T_, schedule=sched),
                    ci_s=ci, plan=_plan(P, kw),
                    failures=((_worst(P, ci), kind),)))
    return P.batched.BatchedCampaign(_cost(P), lanes).run()


def test_lane_matches_reference_across_plans_and_kinds():
    a, b = _both(_matrix)
    assert_same_campaign(a, b)
    assert all(a.recoveries), "every lane of the matrix recovers"


def _real_valued(P):
    sched = P.stream.diurnal_rate(base=2800, amplitude=0.5, period=5400,
                                  seed=13)
    lanes = [P.batched.LaneSpec(
        rates=P.stream.dense_rates(0.0, 3000, schedule=sched), ci_s=ci,
        plan=_plan(P, PLAN_KW[3]), failures=((_worst(P, ci), kind),))
        for ci, kind in ((25.0, "node"), (70.0, "cluster"))]
    return P.batched.BatchedCampaign(_cost(P), lanes).run()


def test_lane_matches_reference_on_real_valued_schedule():
    a, b = _both(_real_valued)
    assert_same_campaign(a, b)


def _offset_clock(P):
    sched = P.stream.diurnal_rate(base=2600, amplitude=0.4, period=7200,
                                  seed=5)
    rec = P.stream.record_workload(sched, duration=7200, seed=5)
    t0, ci = 1000.0, 45.0
    inject_t = P.FailureInjector().worst_case_time(1500.0, t0, ci, 3.0)
    lane = P.batched.LaneSpec(rates=rec.rates_until(4000.0, t0=t0), ci_s=ci,
                              t0=t0, failures=((inject_t, "node"),))
    return P.batched.BatchedCampaign(_cost(P), [lane]).run()


def test_lane_matches_reference_on_recording_with_offset_clock():
    a, b = _both(_offset_clock)
    assert_same_campaign(a, b)
    assert b.lane_ticks[0] == 3000 and b.lane_recovery(0) is not None


# -- Phase 2 over lanes --------------------------------------------------------

def _profiling(P, engine_kw=None):
    sched = P.stream.diurnal_rate(base=1500, amplitude=0.4, period=7200,
                                  seed=3)
    rec = P.stream.record_workload(sched, duration=7200, seed=3)
    ss = P.core.select_failure_points(rec, m=3, smoothing_window=30)
    cost = _cost(P, capacity_eps=2600.0, ckpt_duration_s=1.5)
    cis = [30, 240]
    seq = P.core.run_profiling(
        lambda ci: P.sim.SimDeployment(ci, rec, cost, warmup_s=200,
                                       max_recovery_s=3600.0),
        ss, cis, margin=60)
    bat = P.core.run_profiling_campaign(
        P.sim.BatchedDeployment(cost, rec, warmup_s=200,
                                max_recovery_s=3600.0, **(engine_kw or {})),
        ss, cis, margin=60)
    return seq, bat


def test_batched_profiling_matches_reference_and_sequential():
    (seq_j, bat_j), (seq_t, bat_t) = _both(_profiling)
    for a, b in ((bat_j, bat_t), (seq_j, seq_t), (seq_t, bat_t)):
        np.testing.assert_array_equal(a.latencies, b.latencies)
        np.testing.assert_array_equal(a.recoveries, b.recoveries)
        np.testing.assert_array_equal(a.ci_values, b.ci_values)
        np.testing.assert_array_equal(a.failure_rates, b.failure_rates)
    assert bat_t.recoveries[:, 1].mean() > bat_t.recoveries[:, 0].mean()


def test_dense_rates_match_reference():
    out = []
    for P in PKGS:
        sched = P.stream.diurnal_rate(base=1200, amplitude=0.5, period=3600,
                                      seed=2)
        rec = P.stream.record_workload(sched, duration=600, seed=2)
        out.append((P.stream.dense_rates(37.0, 400, schedule=sched),
                    P.stream.dense_rates(37.0, 400, recording=rec),
                    rec.rates_until(437.0, t0=37.0)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[1][1], out[1][2])


def test_scalar_rate_buffer_matches_reference():
    series = []
    for P in PKGS:
        sched = P.stream.diurnal_rate(base=900, amplitude=0.6, period=1800,
                                      seed=11)
        sim = P.sim.StreamSimulator(_cost(P, capacity_eps=2000.0), ci_s=60.0,
                                    schedule=sched, t0=13.0)
        sim.run_until(513.0)
        s = sim.metrics.series("arrival_rate")
        series.append((np.array(s.times), np.array(s.values)))
    for a, b in zip(*series):
        np.testing.assert_array_equal(a, b)
    assert len(series[1][0]) == 500


def _smoke_campaign(P):
    T_ = 1200
    sched = P.stream.constant_rate(2000.0)
    cost = _cost(P, capacity_eps=3000.0, ckpt_duration_s=1.0)
    t = P.FailureInjector().worst_case_time(150.0, 0.0, 30.0, 1.0)

    def lane(ci, **kw):
        return P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, T_, schedule=sched), ci_s=ci,
            **kw)
    lanes = [lane(30.0), lane(30.0, failures=((t, "node"),)),
             lane(60.0, plan=P.Plan(sync=False), failures=((t, "task"),)),
             lane(60.0, plan=_plan(P, PLAN_KW[3]),
                  failures=((t, "cluster"),))]
    return P.batched.BatchedCampaign(cost, lanes).run()


@pytest.mark.tier1
def test_campaign_smoke_matches_reference():
    a, b = _both(_smoke_campaign)
    assert_same_campaign(a, b)
    assert abs(b.produced[0] - (b.consumed[0] + b.lag[0])) < 1e-6
    assert b.ckpt_count[0] >= 30 and b.ticks_run == 4 * 1200
    assert b.recoveries[3][0]["restore_level"] == "remote"


# -- compaction and early exit -------------------------------------------------

def _mixed_horizons(P):
    sched = P.stream.constant_rate(3000.0)
    lanes = []
    for j, T_ in enumerate((500, 4000, 700, 2500, 900, 1400)):
        ci = 30.0 + 15 * j
        lanes.append(P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, T_, schedule=sched), ci_s=ci,
            failures=((_worst(P, ci), "node"),)))
    return P.batched.BatchedCampaign(_cost(P), lanes, compact_every=64).run()


def test_mixed_horizon_compaction_matches_reference():
    a, b = _both(_mixed_horizons)
    assert_same_campaign(a, b)
    assert b.compactions > 0
    assert b.ticks_run == 500 + 4000 + 700 + 2500 + 900 + 1400


def _early_exit(P):
    sched = P.stream.constant_rate(3000.0)
    lanes = [P.batched.LaneSpec(
        rates=P.stream.dense_rates(0.0, 4000, schedule=sched), ci_s=ci,
        failures=((_worst(P, ci), "node"),)) for ci in (20., 40., 60., 80.)]
    camp = P.batched.BatchedCampaign(_cost(P), lanes, record_history=False,
                                     early_exit=True, compact_every=64).run()
    quiet = P.batched.BatchedCampaign(
        _cost(P), [P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, 1200, schedule=sched),
            ci_s=30.0)],
        record_history=False, early_exit=True, compact_every=64).run()
    return camp, quiet


def test_early_exit_matches_reference():
    (a, qa), (b, qb) = _both(_early_exit)
    assert_same_campaign(a, b)
    assert_same_campaign(qa, qb)
    assert b.lanes_compacted == 4 and b.ticks_run < 4 * 4000
    assert qb.ticks_run == 1200


# -- simulate-to-verify --------------------------------------------------------

def _surfaces(P, cost, tr_lo=1000, tr_hi=2200):
    rng = np.random.default_rng(0)
    ci = rng.uniform(10, 120, 200)
    tr = rng.uniform(tr_lo, tr_hi, 200)
    m_l = P.core.QoSModel().fit(ci, tr, cost.base_latency_s + 40.0 / ci
                                + tr * 1e-5)
    m_r = P.core.QoSModel().fit(ci, tr, 80.0 + 1.2 * ci + 0.01 * tr)
    return m_l, m_r


def _verified(P, top_k=2, exhaustive=False, grid=128, verifier_kw=None,
              engine=None):
    cost = _cost(P, capacity_eps=2600.0, ckpt_duration_s=1.5)
    m_l, m_r = _surfaces(P, cost)
    calls = []
    real = P.batched.make_plan_verifier(
        cost, schedule=P.stream.constant_rate(1500.0), warmup_s=120,
        max_recovery_s=1200.0, **(verifier_kw or {}))

    def verifier(cands):
        real.engine = verifier.engine      # optimize_plan(engine=) sets it
        calls.append([(p.name, ci) for p, ci in cands])
        return real(cands)
    verifier.engine = real.engine
    res = P.core.optimize_plan(m_l, m_r, tr_avg=1500.0, l_const=2.0,
                               r_const=600.0, p=1.0, ci_min=10, ci_max=120,
                               cost=cost, grid=grid, verifier=verifier,
                               verify_top_k=top_k, exhaustive=exhaustive,
                               engine=engine)
    return res, calls


def _same_optimization(a, b) -> None:
    assert (a.feasible, a.verified, a.ci, a.objective, a.overhead) == \
        (b.feasible, b.verified, b.ci, b.objective, b.overhead)
    assert (a.plan.name if a.plan else None) == \
        (b.plan.name if b.plan else None)
    for x, y in zip(a.candidates, b.candidates):
        assert x.plan.name == y.plan.name
        assert (x.ci, x.feasible, x.objective, x.sim) == \
            (y.ci, y.feasible, y.objective, y.sim)


def test_optimize_plan_simulate_to_verify_matches_reference():
    (ra, ca), (rb, cb) = _both(_verified)
    assert ca == cb and len(cb) == 1 and len(cb[0]) == 2
    _same_optimization(ra, rb)
    assert rb.verified and rb.feasible
    replayed = [c for c in rb.candidates if c.sim is not None]
    assert len(replayed) == 2
    assert rb.plan.name in {c.plan.name for c in replayed}


def test_optimize_plan_exhaustive_matches_reference():
    """Exhaustive replay (every feasible variant) picks the same plan and
    CI from the same measurements; the port's device engine on the CPU
    gives those measurements too."""
    (ra, ca), (rb, cb) = _both(_verified, exhaustive=True, grid=32)
    assert ca == cb and len(cb[0]) > 2
    _same_optimization(ra, rb)
    rd, cd = _verified(T, exhaustive=True, grid=32,
                       verifier_kw=dict(device="cpu"), engine="device")
    assert cd == cb
    _same_optimization(rb, rd)


# -- gray failures ------------------------------------------------------------

def _degraded(P):
    sched = P.stream.diurnal_rate(base=2800, amplitude=0.5, period=5400,
                                  seed=7)
    lanes = []
    for ci in (30.0, 75.0):
        for kw in (None, PLAN_KW[3]):
            for name, degs in DEG_KW.items():
                for fails in ((), ((_worst(P, ci) + 400.0, "node"),)):
                    lanes.append(P.batched.LaneSpec(
                        rates=P.stream.dense_rates(0.0, 2500, schedule=sched),
                        ci_s=ci, plan=_plan(P, kw), failures=fails,
                        degradations=[P.Degradation(**d) for d in degs],
                        tag={"deg": name}))
    return P.batched.BatchedCampaign(_cost(P), lanes).run()


def test_lane_matches_reference_under_degradations():
    a, b = _both(_degraded)
    assert_same_campaign(a, b)
    assert b.bp_suppressed.sum() > 0


def _gray(P):
    sched = P.stream.constant_rate(3000.0)

    def lane(name=None, fails=()):
        degs = [P.Degradation(**d) for d in DEG_KW[name]] if name else []
        return P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, 2000, schedule=sched), ci_s=30.0,
            failures=fails, degradations=degs)
    lanes = [lane(), lane("straggler"),
             lane("backpressure", ((340.0, "node"),)),
             lane(None, ((340.0, "node"),)), lane("net_delay_store"),
             lane("net_delay_source")]
    return P.batched.BatchedCampaign(_cost(P), lanes).run()


def test_degradation_semantics_match_reference():
    """The gray-failure semantics on the port's lanes (lag builds and
    drains under a straggler, backpressure suppresses triggers and costs
    the next crash more, to-store delay stretches barriers, to-source
    delay inflates latency only), each lane equal to the reference's."""
    a, b = _both(_gray)
    assert_same_campaign(a, b)
    lag = b.lag_hist
    assert not b.recoveries[1] and lag[1, 300:700].max() > 100.0
    assert b.bp_suppressed[2] > 0 and b.bp_suppressed[3] == 0
    assert b.ckpt_count[2] < b.ckpt_count[3]
    assert b.recoveries[2][0]["recovery_s"] > b.recoveries[3][0]["recovery_s"]
    assert lag[4, 260:860].mean() > lag[0, 260:860].mean() * 1.5
    lat = b.latency_history()
    assert lat[5, 260:740].mean() > lat[0, 260:740].mean() + 1.0
    np.testing.assert_array_equal(lag[5], lag[0])


def test_unknown_kind_rejected_like_reference():
    for P in PKGS:
        sim = P.sim.StreamSimulator(_cost(P), ci_s=30.0,
                                    schedule=P.stream.constant_rate(100.0))
        with pytest.raises(ValueError, match="unknown crash kind"):
            sim.inject_failure(10.0, "gray_goo")
        with pytest.raises(ValueError, match="unknown degradation kind"):
            sim.inject_degradation(10.0, "node", 50.0)
        with pytest.raises(ValueError, match="unknown direction"):
            P.Degradation(t=0.0, kind="net_delay", duration_s=10.0,
                          direction="sideways")
        lane = P.batched.LaneSpec(rates=np.full(10, 100.0), ci_s=30.0,
                                  failures=((5.0, "gray_goo"),))
        with pytest.raises(KeyError):
            P.batched.BatchedCampaign(_cost(P), [lane])


def _large(P):
    sched = P.stream.constant_rate(3000.0)
    rates = P.stream.dense_rates(0.0, 1500, schedule=sched)
    lanes = [P.batched.LaneSpec(rates=rates, ci_s=float(ci),
                                plan=_plan(P, kw),
                                failures=((_worst(P, float(ci)), kind),))
             for ci in np.geomspace(10, 240, 18) for kw in PLAN_KW
             for kind in KINDS]
    return P.batched.BatchedCampaign(_cost(P), lanes).run()


def test_campaign_scales_to_large_grids_like_reference():
    a, b = _both(_large)
    assert b.n_lanes >= 200 and b.ticks_run == b.n_lanes * 1500
    assert_same_campaign(a, b)


def _measure(P):
    sched = P.stream.diurnal_rate(base=2400.0, amplitude=0.4, period=3600.0,
                                  seed=3)
    lanes, injects = [], []
    for j, ci in enumerate(np.geomspace(12.0, 180.0, 9)):
        t = _worst(P, float(ci))
        lanes.append(P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, 1400 - 40 * (j % 3),
                                       schedule=sched),
            ci_s=float(ci), failures=((t, KINDS[j % 3]),)))
        injects.append(t)
    for inj in (0.0, 1500.0):      # empty pre-window; no post-injection tick
        lanes.append(P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, 1400, schedule=sched),
            ci_s=30.0))
        injects.append(inj)
    camp = P.batched.BatchedCampaign(_cost(P), lanes).run()
    out = []
    for margin, max_rec, sel in ((90.0, 900.0, None), (60.0, 50.0, None),
                                 (90.0, 900.0, [3, 7, 10])):
        inj = injects if sel is None else [injects[i] for i in sel]
        fast = P.batched.measure_profile_lanes(camp, inj, margin, max_rec,
                                               lanes=sel)
        loop = P.batched._measure_profile_lanes_loop(camp, inj, margin,
                                                     max_rec, lanes=sel)
        assert fast == loop
        out.append([(m.latency_s, m.recovery_s, m.recovered) for m in fast])
    return out


def test_measure_profile_lanes_matches_reference():
    a, b = _both(_measure)
    assert a == b


# -- actuation -----------------------------------------------------------------

def _retired(P):
    sched = P.stream.constant_rate(3000.0)
    lanes = [P.batched.LaneSpec(
        rates=P.stream.dense_rates(0.0, 500, schedule=sched), ci_s=30.0,
        failures=((_worst(P, 30.0), "node"),)),
        P.batched.LaneSpec(
            rates=P.stream.dense_rates(0.0, 2000, schedule=sched),
            ci_s=30.0)]
    camp = P.batched.BatchedCampaign(_cost(P), lanes, early_exit=True,
                                     compact_every=64)
    h_short, h_long = (P.batched.BatchedLaneHandle(camp, i) for i in (0, 1))
    camp.run(n_ticks=1200)
    assert camp.compactions > 0 and camp._pos[0] < 0
    assert not h_short.alive()
    frozen = (h_short.now(), h_short.current_ci())
    camp.lane_set_ci(0, 15.0)
    camp.lane_set_plan(0, P.Plan(sync=False))
    assert (h_short.now(), h_short.current_ci()) == frozen
    assert h_long.alive()
    camp.lane_set_ci(1, 20.0)
    assert h_long.current_ci() == 20.0
    camp.run()
    return camp


def test_handles_survive_compaction_like_reference():
    a, b = _both(_retired)
    assert_same_campaign(a, b)
    assert b.done and b.recoveries[0]


def _midrun(P):
    rates = 3000.0 + 800.0 * np.sin(np.arange(600) / 40.0)
    lanes = [P.batched.LaneSpec(rates=rates, ci_s=60.0,
                                failures=((150.0, "node"),))
             for _ in range(4)]
    camp = P.batched.BatchedCampaign(_cost(P), lanes)
    camp.run(n_ticks=300)
    camp.lane_set_plan(1, P.Plan(mode="incremental", full_every=8,
                                 sync=False))
    camp.lane_set_ci(2, 20.0)
    camp.lane_set_plan(3, _plan(P, PLAN_KW[3]))
    camp.run()
    return camp


def test_midrun_ci_and_plan_switch_match_reference():
    a, b = _both(_midrun)
    assert_same_campaign(a, b)
    assert b.lane_plan(1).name == a.lane_plan(1).name


def _driven(P):
    rng = np.random.default_rng(0)
    ci = rng.uniform(10, 300, 150)
    tr = rng.uniform(800, 2200, 150)
    cost = _cost(P, capacity_eps=2600.0, ckpt_duration_s=1.0)
    m_l = P.core.QoSModel().fit(ci, tr, cost.base_latency_s + 2.0 / ci)
    m_r = P.core.QoSModel().fit(ci, tr, 80 + 1.2 * ci + 0.02 * tr)
    cfg = P.KhaosConfig(latency_constraint=1.0, recovery_constraint=240.0,
                        optimization_period=30.0, ci_min=10, ci_max=300,
                        reconfig_cooldown=60.0)
    sched = P.stream.constant_rate(1800.0)
    lanes = [P.batched.LaneSpec(
        rates=P.stream.dense_rates(0.0, 601, schedule=sched), ci_s=ci0,
        failures=((250.0, "node"),) if ci0 < 100 else ())
        for ci0 in (290.0, 60.0, 120.0)]
    rt = P.core.KhaosRuntime(cfg, cost=cost)
    rt.install_models(m_l, m_r)
    camp = P.batched.BatchedCampaign(cost, lanes)
    sup = rt.drive_campaign(camp)
    return sup, camp


def decision_key(d) -> tuple:
    """A Decision as comparable values (floats by repr: NaN-safe, exact)."""
    return (repr(d.t), d.kind, repr(d.latency), repr(d.tr_avg),
            repr(d.predicted_recovery), repr(d.new_ci),
            d.new_plan.name if d.new_plan is not None else None)


def test_drive_campaign_decisions_match_reference():
    (sa, ca), (sb, cb) = _both(_driven)
    assert_same_campaign(ca, cb)
    for i in range(3):
        assert [decision_key(d) for d in sa.decisions(i)] == \
            [decision_key(d) for d in sb.decisions(i)]
        assert sa.reconfigurations(i) == sb.reconfigurations(i)
        assert sa.handles[i].plan_changes == sb.handles[i].plan_changes
    assert sa.summary() == sb.summary()
    assert sb.summary()["reconfigured_lanes"] >= 1
