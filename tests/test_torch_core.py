"""The port's Khaos control plane (``repro_torch.core``) against the JAX
package's (``repro.core``), on the same numpy inputs made from a seed.

Both sides are the same NumPy code, so every comparison is EXACT: arrays
with ``assert_array_equal``, scalars and names with ``==``.
"""
import math

import numpy as np
import pytest

from repro import core as jcore
from repro.config import CheckpointPlan as JPlan
from repro.config import KhaosConfig as JKhaosConfig
from repro.data.stream import diurnal_rate as jdiurnal
from repro.data.stream import record_workload as jrecord
from repro.sim import SimCostModel as JCost
from repro.sim import SimDeployment as JSimDeployment
from repro.sim import SimJobHandle as JSimJobHandle
from repro.sim import StreamSimulator as JSim
from repro_torch import core as tcore
from repro_torch.config import CheckpointPlan as TPlan
from repro_torch.config import KhaosConfig as TKhaosConfig
from repro_torch.data.stream import diurnal_rate as tdiurnal
from repro_torch.data.stream import record_workload as trecord
from repro_torch.sim import SimCostModel as TCost
from repro_torch.sim import SimDeployment as TSimDeployment
from repro_torch.sim import SimJobHandle as TSimJobHandle
from repro_torch.sim import StreamSimulator as TSim

CALIBRATION = {
    "schema": "bench_ckpt/3", "state_bytes": 3.2e9, "full_write_s": 4.5,
    "restore_s": 12.0, "delta_fraction": 0.31, "delta_int8_fraction": 0.09,
    "delta_encode_s_per_byte": 2.5e-10,
    "device": {
        "lossless": {"bytes_on_link": 3.3e9, "link_fraction": 1.02,
                     "encode_s": 0.8, "pack_s": 0.05,
                     "per_leaf_encode_s": 0.9},
        "int8": {"bytes_on_link": 8.2e8, "link_fraction": 0.255,
                 "encode_s": 0.3, "pack_s": 0.05, "per_leaf_encode_s": 0.4},
    },
}


def _series(n=400, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return 1000 + 3 * t + 80 * np.sin(t / 17) + rng.normal(0, 10, n)


def _fit_pair(side, seed=0):
    rng = np.random.default_rng(seed)
    ci = rng.uniform(10, 120, 60)
    tr = rng.uniform(1000, 4000, 60)
    lat = 0.45 + 40.0 / ci + tr * 1e-5
    rec = 80.0 + 1.2 * ci + 0.01 * tr
    return side.QoSModel().fit(ci, tr, lat), side.QoSModel().fit(ci, tr, rec)


def test_online_arima_forecasts_match():
    m_j, m_t = jcore.OnlineARIMA(p=8, d=1, lr=0.1), \
        tcore.OnlineARIMA(p=8, d=1, lr=0.1)
    for y in _series():
        assert m_j.update(y) == m_t.update(y)
    np.testing.assert_array_equal(m_j.forecast(12), m_t.forecast(12))


def test_anomaly_detector_flags_match():
    rng = np.random.default_rng(3)
    dets = [jcore.AnomalyDetector(), tcore.AnomalyDetector()]
    flags = ([], [])
    for t in range(500):
        thr = 1000 + 30 * np.sin(t / 20) + rng.normal(0, 5)
        lag = 50 + 5 * np.sin(t / 10) + rng.normal(0, 2)
        if 300 <= t < 360:
            thr, lag = 0.0, 50 + 200 * (t - 299)
        for det, out in zip(dets, flags):
            out.append(det.observe(t, {"throughput": thr,
                                       "consumer_lag": lag},
                                   learn=not (300 <= t < 420)))
    assert flags[0] == flags[1]
    assert any(flags[0])
    assert dets[0].recoveries == dets[1].recoveries


@pytest.mark.parametrize("mode", ["throughput", "time"])
def test_select_failure_points_match(mode):
    rj = jrecord(jdiurnal(base=1000, amplitude=0.8, period=3600),
                 duration=3600, seed=0)
    rt = trecord(tdiurnal(base=1000, amplitude=0.8, period=3600),
                 duration=3600, seed=0)
    np.testing.assert_array_equal(rj.counts, rt.counts)
    sj = jcore.select_failure_points(rj, m=5, smoothing_window=30, mode=mode)
    st = tcore.select_failure_points(rt, m=5, smoothing_window=30, mode=mode)
    np.testing.assert_array_equal(sj.failure_times, st.failure_times)
    np.testing.assert_array_equal(sj.failure_rates, st.failure_rates)
    np.testing.assert_array_equal(sj.smoothed, st.smoothed)


def test_qos_models_and_optimize_ci_match():
    (lj, rj), (lt, rt) = _fit_pair(jcore), _fit_pair(tcore)
    for a, b in ((lj, lt), (rj, rt)):
        np.testing.assert_array_equal(a._beta, b._beta)
        np.testing.assert_array_equal(a._mu, b._mu)
        np.testing.assert_array_equal(a._sd, b._sd)
    ci = np.linspace(5, 150, 97)
    np.testing.assert_array_equal(lj.predict(ci, 2500.0),
                                  lt.predict(ci, 2500.0))
    for a, b in zip(lj.predict_pair(rj, ci, 1800.0),
                    lt.predict_pair(rt, ci, 1800.0)):
        np.testing.assert_array_equal(a, b)
    for tr_avg, l_const in ((2500.0, 1.0), (3900.0, 0.5)):
        oj = jcore.optimize_ci(lj, rj, tr_avg, l_const, 240.0, 1.1, 10, 120)
        ot = tcore.optimize_ci(lt, rt, tr_avg, l_const, 240.0, 1.1, 10, 120)
        assert vars(oj) == vars(ot)
    assert jcore.young_daly_interval(30.0, 3600.0) == \
        tcore.young_daly_interval(30.0, 3600.0)


def test_plan_variants_and_optimize_plan_match():
    cj = JCost.from_calibration(CALIBRATION, capacity_eps=4600.0,
                                ckpt_sync_penalty=0.6)
    ct = TCost.from_calibration(CALIBRATION, capacity_eps=4600.0,
                                ckpt_sync_penalty=0.6)
    assert {f: getattr(cj, f) for f in vars(cj)} == \
        {f: getattr(ct, f) for f in vars(ct)}
    vj = jcore.default_plan_variants(cj, ci_ref=60.0)
    vt = tcore.default_plan_variants(ct, ci_ref=60.0)
    assert [p.name for p in vj] == [p.name for p in vt]
    (lj, rj), (lt, rt) = _fit_pair(jcore), _fit_pair(tcore)
    for tr_avg, l_const in ((2500.0, 1.0), (3500.0, 0.6)):
        resj = jcore.optimize_plan(lj, rj, tr_avg, l_const, 240.0, 1.0, 10,
                                   120, cj)
        rest = tcore.optimize_plan(lt, rt, tr_avg, l_const, 240.0, 1.0, 10,
                                   120, ct)
        assert resj.feasible == rest.feasible
        assert (resj.plan.name if resj.plan else None) == \
            (rest.plan.name if rest.plan else None)
        assert resj.ci == rest.ci and resj.objective == rest.objective
        assert len(resj.candidates) == len(rest.candidates) == len(vj)
        for a, b in zip(resj.candidates, rest.candidates):
            assert a.plan.name == b.plan.name
            assert (a.ci, a.feasible, a.q_r, a.q_l, a.objective,
                    a.overhead) == (b.ci, b.feasible, b.q_r, b.q_l,
                                    b.objective, b.overhead)


def _controlled_run(core, cost_cls, sim_cls, handle_cls, cfg_cls, plan_cls):
    """A controller with the mechanism search over a simulated job under
    a rising diurnal load; returns its Decisions."""
    cost = cost_cls.from_calibration(CALIBRATION, capacity_eps=2600.0)
    sched = (jdiurnal if core is jcore else tdiurnal)(
        base=1800.0, amplitude=0.4, period=1800.0)
    sim = sim_cls(cost, ci_s=60.0, schedule=sched,
                  plan=plan_cls(interval_s=60.0))
    m_l, m_r = _fit_pair(core, seed=5)
    ctl = core.KhaosController(
        cfg=cfg_cls(latency_constraint=0.9, recovery_constraint=240.0,
                    optimization_period=30.0, ci_min=10, ci_max=120,
                    reconfig_cooldown=60.0),
        m_l=m_l, m_r=m_r, cost=cost)
    job = handle_cls(sim)
    sim.inject_failure(700.0, "node")
    while sim.t < 1500:
        sim.tick()
        ctl.maybe_optimize(job)
    return ctl.decisions, job


def test_controller_decisions_match_over_sim_handles():
    dj, hj = _controlled_run(jcore, JCost, JSim, JSimJobHandle,
                             JKhaosConfig, JPlan)
    dt, ht = _controlled_run(tcore, TCost, TSim, TSimJobHandle,
                             TKhaosConfig, TPlan)
    assert len(dj) == len(dt) > 10
    for a, b in zip(dj, dt):
        assert a.kind == b.kind and a.kind in tcore.Decision.KINDS
        for x, y in ((a.t, b.t), (a.latency, b.latency),
                     (a.tr_avg, b.tr_avg),
                     (a.predicted_recovery, b.predicted_recovery)):
            assert x == y or (math.isnan(x) and math.isnan(y))
        assert a.new_ci == b.new_ci
        assert (a.new_plan.name if a.new_plan else None) == \
            (b.new_plan.name if b.new_plan else None)
    assert {d.kind for d in dt} >= {"unhealthy", "reconfigure"}
    assert hj.plan_changes == ht.plan_changes


def _runtime_phases(core, cfg_cls, cost_cls, dep_cls, record, rate):
    cost = cost_cls(capacity_eps=2600.0, ckpt_duration_s=2.0)
    rec = record(rate(base=1500.0, amplitude=0.3, period=1200.0),
                 duration=1200, seed=2)
    cfg = cfg_cls(num_failure_points=2, num_configs=2, ci_min=20,
                  ci_max=90, optimization_period=30.0)
    rt = core.KhaosRuntime(cfg, cost=cost)
    with pytest.raises(core.PhaseError):
        rt.run_profiling(lambda ci: dep_cls(ci, rec, cost))
    with pytest.raises(core.PhaseError):
        rt.attach(object())
    rt.record_steady_state(rec)
    prof = rt.run_profiling(
        lambda ci: dep_cls(ci, rec, cost, warmup_s=60.0,
                           max_recovery_s=600.0), margin=60.0)
    with pytest.raises(core.PhaseError):
        rt.record_steady_state(rec)
    return rt, prof


def test_runtime_phases_and_profiling_match():
    rj, pj = _runtime_phases(jcore, JKhaosConfig, JCost, JSimDeployment,
                             jrecord, jdiurnal)
    rt, pt = _runtime_phases(tcore, TKhaosConfig, TCost, TSimDeployment,
                             trecord, tdiurnal)
    assert rj.phase_sequence() == rt.phase_sequence() == \
        ["steady_state", "profiled"]
    for a, b in zip(pj.flat(), pt.flat()):
        np.testing.assert_array_equal(a, b)
    assert rj.phase_log[-1].info == rt.phase_log[-1].info
    np.testing.assert_array_equal(rj.m_l._beta, rt.m_l._beta)
    np.testing.assert_array_equal(rj.m_r._beta, rt.m_r._beta)
    assert rj.initial_ci(1500.0) == rt.initial_ci(1500.0)
    sim = TSim(TCost(capacity_eps=2600.0), ci_s=60.0,
               schedule=tdiurnal(base=1500.0))
    with pytest.raises(TypeError, match="JobHandle"):
        rt.attach(object())
    rt.attach(TSimJobHandle(sim))
    assert rt.phase_sequence() == ["steady_state", "profiled", "optimizing"]
    sim.run_until(90.0)
    assert rt.step() is not None


def test_missing_handle_methods_and_protocol_match():
    assert jcore.JOB_HANDLE_METHODS == tcore.JOB_HANDLE_METHODS
    assert tcore.Decision.KINDS == jcore.Decision.KINDS
    sim = TSim(TCost(), ci_s=60.0, schedule=tdiurnal())
    assert tcore.missing_handle_methods(TSimJobHandle(sim)) == []
    assert tcore.missing_handle_methods(object()) == \
        jcore.missing_handle_methods(object()) == \
        list(tcore.JOB_HANDLE_METHODS)
    with pytest.raises(AssertionError):
        tcore.Decision(0.0, "bogus", 0.0, 0.0, 0.0)
