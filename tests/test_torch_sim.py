"""The port's scalar simulator and cost model (``repro_torch.sim``) against
the JAX package's (``repro.sim``): the same cost model, schedule, CI,
plan and injected failures must give IDENTICAL metric series (both sides
are the same NumPy code: ``assert_array_equal``, no tolerance).
"""
import numpy as np
import pytest

from repro.config import CheckpointPlan as JPlan
from repro.data.stream import diurnal_rate as jdiurnal
from repro.data.stream import record_workload as jrecord
from repro.sim import SimCostModel as JCost
from repro.sim import SimDeployment as JSimDeployment
from repro.sim import StreamSimulator as JSim
from repro.sim import levels_due as jlevels_due
from repro_torch.config import CheckpointPlan as TPlan
from repro_torch.data.stream import diurnal_rate as tdiurnal
from repro_torch.data.stream import record_workload as trecord
from repro_torch.sim import SimCostModel as TCost
from repro_torch.sim import SimDeployment as TSimDeployment
from repro_torch.sim import StreamSimulator as TSim
from repro_torch.sim import costmodel_from_arch
from repro_torch.sim import levels_due as tlevels_due

PLANS = {
    "full-sync": {},
    "incr-dev-int8": dict(mode="incremental", full_every=4,
                          encode_placement="device", delta_codec="int8",
                          replication_factor=0),
    "multilevel-async": dict(levels=("memory", "local", "remote"),
                             local_every=2, remote_every=4, sync=False),
}
METRICS = ("throughput", "consumer_lag", "latency", "arrival_rate")


def _run(sim_cls, plan_cls, cost_cls, rate, plan_kw):
    cost = cost_cls(capacity_eps=2600.0, ckpt_duration_s=3.0,
                    delta_encode_s_per_byte=1e-10, state_bytes=2e9,
                    device_encode_s=0.4, device_encode_s_int8=0.2)
    sim = sim_cls(cost, ci_s=45.0, schedule=rate(base=1000.0, period=900.0),
                  plan=plan_cls(interval_s=45.0, **plan_kw))
    sim.inject_failure(300.0, "node")
    sim.inject_failure(700.0, "task")
    sim.inject_degradation(450.0, "straggler", 60.0, severity=2.0)
    sim.inject_degradation(520.0, "net_delay", 40.0, severity=1.5,
                           jitter_s=0.5, direction="to_ckpt_store")
    sim.inject_degradation(600.0, "backpressure", 50.0)
    sim.run_until(400.0)
    sim.set_plan(plan_cls(interval_s=30.0, mode="incremental",
                          full_every=2))
    sim.run_until(1500.0)
    return sim


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_simulator_series_match(plan):
    sj = _run(JSim, JPlan, JCost, jdiurnal, PLANS[plan])
    st = _run(TSim, TPlan, TCost, tdiurnal, PLANS[plan])
    for m in METRICS:
        a, b = sj.metrics.series(m), st.metrics.series(m)
        np.testing.assert_array_equal(np.asarray(a.times),
                                      np.asarray(b.times))
        np.testing.assert_array_equal(np.asarray(a.values),
                                      np.asarray(b.values))
    assert sj.recoveries == st.recoveries and st.recoveries
    assert (sj.ckpt_count, sj.save_count, sj.bp_suppressed) == \
        (st.ckpt_count, st.save_count, st.bp_suppressed)


def test_profile_failure_pairs_match():
    cost_j = JCost(capacity_eps=2600.0, ckpt_duration_s=2.0)
    cost_t = TCost(capacity_eps=2600.0, ckpt_duration_s=2.0)
    rj = jrecord(jdiurnal(base=1800.0, period=1800.0), duration=1800, seed=4)
    rt = trecord(tdiurnal(base=1800.0, period=1800.0), duration=1800, seed=4)
    for ci in (15.0, 60.0):
        dj = JSimDeployment(ci, rj, cost_j, warmup_s=120.0,
                            max_recovery_s=900.0)
        dt = TSimDeployment(ci, rt, cost_t, warmup_s=120.0,
                            max_recovery_s=900.0)
        for ft in (500.0, 1200.0):
            assert dj.profile_failure(ft, 60.0) == dt.profile_failure(ft, 60.0)
        assert dj.injector.log == dt.injector.log


def test_cost_model_prices_match():
    cj, ct = JCost(delta_encode_s_per_byte=1e-10, state_bytes=3e9), \
        TCost(delta_encode_s_per_byte=1e-10, state_bytes=3e9)
    for kw in PLANS.values():
        pj, pt = JPlan(interval_s=30.0, **kw), TPlan(interval_s=30.0, **kw)
        assert pj.name == pt.name
        for i in range(8):
            assert jlevels_due(pj, i) == tlevels_due(pt, i)
            assert cj.trigger_write_duration(pj, i) == \
                ct.trigger_write_duration(pt, i)
            assert cj.trigger_link_bytes(pj, i) == ct.trigger_link_bytes(pt, i)
        for kind in ("task", "node", "cluster"):
            assert cj.plan_downtime_s(pj, kind) == ct.plan_downtime_s(pt, kind)
            assert cj.plan_lost_work_multiplier(pj, kind) == \
                ct.plan_lost_work_multiplier(pt, kind)
        np.testing.assert_array_equal(
            cj.plan_overhead_fractions(pj, np.linspace(5, 120, 24)),
            ct.plan_overhead_fractions(pt, np.linspace(5, 120, 24)))
    from repro.sim import costmodel_from_arch as jfrom_arch
    assert vars(jfrom_arch(6_000_000_000, 0.8, 4096 * 256, 4096)) == \
        vars(costmodel_from_arch(6_000_000_000, 0.8, 4096 * 256, 4096))
