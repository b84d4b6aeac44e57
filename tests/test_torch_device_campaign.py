"""The port's torch lane engine (``repro_torch.sim.device.DeviceCampaign``)
against the port's NumPy lane engine, on the CPU: the full plan x crash
kind x degradation kind x CI matrix of ``benchmarks/torch_bench_campaign.py``
gives the same lag and latency histories, final state and recovery records
BIT FOR BIT, also under mid-run actuation and the Phase-3 controller loop,
and the exhaustive plan sweep on the torch engine matches or improves the
top-k replay.  The twin of ``tests/test_device_campaign.py`` (whose engine
the port holds to ``tests/test_torch_batched_sim.py``'s reference instead:
the JAX package's device engine needs a JAX it does not import under).
No tolerance anywhere in this file.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import CheckpointPlan, KhaosConfig
from repro_torch.core import KhaosRuntime, QoSModel, optimize_plan
from repro_torch.data.stream import constant_rate, dense_rates
from repro_torch.ft.failures import jitter_phase as np_phase
from repro_torch.sim import (BatchedCampaign, LaneSpec, SimCostModel,
                             make_campaign, make_plan_verifier)
from repro_torch.sim import device as dv
from repro_torch.sim.device import DeviceCampaign

ROOT = Path(__file__).resolve().parents[1]


def _bench():
    spec = importlib.util.spec_from_file_location(
        "torch_bench_campaign", ROOT / "benchmarks" / "torch_bench_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _bench()
COST = SimCostModel(capacity_eps=4600.0, base_latency_s=0.5,
                    ckpt_duration_s=3.0, ckpt_sync_penalty=0.6)
RATES = 3000.0 + 800.0 * np.sin(np.arange(900) / 40.0)
FINAL_STATE = ("lag", "consumed", "produced", "processed_total",
               "ckpt_count", "save_count", "steady_lag", "down", "t",
               "off_lvl", "last_off", "pol_last", "bp_suppressed", "fptr",
               "dptr", "af_active", "dg_cap_scale", "interval", "plan_id")


@pytest.fixture(scope="module", params=[400, 900])
def matrix(request):
    lanes = BENCH.parity_lanes(horizon=request.param)
    a = BatchedCampaign(COST, lanes).run()
    b = DeviceCampaign(COST, lanes, device="cpu").run()
    return request.param, a, b


def test_no_fma_contraction_and_numpy_remainder():
    """Eager torch rounds the tick's mul-add chain as NumPy does, and the
    jitter phase follows NumPy's remainder, also where t - t0 < 0."""
    assert dv.fma_contraction_active("cpu") is False
    assert dv.phase_matches_numpy("cpu") is True
    d = np.array([-3.75, -2.0, -1.5, -1.0, -0.25, -0.0, 0.0, 0.5, 1.0,
                  1.999, 2.0, 3.5])
    t0 = np.full(d.size, 100.0)
    got = dv.jitter_phase(torch.as_tensor(100.0 + d), torch.as_tensor(t0))
    np.testing.assert_array_equal(got.numpy(), np_phase(100.0 + d, t0))
    assert got.dtype == torch.float64


def test_matrix_lag_history_bitexact(matrix):
    _, a, b = matrix
    np.testing.assert_array_equal(a.lag_hist, b.lag_hist)


def test_matrix_latency_history_bitexact(matrix):
    _, a, b = matrix
    np.testing.assert_array_equal(a.latency_history(), b.latency_history())


def test_matrix_final_state_bitexact(matrix):
    _, a, b = matrix
    for name in FINAL_STATE:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            err_msg=name)
    assert BENCH.divergent_lanes(a, b) == 0


def test_matrix_recoveries_identical(matrix):
    horizon, a, b = matrix
    assert a.recoveries == b.recoveries
    if horizon == 900:
        assert sum(map(len, a.recoveries)) >= 20, \
            "the matrix must actually exercise recoveries"


def _popped_per_tick(times, ptr, t, ticks, n):
    """The events each tick pops, by stepping every lane's clock as the
    tick does (+1.0 per alive tick) and popping like the event loop."""
    clock, p = t.copy(), ptr.copy()
    want = np.zeros(n, dtype=np.int64)
    for d in range(n):
        for i in range(len(t)):
            cnt = 0
            while d < ticks[i] and p[i] < times.shape[1] \
                    and times[i, p[i]] <= clock[i]:
                p[i] += 1
                cnt += 1
            want[d] = max(want[d], cnt)
        clock = np.where(d < ticks, clock + 1.0, clock)
    return want


def test_event_passes_cover_every_event():
    """The host's count of event-loop passes per tick never falls short
    of the events a lane pops at that tick (fractional clocks, several
    events in one tick, a lane that stops), and a lane clock far from 0
    drifts by no more than the slack allows; the torch engine then
    equals the NumPy engine on such lanes."""
    t = np.array([0.3, 1000.7, 5.0, 12.0, 86400.1])
    times = np.array([[2.3, 2.31, 2.4, np.inf],
                      [1003.7, 1003.7, 1010.0, 1010.5],
                      [0.0, 4.0, 7.0, 7.0],
                      [np.inf] * 4,
                      [86401.1, 86403.1, 86403.1000001, 86419.1]])
    ptr = np.array([0, 1, 1, 0, 0])
    ticks = np.array([100, 100, 6, 100, 100])
    got = dv.event_passes(times, ptr, t, ticks, k0=0, n=20)
    want = _popped_per_tick(times, ptr, t, ticks, 20)
    assert (got >= want).all(), (got, want)
    assert want[2] == 2 and want[10] == 2 and got.sum() <= 2 * want.sum()

    rates = 2500.0 + 700.0 * np.sin(np.arange(700) / 30.0)
    lanes = [LaneSpec(rates=rates, ci_s=ci, t0=t0, failures=fails)
             for t0, ci, fails in (
                 (1234.567, 17.0, ((1300.0, "node"), (1300.4, "task"),
                                   (1302.567, "cluster"))),
                 (0.3, 23.0, ((150.3, "task"), (150.3, "node"))),
                 (86400.1, 31.0, ((86500.1, "node"), (86700.6, "task"))))]
    a = BatchedCampaign(COST, lanes).run()
    b = DeviceCampaign(COST, lanes, device="cpu",
                       history_chunk_bytes=8 * 3 * 50).run()
    assert b.chunks > 10
    np.testing.assert_array_equal(a.lag_hist, b.lag_hist)
    for name in FINAL_STATE:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.recoveries == b.recoveries and all(a.recoveries)


def test_midrun_plan_and_ci_switch_bitexact():
    """Actuation between run() calls — the drive_campaign contract —
    leaves both engines in the same state, including the flink-semantics
    savepoint restart a plan switch triggers."""
    lanes = [LaneSpec(rates=RATES[:600], ci_s=60.0,
                      failures=((150.0, "node"),)) for _ in range(4)]
    a = BatchedCampaign(COST, lanes)
    b = DeviceCampaign(COST, lanes, device="cpu")
    for camp in (a, b):
        camp.run(n_ticks=300)
        camp.lane_set_plan(1, CheckpointPlan(mode="incremental",
                                             full_every=8, sync=False))
        camp.lane_set_ci(2, 20.0)
        camp.run()
    np.testing.assert_array_equal(a.lag_hist, b.lag_hist)
    for name in FINAL_STATE:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            err_msg=name)
    assert a.recoveries == b.recoveries
    assert a.lane_plan(1).name == b.lane_plan(1).name


def test_compaction_and_early_exit_bitexact():
    """Mixed horizons with early exit: the torch engine compacts the same
    lanes at the same ticks and ends with the same results."""
    rates = 3000.0 + 800.0 * np.sin(np.arange(1500) / 40.0)
    lanes = [LaneSpec(rates=rates[:T], ci_s=20.0 + 10 * j,
                      failures=((100.0 + 13 * j, "node"),))
             for j, T in enumerate((300, 1500, 700, 1100))]
    kw = dict(early_exit=True, compact_every=64)
    a = BatchedCampaign(COST, lanes, **kw).run()
    b = DeviceCampaign(COST, lanes, device="cpu", **kw).run()
    assert b.compactions == a.compactions > 0
    assert (b.ticks_run, b.lanes_compacted) == (a.ticks_run,
                                                a.lanes_compacted)
    np.testing.assert_array_equal(a.lag_hist, b.lag_hist)
    assert a.recoveries == b.recoveries


def test_drive_campaign_device_matches_numpy():
    """The Phase-3 controller loop produces identical decisions and lane
    trajectories on either engine underneath."""
    rng = np.random.default_rng(0)
    ci = rng.uniform(10, 300, 150)
    tr = rng.uniform(800, 2200, 150)
    cost = SimCostModel(capacity_eps=2600.0, ckpt_duration_s=1.0)
    m_l = QoSModel().fit(ci, tr, cost.base_latency_s + 2.0 / ci)
    m_r = QoSModel().fit(ci, tr, 80 + 1.2 * ci + 0.02 * tr)
    cfg = KhaosConfig(latency_constraint=1.0, recovery_constraint=240.0,
                      optimization_period=30.0, ci_min=10, ci_max=300,
                      reconfig_cooldown=60.0)
    lanes = [LaneSpec(rates=dense_rates(0.0, 601,
                                        schedule=constant_rate(1800.0)),
                      ci_s=290.0)]
    sups = {}
    for engine, kw in (("numpy", {}), ("device", {"device": "cpu"})):
        rt = KhaosRuntime(cfg, cost=cost)
        rt.install_models(m_l, m_r)
        camp = make_campaign(cost, lanes, engine=engine, **kw)
        sups[engine] = (rt.drive_campaign(camp), camp)
    (sup_n, camp_n), (sup_d, camp_d) = sups["numpy"], sups["device"]
    assert isinstance(camp_d, DeviceCampaign)
    assert sup_n.handles[0].reconfigurations == \
        sup_d.handles[0].reconfigurations
    assert sup_n.handles[0].reconfigurations, "the controller must actuate"
    assert sup_n.handles[0].plan_changes == sup_d.handles[0].plan_changes
    assert [d.kind for d in sup_n.decisions(0)] == \
        [d.kind for d in sup_d.decisions(0)]
    np.testing.assert_array_equal(camp_n.lag_hist, camp_d.lag_hist)


def test_optimize_plan_exhaustive_device_matches_or_improves_topk():
    """The exhaustive sweep on the torch engine replays every feasible
    variant with measurements bit-identical to the NumPy verifier's, so
    its pick matches or improves the top-k pick's MEASURED objective."""
    cost = SimCostModel(capacity_eps=2600.0, ckpt_duration_s=1.5)
    rng = np.random.default_rng(0)
    ci = rng.uniform(10, 120, 200)
    tr = rng.uniform(1000, 2200, 200)
    m_l = QoSModel().fit(ci, tr, cost.base_latency_s + 40.0 / ci + tr * 1e-5)
    m_r = QoSModel().fit(ci, tr, 80.0 + 1.2 * ci + 0.01 * tr)
    kw = dict(tr_avg=1500.0, l_const=2.0, r_const=600.0, p=1.0,
              ci_min=10, ci_max=120, cost=cost, grid=32)
    ver = make_plan_verifier(cost, schedule=constant_rate(1500.0),
                             warmup_s=60.0, max_recovery_s=600.0)
    res_top = optimize_plan(m_l, m_r, verifier=ver, verify_top_k=2, **kw)
    ver = make_plan_verifier(cost, schedule=constant_rate(1500.0),
                             warmup_s=60.0, max_recovery_s=600.0,
                             device="cpu")
    res_ex = optimize_plan(m_l, m_r, verifier=ver, exhaustive=True,
                           engine="device", **kw)
    assert ver.engine == "device"        # optimize_plan(engine=) set it

    def measured(res):
        return {c.plan.name: c.sim["objective"] for c in res.candidates
                if c.sim is not None and c.sim["feasible"]}
    top_m, ex_m = measured(res_top), measured(res_ex)
    assert set(top_m) <= set(ex_m)
    for name, obj in top_m.items():
        assert ex_m[name] == obj
    assert res_ex.verified and res_top.verified
    assert min(ex_m.values()) <= min(top_m.values())
    assert ex_m[res_ex.plan.name] <= top_m[res_top.plan.name]


def test_make_campaign_factory_and_lazy_export():
    lanes = [LaneSpec(rates=RATES[:100], ci_s=30.0)]
    assert type(make_campaign(COST, lanes)) is BatchedCampaign
    camp = make_campaign(COST, lanes, engine="device", device="cpu")
    assert type(camp) is DeviceCampaign and camp.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown campaign engine"):
        make_campaign(COST, lanes, engine="cuda")
    with pytest.raises(ValueError, match="device engine"):
        make_campaign(COST, lanes, device="cpu")
    import repro_torch.sim
    assert repro_torch.sim.DeviceCampaign is DeviceCampaign


def test_device_campaign_without_cuda_or_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    lanes = [LaneSpec(rates=RATES[:100], ci_s=30.0)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCampaign(COST, lanes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_campaign(COST, lanes, engine="device")


def test_campaign_section_smoke_on_cpu():
    """``device_section(smoke=True)`` of the bench twin on the CPU: one
    throughput row and the parity matrix at horizon 400, zero divergent
    lanes."""
    sec = BENCH.device_section(smoke=True, device="cpu")
    assert sec["parity"]["divergent_lanes"] == 0
    assert sec["parity"]["fma_contraction"] is False
    assert sec["parity"]["phase_matches_numpy"] is True
    row = sec["throughput"][0]
    assert row["lanes"] == 256 and row["device_lane_ticks_per_s"] > 0
    assert sec["sweep"] is None


def test_trace_ticks_on_cpu():
    """The bench's tick trace runs on the CPU and reports no device
    figure there (a device number comes only from a card)."""
    out = BENCH.trace_ticks(64, ticks=8, device="cpu")
    assert out["wall_ms_per_tick"] > 0 and out["launches_per_tick"] == 0
    assert out["device_ms_per_tick"] is None
    assert out["device_busy_share"] is None
    assert out["top_ops"] and all(k.startswith("aten::")
                                  for k, _ in out["top_ops"])
