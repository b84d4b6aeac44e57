"""The port's fleet supervision (``repro_torch.fleet``): the twins of
``tests/test_fleet.py`` (registry transfer, admission control, pooled
profiling, the multiplexed Phase-3 tick, the bounded metrics plane), the
cases that drive campaigns on both lane engines (the torch engine on the
CPU), and the fleets of ``benchmarks/torch_bench_fleet.py`` held to the
JAX package's ``benchmarks/bench_fleet.py``.

Tolerance: none.  On the NumPy engine the port's fleet must equal the
reference's bit for bit (every job's status, phase, profiling lane-ticks
and QoS-violation seconds, the decisions by kind, and the shared decision
log), and on the torch lane engine it must equal its own NumPy run.
"""
import dataclasses
import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest

from repro_torch.config import KhaosConfig, replace
from repro_torch.core.qos_models import demo_prior_models
from repro_torch.core.runtime import KhaosRuntime, PhaseError
from repro_torch.data.stream import constant_rate, record_workload
from repro_torch.fleet import (DivergenceWatchdog, FleetJobSpec,
                               FleetSupervisor, JobFingerprint,
                               QoSModelRegistry, decide_admission,
                               fingerprint)
from repro_torch.metrics import MetricsStore, TimeSeries
from repro_torch.sim import BatchedDeployment, SimCostModel

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
#: (engine, device) of the campaign-driving cases
ENGINES = [("numpy", None), ("device", "cpu")]


def _cost(**kw):
    kw.setdefault("capacity_eps", 2600.0)
    kw.setdefault("ckpt_duration_s", 1.0)
    kw.setdefault("state_bytes", 1e9)
    return SimCostModel(**kw)


def _cfg(**kw):
    kw.setdefault("latency_constraint", 1.5)
    kw.setdefault("recovery_constraint", 240.0)
    kw.setdefault("optimization_period", 30.0)
    kw.setdefault("ci_min", 10.0)
    kw.setdefault("ci_max", 120.0)
    kw.setdefault("num_failure_points", 2)
    kw.setdefault("num_configs", 2)
    kw.setdefault("record_seconds", 400.0)
    kw.setdefault("reconfig_cooldown", 60.0)
    return KhaosConfig(**kw)


def _spec(name, rate=1200.0, **kw):
    kw.setdefault("cost", _cost())
    kw.setdefault("cfg", _cfg())
    kw.setdefault("schedule", constant_rate(rate))
    kw.setdefault("horizon_s", 300.0)
    kw.setdefault("profile_max_recovery_s", 600.0)
    return FleetJobSpec(name, **kw)


# ---------------------------------------------------------------------------
# fingerprints + registry
# ---------------------------------------------------------------------------

def test_fingerprint_matches_near_twin_and_misses_different_job():
    cfg = _cfg()
    rec_a = record_workload(constant_rate(1200.0), 400.0, seed=0)
    rec_b = record_workload(constant_rate(1200.0), 400.0, seed=7)
    fp_a = fingerprint(cfg, rec_a, state_bytes=1e9)
    fp_b = fingerprint(cfg, rec_b, state_bytes=1e9)
    assert fp_a.key() == fp_b.key()       # twin workloads collide (hit)
    # 4x the state -> different write/restore economics -> miss
    assert fingerprint(cfg, rec_a, 4e9).key() != fp_a.key()
    # 4x the rate envelope -> miss
    rec_hot = record_workload(constant_rate(4800.0), 400.0, seed=0)
    assert fingerprint(cfg, rec_hot, 1e9).key() != fp_a.key()
    # different CI search window -> miss
    assert fingerprint(replace(cfg, ci_max=300.0), rec_a, 1e9).key() \
        != fp_a.key()


def test_registry_roundtrip(tmp_path):
    m_l, m_r = demo_prior_models()
    cfg = _cfg()
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    fp = fingerprint(cfg, rec, 1e9)
    reg = QoSModelRegistry()
    assert reg.lookup(fp) is None
    reg.put(fp, m_l, m_r, "donor-job")
    path = str(tmp_path / "registry.json")
    reg.save(path)
    back = QoSModelRegistry.load(path)
    entry = back.lookup(fp)
    assert entry is not None and entry.source_job == "donor-job"
    ci = np.linspace(10, 60, 7)
    tr = np.linspace(200, 900, 7)
    np.testing.assert_allclose(entry.m_l.predict(ci, tr),
                               m_l.predict(ci, tr), rtol=1e-12)
    np.testing.assert_allclose(entry.m_r.predict(ci, tr),
                               m_r.predict(ci, tr), rtol=1e-12)


def test_divergence_watchdog_fires_once_per_episode():
    wd = DivergenceWatchdog(rel_err_threshold=0.5, patience=2)
    assert not wd.observe(1.0, 1.0)        # accurate
    assert not wd.observe(2.0, 1.0)        # bad x1
    assert wd.observe(2.0, 1.0)            # bad x2 -> fires
    assert not wd.observe(2.0, 1.0)        # same episode: no refire
    assert not wd.observe(1.0, 1.0)        # recovers
    assert not wd.observe(2.0, 1.0)
    assert wd.observe(2.0, 1.0)            # new episode fires again


# ---------------------------------------------------------------------------
# adopt_models phase legality
# ---------------------------------------------------------------------------

def test_adopt_models_requires_phase1_and_logs_transfer():
    m_l, m_r = demo_prior_models()
    rt = KhaosRuntime(_cfg())
    with pytest.raises(PhaseError):
        rt.adopt_models(m_l, m_r)          # Phase 1 has not run
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    rt.record_steady_state(rec)
    rt.adopt_models(m_l, m_r, source="neighbor")
    assert rt.phase == "profiled" and rt.transferred
    ev = rt.phase_log[-1]
    assert ev.phase == "profiled" and ev.info["transferred"] \
        and ev.info["source"] == "neighbor"


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,device", ENGINES)
def test_admission_rejects_queues_and_admits(engine, device):
    cost, cfg = _cost(), _cfg()
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    ok = decide_admission("j", cost, rec, cfg, residual_eps=8000.0,
                          engine=engine, device=device)
    assert ok.action == "admit" and ok.admitted
    over = decide_admission("j", cost, rec, cfg, residual_eps=500.0,
                            engine=engine, device=device)
    assert over.action == "reject" and not over.admitted
    q = decide_admission("j", cost, rec, cfg, residual_eps=500.0,
                         queueable=True, engine=engine, device=device)
    assert q.action == "queue" and not q.admitted


@pytest.mark.parametrize("engine,device", ENGINES)
def test_whatif_catches_recovery_infeasible_residual(engine, device):
    """A job that fits the budget at steady state but cannot drain its
    post-failure backlog at the residual capacity is still rejected —
    the what-if campaign, not the reservation arithmetic, catches it."""
    cost, cfg = _cost(), _cfg(recovery_constraint=60.0)
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    # residual barely above the reservation: replay drains too slowly
    d = decide_admission("j", cost, rec, cfg,
                         residual_eps=1500.0, headroom=0.0,
                         engine=engine, device=device)
    assert d.action == "reject"
    assert "what-if" in d.reason
    assert d.whatif_recovery_s > cfg.recovery_constraint


def test_numpy_engine_refuses_a_device():
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    with pytest.raises(ValueError, match="device="):
        decide_admission("j", _cost(), rec, _cfg(), residual_eps=8000.0,
                         device="cpu")


@pytest.mark.parametrize("engine,device", ENGINES)
def test_supervisor_queue_retry_after_capacity_frees(engine, device):
    sup = FleetSupervisor(fleet_capacity_eps=2600.0, engine=engine,
                          device=device)
    d1 = sup.submit(_spec("first", rate=1200.0))
    assert d1.admitted
    d2 = sup.submit(_spec("waiting", rate=1200.0, queueable=True))
    assert d2.action == "queue"
    assert sup.jobs["waiting"].status == "queued"
    # first job finishes -> its reservation is released -> retry admits
    sup.jobs["first"].status = "done"
    sup.reserved_eps -= sup.jobs["first"].admission.reserved_eps
    out = sup.retry_queued()
    assert [d.action for d in out] == ["admit"]
    assert sup.jobs["waiting"].status == "admitted"


# ---------------------------------------------------------------------------
# pooled profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,device", ENGINES)
def test_pooled_profiling_matches_solo_deployment(engine, device):
    """A job profiled as a slice of the POOLED multi-job campaign gets
    bit-identical (L, R) matrices to profiling alone through its own
    BatchedDeployment — lanes are independent, pooling is free."""
    sup = FleetSupervisor(fleet_capacity_eps=10_000.0, engine=engine,
                          device=device)
    sup.submit(_spec("a", rate=1200.0, seed=0))
    sup.submit(_spec("b", rate=1400.0, seed=1))
    sup.run_profiling_pooled()
    job = sup.jobs["a"]
    rt_solo = KhaosRuntime(_cfg())
    rt_solo.record_steady_state(job.recording)
    rt_solo.run_profiling(
        BatchedDeployment(job.spec.cost, job.recording,
                          warmup_s=job.spec.profile_warmup_s,
                          max_recovery_s=job.spec.profile_max_recovery_s),
        ci_values=rt_solo.default_ci_grid(),
        margin=job.spec.cfg.profile_margin_seconds)
    np.testing.assert_array_equal(job.runtime.profile.latencies,
                                  rt_solo.profile.latencies)
    np.testing.assert_array_equal(job.runtime.profile.recoveries,
                                  rt_solo.profile.recoveries)
    # both jobs walked the legal phase order through the shared sweep
    for name in ("a", "b"):
        assert sup.jobs[name].runtime.phase_sequence() == \
            ["steady_state", "profiled"]
    assert len(sup.registry) >= 1


# ---------------------------------------------------------------------------
# transfer fast path + divergence fallback (the tentpole loop)
# ---------------------------------------------------------------------------

def _fleet_with_transfer(divergence_threshold, patience=1, engine="numpy",
                         device=None):
    sup = FleetSupervisor(fleet_capacity_eps=10_000.0,
                          divergence_threshold=divergence_threshold,
                          divergence_patience=patience, engine=engine,
                          device=device)
    cfg = _cfg(num_failure_points=3, num_configs=3)
    assert sup.submit(_spec("donor", rate=1200.0, seed=0,
                            cfg=cfg)).action == "admit"
    sup.run_profiling_pooled()
    d = sup.submit(_spec("twin", rate=1200.0, seed=3, cfg=cfg))
    assert d.action == "admit_transfer"
    return sup


@pytest.mark.parametrize("engine,device", ENGINES)
def test_transfer_skips_phase2_with_less_lane_time(engine, device):
    sup = _fleet_with_transfer(divergence_threshold=1e9, engine=engine,
                               device=device)
    donor, twin = sup.jobs["donor"], sup.jobs["twin"]
    # the machine walked steady_state -> profiled WITHOUT a campaign
    assert twin.runtime.phase == "profiled" and twin.runtime.transferred
    assert twin.transfer_source == "donor"
    # cold z x m grid (9 lanes) vs ONE validation-probe lane
    assert donor.profiling_lane_ticks >= 5 * twin.profiling_lane_ticks
    sup.start()
    sup.run(300.0, chunk_s=30.0)
    assert twin.runtime.phase == "optimizing"
    assert twin.reprofiles == 0            # watchdog disabled: no fallback


@pytest.mark.parametrize("engine,device", ENGINES)
def test_transfer_divergence_triggers_reprofile_reentry(engine, device):
    sup = _fleet_with_transfer(divergence_threshold=1e-9, patience=1,
                               engine=engine, device=device)
    twin = sup.jobs["twin"]
    sup.start()
    sup.run(300.0, chunk_s=30.0)
    # the watchdog tripped: a REAL Phase-2 re-entry ran mid-supervision
    assert twin.reprofiles == 1 and not twin.transferred
    seq = twin.runtime.phase_sequence()
    i = seq.index("reprofile")
    # the detour is logged, then the machine re-walks the legal order
    # (phase snaps back to steady_state in place, so the next logged
    # events are the re-fit and the re-entry)
    assert seq[i:i + 3] == ["reprofile", "profiled", "optimizing"]
    # the re-fitted models are the job's own now, and the registry healed
    assert twin.runtime.transferred      # transfer HAPPENED historically
    entry = sup.registry.lookup(twin.fp)
    assert entry.source_job == "twin"
    assert twin.watchdog is None         # disarmed after self-fit


# ---------------------------------------------------------------------------
# the multiplexed tick: shared campaign, shared decision log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,device", ENGINES)
def test_supervisor_multiplexes_substrates_with_shared_decision_log(
        engine, device):
    sup = FleetSupervisor(fleet_capacity_eps=16_000.0, engine=engine,
                          device=device)
    for i in range(3):
        assert sup.submit(_spec(f"lane{i}", rate=1100.0 + 100 * i,
                                seed=i)).admitted
    assert sup.submit(_spec("scalar0", rate=1200.0, seed=9,
                            substrate="scalar")).admitted
    sup.run_profiling_pooled()
    sup.start()
    status = sup.run(300.0, chunk_s=30.0)
    # ONE shared campaign carries every lane job
    assert status["shared_campaigns"] == 1
    camp = sup.jobs["lane0"].campaign
    assert camp is sup.jobs["lane1"].campaign is sup.jobs["lane2"].campaign
    assert {sup.jobs[f"lane{i}"].lane for i in range(3)} == {0, 1, 2}
    # every job reached Phase 3 through its own machine
    for n, j in sup.jobs.items():
        assert j.runtime.phase == "optimizing", n
    # the shared decision log saw every job's controller, labeled
    labels = {label for label, _d in sup.decision_log}
    assert labels == {"lane0", "lane1", "lane2", "scalar0"}
    for label, d in sup.decision_log:
        assert d.kind in ("none", "defer", "reconfigure", "proactive",
                          "infeasible", "cooldown", "unhealthy")
    # per-job and per-fleet series landed in the monitor plane
    for n in ("lane0", "scalar0"):
        assert len(sup.metrics.series(f"{n}/latency")) > 0
    assert len(sup.metrics.series("fleet/jobs_optimizing")) > 0
    assert sup.qos_violations("lane0")["qos_violation_s"] >= 0.0


# ---------------------------------------------------------------------------
# bounded metrics plane
# ---------------------------------------------------------------------------

def test_bounded_timeseries_holds_memory_flat():
    ts = TimeSeries("x", maxlen=64, max_rollups=8)
    n = 20_000
    for i in range(n):
        ts.append(float(i), float(i % 100))
    # raw buffer and rollup list are both bounded -> flat memory
    assert len(ts.times) <= 64
    assert len(ts.rollups) <= 8
    # lifetime aggregates still see every sample
    assert ts.lifetime_count() == n
    ref = np.arange(n) % 100
    assert abs(ts.lifetime_mean() - ref.mean()) < 1.0
    assert ts.lifetime_max() == ref.max()
    # recent-window queries stay exact over the raw tail
    t, v = ts.window(n - 10, n)
    np.testing.assert_array_equal(v, ref[-10:])


def test_bounded_store_vs_unbounded_reference():
    bounded = MetricsStore(maxlen=32)
    exact = MetricsStore()
    rng = np.random.default_rng(0)
    vals = rng.uniform(0, 10, 5000)
    for i, v in enumerate(vals):
        bounded.record("m", float(i), float(v))
        exact.record("m", float(i), float(v))
    b, e = bounded.series("m"), exact.series("m")
    assert len(b.times) <= 32 and len(e.times) == 5000
    assert b.lifetime_count() == e.lifetime_count()
    assert abs(b.lifetime_mean() - np.mean(vals)) < 1e-9
    assert b.lifetime_max() == np.max(vals)
    # non-monotonic appends still rejected in bounded mode
    with pytest.raises(ValueError):
        b.append(0.0, 1.0)


def test_rollup_merge_preserves_aggregates():
    from repro_torch.metrics import Rollup
    a = Rollup(0.0, 9.0, 10, 2.0, 1.0, 5.0)
    b = Rollup(10.0, 19.0, 30, 4.0, 0.5, 9.0)
    m = a.merge(b)
    assert m.count == 40
    assert abs(m.mean - (2.0 * 10 + 4.0 * 30) / 40) < 1e-12
    assert m.vmin == 0.5 and m.vmax == 9.0
    assert m.t_start == 0.0 and m.t_end == 19.0


def test_fingerprint_key_format_is_stable():
    """Persisted registries (QoSModelRegistry.save) are keyed by this
    string — a format change silently orphans every saved surface on the
    next fleet restart, so the format is pinned as a literal."""
    fp = JobFingerprint(state_bytes_log2=30, rate_mean_bin=10,
                        rate_peak_bin=11, ci_window=(10.0, 120.0),
                        num_configs=12)
    assert fp.key() == "sb30-rm10-rp11-ci10_120-z12"
    # and a real fingerprint survives the JSON round trip key-intact
    cfg = _cfg()
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    real = fingerprint(cfg, rec, 1e9)
    m_l, m_r = demo_prior_models()
    reg = QoSModelRegistry()
    reg.put(real, m_l, m_r, "donor")
    back = QoSModelRegistry.from_dict(reg.to_dict())
    entry = back.lookup(real)
    assert entry is not None and entry.fp.key() == real.key()


def test_registry_save_is_restart_stable(tmp_path):
    """save -> load -> save must be byte-identical (a fleet restarting in
    a loop never rewrites its registry), and reloaded surfaces must
    predict bit-exactly, not just approximately."""
    m_l, m_r = demo_prior_models()
    cfg = _cfg()
    rec = record_workload(constant_rate(1200.0), 400.0, seed=0)
    reg = QoSModelRegistry()
    reg.put(fingerprint(cfg, rec, 1e9), m_l, m_r, "donor")
    p1, p2 = str(tmp_path / "r1.json"), str(tmp_path / "r2.json")
    reg.save(p1)
    back = QoSModelRegistry.load(p1)
    back.save(p2)
    with open(p1, "rb") as a, open(p2, "rb") as b:
        assert a.read() == b.read()
    ci = np.linspace(10, 60, 7)
    tr = np.linspace(200, 900, 7)
    entry = back.lookup(fingerprint(cfg, rec, 1e9))
    np.testing.assert_array_equal(entry.m_l.predict(ci, tr),
                                  m_l.predict(ci, tr))
    np.testing.assert_array_equal(entry.m_r.predict(ci, tr),
                                  m_r.predict(ci, tr))


# ---------------------------------------------------------------------------
# the E11 fleets against the JAX package's, and across the lane engines
# ---------------------------------------------------------------------------

def _load(name: str):
    """A bench module by file path, without touching ``sys.path``."""
    spec = importlib.util.spec_from_file_location(f"_fleet_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(x):
    """``x`` with every float replaced by its IEEE bytes (NaN == NaN)."""
    if isinstance(x, float):
        return struct.pack("<d", x)
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    return x


def _record(sup) -> dict:
    """What a supervised fleet did: per job its status, phase, profiling
    lane-ticks and (lane jobs) QoS-violation seconds; the decisions by
    kind; the shared decision log as (label, every Decision field, the
    new plan's name)."""
    status = sup.status()
    jobs = {}
    for name, j in sup.jobs.items():
        rec = {k: status["jobs"][name][k] for k in
               ("status", "phase", "admission", "transferred",
                "profiling_lane_ticks", "reprofiles")}
        if j.spec.substrate == "lane" and j.campaign is not None:
            rec["qos"] = sup.qos_violations(name)
        jobs[name] = rec
    log = [(label, *(getattr(d, f.name) for f in dataclasses.fields(d)
                     if f.name != "new_plan"),
            d.new_plan.name if d.new_plan is not None else None)
           for label, d in sup.decision_log]
    return _bits({"jobs": jobs, "kinds": status["decisions_by_kind"],
                  "t": status["t"], "reserved": status["reserved_eps"],
                  "log": log})


def _e11(mod, *args):
    sup = mod._build_fleet(*args)[0]
    sup.run(900.0, chunk_s=30.0)
    return sup


def _smoke(mod, monkeypatch, tmp_path, **kw):
    """Run ``mod.smoke`` and return the supervisor it built."""
    sups = []

    class Capturing(mod.FleetSupervisor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sups.append(self)
    monkeypatch.setattr(mod, "FleetSupervisor", Capturing)
    mod.smoke(str(tmp_path), **kw)
    assert len(sups) == 1
    return sups[0]


@pytest.fixture(scope="module")
def e11_numpy():
    return _record(_e11(_load("torch_bench_fleet"), "numpy"))


def test_e11_fleet_matches_reference(e11_numpy):
    ref = _record(_e11(_load("bench_fleet")))
    assert e11_numpy == ref
    kinds = {name: j["status"] for name, j in ref["jobs"].items()}
    assert sum(s == "done" for s in kinds.values()) == 8
    assert kinds["firehose"] == "rejected"
    assert len(ref["log"]) > 100


def test_e11_fleet_on_the_torch_lane_engine_matches_numpy(e11_numpy):
    dev = _record(_e11(_load("torch_bench_fleet"), "device", "cpu"))
    assert dev == e11_numpy


def test_smoke_fleet_matches_reference(monkeypatch, tmp_path):
    ref = _smoke(_load("bench_fleet"), monkeypatch, tmp_path / "ref")
    mod = _load("torch_bench_fleet")
    port = _smoke(mod, monkeypatch, tmp_path / "np", engine="numpy")
    assert _record(port) == _record(ref)
    dev = _smoke(mod, monkeypatch, tmp_path / "dev", engine="device",
                 device="cpu")
    assert _record(dev) == _record(port)
    assert [j.status for j in dev.jobs.values()] == \
        ["done", "done", "rejected"]


def test_bench_fleet_artifact_validates_on_the_cpu(tmp_path):
    """The whole E11 bench on the NumPy lanes: its artifact passes the
    validator (the host-clock wall-clock claim is the card's to hold) and
    the validator refuses a fleet without a rejection."""
    mod = _load("torch_bench_fleet")
    out = tmp_path / "BENCH_fleet_torch.json"
    art = mod.bench_fleet(str(out), verbose=False, engine="numpy",
                          gate_wallclock=False)
    assert out.exists() and art["transfer"]["ratio"] >= 5.0
    assert set(art["wallclock"]) >= {"one_job_s", "fleet_s", "ratio",
                                     "pooled_phase2_s", "build_s"}
    with pytest.raises(ValueError, match="rejected nothing"):
        mod.validate_fleet_artifact(
            {**{k: v for k, v in art.items() if k != "wallclock"},
             "rejected": []})
