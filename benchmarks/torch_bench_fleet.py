"""E11 on the PyTorch port: fleet supervision — one control plane over
many jobs, with QoS-model transfer and admission control — the twin of
``bench_fleet.py``.

    PYTHONPATH=src python benchmarks/torch_bench_fleet.py \\
        [--engine numpy|device] [--device cpu] [--out PATH] [--smoke]

Eight jobs from four workload families (two constant-rate families in
different log2 rate bins, a diurnal family and a scalar-substrate family
with their own CI windows) run ALL THREE Khaos phases in one process
under a single ``FleetSupervisor``: Phase 1 per job at submit, Phase 2
POOLED (every cold job's z x m grid as lanes of one campaign),
Phase 3 multiplexed (one shared supervision campaign for the lane jobs,
scalar sims alongside, every controller polled on the same tick and
appending to one decision log).  A ninth firehose job is REJECTED by
admission control.

The artifact (``BENCH_fleet.json``, schema "bench_fleet/1") gates the
three fleet claims:

* SHARED TICK SCALES — supervising the 8-job fleet costs < 2x the
  controller wall-clock of supervising one job (the pooled campaign
  amortizes the tick across lanes);
* TRANSFER IS CHEAP — second-wave jobs whose fingerprints hit the
  ``QoSModelRegistry`` pay >= 5x less profiling lane-time than their
  cold-profiled donors (one validation-probe lane vs the z x m grid);
* TRANSFER IS SAFE — a transfer-admitted job's QoS-violation seconds
  stay within tolerance of its cold-profiled twin flying the same
  workload and the same failure schedule on the same shared campaign.

``smoke()`` is the micro drill ``benchmarks/torch_run.py --smoke`` runs:
three jobs (one cold, one transfer-admitted, one rejected) through the
same pipeline, with the emitted artifact validated against the schema.

Every campaign of the fleet (what-ifs, transfer probes, the pooled Phase
2, the shared Phase-3 campaign) runs on ``engine``: the torch lane engine
(``"device"``, on the CUDA device unless ``device`` names another) by
default, or the NumPy lanes (``"numpy"``), bit for bit the same fleet.
The artifact's ``wallclock`` section holds the host-clock measurements
(the controller wall-clocks, and the seconds of the pooled Phase 2 and
of one fleet build); every other key depends on the fleet alone.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.config import replace as cfg_replace
from repro_torch.data.stream import constant_rate, diurnal_rate
from repro_torch.fleet import FleetJobSpec, FleetSupervisor
from repro_torch.sim import SimCostModel

MIN_TRANSFER_RATIO = 5.0
MAX_WALLCLOCK_RATIO = 2.0
TWIN_TOLERANCE_S = 60.0


def _cost() -> SimCostModel:
    """One shared pricing model for the whole fleet (that is what makes
    the pooled campaign a single sweep), at modest utilization — the
    regime where fitted QoS surfaces genuinely transfer between
    near-twin jobs."""
    return SimCostModel(capacity_eps=2600.0, ckpt_duration_s=1.0,
                        state_bytes=2e9)


def _kcfg(**over) -> KhaosConfig:
    base = KhaosConfig(latency_constraint=1.5, recovery_constraint=240.0,
                       optimization_period=30.0, ci_min=10.0, ci_max=120.0,
                       num_failure_points=3, num_configs=3,
                       record_seconds=600.0, reconfig_cooldown=60.0)
    return cfg_replace(base, **over) if over else base


def _spec(name: str, sched, cfg: KhaosConfig, seed: int,
          substrate: str = "lane", horizon_s: float = 900.0) -> FleetJobSpec:
    return FleetJobSpec(name, _cost(), cfg, schedule=sched, seed=seed,
                        substrate=substrate, horizon_s=horizon_s,
                        failures=((500.0, "node"),),
                        profile_warmup_s=120.0,
                        profile_max_recovery_s=600.0)


# ---------------------------------------------------------------------------
# artifact schema gate
# ---------------------------------------------------------------------------

def validate_fleet_artifact(art: dict, min_jobs: int = 8) -> None:
    """Schema + claims gate for BENCH_fleet.json (raises ValueError)."""
    if art.get("schema") != "bench_fleet/1":
        raise ValueError(f"bench_fleet schema mismatch: {art.get('schema')}")
    for key in ("jobs", "transfer", "rejected", "decisions_by_kind",
                "shared_campaigns"):
        if key not in art:
            raise ValueError(f"bench_fleet artifact missing {key!r}")
    n_opt = sum(1 for j in art["jobs"].values()
                if j.get("phase") == "optimizing")
    if n_opt < min_jobs:
        raise ValueError(f"only {n_opt} jobs reached Phase 3 "
                         f"(need >= {min_jobs})")
    if art["shared_campaigns"] < 1:
        raise ValueError("no shared Phase-3 campaign was built")
    if not art["rejected"]:
        raise ValueError("admission control rejected nothing")
    tr = art["transfer"]
    if tr["n_transfer"] < 1:
        raise ValueError("no job was transfer-admitted")
    if tr["ratio"] < tr["min_ratio"]:
        raise ValueError(
            f"transfer profiling saving {tr['ratio']:.1f}x is below the "
            f"{tr['min_ratio']:.0f}x gate (cold {tr['cold_lane_ticks']:.0f} "
            f"ticks vs transfer {tr['transfer_lane_ticks']:.0f})")
    wc = art.get("wallclock")
    if wc is not None and not wc["ratio"] < wc["max_ratio"]:
        raise ValueError(
            f"fleet controller wall-clock {wc['fleet_s']:.3f}s is "
            f"{wc['ratio']:.2f}x the one-job baseline "
            f"{wc['one_job_s']:.3f}s (gate < {wc['max_ratio']:.1f}x)")
    for tw in art.get("twins", []):
        if abs(tw["delta_s"]) > tw["tolerance_s"]:
            raise ValueError(
                f"transfer twin {tw['transfer']} diverged from cold twin "
                f"{tw['cold']}: qos-violation delta {tw['delta_s']:.0f}s "
                f"exceeds {tw['tolerance_s']:.0f}s")


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------

WALLCLOCK_REPS = 3       # min-of-N: the claim is intrinsic controller
                         # cost, so the noise-robust estimator is the
                         # minimum over fresh builds, for BOTH sides


def _one_job_baseline(reps: int = WALLCLOCK_REPS, engine: str = "device",
                      device: Any = None) -> float:
    """Controller wall-clock of supervising ONE job end to end — the
    denominator of the shared-tick claim (min over ``reps`` builds)."""
    best = float("inf")
    for _ in range(reps):
        sup = FleetSupervisor(fleet_capacity_eps=6000.0, engine=engine,
                              device=device)
        assert sup.submit(_spec("solo", constant_rate(1250.0), _kcfg(),
                                seed=11)).admitted
        sup.run_profiling_pooled()
        sup.start()
        t0 = time.perf_counter()
        sup.run(900.0, chunk_s=30.0)
        best = min(best, time.perf_counter() - t0)
    return best


def _build_fleet(engine: str = "device", device: Any = None):
    """Submit both waves (plus the rejected firehose), pool Phase 2, and
    start Phase 3 — everything up to (not including) the timed run.  The
    last item returned is the seconds of the first pooled Phase 2."""
    sup = FleetSupervisor(fleet_capacity_eps=13_000.0, engine=engine,
                          device=device)
    cfg_a, cfg_b = _kcfg(), _kcfg()
    cfg_c = _kcfg(ci_min=15.0, ci_max=150.0)      # diurnal family
    cfg_d = _kcfg(ci_min=12.0, ci_max=110.0)      # scalar family
    wave1 = [
        _spec("iot-cold", constant_rate(650.0), cfg_a, seed=0),
        _spec("ysb-cold", constant_rate(1250.0), cfg_b, seed=1),
        _spec("diurnal-cold", diurnal_rate(base=450.0, amplitude=0.4),
              cfg_c, seed=2),
        _spec("scalar-cold", constant_rate(1000.0), cfg_d, seed=3,
              substrate="scalar", horizon_s=300.0),
    ]
    for s in wave1:
        dec = sup.submit(s)
        assert dec.admitted, (s.name, dec.reason)
    rejected = sup.submit(_spec("firehose", constant_rate(20_000.0),
                                _kcfg(), seed=8))
    t0 = time.perf_counter()
    prof = sup.run_profiling_pooled()
    phase2_s = time.perf_counter() - t0

    wave2 = [
        _spec("iot-xfer", constant_rate(650.0), cfg_a, seed=4),
        _spec("ysb-xfer", constant_rate(1250.0), cfg_b, seed=5),
        _spec("diurnal-xfer", diurnal_rate(base=450.0, amplitude=0.4),
              cfg_c, seed=6),
        _spec("scalar-xfer", constant_rate(1000.0), cfg_d, seed=7,
              substrate="scalar", horizon_s=300.0),
    ]
    for s in wave2:
        dec = sup.submit(s)
        assert dec.admitted, (s.name, dec.reason)
    sup.run_profiling_pooled()      # safety net: cold path for failed probes

    sup.start()
    return sup, rejected, prof, len(wave1) + len(wave2), phase2_s


def bench_fleet(out: str = "BENCH_fleet_torch.json", verbose: bool = True,
                engine: str = "device", device: Any = None,
                gate_wallclock: bool = True,
                reps: int = WALLCLOCK_REPS) -> dict:
    """E11 on ``engine``: the artifact, validated (the wall-clock claim
    too unless ``gate_wallclock`` is False) and written to ``out``.  Each
    wall-clock is the minimum over ``reps`` fresh builds."""
    one_job_s = _one_job_baseline(reps=reps, engine=engine, device=device)

    fleet_s = phase2_s = build_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sup, rejected, prof, n_jobs, p2 = _build_fleet(engine, device)
        t1 = time.perf_counter()
        status = sup.run(900.0, chunk_s=30.0)
        fleet_s = min(fleet_s, time.perf_counter() - t1)
        build_s = min(build_s, t1 - t0)
        phase2_s = min(phase2_s, p2)

    cold = [j for j in sup.jobs.values() if j.runtime is not None
            and not j.transferred and j.reprofiles == 0]
    xfer = [j for j in sup.jobs.values() if j.transferred]
    cold_ticks = float(np.mean([j.profiling_lane_ticks for j in cold]))
    xfer_ticks = float(np.mean([j.profiling_lane_ticks for j in xfer])) \
        if xfer else float("inf")
    twins = []
    for c, x in (("iot-cold", "iot-xfer"), ("ysb-cold", "ysb-xfer")):
        if not sup.jobs[x].transferred:
            continue
        vc = sup.qos_violations(c)["qos_violation_s"]
        vx = sup.qos_violations(x)["qos_violation_s"]
        twins.append({"cold": c, "transfer": x,
                      "cold_qos_violation_s": vc,
                      "transfer_qos_violation_s": vx,
                      "delta_s": vx - vc,
                      "tolerance_s": TWIN_TOLERANCE_S})

    art = {
        "schema": "bench_fleet/1",
        "fleet_capacity_eps": sup.fleet_capacity_eps,
        "jobs": status["jobs"],
        "pooled_phase2": prof,
        "shared_campaigns": status["shared_campaigns"],
        "decisions_by_kind": status["decisions_by_kind"],
        "rejected": [n for n, j in sup.jobs.items()
                     if j.status == "rejected"],
        "rejected_reason": rejected.reason,
        "wallclock": {"one_job_s": one_job_s, "fleet_s": fleet_s,
                      "ratio": fleet_s / max(one_job_s, 1e-9),
                      "max_ratio": MAX_WALLCLOCK_RATIO,
                      "reps": reps,
                      "pooled_phase2_s": phase2_s, "build_s": build_s},
        "transfer": {"n_transfer": len(xfer), "n_cold": len(cold),
                     "cold_lane_ticks": cold_ticks,
                     "transfer_lane_ticks": xfer_ticks,
                     "ratio": cold_ticks / max(xfer_ticks, 1e-9),
                     "min_ratio": MIN_TRANSFER_RATIO},
        "twins": twins,
    }
    validate_fleet_artifact(art if gate_wallclock else {
        k: v for k, v in art.items() if k != "wallclock"}, min_jobs=8)
    with open(out, "w") as f:
        json.dump(art, f, indent=2)
    if verbose:
        wc, tr = art["wallclock"], art["transfer"]
        print(f"fleet of {n_jobs} on the {engine} engine: controller "
              f"wall-clock "
              f"{wc['fleet_s']:.3f}s vs one-job {wc['one_job_s']:.3f}s "
              f"({wc['ratio']:.2f}x, gate < {wc['max_ratio']:.1f}x)")
        print(f"transfer profiling: cold {tr['cold_lane_ticks']:.0f} lane-"
              f"ticks vs transfer {tr['transfer_lane_ticks']:.0f} "
              f"({tr['ratio']:.1f}x less, gate >= {tr['min_ratio']:.0f}x); "
              f"{tr['n_transfer']} of {n_jobs // 2} wave-2 jobs "
              f"transferred")
        for tw in twins:
            print(f"twin {tw['cold']} vs {tw['transfer']}: qos-violation "
                  f"{tw['cold_qos_violation_s']:.0f}s vs "
                  f"{tw['transfer_qos_violation_s']:.0f}s "
                  f"(|delta| <= {tw['tolerance_s']:.0f}s)")
        print(f"rejected: {art['rejected']} ({art['rejected_reason']}); "
              f"decisions {art['decisions_by_kind']}; pooled Phase 2 "
              f"{phase2_s:.3f}s, fleet build {build_s:.3f}s")
        print(f"wrote {out}")
    return art


# ---------------------------------------------------------------------------
# smoke drill (torch_run.py --smoke)
# ---------------------------------------------------------------------------

def smoke(tmpdir: str, engine: str = "device", device: Any = None) -> dict:
    """Micro fleet drill: one cold job, one transfer-admitted twin, one
    firehose rejected by admission — the emitted artifact must validate
    against "bench_fleet/1" (AssertionError/ValueError on regression)."""
    os.makedirs(tmpdir, exist_ok=True)
    sup = FleetSupervisor(fleet_capacity_eps=4500.0, engine=engine,
                          device=device)
    cfg = _kcfg()

    def spec(name, rate, seed, horizon=300.0):
        return FleetJobSpec(name, _cost(), cfg, schedule=constant_rate(rate),
                            seed=seed, horizon_s=horizon,
                            profile_warmup_s=120.0,
                            profile_max_recovery_s=600.0)

    assert sup.submit(spec("cold", 1250.0, seed=0)).action == "admit"
    sup.run_profiling_pooled()
    dec = sup.submit(spec("xfer", 1250.0, seed=1))
    assert dec.action == "admit_transfer", \
        f"twin did not ride the registry: {dec.action} ({dec.reason})"
    rej = sup.submit(spec("firehose", 20_000.0, seed=2))
    assert rej.action == "reject", rej.action
    sup.start()
    status = sup.run(300.0, chunk_s=30.0)

    cold, xfer = sup.jobs["cold"], sup.jobs["xfer"]
    art = {
        "schema": "bench_fleet/1",
        "fleet_capacity_eps": sup.fleet_capacity_eps,
        "jobs": status["jobs"],
        "shared_campaigns": status["shared_campaigns"],
        "decisions_by_kind": status["decisions_by_kind"],
        "rejected": [n for n, j in sup.jobs.items()
                     if j.status == "rejected"],
        "transfer": {"n_transfer": 1, "n_cold": 1,
                     "cold_lane_ticks": float(cold.profiling_lane_ticks),
                     "transfer_lane_ticks": float(xfer.profiling_lane_ticks),
                     "ratio": cold.profiling_lane_ticks /
                     max(xfer.profiling_lane_ticks, 1),
                     "min_ratio": MIN_TRANSFER_RATIO},
    }
    path = os.path.join(tmpdir, "BENCH_fleet.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=2)
    with open(path) as f:
        validate_fleet_artifact(json.load(f), min_jobs=2)
    print(f"fleet smoke OK: cold/transfer/rejected = "
          f"{[j['status'] for j in status['jobs'].values()]}, "
          f"transfer saving {art['transfer']['ratio']:.1f}x, "
          f"artifact validated at {path}")
    return art


def main(out: str = "BENCH_fleet_torch.json", device: Any = None,
         engine: str = "device") -> dict:
    print("\n=== E11: fleet supervisor — admission, QoS-model transfer, "
          "one multiplexed tick over 8 jobs ===")
    return bench_fleet(out, engine=engine, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="device", choices=("numpy", "device"))
    ap.add_argument("--device", default=None,
                    help="torch device of the device engine (default: cuda)")
    ap.add_argument("--out", default="BENCH_fleet_torch.json")
    ap.add_argument("--smoke", action="store_true",
                    help="the three-job drill (artifact in a temporary "
                         "directory)")
    args = ap.parse_args()
    if args.smoke:
        with tempfile.TemporaryDirectory() as tmp:
            smoke(tmp, engine=args.engine, device=args.device)
    else:
        main(args.out, device=args.device, engine=args.engine)
