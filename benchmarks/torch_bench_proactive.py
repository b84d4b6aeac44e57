"""E10 on the PyTorch port: proactive control under degradation — the twin
of ``bench_proactive.py`` (the full head-to-head and the smoke drill).

    PYTHONPATH=src python benchmarks/torch_bench_proactive.py [--device cpu]
        [--smoke]

``head_to_head()`` is the full E10: proactive Khaos (``KhaosConfig.
proactive``: forecast-driven plan switching at the predicted peak rate)
races reactive Khaos and two statics as lanes of ONE campaign on the
torch lane engine under a diurnal λ(t) ramp with injected gray failures
(straggler, directional net_delay, backpressure) and node crashes.  Both
Khaos lanes are supervised controller-in-the-loop by a single
``KhaosRuntime.drive_campaign`` call via ``lane_cfgs``; the only
difference between them is the proactive flag.  Its result is the
``"proactive"`` section of the ``bench_sim/3`` artifact, whose validator
gates a STRICT proactive win (``torch_bench_recovery._validate_proactive``).
QoS-violation seconds are simulated time, the same on any device.

``smoke()`` is the micro drill: a proactive Khaos controller supervises
one lane of a campaign on the torch lane engine under the same ramp, with
a backpressure window and a node crash right after it.  It gates
(``AssertionError`` on a regression):

  * >= 1 forecast-driven ("proactive") plan switch BEFORE the λ peak;
  * the crash's latency excursion trips the anomaly detector, whose
    sustained anomaly fires the ``reprofile`` rung — the phase log shows
    the legal re-entry optimizing -> reprofile -> profiled -> optimizing;
  * the backpressure window actually suppressed cadence slots.

Phase 2 (and the reprofile) profile as lanes of one campaign on the same
engine.  The engine runs on the CUDA device unless ``device`` names
another.
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.config import replace as cfg_replace
from repro_torch.core import AnomalyDetector, KhaosRuntime
from repro_torch.data.stream import dense_rates, record_workload
from repro_torch.ft.failures import Degradation
from repro_torch.sim import (BatchedDeployment, LaneSpec, SimCostModel,
                             make_campaign)


def _cost() -> SimCostModel:
    """Sync-stall checkpoint regime: a heavy full-stop write (8 s at full
    capacity loss) makes the cadence duty-cycle price BOTH latency and the
    post-failure replay drain, so the Eq.-8 optimum is load-dependent —
    the premise of a proactive plan switch."""
    return SimCostModel(capacity_eps=4600.0, base_latency_s=0.5,
                        ckpt_duration_s=8.0, ckpt_sync_penalty=1.0)


def ramp_schedule(base: float, amplitude: float, period: float):
    """Clean raised-cosine diurnal ramp: λ(0)=base, peak base*(1+amplitude)
    at period/2 — monotone rise then fall, so "before the peak" is a
    well-defined assertion target."""
    def rate(t: float) -> float:
        x = 2.0 * np.pi * (t % period) / period
        return float(base * (1.0 + amplitude * 0.5 * (1.0 - np.cos(x))))
    return rate


def _violations(camp, lane: int, l_const: float, r_const: float) -> dict:
    """QoS-violation seconds for one lane: recovery excess over r_const
    plus the count of ticks whose end-to-end latency exceeded l_const."""
    recs = [r["recovery_s"] for r in camp.recoveries[lane]]
    rec_viol = float(sum(max(0.0, r - r_const) for r in recs))
    ts = camp.times(lane)
    lat = camp.latency_history()[lane, :len(ts)]
    lat_viol = float(np.sum(lat > l_const))
    return {"recovery_violation_s": rec_viol,
            "latency_violation_s": lat_viol,
            "qos_violation_s": rec_viol + lat_viol,
            "recoveries_s": [float(r) for r in recs]}


def head_to_head(period: float = 14_400.0, opt_period: float = 120.0,
                 verbose: bool = True, device: Any = None,
                 engine: str = "device") -> dict:
    """Proactive vs reactive vs statics over one diurnal cycle; returns
    the artifact section ``torch_bench_recovery`` embeds as
    ``"proactive"`` (with the host's ``wall_s`` added)."""
    t_start = time.perf_counter()
    dev = device if engine == "device" else None
    cost = _cost()
    base, amp = 2200.0, 0.8                     # peak 3960 of 4600 capacity
    sched = ramp_schedule(base, amp, period)
    # r_const sits between the peak's best achievable recovery (~2000 s at
    # CI ~200) and what the mean-optimal CI needs there (~2700+ s): the
    # peak violates the stale plan but a proactive switch restores
    # feasibility.  l_const is loose enough that only a backlog excursion
    # (tight cadence near capacity) breaches it.
    l_const, r_const = 6.0, 2400.0
    horizon = int(period)

    # Phases 1-2 on a recording of the same ramp.  forecast_horizon=12
    # (24 min at the 120 s cycle) reaches far enough up the ramp to see
    # the breach coming without the long-horizon ARIMA overshoot.
    recording = record_workload(sched, duration=period, seed=7)
    ci_grid = np.geomspace(40.0, 300.0, 6)
    kcfg = KhaosConfig(latency_constraint=l_const,
                       recovery_constraint=r_const,
                       optimization_period=opt_period,
                       ci_min=40.0, ci_max=300.0,
                       reconfig_cooldown=2 * opt_period,
                       num_failure_points=4, smoothing_window=60,
                       forecast_horizon=12)
    rt = KhaosRuntime(kcfg)
    rt.record_steady_state(recording)
    rt.run_profiling(BatchedDeployment(cost, recording, warmup_s=600,
                                       max_recovery_s=3600.0, engine=engine,
                                       device=dev),
                     ci_grid, margin=120)
    ci0 = rt.initial_ci(float(np.mean(recording.counts)))

    # shared chaos schedule: every lane faces the same day.  The scale
    # factor keeps event times proportional when the period shrinks.
    # The decisive crash (5860 s) lands in the LEAD WINDOW: the forecast
    # already pre-acted but the measured rate has not yet breached
    # anything, so the reactive twin meets it on the stale plan — and the
    # store-path net_delay window (5800-7000 s) inflates every sync
    # barrier, leaving the tight stale cadence with negative drain
    # through the peak.
    s = period / 14_400.0
    crashes = ((2500.0 * s, "node"), (5860.0 * s, "node"))
    degradations = (
        Degradation(1200.0 * s, "straggler", 600.0 * s, severity=1.3),
        Degradation(5000.0 * s, "net_delay", 600.0 * s, severity=2.0,
                    jitter_s=0.5, direction="to_source"),
        Degradation(5800.0 * s, "net_delay", 1200.0 * s, severity=6.0,
                    jitter_s=1.0, direction="to_ckpt_store"),
        Degradation(9000.0 * s, "backpressure", 600.0 * s),
    )

    configs = [("Khaos-proactive", ci0 or 240.0),
               ("Khaos-reactive", ci0 or 240.0),
               ("static 40s", 40.0),
               ("static 480s", 480.0)]
    day_rates = dense_rates(0.0, horizon, schedule=sched)
    lanes = [LaneSpec(rates=day_rates, ci_s=float(ci),
                      failures=crashes, degradations=degradations,
                      tag={"name": name})
             for name, ci in configs]
    camp = make_campaign(cost, lanes, engine=engine, device=dev,
                         flink_semantics=False)
    sup = rt.drive_campaign(
        camp, lanes=[0, 1],
        lane_cfgs={0: cfg_replace(kcfg, proactive=True)})

    out = {"configs": [n for n, _ in configs], "horizon_s": float(horizon),
           "latency_constraint_s": l_const, "recovery_constraint_s": r_const,
           "initial_ci_s": float(ci0 or 240.0),
           "qos_violation_s": {}, "recovery_violation_s": {},
           "latency_violation_s": {}}
    for i, (name, _ci) in enumerate(configs):
        v = _violations(camp, i, l_const, r_const)
        out["qos_violation_s"][name] = v["qos_violation_s"]
        out["recovery_violation_s"][name] = v["recovery_violation_s"]
        out["latency_violation_s"][name] = v["latency_violation_s"]
        if verbose:
            reconf = len(sup.reconfigurations(i)) if i < 2 else 0
            print(f"{name:>16s}: qos-viol {v['qos_violation_s']:7.0f}s "
                  f"(rec {v['recovery_violation_s']:6.0f}s, lat "
                  f"{v['latency_violation_s']:5.0f}s)  recoveries "
                  f"{[round(r) for r in v['recoveries_s']]}  "
                  f"reconfigs {reconf}  "
                  f"bp-suppressed {int(camp.bp_suppressed[i])}")
    pro = [d for d in sup.controllers[0].decisions if d.kind == "proactive"]
    t0 = pro[0].t if pro else float("inf")
    # the reactive twin's "response" is its first departure from steady
    # operation AFTER the proactive lane had already re-planned — either a
    # breach-driven reconfigure or going unhealthy when the unpre-empted
    # breach materializes as a crash
    re_first = next((d.t for d in sup.controllers[1].decisions
                     if d.t > t0 and d.kind in ("reconfigure", "infeasible",
                                                "unhealthy")), float("nan"))
    out["proactive_decisions"] = len(pro)
    out["first_proactive_t"] = float(pro[0].t) if pro else float("nan")
    out["first_reactive_response_t"] = float(re_first)
    out["lead_s"] = float(re_first - pro[0].t) if pro else float("nan")
    out["bp_suppressed"] = [int(x) for x in camp.bp_suppressed[:len(configs)]]
    out["wall_s"] = time.perf_counter() - t_start
    if verbose and pro:
        print(f"proactive lead: first pre-act at t={pro[0].t:.0f}s, "
              f"reactive response at t={re_first:.0f}s "
              f"(lead {out['lead_s']:.0f}s over a {opt_period:.0f}s period; "
              f"{out['wall_s']:.2f} s on the host clock)")
    return out


def bench_proactive(device: Any = None) -> dict:
    print("\n=== E10: proactive vs reactive Khaos under gray failures "
          "(one campaign, twin controllers) ===")
    return head_to_head(device=device)


def smoke(device: Any = None) -> dict:
    """The micro proactive-control drill (see the module docstring)."""
    cost = _cost()
    period = 7200.0
    base, amp = 2200.0, 0.8
    sched = ramp_schedule(base, amp, period)
    l_const, r_const = 6.0, 2400.0

    recording = record_workload(sched, duration=period, seed=7)
    ci_grid = np.geomspace(40.0, 300.0, 5)
    kcfg = KhaosConfig(latency_constraint=l_const,
                       recovery_constraint=r_const,
                       optimization_period=60.0,
                       ci_min=40.0, ci_max=300.0,
                       reconfig_cooldown=120.0,
                       num_failure_points=3, smoothing_window=60,
                       forecast_horizon=12, proactive=True)
    rt = KhaosRuntime(kcfg)
    rt.record_steady_state(recording)
    deployment = BatchedDeployment(cost, recording, warmup_s=300,
                                   max_recovery_s=1800.0, engine="device",
                                   device=device)
    rt.run_profiling(deployment, ci_grid, margin=90)
    ci0 = rt.initial_ci(float(np.mean(recording.counts)))

    # arm the mitigation ladder: a small-p detector so the micro drill
    # warms; error_window=30 flushes the warm-up predictions' large
    # relative errors before the crash, so its latency spike is a hit
    rt.attach_anomaly_detector(
        AnomalyDetector(metrics=("latency",), p=3, d=1, threshold_sigma=3.0,
                        error_window=30, min_anomaly_len=1,
                        recovery_normal_len=5), lane=0)
    rt.enable_reprofiling(deployment, ci_grid)

    # backpressure holds the barrier, then the crash right after the window
    # loses the whole suppressed span -> latency excursion -> anomaly
    lane = LaneSpec(
        rates=dense_rates(0.0, int(period), schedule=sched),
        ci_s=float(ci0 or 240.0),
        failures=((2850.0, "node"),),
        degradations=(Degradation(2200.0, "backpressure", 600.0),),
        tag={"name": "proactive-drill"})
    camp = make_campaign(cost, [lane], engine="device", device=device,
                         flink_semantics=False)
    sup = rt.drive_campaign(camp, lanes=[0])

    pro = [d for d in sup.controllers[0].decisions if d.kind == "proactive"]
    t_peak = period / 2.0
    assert pro and pro[0].t < t_peak, \
        f"no proactive plan switch before the λ peak (t={t_peak:.0f}s): " \
        f"{[(d.t, d.kind) for d in sup.controllers[0].decisions][:40]}"
    seq = rt.phase_sequence()
    assert "reprofile" in seq, f"anomaly never fired the reprofile rung: {seq}"
    i = seq.index("reprofile")
    assert seq[:3] == ["steady_state", "profiled", "optimizing"] and \
        seq[i:i + 3] == ["reprofile", "profiled", "optimizing"], \
        f"illegal phase order around reprofile: {seq}"
    assert int(camp.bp_suppressed[0]) >= 1, \
        "backpressure window suppressed no cadence slot"
    assert any(k for _t, k, _ in rt.mitigations if k == "reprofile")
    print(f"proactive smoke OK: first pre-act t={pro[0].t:.0f}s "
          f"(peak {t_peak:.0f}s), reprofile at phase_log[{i}], "
          f"{int(camp.bp_suppressed[0])} suppressed slots ({camp.chunks} "
          f"device chunks on {camp.device})")
    return {"first_proactive_t": float(pro[0].t),
            "phase_sequence": seq,
            "bp_suppressed": int(camp.bp_suppressed[0]),
            "decisions_by_kind": sup.summary()["decisions_by_kind"],
            "device_chunks": camp.chunks}


def main(device: Any = None) -> dict:
    return bench_proactive(device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the lane engine (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the micro drill (default: the full head-to-head)")
    args = ap.parse_args()
    if args.smoke:
        smoke(device=args.device)
    else:
        main(device=args.device)
