"""E10 on the PyTorch port: the proactive-control drill — the twin of
``bench_proactive.smoke``.

    PYTHONPATH=src python benchmarks/torch_bench_proactive.py [--device cpu]

A proactive Khaos controller (``KhaosConfig.proactive``: forecast-driven
plan switching at the predicted peak rate) supervises one lane of a
campaign on the torch lane engine under a diurnal λ(t) ramp, with a
backpressure window and a node crash right after it.  ``smoke()`` gates
(``AssertionError`` on a regression):

  * >= 1 forecast-driven ("proactive") plan switch BEFORE the λ peak;
  * the crash's latency excursion trips the anomaly detector, whose
    sustained anomaly fires the ``reprofile`` rung — the phase log shows
    the legal re-entry optimizing -> reprofile -> profiled -> optimizing;
  * the backpressure window actually suppressed cadence slots.

Phase 2 (and the reprofile) profile as lanes of one campaign on the same
engine.  The engine runs on the CUDA device unless ``device`` names
another.  (The reference's full head-to-head, ``bench_proactive.
head_to_head``, is not twinned here.)
"""
from __future__ import annotations

import argparse
from typing import Any

import numpy as np

from repro_torch.config import KhaosConfig
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


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the lane engine (default: cuda)")
    smoke(device=ap.parse_args().device)
