"""E12 on the PyTorch port: the torch lane engine against the NumPy lane
engine — the twin of ``bench_campaign.py`` (the "device" section of the
``bench_sim/3`` artifact).

    PYTHONPATH=src python benchmarks/torch_bench_campaign.py [--device cpu]

Three measurements, one per claim the device engine makes:

  throughput   lane-ticks/s of the NumPy engine and of the torch engine
               (``sim.DeviceCampaign``) at 1e3/1e4/1e5 lanes of the same
               failure-bearing scenario (record_history=False).  The torch
               engine runs twice, cold (first use of the device included)
               and warm; the warm run is its number;
  parity       the hard gate: the full (plan x crash kind x degradation
               kind x CI) matrix through BOTH engines; a lane counts as
               divergent unless its lag history, latency history,
               recovery records and final counters are ALL bit-identical.
               ``divergent_lanes`` must be 0.  ``fma_contraction`` and
               ``phase_matches_numpy`` report the two device probes of
               ``sim.device``;
  trace        where a torch-engine tick's time goes (``trace_ticks``): a
               profiler window of 256 ticks, each with one crash-event
               pass, at a lane count — host wall per tick, device kernel
               time per tick, the device's busy share, kernel launches per
               tick, and the ops with the most device time;
  sweep        ``optimize_plan`` on the E4 scenario with the usual top-3
               replay (NumPy) vs the exhaustive full-variant-grid replay
               (torch engine).  The exhaustive replay scores a superset of
               the shortlist with bit-identical measurements, so its pick
               must match or improve the top-k pick's measured Eq.-8
               objective: ``exhaustive_objective <= topk_objective``.

The torch engine runs on the CUDA device unless ``device`` names another.
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np

from repro_torch.config import CheckpointPlan
from repro_torch.core import QoSModel, optimize_plan
from repro_torch.data.stream import constant_rate
from repro_torch.ft.failures import Degradation
from repro_torch.sim import (BatchedCampaign, LaneSpec, SimCostModel,
                             make_plan_verifier)
from repro_torch.sim.device import (DeviceCampaign, fma_contraction_active,
                                    phase_matches_numpy)

THR_TICKS = 2000
THR_LANE_COUNTS = (1_000, 10_000, 100_000)

PARITY_PLANS = (
    ("full-sync", None),
    ("full-async", CheckpointPlan(sync=False)),
    ("incr8-async", CheckpointPlan(mode="incremental", full_every=8,
                                   sync=False)),
    ("incr4-async-mlr", CheckpointPlan(mode="incremental", full_every=4,
                                       levels=("memory", "local", "remote"),
                                       local_every=1, remote_every=8)),
)
PARITY_KINDS = ("task", "node", "cluster")
PARITY_DEGRADATIONS = (
    ("straggler", Degradation(t=300.0, kind="straggler", duration_s=400.0,
                              severity=1.8)),
    ("net_delay_source", Degradation(t=250.0, kind="net_delay",
                                     duration_s=500.0, severity=3.0,
                                     jitter_s=0.8, direction="to_source")),
    ("net_delay_store", Degradation(t=250.0, kind="net_delay",
                                    duration_s=600.0, severity=4.0,
                                    jitter_s=1.0, direction="to_ckpt_store")),
    ("backpressure", Degradation(t=200.0, kind="backpressure",
                                 duration_s=150.0)),
)


def _thr_cost() -> SimCostModel:
    return SimCostModel(capacity_eps=4600.0, base_latency_s=0.5,
                        ckpt_duration_s=3.0, ckpt_sync_penalty=0.6)


def _thr_lanes(n: int, horizon: int = THR_TICKS) -> list[LaneSpec]:
    """n failure-bearing lanes sharing one λ array (the mega-campaign
    shape: many scenarios, one workload upload)."""
    rates = 3000.0 + 800.0 * np.sin(np.arange(horizon) / 40.0)
    return [LaneSpec(rates=rates, ci_s=float(10 + (i % 12) * 10),
                     failures=((300.0 + (i % 700), "task"),))
            for i in range(n)]


def bench_throughput(lane_counts=THR_LANE_COUNTS, horizon: int = THR_TICKS,
                     device: Any = None) -> list[dict]:
    """One row per lane count, both engines over the same lanes."""
    cost = _thr_cost()
    rows = []
    for n in lane_counts:
        lanes = _thr_lanes(n, horizon)
        t0 = time.perf_counter()
        BatchedCampaign(cost, lanes, record_history=False).run()
        wall_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        DeviceCampaign(cost, lanes, record_history=False,
                       device=device).run()
        wall_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        camp = DeviceCampaign(cost, lanes, record_history=False,
                              device=device).run()
        wall_warm = time.perf_counter() - t0
        np_rate = n * horizon / wall_np
        dev_rate = n * horizon / wall_warm
        rows.append({
            "lanes": n,
            "lane_ticks": n * horizon,
            "numpy_wall_s": wall_np,
            "device_wall_s": wall_warm,
            "numpy_lane_ticks_per_s": np_rate,
            "device_lane_ticks_per_s": dev_rate,
            "device_cold_wall_s": wall_cold,
            "device_chunks": camp.chunks,
            "device_speedup": dev_rate / np_rate,
        })
        print(f"  {n:>7d} lanes x {horizon} ticks: numpy "
              f"{np_rate / 1e6:8.3f}M t/s ({wall_np:.2f} s), device "
              f"{dev_rate / 1e6:8.3f}M t/s ({wall_warm:.2f} s; "
              f"{dev_rate / np_rate:.2f}x, cold {wall_cold:.2f} s)")
    return rows


def parity_lanes(horizon: int = 900) -> list[LaneSpec]:
    """The full scenario matrix both engines must agree on bit-for-bit:
    every plan x crash kind x CI with two injections, every plan x
    degradation kind with and without a concurrent crash, and pure
    no-failure lanes."""
    rates = 3000.0 + 800.0 * np.sin(np.arange(horizon) / 40.0)
    lanes = []
    for pi, (_name, plan) in enumerate(PARITY_PLANS):
        for kind in PARITY_KINDS:
            for ci in (15.0, 45.0):
                lanes.append(LaneSpec(
                    rates=rates, ci_s=ci, plan=plan,
                    failures=((200.0 + 20 * pi, kind), (560.0, "task"))))
    for _name, plan in PARITY_PLANS:
        for _dname, deg in PARITY_DEGRADATIONS:
            for fails in ((), ((400.0, "task"),)):
                lanes.append(LaneSpec(rates=rates, ci_s=20.0, plan=plan,
                                      failures=fails, degradations=[deg]))
    for _name, plan in PARITY_PLANS:
        lanes.append(LaneSpec(rates=rates, ci_s=25.0, plan=plan))
    return lanes


#: per-lane final counters the parity gate compares
PARITY_STATE = ("lag", "consumed", "produced", "processed_total",
                "ckpt_count", "save_count", "steady_lag", "down", "t",
                "bp_suppressed")


def divergent_lanes(a: BatchedCampaign, b: BatchedCampaign) -> int:
    """Count lanes that differ ANYWHERE: history, latency, recoveries, or
    final counters.  Bit-exact comparison — no tolerance."""
    n = a.n_lanes
    bad = np.zeros(n, dtype=bool)
    if a.lag_hist is not None:
        bad |= (a.lag_hist != b.lag_hist).any(axis=1)
        bad |= (a.latency_history() != b.latency_history()).any(axis=1)
    for name in PARITY_STATE:
        bad |= np.asarray(getattr(a, name)) != np.asarray(getattr(b, name))
    bad |= (a.off_lvl != b.off_lvl).any(axis=1)
    for i in range(n):
        if a.recoveries[i] != b.recoveries[i]:
            bad[i] = True
    return int(bad.sum())


def parity_check(horizon: int = 900, device: Any = None) -> dict:
    cost = _thr_cost()
    lanes = parity_lanes(horizon)
    t0 = time.perf_counter()
    a = BatchedCampaign(cost, lanes).run()
    wall_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = DeviceCampaign(cost, lanes, device=device).run()
    wall_dev = time.perf_counter() - t0
    div = divergent_lanes(a, b)
    out = {"lanes": len(lanes), "ticks": horizon,
           "divergent_lanes": div,
           "recoveries": sum(len(r) for r in a.recoveries),
           "fma_contraction": bool(fma_contraction_active(device)),
           "phase_matches_numpy": bool(phase_matches_numpy(device)),
           "numpy_wall_s": wall_np, "device_wall_s": wall_dev,
           "device_chunks": b.chunks}
    print(f"  parity: {len(lanes)} lanes x {horizon} ticks, {div} divergent, "
          f"{out['recoveries']} recoveries (fma_contraction="
          f"{out['fma_contraction']}, phase_matches_numpy="
          f"{out['phase_matches_numpy']})")
    return out


def profile_advance(camp: DeviceCampaign, advance) -> dict:
    """Run ``advance()`` (which moves ``camp`` on by some ticks) under
    ``torch.profiler``: host wall per tick, device kernel time per tick,
    the device's busy share, kernel launches per tick, and the ops with
    the most device time.  Device figures are None off a CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = camp.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    k0 = camp._step_idx
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        advance()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks = camp._step_idx - k0
    events = prof.key_averages()

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 if cuda else None
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=dev_us if cuda else (lambda e: e.self_cpu_time_total),
                 reverse=True)
    return {"lanes": camp.n_lanes, "ticks": ticks,
            "wall_ms_per_tick": wall * 1e3 / ticks,
            "device_ms_per_tick": busy_ms / ticks if cuda else None,
            "device_busy_share": busy_ms / (wall * 1e3) if cuda else None,
            "launches_per_tick": sum(e.count for e in events
                                     if e.key == "cudaLaunchKernel") / ticks,
            "top_ops": [(e.key, e.count // ticks) for e in ops[:4]]}


def trace_ticks(n: int, ticks: int = 256, device: Any = None) -> dict:
    """Profile ``ticks`` torch-engine ticks of the throughput scenario at
    ``n`` lanes, after 256 warm ticks (so the window starts 44 ticks
    before the first crash and holds one crash-event pass a tick from
    there)."""
    camp = DeviceCampaign(_thr_cost(), _thr_lanes(n, THR_TICKS),
                          record_history=False, device=device)
    camp.run(n_ticks=256)
    out = profile_advance(camp, lambda: camp.run(n_ticks=ticks))
    print(f"  trace {n} lanes: {out['wall_ms_per_tick']:.3f} ms a tick on "
          f"the host clock (profiled), device "
          f"{out['device_ms_per_tick']} ms a tick, busy share "
          f"{out['device_busy_share']}, {out['launches_per_tick']:.0f} "
          f"launches a tick; top ops {out['top_ops']}")
    return out


# ---------------------------------------------------------------------------
# exhaustive sweep vs top-k replay (E4 scenario)
# ---------------------------------------------------------------------------

def _e4_surfaces(cost: SimCostModel) -> tuple[QoSModel, QoSModel]:
    """Analytic stand-in QoS surfaces on the E4 envelope — the surfaces
    only pick the shortlist; the replay measurements decide the winner."""
    rng = np.random.default_rng(0)
    ci = rng.uniform(10, 240, 200)
    tr = rng.uniform(2000, 3600, 200)
    m_l = QoSModel().fit(ci, tr, cost.base_latency_s + 40.0 / ci + tr * 1e-5)
    m_r = QoSModel().fit(ci, tr, 80.0 + 1.2 * ci + 0.01 * tr)
    return m_l, m_r


def measured_objective(res) -> float:
    objs = [c.sim["objective"] for c in res.candidates
            if c.sim is not None and c.sim["feasible"]]
    return float(min(objs)) if objs else float("nan")


def bench_sweep(rate: float = 3000.0, l_const: float = 2.0,
                r_const: float = 600.0, max_recovery_s: float = 1200.0,
                grid: int = 64, device: Any = None) -> dict:
    cost = _thr_cost()
    m_l, m_r = _e4_surfaces(cost)
    kw = dict(tr_avg=rate, l_const=l_const, r_const=r_const, p=1.0,
              ci_min=10.0, ci_max=240.0, cost=cost, grid=grid)

    ver = make_plan_verifier(cost, schedule=constant_rate(rate),
                             warmup_s=120.0, max_recovery_s=max_recovery_s)
    t0 = time.perf_counter()
    res_top = optimize_plan(m_l, m_r, verifier=ver, verify_top_k=3, **kw)
    wall_top = time.perf_counter() - t0

    ver = make_plan_verifier(cost, schedule=constant_rate(rate),
                             warmup_s=120.0, max_recovery_s=max_recovery_s,
                             device=device)
    t0 = time.perf_counter()
    res_ex = optimize_plan(m_l, m_r, verifier=ver, exhaustive=True,
                           engine="device", **kw)
    wall_ex = time.perf_counter() - t0

    out = {
        "variants": len(res_top.candidates),
        "replayed_topk": sum(1 for c in res_top.candidates
                             if c.sim is not None),
        "replayed_exhaustive": sum(1 for c in res_ex.candidates
                                   if c.sim is not None),
        "topk_wall_s": wall_top,
        "exhaustive_wall_s": wall_ex,
        "topk_objective": measured_objective(res_top),
        "exhaustive_objective": measured_objective(res_ex),
        "topk_plan": res_top.plan.name if res_top.plan else None,
        "exhaustive_plan": res_ex.plan.name if res_ex.plan else None,
        "topk_ci": res_top.ci,
        "exhaustive_ci": res_ex.ci,
    }
    print(f"  sweep: top-3 replay {wall_top:.2f} s (obj "
          f"{out['topk_objective']:.4f}, {out['topk_plan']}) vs exhaustive "
          f"{out['replayed_exhaustive']}-candidate device replay "
          f"{wall_ex:.2f} s (obj {out['exhaustive_objective']:.4f}, "
          f"{out['exhaustive_plan']})")
    return out


def device_section(smoke: bool = False, device: Any = None) -> dict:
    """The "device" section of the bench_sim/3 artifact.  ``smoke``: one
    256-lane throughput point, the parity matrix at horizon 400, no
    sweep (the validator accepts a null sweep)."""
    print("\n=== Device campaign engine (E12, torch) ===")
    if smoke:
        throughput = bench_throughput(lane_counts=(256,), horizon=400,
                                      device=device)
        parity = parity_check(horizon=400, device=device)
        sweep = None
    else:
        throughput = bench_throughput(device=device)
        parity = parity_check(device=device)
        sweep = bench_sweep(device=device)
    return {"throughput": throughput, "parity": parity, "sweep": sweep}


def main(device: Any = None) -> dict:
    return device_section(smoke=False, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the lane engine (default: cuda)")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    device_section(smoke=args.smoke, device=args.device)
