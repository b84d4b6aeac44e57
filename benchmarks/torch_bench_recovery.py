"""E4 on the PyTorch port: recovery time and latency vs CI at fixed load,
through the scalar ``StreamSimulator`` and as lanes of one campaign on the
torch lane engine, emitted as the ``bench_sim/3`` artifact — the twin of
``bench_recovery.py`` and its artifact validators.

    PYTHONPATH=src python benchmarks/torch_bench_recovery.py [--smoke] \\
        [--out PATH] [--device cpu]

``bench_recovery_vs_ci(out)`` is the full E4: the scalar sweep over eight
CIs, the same sweep as campaign lanes (rows equal to the scalar oracle),
and the 432-lane scenario grid (CI x mechanism x failure kind x workload,
lane-level early exit) timed over three runs, with the full E10
head-to-head (``torch_bench_proactive.bench_proactive``) and the full E12
section (``torch_bench_campaign.device_section``) embedded — passed in,
or computed here — written to ``out`` (default ``BENCH_sim_torch.json``)
after its validators pass.  Latencies and recoveries are simulated time;
only the wall-clock figures depend on the machine.

``smoke(tmpdir)`` runs a reduced E4 grid (CIs 30 and 120) through both
engines (their rows must agree exactly), a 4-lane early-exit grid, and
embeds the proactive drill (``torch_bench_proactive.smoke``) and the
device-engine section (``torch_bench_campaign.device_section``) — passed
in, or computed here — then writes ``BENCH_sim.json`` into ``tmpdir``,
validates it and reads it back.

bench_sim/3 schema:
  schema               "bench_sim/3"
  e4                   per-CI latency/recovery from BOTH engines,
                       wall-clocks, max absolute divergence
  grid                 the campaign measurement: lanes, lane_ticks, wall_s,
                       lane_ticks_per_s, recovered_fraction,
                       compactions/lanes_compacted, the scenario axes
  proactive            the E10 section (full head-to-head or the smoke
                       drill's summary)
  device               the E12 section: throughput, parity
                       (``divergent_lanes`` must be 0) and sweep (null in a
                       smoke; else ``exhaustive_objective <= topk_objective``)
  scalar_ticks_per_s   the scalar loop's measured tick rate
  speedup              grid lane-ticks/s over scalar ticks/s

The lanes run on the CUDA device unless ``device`` names another.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Any, Optional

import numpy as np

from repro_torch.config import CheckpointPlan
from repro_torch.core import young_daly_interval
from repro_torch.data.stream import constant_rate, dense_rates, diurnal_rate
from repro_torch.ft.failures import FailureInjector
from repro_torch.sim import (LaneSpec, SimCostModel, StreamSimulator,
                             make_campaign)

E4_CIS = (10, 20, 30, 60, 90, 120, 180, 240)
E4_RATE = 3000.0
E4_HORIZON_S = 5000.0          # post-injection window of the scalar sweep
GRID_HORIZON = 2200            # ticks per grid lane (recovery completes well
                               # inside this for every grid scenario family)

SIM_SCHEMA = "bench_sim/3"
SIM_SCHEMA_KEYS = ("schema", "e4", "grid", "proactive", "device",
                   "scalar_ticks_per_s", "speedup")


def _e4_cost() -> SimCostModel:
    return SimCostModel(capacity_eps=4600.0, base_latency_s=0.5,
                        ckpt_duration_s=3.0, ckpt_sync_penalty=0.6)


def _worst_case(ci: float, cost: SimCostModel) -> float:
    return FailureInjector().worst_case_time(3 * ci + 5.0, 0.0, float(ci),
                                             cost.ckpt_duration_s)


# ---------------------------------------------------------------------------
# E4 grid, both engines
# ---------------------------------------------------------------------------

def scalar_e4(cost: SimCostModel, cis=E4_CIS) -> tuple[list, float, int]:
    """The sequential sweep; returns (rows, wall_s, ticks)."""
    rows, ticks = [], 0
    t0 = time.perf_counter()
    for ci in cis:
        sim = StreamSimulator(cost, ci_s=float(ci),
                              schedule=constant_rate(E4_RATE))
        t = _worst_case(ci, cost)
        sim.inject_failure(t)
        sim.run_until(t + E4_HORIZON_S)
        lat_pre = sim.metrics.series("latency").mean_over(0, t) * 1e3
        rec = sim.recoveries[0]["recovery_s"] if sim.recoveries \
            else float("nan")
        rows.append((ci, lat_pre, rec))
        ticks += len(sim.metrics.series("latency"))
    return rows, time.perf_counter() - t0, ticks


def e4_lanes(cost: SimCostModel, cis=E4_CIS) -> list[LaneSpec]:
    lanes = []
    for ci in cis:
        t = _worst_case(ci, cost)
        n = int(np.ceil(t + E4_HORIZON_S))
        lanes.append(LaneSpec(
            rates=dense_rates(0.0, n, schedule=constant_rate(E4_RATE)),
            ci_s=float(ci), failures=((t, "node"),),
            tag={"e4_ci": float(ci), "inject_t": t}))
    return lanes


def batched_e4(cost: SimCostModel, cis=E4_CIS,
               device: Any = None) -> tuple[list, float]:
    """The same table from campaign lanes on the torch engine; rows must
    match the scalar oracle."""
    lanes = e4_lanes(cost, cis)
    t0 = time.perf_counter()
    camp = make_campaign(cost, lanes, engine="device", device=device).run()
    wall = time.perf_counter() - t0
    lat_hist = camp.latency_history()
    rows = []
    for i, lane in enumerate(lanes):
        ts = camp.times(i)
        pre = ts <= lane.tag["inject_t"]       # mean_over(0, t) is inclusive
        lat_pre = float(np.mean(lat_hist[i, :len(ts)][pre])) * 1e3
        rec = camp.lane_recovery(i)
        rows.append((lane.tag["e4_ci"], lat_pre,
                     rec if rec is not None else float("nan")))
    return rows, wall


# ---------------------------------------------------------------------------
# the 10x scenario grid (throughput measurement)
# ---------------------------------------------------------------------------

GRID_PLANS = (
    ("full-sync", None),
    ("full-async", CheckpointPlan(sync=False)),
    ("incr8-async", CheckpointPlan(mode="incremental", full_every=8,
                                   sync=False)),
    ("incr8-async-mlr", CheckpointPlan(mode="incremental", full_every=8,
                                       sync=False,
                                       levels=("memory", "local", "remote"),
                                       local_every=1, remote_every=8)),
)
GRID_KINDS = ("task", "node", "cluster")


def grid_lanes(cost: SimCostModel, n_cis: int = 18,
               horizon: int = GRID_HORIZON) -> list[LaneSpec]:
    """CI grid x mechanism x failure kind x workload — every lane one chaos
    scenario with a worst-case injection."""
    workloads = (("const", constant_rate(E4_RATE)),
                 ("diurnal", diurnal_rate(base=0.8 * E4_RATE, amplitude=0.4,
                                          period=7200.0, seed=7)))
    # one dense λ array per workload, shared by every lane that replays it
    rates = {w: dense_rates(0.0, horizon, schedule=s) for w, s in workloads}
    lanes = []
    for ci in np.geomspace(10.0, 240.0, n_cis):
        t = _worst_case(float(ci), cost)
        for plan_name, plan in GRID_PLANS:
            for kind in GRID_KINDS:
                for wname, _sched in workloads:
                    lanes.append(LaneSpec(
                        rates=rates[wname],
                        ci_s=float(ci), plan=plan, failures=((t, kind),),
                        tag={"plan": plan_name, "kind": kind,
                             "workload": wname}))
    return lanes


def grid_campaign(cost: SimCostModel, lanes, engine: str = "device",
                  device: Any = None):
    """One run of the grid's campaign (no history, lane-level early exit:
    recovered lanes are compacted out of the arrays)."""
    return make_campaign(cost, lanes, engine=engine,
                         device=device if engine == "device" else None,
                         record_history=False, early_exit=True).run()


def bench_grid(cost: SimCostModel, repeats: int = 3,
               device: Any = None) -> dict:
    """Throughput grid with lane-level early exit, the median wall of
    ``repeats`` runs (the compaction counters are part of the artifact)."""
    lanes = grid_lanes(cost)
    walls = []
    camp = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        camp = grid_campaign(cost, lanes, device=device)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    recovered = sum(1 for r in camp.recoveries if r)
    return {
        "lanes": len(lanes),
        "lane_ticks": int(camp.ticks_run),
        "wall_s": wall,
        "lane_ticks_per_s": camp.ticks_run / wall,
        "recovered_fraction": recovered / len(lanes),
        "compactions": int(camp.compactions),
        "lanes_compacted": int(camp.lanes_compacted),
        "ci_grid": [10.0, 240.0, 18],
        "plans": [n for n, _ in GRID_PLANS],
        "kinds": list(GRID_KINDS),
        "workloads": ["const", "diurnal"],
    }


# ---------------------------------------------------------------------------
# artifact
# ---------------------------------------------------------------------------

def build_sim_artifact(scalar_rows, scalar_wall, scalar_ticks,
                       batched_rows, batched_wall, grid: dict,
                       proactive: dict, device: dict) -> dict:
    s = np.array(scalar_rows)
    b = np.array(batched_rows)
    scalar_tps = scalar_ticks / max(scalar_wall, 1e-9)
    return {
        "schema": SIM_SCHEMA,
        "e4": {
            "cis": [float(x) for x in s[:, 0]],
            "latency_ms": [float(x) for x in s[:, 1]],
            "recovery_s": [float(x) for x in s[:, 2]],
            "latency_ms_batched": [float(x) for x in b[:, 1]],
            "recovery_s_batched": [float(x) for x in b[:, 2]],
            "scalar_wall_s": float(scalar_wall),
            "batched_wall_s": float(batched_wall),
            "max_abs_recovery_diff_s":
                float(np.nanmax(np.abs(s[:, 2] - b[:, 2]))),
            "max_abs_latency_diff_ms":
                float(np.nanmax(np.abs(s[:, 1] - b[:, 1]))),
        },
        "grid": grid,
        "proactive": proactive,
        "device": device,
        "scalar_ticks_per_s": float(scalar_tps),
        "speedup": float(grid["lane_ticks_per_s"] / scalar_tps),
    }


def _validate_proactive(p: dict) -> None:
    """Gate the E10 section: proactive control paid off (full form) or
    the micro drill exercised every rung of the ladder (smoke form)."""
    if not isinstance(p, dict) or not p:
        raise ValueError("proactive section missing or empty")
    if "qos_violation_s" in p:
        qos = p["qos_violation_s"]
        for name in ("Khaos-proactive", "Khaos-reactive"):
            if name not in qos:
                raise ValueError(f"proactive.qos_violation_s missing {name!r}")
        if not (qos["Khaos-proactive"] < qos["Khaos-reactive"]):
            raise ValueError(
                "proactive Khaos did not strictly beat reactive Khaos: "
                f"{qos['Khaos-proactive']:.0f}s vs "
                f"{qos['Khaos-reactive']:.0f}s of QoS violation")
        if not (int(p.get("proactive_decisions", 0)) >= 1):
            raise ValueError("no forecast-driven plan switch in the "
                             "head-to-head run")
        if not np.isfinite(p.get("first_proactive_t", float("nan"))):
            raise ValueError("first_proactive_t missing or non-finite")
    else:
        if not np.isfinite(p.get("first_proactive_t", float("nan"))):
            raise ValueError("smoke drill produced no proactive decision")
        if "reprofile" not in p.get("phase_sequence", ()):
            raise ValueError("smoke drill never re-entered the reprofile "
                             "phase after the anomaly")
        if not (int(p.get("bp_suppressed", 0)) >= 1):
            raise ValueError("backpressure window suppressed no checkpoint "
                             "cadence slots")


def _validate_device(d: dict) -> None:
    """Gate the E12 section: zero divergent parity lanes; when the sweep
    ran, the exhaustive pick matches or beats the top-k pick's measured
    objective."""
    if not isinstance(d, dict) or not d:
        raise ValueError("device section missing or empty")
    thr = d.get("throughput")
    if not thr:
        raise ValueError("device.throughput missing or empty")
    for row in thr:
        for k in ("lanes", "lane_ticks", "numpy_lane_ticks_per_s",
                  "device_lane_ticks_per_s"):
            if not (k in row and row[k] > 0):
                raise ValueError(f"device.throughput row missing {k}")
    par = d.get("parity")
    if not isinstance(par, dict) or "divergent_lanes" not in par:
        raise ValueError("device.parity section missing")
    if par["divergent_lanes"] != 0:
        raise ValueError(
            f"device engine diverged from the NumPy engine on "
            f"{par['divergent_lanes']}/{par.get('lanes', '?')} parity lanes")
    sweep = d.get("sweep")
    if sweep is not None:
        if not (sweep["replayed_exhaustive"] >= sweep["replayed_topk"]):
            raise ValueError("exhaustive sweep replayed fewer candidates "
                             "than the top-k shortlist")
        if not (sweep["exhaustive_objective"]
                <= sweep["topk_objective"] + 1e-9):
            raise ValueError(
                "exhaustive device sweep chose a WORSE measured objective "
                f"than top-k replay ({sweep['exhaustive_objective']:.6f} vs "
                f"{sweep['topk_objective']:.6f})")


def validate_sim_artifact(art: dict) -> None:
    """Schema gate of the bench_sim/3 artifact."""
    missing = [k for k in SIM_SCHEMA_KEYS if k not in art]
    if missing:
        raise ValueError(f"BENCH_sim artifact missing keys {missing}")
    if art["schema"] != SIM_SCHEMA:
        raise ValueError(f"unknown sim-bench schema {art['schema']!r}")
    e4 = art["e4"]
    n = len(e4["cis"])
    for k in ("latency_ms", "recovery_s", "latency_ms_batched",
              "recovery_s_batched"):
        if len(e4[k]) != n:
            raise ValueError(f"e4.{k} length {len(e4[k])} != {n}")
    if not (e4["max_abs_recovery_diff_s"] <= 1.0):
        raise ValueError("batched E4 diverged from the scalar oracle: "
                         f"max |recovery diff| = "
                         f"{e4['max_abs_recovery_diff_s']}s")
    if not (e4["max_abs_latency_diff_ms"] <= 1.0):
        raise ValueError("batched E4 latency diverged from the scalar oracle")
    g = art["grid"]
    for k in ("lanes", "lane_ticks", "wall_s", "lane_ticks_per_s",
              "recovered_fraction", "compactions", "lanes_compacted"):
        if k not in g or not isinstance(g[k], (int, float)) or g[k] < 0:
            raise ValueError(f"grid.{k} missing or not a non-negative number")
    if g["lanes_compacted"] > g["lanes"]:
        raise ValueError("lanes_compacted exceeds the lane count")
    if not (0.0 < g["recovered_fraction"] <= 1.0):
        raise ValueError(
            f"implausible recovered_fraction {g['recovered_fraction']}")
    _validate_proactive(art["proactive"])
    _validate_device(art["device"])
    if art["speedup"] <= 0:
        raise ValueError("speedup must be positive")


def emit_sim_artifact(path: str, art: dict) -> dict:
    validate_sim_artifact(art)
    with open(path, "w") as f:
        json.dump(art, f, indent=2)
    g = art["grid"]
    print(f"sim-bench artifact -> {path}: {g['lanes']} lanes, "
          f"{g['lane_ticks_per_s'] / 1e6:.3f}M lane-ticks/s vs scalar "
          f"{art['scalar_ticks_per_s'] / 1e3:.0f}k ticks/s "
          f"({art['speedup']:.2f}x)")
    return art


def _sibling(name: str):
    """A benchmark module beside this one (loaded by path once)."""
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def smoke(tmpdir: str, proactive: Optional[dict] = None,
          device_sec: Optional[dict] = None, device: Any = None) -> dict:
    """Reduced E4 through both engines, a 4-lane early-exit grid, the
    artifact written into ``tmpdir``, validated and read back."""
    if proactive is None:
        proactive = _sibling("torch_bench_proactive").smoke(device=device)
    if device_sec is None:
        device_sec = _sibling("torch_bench_campaign").device_section(
            smoke=True, device=device)
    os.makedirs(tmpdir, exist_ok=True)
    cost = _e4_cost()
    cis = (30, 120)
    scalar_rows, scalar_wall, scalar_ticks = scalar_e4(cost, cis)
    batched_rows, batched_wall = batched_e4(cost, cis, device=device)
    lanes = [LaneSpec(rates=dense_rates(0.0, 1500,
                                        schedule=constant_rate(E4_RATE)),
                      ci_s=float(ci),
                      failures=((_worst_case(ci, cost), kind),))
             for ci in cis for kind in ("task", "node")]
    t0 = time.perf_counter()
    camp = make_campaign(cost, lanes, engine="device", device=device,
                         record_history=False, early_exit=True,
                         compact_every=64).run()
    wall = time.perf_counter() - t0
    grid = {"lanes": len(lanes), "lane_ticks": int(camp.ticks_run),
            "wall_s": wall, "lane_ticks_per_s": camp.ticks_run / wall,
            "recovered_fraction":
                sum(1 for r in camp.recoveries if r) / len(lanes),
            "compactions": int(camp.compactions),
            "lanes_compacted": int(camp.lanes_compacted),
            "plans": ["full-sync"], "kinds": ["task", "node"],
            "workloads": ["const"],
            "ci_grid": [float(cis[0]), float(cis[-1]), 2]}
    art = build_sim_artifact(scalar_rows, scalar_wall, scalar_ticks,
                             batched_rows, batched_wall, grid, proactive,
                             device_sec)
    path = os.path.join(tmpdir, "BENCH_sim.json")
    emit_sim_artifact(path, art)
    with open(path) as f:
        validate_sim_artifact(json.load(f))
    assert art["e4"]["max_abs_recovery_diff_s"] == 0.0 and \
        art["e4"]["max_abs_latency_diff_ms"] == 0.0, \
        "smoke lanes must match the scalar oracle exactly"
    print(f"recovery smoke OK: {path} validates ({len(lanes)}-lane grid, "
          f"{grid['lanes_compacted']} lanes compacted early)")
    return art


def bench_recovery_vs_ci(out: str = "BENCH_sim_torch.json",
                         proactive: Optional[dict] = None,
                         device_sec: Optional[dict] = None,
                         device: Any = None) -> dict:
    """The full E4 (see the module docstring); returns the artifact.
    ``proactive`` is the E10 section, ``device_sec`` the E12 section —
    ``torch_run.py`` passes them through so each runs once."""
    if proactive is None:
        proactive = _sibling("torch_bench_proactive").bench_proactive(
            device=device)
    if device_sec is None:
        device_sec = _sibling("torch_bench_campaign").device_section(
            device=device)
    cost = _e4_cost()
    print("\n=== Recovery & latency vs CI (constant 3000 ev/s, worst-case "
          "failure) ===")
    scalar_rows, scalar_wall, scalar_ticks = scalar_e4(cost)
    batched_rows, batched_wall = batched_e4(cost, device=device)
    print(f"{'CI (s)':>8s} {'avg latency (ms)':>18s} {'recovery (s)':>14s} "
          f"{'batched rec (s)':>16s}")
    for (ci, lat, rec), (_, _, recb) in zip(scalar_rows, batched_rows):
        print(f"{int(ci):8d} {lat:18.0f} {rec:14.0f} {recb:16.0f}")
    yd = young_daly_interval(cost.ckpt_duration_s, mtbf_s=4 * 3600.0)
    print(f"Young/Daly optimum for MTBF=4h, delta={cost.ckpt_duration_s}s: "
          f"{yd:.0f}s (static, workload-blind — the gap Khaos closes)")

    grid = bench_grid(cost, device=device)
    print(f"scalar 8-point sweep: {scalar_wall:.2f}s; {grid['lanes']}-lane "
          f"campaign grid: {grid['wall_s']:.2f}s "
          f"({grid['recovered_fraction']*100:.0f}% of lanes recovered)")
    art = build_sim_artifact(scalar_rows, scalar_wall, scalar_ticks,
                             batched_rows, batched_wall, grid, proactive,
                             device_sec)
    return emit_sim_artifact(out, art)


def main(out: str = "BENCH_sim_torch.json", proactive: Optional[dict] = None,
         device_sec: Optional[dict] = None, device: Any = None) -> dict:
    return bench_recovery_vs_ci(out, proactive=proactive,
                                device_sec=device_sec, device=device)


if __name__ == "__main__":
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the lane engine (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced drill (default: the full E4)")
    ap.add_argument("--out", default=None,
                    help="the artifact's path (default BENCH_sim_torch.json)"
                         "; with --smoke the directory of BENCH_sim.json "
                         "(default: a temporary directory)")
    args = ap.parse_args()
    if not args.smoke:
        main(args.out or "BENCH_sim_torch.json", device=args.device)
    elif args.out:
        smoke(args.out, device=args.device)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            smoke(tmp, device=args.device)
