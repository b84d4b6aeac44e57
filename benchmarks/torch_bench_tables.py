"""E1 + E2 on the PyTorch port: the paper's two experiments (Tables II and
III, Fig. 3) — the twin of ``bench_tables.py``.

    PYTHONPATH=src python benchmarks/torch_bench_tables.py [--quick] \\
        [--device cpu]

IoT-Vehicles analogue: diurnal vehicle-traffic workload (TAPASCologne-like)
YSB analogue:          ad-click CTR workload with bursts

Calibration: service capacity sized for ~0.55 peak utilization and a 2.5s
sync checkpoint write (paper cluster: 50 nodes, 1GbE, Flink 1.12 defaults,
50s heartbeat timeout) — chosen so failure-free latencies sit near the
paper's 500-1100 ms band and single-failure recoveries near its
140-290 s/failure band.

Phase 2 profiles on the torch lane engine (on the CUDA device unless
``device`` names another); the day itself is the scalar simulator on the
host.  Latencies and recoveries are simulated time, the same on any
device; only wall-clock seconds depend on the machine.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from typing import Any

from repro_torch.data.stream import ctr_rate, diurnal_rate
from repro_torch.sim import SimCostModel

DAY = 86_400.0     # one-day sim (12 failures, like the paper's runs)


def _sibling(name: str):
    """A benchmark module beside this one (loaded by path once)."""
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        # registered before it runs: its dataclasses look themselves up
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def iot_setup():
    """(schedule, cost model, seed) of E1, as ``bench_iot_vehicles``."""
    sched = diurnal_rate(base=2200.0, amplitude=0.55, period=DAY, seed=42)
    cost = SimCostModel(capacity_eps=4600.0, base_latency_s=0.55,
                        ckpt_duration_s=3.0, ckpt_sync_penalty=0.6)
    return sched, cost, 1


def ysb_setup():
    """(schedule, cost model, seed) of E2, as ``bench_ysb``."""
    sched = ctr_rate(base=2200.0, seed=43, period=DAY)
    cost = SimCostModel(capacity_eps=6400.0, base_latency_s=0.50,
                        ckpt_duration_s=2.5, ckpt_sync_penalty=0.6)
    return sched, cost, 2


def bench_iot_vehicles(repeats: int = 3, device: Any = None):
    common = _sibling("torch_common")
    sched, cost, seed = iot_setup()
    rows, err = common.run_experiment("IoT", sched, cost, duration=DAY,
                                      seed=seed, repeats=repeats,
                                      device=device)
    common.print_table("IoT Vehicles Experiment (Table II analogue)", rows,
                       err)
    return rows, err


def bench_ysb(repeats: int = 3, device: Any = None):
    common = _sibling("torch_common")
    sched, cost, seed = ysb_setup()
    rows, err = common.run_experiment("YSB", sched, cost, duration=DAY,
                                      seed=seed, repeats=repeats,
                                      device=device)
    common.print_table("YSB Experiment (Table III analogue)", rows, err)
    return rows, err


def main(repeats: int = 3, device: Any = None):
    iot = bench_iot_vehicles(repeats=repeats, device=device)
    ysb = bench_ysb(repeats=repeats, device=device)
    return {"iot": iot, "ysb": ysb}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one repetition (default: median of 3)")
    ap.add_argument("--device", default=None,
                    help="torch device of the lane engine (default: cuda)")
    args = ap.parse_args()
    main(repeats=1 if args.quick else 3, device=args.device)
