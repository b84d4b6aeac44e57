"""Phase-2 profiling launcher of the port: record a workload, run the z x m
profiling grid, and emit the (C, TR, L, R) grids + fitted QoS models —
sequenced by the ``KhaosRuntime`` phase machine (Phase 1 -> Phase 2).

By default the whole grid runs as lanes of ONE campaign on the torch lane
engine (``sim.BatchedDeployment(engine="device")``, on the CUDA device
unless ``--device`` names another); ``--sequential`` keeps the
one-pipeline-per-CI oracle path (``sim.SimDeployment``).  Both give the
same grids bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.profile_run \
        --ci 10,30,60,90,120 [--device cpu] [--out PATH]

The JSON has the JAX package's launcher's keys and, at the same
arguments, its values.  The default ``--out`` is
``experiments/profiling_torch.json``: the JAX package's
``experiments/profiling.json`` is never written.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

DEFAULT_OUT = "experiments/profiling_torch.json"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ci", default="10,30,60,90,120")
    ap.add_argument("--failure-points", type=int, default=5)
    ap.add_argument("--record-seconds", type=float, default=14_400.0)
    ap.add_argument("--capacity", type=float, default=4600.0)
    ap.add_argument("--ckpt-duration", type=float, default=3.0)
    ap.add_argument("--margin", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="one deployment per CI (the scalar oracle path) "
                         "instead of the batched campaign")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device engine (default: cuda)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from repro_torch.config import KhaosConfig
    from repro_torch.core import KhaosRuntime
    from repro_torch.data.stream import diurnal_rate, record_workload
    from repro_torch.sim import (BatchedDeployment, SimCostModel,
                                 SimDeployment)

    sched = diurnal_rate(base=0.5 * args.capacity, amplitude=0.55,
                         period=args.record_seconds, seed=args.seed)
    recording = record_workload(sched, duration=args.record_seconds,
                                seed=args.seed)
    cost = SimCostModel(capacity_eps=args.capacity,
                        ckpt_duration_s=args.ckpt_duration,
                        ckpt_sync_penalty=0.6)
    ci_values = [float(x) for x in args.ci.split(",")]

    rt = KhaosRuntime(KhaosConfig(num_failure_points=args.failure_points,
                                  ci_min=min(ci_values), ci_max=max(ci_values),
                                  num_configs=len(ci_values)))
    rt.record_steady_state(recording)
    if args.sequential:
        deployment = lambda ci: SimDeployment(ci, recording, cost)  # noqa: E731
    else:
        deployment = BatchedDeployment(cost, recording, engine="device",
                                       device=args.device)
    prof = rt.run_profiling(deployment, ci_values, margin=args.margin,
                            progress=lambda m: print("  " + m, flush=True))

    ci_f, tr_f, L_f, R_f = prof.flat()
    out = {
        "ci_values": ci_values,
        "failure_rates": prof.failure_rates.tolist(),
        "latencies": prof.latencies.tolist(),
        "recoveries": prof.recoveries.tolist(),
        "m_l_pct_error": rt.m_l.avg_percent_error(ci_f, tr_f, L_f),
        "m_r_pct_error": rt.m_r.avg_percent_error(ci_f, tr_f, R_f),
        "phases": rt.phase_sequence(),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nM_L pct error {out['m_l_pct_error']:.3f}  "
          f"M_R pct error {out['m_r_pct_error']:.3f}")
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
