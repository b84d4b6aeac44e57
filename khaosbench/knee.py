"""The knee of a Poisson cell: the highest rate its job sustains without a
growing backlog, found once by a sweep (the cell's rate is then fixed in
its traffic file).

    python3 khaosbench/knee.py --workload yi6b.chaos.ci1 --seconds 20 \
        --fractions 0.6 0.8 0.9 1.0 1.1

One process, one set-up; a saturated window first measures the capacity
in events/s under the cell's checkpoint plan, then one window per
fraction of it, without failures.  Prints one JSON line per window: the
rate, the events it created, the backlog left at its end and the 95th
percentile of the events' latency.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fractions", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    from khaosbench import spec
    from khaosbench.harness import CellRun
    from khaosbench.timeline import event_latencies

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = dict(spec.traffic(cell["traffic"]), failures=[])
    run = CellRun(cfg, dict(traffic, source="saturated"), args.seed,
                  args.seconds)
    run.setup()
    run.window()
    rec = run.rec
    capacity = (rec.cursor_end - rec.cursor0) / rec.window_s
    print(json.dumps({"rate": "saturated", "events_per_s": capacity}),
          flush=True)
    for frac in args.fractions:
        run.traffic = dict(traffic, rate_events_per_s=frac * capacity)
        run.window()
        created = len(rec.arrivals)
        backlog = rec.cursor0 + created - rec.cursor_end
        lat = event_latencies(rec.log, rec.arrivals, rec.cursor0,
                              rec.window_s)
        print(json.dumps({"fraction": frac, "rate": frac * capacity,
                          "created": created, "backlog_end": int(backlog),
                          "latency_p95_ms": float(np.percentile(lat, 95))
                          * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
