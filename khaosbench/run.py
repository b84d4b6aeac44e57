"""Run one cell of the benchmark once and print its result.

    python3 khaosbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number that decided
``correct`` beside its limit, and the same lines end standard error.  The
run needs as many CUDA devices as the cell asks for and exits non-zero
without a result otherwise, or when JAX or the JAX package is loaded once
the window has closed.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# kernel and compiler caches live at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / ".khaosbench_cache" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / ".khaosbench_cache" / "extensions"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(run, bench: dict, cell: dict, traced: bool, device: dict,
           checks: dict, here=None) -> dict:
    from khaosbench import spec

    rec = run.rec
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], traced):
        value = spec.reader(m["name"], here or spec.HERE)(rec)
        if value is None:
            if traced:
                continue            # nothing to read: the metric is left out
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": rec.card["name"], "count": 1,
           "power_limit": rec.card["power_limit"], **device}
    out = {"attempted": run.attempted(),
           "failed": checks["cursor_violations"][0],
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    out = {"correct": ok, **out}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, device="cuda", cfg=None, traffic=None,
             started: float = STARTED, here=None) -> tuple[dict, dict]:
    """Set-up, window and checks of cell ``name``: its result object, and
    notes for the log (set-up times, triggers, restores).
    ``cfg``/``traffic`` stand in for the cell's files (the CPU tests run
    it at small sizes); ``here`` is the directory the cell's files are
    found in by name (``khaosbench/``)."""
    from khaosbench import spec
    from khaosbench.harness import CellRun

    here = here or spec.HERE
    cell = spec.cell(bench, name)
    cfg = cfg or spec.config(bench, cell["config"], here.parent)
    traffic = traffic or spec.traffic(cell["traffic"], here)
    run = CellRun(cfg, traffic, seed, seconds, traced, device,
                  started=started, here=here)
    run.setup()
    run.window()
    dev, checks = run.finish()
    out = result(run, bench, cell, traced, dev, checks, here)
    rec = run.rec
    traced = rec.traced_step_walls
    notes = {"setup": {k: round(v, 3) for k, v in rec.setup_parts.items()},
             "window_s": rec.window_s, "steps": len(rec.step_walls),
             "traced_steps": (len(traced), sum(traced) / max(len(traced), 1)),
             "triggers": [(round(t["t"], 3), t["kind"],
                           round(t["blocking_s"], 4)) for t in rec.triggers],
             "restores": [(round(r["t"], 3), round(r["duration_s"], 4))
                          for r in rec.restores],
             "failures": rec.failures}
    if rec.spans is not None:           # the program's, over the window
        names = [sp["name"] for sp in rec.spans if sp["start"] >= 0]
        notes["spans"] = {n: names.count(n) for n in sorted(set(names))}
    notes.update(rec.observed)
    return out, notes


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from khaosbench import spec

    bench = spec.load_benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out, notes = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"card {out['device']['kind']}, power limit "
          f"{out['device']['power_limit']}", file=sys.stderr)
    for k, v in notes.items():
        print(f"note {k} {v}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
