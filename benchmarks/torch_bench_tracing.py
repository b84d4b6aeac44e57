"""A benchmark cell with the port's tracer on: the spans inside the train
step, the checkpoint plane and the restore (``repro_torch.utils.timing``)
read as per-layer numbers, the device's idle time named by them, and the
tracer's own cost.

    python3 benchmarks/torch_bench_tracing.py --workload yi6b.stream.ci2 \\
        --seed 7 --seconds 50 --mode traced
    python3 benchmarks/torch_bench_tracing.py --workload yi6b.stream.ci2 \\
        --seed 7 --seconds 50 --mode on        # or off: the tracer's cost

It runs one cell of ``khaosbench`` as ``khaosbench/run.py`` does, with
what the benchmark does not do yet.  ``traced`` is a ``--trace 1`` run
with the tracer on over the window; its profiler slice is reduced with the
program's ``repro_torch.*`` spans beside the benchmark's ``khaosbench.*``
ones: their twins on the device's timeline are no work, and an idle gap
takes the name of the innermost span of either kind that covers it.
``on`` and ``off`` are untraced runs (no profiler) with the tracer on or
off over the window, for the tracer's cost in ``tokens_per_s``.  The last
line of standard output is the cell's result object with ``readings``
(``READINGS`` below, None where the window held nothing to read) and
``spans`` (count, mean ms and total s of each span name) added.

This script stands in for the benchmark until the benchmark reads the
program's spans itself: ``READINGS`` then become ``khaosbench/metrics/``
files, ``from_profiler``'s prefix handling moves into
``khaosbench/trace.py``, the tracer is turned on in
``khaosbench/harness.py``'s window, and this script and its test go.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROGRAM_PREFIX = "repro_torch."


# -- the window's spans (``rec.spans``: dicts, times in window seconds) ------
def _named(rec, name: str) -> list:
    return [s for s in rec.spans if s["name"] == name and s["start"] >= 0]


def _dur(span: dict) -> float:
    return span["end"] - span["start"]


def _mean_ms(seconds: list):
    return statistics.fmean(seconds) * 1e3 if seconds else None


def _saves(rec, kind: str) -> list:
    return [s for s in _named(rec, "ckpt.save") if s["attrs"]["kind"] == kind]


def _per_save(rec, kind: str, names: tuple) -> list:
    """For each window save of ``kind``: the seconds of its direct
    children named in ``names``."""
    out = []
    for save in _saves(rec, kind):
        out.append(sum(_dur(s) for s in rec.spans if s["parent"] == save["id"]
                       and s["name"] in names))
    return out


def _children(rec, kind: str, name: str) -> list:
    """The spans named ``name`` directly under a window save of ``kind``
    (saves without one count nothing)."""
    ids = {save["id"] for save in _saves(rec, kind)}
    return [s for s in rec.spans if s["parent"] in ids and s["name"] == name]


def _overlaps(span: dict, others: list) -> bool:
    return any(span["start"] < o["end"] and span["end"] > o["start"]
               for o in others)


def _idle_per_step_ms(rec, label: str):
    if rec.trace is None or not rec.traced_step_walls:
        return None
    return (rec.trace.idle_by_host.get(label, 0.0)
            / len(rec.traced_step_walls) * 1e3)


def step_ms_under_d2h(rec, kind):
    """Mean ``trainer.step`` of the steps that overlap a background D2H of
    a ``kind`` trigger (None: of no trigger)."""
    bg = _named(rec, "ckpt.d2h.background")
    if kind is None:
        return _mean_ms([_dur(s) for s in _named(rec, "trainer.step")
                         if not _overlaps(s, bg)])
    bg = [s for s in bg if s["attrs"].get("kind") == kind]
    return _mean_ms([_dur(s) for s in _named(rec, "trainer.step")
                     if _overlaps(s, bg)])


def alloc_retries(rec, name: str):
    got = [s["attrs"]["alloc_retries"] for s in _named(rec, name)
           if "alloc_retries" in s["attrs"]]
    return float(sum(got)) if got else None


def delta_link_mb(rec):
    got = [s["attrs"]["bytes_on_link"] for s in _saves(rec, "delta")]
    return statistics.fmean(got) / 1e6 if got else None


def full_staged_mb(rec):
    got = [s["attrs"]["staged_bytes"]
           for s in _named(rec, "ckpt.d2h.background")
           if s["attrs"].get("kind") == "full"
           and "staged_bytes" in s["attrs"]]
    return statistics.fmean(got) / 1e6 if got else None


def landing_pin_ms(rec):
    got = [_dur(s) for s in _named(rec, "ckpt.landing.pin")]
    return sum(got) * 1e3 if got else None


#: name -> (reader, where it reads); the names a benchmark entry would take
READINGS = {
    "step_idle_ms.grad": (lambda r: _idle_per_step_ms(r, "train.grad"),
                          "idle s labelled train.grad / traced steps"),
    "step_idle_ms.optim": (lambda r: _idle_per_step_ms(r, "train.optim"),
                           "idle s labelled train.optim / traced steps"),
    "step_ms.full_d2h": (lambda r: step_ms_under_d2h(r, "full"),
                         "mean trainer.step under a full's background D2H"),
    "step_ms.no_d2h": (lambda r: step_ms_under_d2h(r, None),
                       "mean trainer.step under no background D2H"),
    "alloc_retries": (lambda r: alloc_retries(r, "trainer.step"),
                      "sum of trainer.step alloc_retries"),
    "alloc_retries.save": (lambda r: alloc_retries(r, "ckpt.save"),
                           "sum of ckpt.save alloc_retries"),
    "delta_encode_ms": (lambda r: _mean_ms(_per_save(
        r, "delta", ("ckpt.delta.pack", "ckpt.delta.encode",
                     "ckpt.delta.stats"))),
        "mean pack + encode + stats of a delta save"),
    "delta_d2h_ms": (lambda r: _mean_ms(_per_save(
        r, "delta", ("ckpt.d2h.first", "ckpt.d2h.queue", "ckpt.d2h.wait"))),
        "mean d2h.first + d2h.queue + d2h.wait of a delta save"),
    "delta_link_mb": (delta_link_mb, "mean bytes_on_link of a delta / 1e6"),
    "full_first_chunk_ms": (lambda r: _mean_ms(
        [_dur(s) for s in _children(r, "full", "ckpt.d2h.first")]),
        "mean d2h.first of the full saves that copy one"),
    "full_blocking_ms": (lambda r: _mean_ms(
        [_dur(s) for s in _saves(r, "full")]), "mean ckpt.save of a full"),
    "full_base_ms": (lambda r: _mean_ms(_per_save(
        r, "full", ("ckpt.full.base",))), "mean ckpt.full.base of a full"),
    "full_staged_mb": (full_staged_mb,
                       "mean staged_bytes of a full's d2h.background / 1e6"),
    "restore_d2h_ms": (lambda r: _mean_ms(
        [_dur(s) for s in _named(r, "ckpt.restore.snapshot")]),
        "mean ckpt.restore.snapshot"),
    "restore_copy_ms": (lambda r: _mean_ms(
        [_dur(s) for s in _named(r, "ckpt.restore.copy")]),
        "mean ckpt.restore.copy"),
    "restore_h2d_ms": (lambda r: _mean_ms(
        [_dur(s) for s in _named(r, "trainer.restore.h2d")]),
        "mean trainer.restore.h2d"),
    "landing_pin_ms": (landing_pin_ms, "sum of ckpt.landing.pin"),
}


def readings(rec) -> dict:
    if getattr(rec, "spans", None) is None:
        return {name: None for name in READINGS}
    return {name: read(rec) for name, (read, _) in READINGS.items()}


def span_table(rec) -> dict:
    """name -> [count, mean ms, total s] over the window's spans."""
    out: dict = {}
    for s in getattr(rec, "spans", None) or ():
        if s["start"] >= 0:
            out.setdefault(s["name"], []).append(_dur(s))
    return {k: [len(v), statistics.fmean(v) * 1e3, sum(v)]
            for k, v in sorted(out.items())}


# -- the two additions to the harness ----------------------------------------
def program_tracer():
    """The port's tracer module, or None where the port has none."""
    from repro_torch.utils import timing
    if all(hasattr(timing, n) for n in ("enable", "disable", "reset",
                                        "spans", "dropped")):
        return timing
    return None


def from_profiler(prof):
    """``khaosbench.trace.from_profiler`` with the program's spans beside
    the benchmark's: both are host spans (each kind's twin on the device's
    timeline is no work) and name the idle gaps they cover."""
    from khaosbench import trace

    device, host = [], []
    t0, t1 = float("inf"), float("-inf")
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith((trace.HOST_PREFIX, PROGRAM_PREFIX)):
            if e.device_type.name != "CUDA":
                label = e.name.split(".", 1)[1]
                host.append((trace.HOST_PREFIX + label, a, b))
        elif e.device_type.name == "CUDA":
            device.append((e.name, a, b))
        else:
            continue
        t0, t1 = min(t0, a), max(t1, b)
    whole = trace.HOST_PREFIX + "window"
    window = [(a, b) for name, a, b in host if name == whole]
    if window:
        t0, t1 = window[0]
    return trace.summarize(device, [s for s in host if s[0] != whole], t0, t1)


@contextlib.contextmanager
def tracer_in_window(reduce: bool):
    """The harness with the port's tracer on over each window (the spans,
    re-based to window seconds, in ``rec.spans``), and with ``reduce``
    the program-aware reduction of its profiler slice."""
    from khaosbench import harness

    tracer = program_tracer()
    real_window, real_reduce = harness.CellRun.window, harness.from_profiler

    def window(self):
        if tracer is None:
            return real_window(self)
        tracer.reset()
        tracer.enable()
        try:
            real_window(self)
        finally:
            tracer.disable()
        t0 = self.stream.t0
        self.rec.spans = [dict(s.as_dict(), start=s.start - t0,
                               end=s.end - t0) for s in tracer.spans()]
        self.rec.spans_dropped = tracer.dropped()

    harness.CellRun.window = window
    if reduce:
        harness.from_profiler = from_profiler
    try:
        yield
    finally:
        harness.CellRun.window = real_window
        harness.from_profiler = real_reduce


def run_cell(bench: dict, name: str, seed: int, seconds: float, mode: str,
             device="cuda", cfg=None, traffic=None, started=None):
    """One run of cell ``name`` in ``mode`` (traced | on | off): its result
    object, with ``readings`` and ``spans`` where the tracer was on, and
    the run's ``Record``."""
    from khaosbench import run as runner
    from khaosbench import spec
    from khaosbench.harness import CellRun

    cell = spec.cell(bench, name)
    traced = mode == "traced"
    run = CellRun(cfg or spec.config(bench, cell["config"]),
                  traffic or spec.traffic(cell["traffic"]), seed, seconds,
                  traced, device,
                  started=runner.STARTED if started is None else started)
    patch = (tracer_in_window(reduce=traced) if mode != "off"
             else contextlib.nullcontext())
    with patch:
        run.setup()
        run.window()
        dev, checks = run.finish()
    out = runner.result(run, bench, cell, traced, dev, checks)
    rec = run.rec
    if mode != "off":
        out["readings"] = readings(rec)
        out["spans"] = span_table(rec)
        out["spans_dropped"] = getattr(rec, "spans_dropped", None)
    tps = spec.reader("tokens_per_s")(rec) if rec.step_walls else None
    out["tokens_per_s"] = tps
    out["steps"] = len(rec.step_walls)
    out["triggers"] = [(round(t["t"], 3), t["kind"], round(t["blocking_s"], 4))
                       for t in rec.triggers]
    return out, rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--mode", choices=("traced", "on", "off"),
                   default="traced")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from khaosbench import run as runner
    from khaosbench import spec

    for key, path in runner.CACHES.items():
        os.environ[key] = str(path)
    bench = spec.load_benchmark()
    out, _ = run_cell(bench, args.workload, args.seed, args.seconds,
                      args.mode, args.device)
    out["mode"] = args.mode
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
