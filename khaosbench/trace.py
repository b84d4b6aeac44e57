"""Reduction of a ``torch.profiler`` trace of part of the window: the
device's busy time (the union of every kernel, copy and set on the card),
time by device operation, and the device's idle time grouped by what the
host was doing: the benchmark's own ``khaosbench.*`` spans and the
program's ``repro_torch.*`` spans (its tracer's, on in a traced window).
Both are host spans; the profiler's twin of each on the device's timeline
is no work."""
from __future__ import annotations

from dataclasses import dataclass, field

HOST_PREFIX = "khaosbench."
PROGRAM_PREFIX = "repro_torch."
SPAN_PREFIXES = (HOST_PREFIX, PROGRAM_PREFIX)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_s: dict = field(default_factory=dict)        # device op -> seconds
    op_count: dict = field(default_factory=dict)    # device op -> launches
    idle_by_host: dict = field(default_factory=dict)

    def op_mean_s(self, fragment: str):
        """Mean device seconds per launch of the ops whose name holds
        ``fragment``, or None where the trace has none."""
        n = sum(c for k, c in self.op_count.items() if fragment in k)
        if not n:
            return None
        return sum(s for k, s in self.op_s.items() if fragment in k) / n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(name: str) -> str:
    for prefix in SPAN_PREFIXES:
        if name.startswith(prefix):
            return name[len(prefix):]
    return name


def summarize(device: list, host: list, t0: float, t1: float) -> TraceSummary:
    """``device``: (name, start_us, end_us) of every device activity;
    ``host``: (name, start_us, end_us) of the host spans, the benchmark's
    and the program's, each labelled without its prefix; [t0, t1] the
    traced window in the same microseconds."""
    op_s: dict = {}
    op_count: dict = {}
    for name, a, b in device:
        op_s[name] = op_s.get(name, 0.0) + (b - a) / 1e6
        op_count[name] = op_count.get(name, 0) + 1
    busy = _union([(max(a, t0), min(b, t1)) for _, a, b in device
                   if b > t0 and a < t1])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    spans = sorted(host, key=lambda s: s[1])
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "other"
        for name, s0, s1 in spans:      # innermost span covering the gap
            if s0 <= mid <= s1:
                label = _label(name)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return TraceSummary((t1 - t0) / 1e6, busy_s, op_s, op_count, idle)


def from_profiler(prof) -> TraceSummary:
    """The summary of a stopped ``torch.profiler.profile``: its window is
    from the first to the last event it recorded."""
    device, host = [], []
    t0, t1 = float("inf"), float("-inf")
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIXES):
            # a host span; its twin on the device's timeline is no work
            if e.device_type.name != "CUDA":
                host.append((e.name, a, b))
        elif e.device_type.name == "CUDA":
            device.append((e.name, a, b))
        else:
            continue
        t0, t1 = min(t0, a), max(t1, b)
    window = [(a, b) for name, a, b in host if name == HOST_PREFIX + "window"]
    if window:
        t0, t1 = window[0]
    spans = [s for s in host if s[0] != HOST_PREFIX + "window"]
    return summarize(device, spans, t0, t1)
