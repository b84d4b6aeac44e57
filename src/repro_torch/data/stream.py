"""Streaming workload substrate — the framework's "Kafka".

The paper's Phase 1 records the incoming event stream `D` and extracts the
workload function ``W(t) = |E^(t)|`` (events per second).  Here the stream
carries *training events* (documents of tokens, or serving requests); the
producer rate follows a RateSchedule.  The stream is recordable and
replayable at the recorded rate — exactly what Phase 2 needs to drive the
parallel profiling deployments.

Two workload shapes reproduce the paper's experiments:
  * ``diurnal_rate``  — IoT-Vehicles analogue (TAPASCologne-like daily cycle)
  * ``ctr_rate``      — YSB analogue (ad-click CTR-like bursty rate)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

RateSchedule = Callable[[float], float]   # t (seconds) -> events/second


def constant_rate(rate: float) -> RateSchedule:
    return lambda t: float(rate)


def diurnal_rate(base: float = 1000.0, amplitude: float = 0.6,
                 period: float = 86_400.0, noise: float = 0.05,
                 seed: int = 0) -> RateSchedule:
    """Vehicle-traffic-like daily cycle: morning/evening peaks + noise."""
    rng = np.random.default_rng(seed)
    # fixed random phases for harmonics -> deterministic per seed
    phases = rng.uniform(0, 2 * np.pi, size=3)

    def rate(t: float) -> float:
        x = 2 * np.pi * (t % period) / period
        day = 0.5 * (1 - np.cos(x))                       # one broad daily bump
        rush = 0.35 * (np.sin(2 * x + phases[0]) ** 2)     # two rush-hour peaks
        wiggle = 0.08 * np.sin(7 * x + phases[1]) + 0.05 * np.sin(13 * x + phases[2])
        level = base * (1.0 + amplitude * (day + rush + wiggle - 0.5))
        jitter = 1.0 + noise * np.sin(t * 0.37 + phases[0] * 11.3)
        return float(max(1.0, level * jitter))

    return rate


def ctr_rate(base: float = 2000.0, seed: int = 1, period: float = 86_400.0) -> RateSchedule:
    """Ad-click-like workload: plateau + bursts (YSB analogue)."""
    rng = np.random.default_rng(seed)
    n_bursts = 6
    centers = rng.uniform(0, period, n_bursts)
    widths = rng.uniform(0.01, 0.04, n_bursts) * period
    heights = rng.uniform(0.3, 0.9, n_bursts)

    def rate(t: float) -> float:
        tt = t % period
        x = 2 * np.pi * tt / period
        level = base * (1.0 + 0.25 * np.sin(x) + 0.12 * np.sin(3 * x + 1.1))
        for c, w, h in zip(centers, widths, heights):
            level += base * h * np.exp(-0.5 * ((tt - c) / w) ** 2)
        return float(max(1.0, level))

    return rate


# ---------------------------------------------------------------------------
# Recording (Phase 1 artifact)
# ---------------------------------------------------------------------------

@dataclass
class WorkloadRecording:
    """The paper's dataset D, reduced to per-second arrival counts.

    ``times[i]`` is the i-th second of the recording window and
    ``counts[i] = |E^(t_i)| = W(t_i)``.
    """
    times: np.ndarray
    counts: np.ndarray

    def __post_init__(self) -> None:
        self.times = np.asarray(self.times, dtype=np.float64)
        self.counts = np.asarray(self.counts, dtype=np.float64)
        assert self.times.shape == self.counts.shape

    @property
    def duration(self) -> float:
        return float(self.times[-1] - self.times[0]) if len(self.times) > 1 else 0.0

    def workload(self, smoothing_window: int = 1) -> np.ndarray:
        """W(t), optionally smoothed with the paper's averaging window."""
        if smoothing_window <= 1:
            return self.counts.copy()
        k = np.ones(smoothing_window) / smoothing_window
        pad = smoothing_window // 2
        vp = np.pad(self.counts, (pad, smoothing_window - 1 - pad), mode="edge")
        return np.convolve(vp, k, mode="valid")

    def rate_at(self, t: float) -> float:
        i = int(np.clip(np.searchsorted(self.times, t), 0, len(self.times) - 1))
        return float(self.counts[i])

    def rates_at(self, times) -> np.ndarray:
        """Vectorized ``rate_at`` — one searchsorted for a whole time grid
        (the batched simulator's per-lane λ arrays come from here)."""
        times = np.asarray(times, dtype=np.float64)
        idx = np.clip(np.searchsorted(self.times, times), 0, len(self.times) - 1)
        return self.counts[idx]

    def rates_until(self, t_end: float, t0: Optional[float] = None,
                    tick: float = 1.0) -> np.ndarray:
        """Dense per-tick rate array for [t0, t_end) — precomputed once so a
        simulator pays an array index per tick instead of a Python call."""
        start = float(self.times[0]) if t0 is None else float(t0)
        n = max(0, int(np.ceil((t_end - start) / tick)))
        return self.rates_at(start + np.arange(n) * tick)

    def slice(self, t0: float, t1: float) -> "WorkloadRecording":
        m = (self.times >= t0) & (self.times <= t1)
        return WorkloadRecording(self.times[m], self.counts[m])


def dense_rates(t0: float, n_ticks: int,
                recording: Optional[WorkloadRecording] = None,
                schedule: Optional[RateSchedule] = None,
                tick: float = 1.0) -> np.ndarray:
    """Precompute λ(t) for ``n_ticks`` ticks starting at ``t0``.

    A recording resolves with one vectorized searchsorted; a schedule is a
    Python callable so it is sampled once here — either way the simulators
    stop paying a per-tick Python call on their hot loop.  The time grid
    ``t0 + k*tick`` matches the scalar simulator's clock exactly (its clock
    advances by exact float increments), so the values are identical to
    per-tick ``rate_at`` calls.
    """
    times = t0 + np.arange(n_ticks) * tick
    if recording is not None:
        return recording.rates_at(times)
    assert schedule is not None, "need a recording or a schedule"
    return np.array([schedule(float(t)) for t in times], dtype=np.float64)


def record_workload(schedule: RateSchedule, duration: float, t0: float = 0.0,
                    tick: float = 1.0, seed: int = 0,
                    poisson: bool = True) -> WorkloadRecording:
    """Phase 1 recording: sample arrivals for ``duration`` seconds.

    With ``poisson=True`` the per-tick count is Poisson(rate*tick) —
    realistic arrival noise the smoothing window then removes, as in the
    paper.
    """
    rng = np.random.default_rng(seed)
    n = int(round(duration / tick))
    times = t0 + np.arange(n) * tick
    rates = np.array([schedule(t) for t in times]) * tick
    counts = rng.poisson(rates).astype(np.float64) if poisson else rates
    return WorkloadRecording(times, counts)


# ---------------------------------------------------------------------------
# Live stream with lag accounting (the "messaging queue")
# ---------------------------------------------------------------------------

@dataclass
class EventStream:
    """Producer/consumer queue with offsets, the unit the trainer consumes.

    * producer side advances with time according to a schedule or recording
      (``produce_until``),
    * consumer side takes events in order (``consume``),
    * ``lag`` is the paper's *consumer lag* metric.

    Events are abstract here; the data pipeline maps offsets -> token
    batches deterministically, so an offset is a complete cursor (this is
    what makes checkpoint/restore exactly-once, cf. DESIGN.md §7.7).
    """
    schedule: Optional[RateSchedule] = None
    recording: Optional[WorkloadRecording] = None
    produced: float = 0.0       # fractional produced offset
    consumed: int = 0
    _last_t: float = 0.0        # stream production starts at t=0

    def rate_at(self, t: float) -> float:
        if self.recording is not None:
            return self.recording.rate_at(t)
        assert self.schedule is not None
        return self.schedule(t)

    def produce_until(self, t: float) -> None:
        if t == self._last_t:
            return
        if t < self._last_t:
            raise ValueError("time went backwards")
        # integrate the rate over [last_t, t] with 1s midpoint steps
        span = t - self._last_t
        steps = max(1, int(span))
        dt = span / steps
        for i in range(steps):
            tm = self._last_t + (i + 0.5) * dt
            self.produced += self.rate_at(tm) * dt
        self._last_t = t

    @property
    def lag(self) -> int:
        return max(0, int(self.produced) - self.consumed)

    def consume(self, n: int) -> int:
        """Take up to n events; returns how many were actually available."""
        take = min(n, self.lag)
        self.consumed += take
        return take

    # -- checkpoint support -------------------------------------------------
    def cursor(self) -> dict:
        return {"consumed": self.consumed}

    def restore(self, cursor: dict) -> None:
        self.consumed = int(cursor["consumed"])
