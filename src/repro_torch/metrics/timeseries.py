"""In-memory time-series store — the framework's "Prometheus".

The Khaos controller, the anomaly detector and the simulator all read and
write through this interface, so the same controller code runs against the
discrete-event simulator and the live trainer.

Two retention modes:

* unbounded (the default, ``maxlen=None``) — every sample is kept, exactly
  the pre-fleet behavior; the windowed queries below are exact over the
  whole history.
* bounded (``maxlen=N``) — the fleet-plane mode: only the most recent N
  samples are held raw.  When the buffer overflows, the OLDEST half is
  evicted into one ``Rollup`` bucket (count/mean/min/max over the evicted
  span), and the rollup list itself is bounded (``max_rollups``) by
  merging adjacent buckets — halving historical resolution instead of
  growing — so memory stays flat no matter how long a campaign runs.
  Windowed queries (the controller's trailing-window reads) see the raw
  recent samples; lifetime aggregates (``lifetime_count``/
  ``lifetime_mean``) fold the rollups back in.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np


@dataclass
class Rollup:
    """Aggregate of an evicted sample span [t_start, t_end]."""
    t_start: float
    t_end: float
    count: int
    mean: float
    vmin: float
    vmax: float

    def merge(self, other: "Rollup") -> "Rollup":
        n = self.count + other.count
        return Rollup(min(self.t_start, other.t_start),
                      max(self.t_end, other.t_end), n,
                      (self.mean * self.count + other.mean * other.count) / n,
                      min(self.vmin, other.vmin),
                      max(self.vmax, other.vmax))


@dataclass
class TimeSeries:
    name: str
    times: list = field(default_factory=list)
    values: list = field(default_factory=list)
    maxlen: Optional[int] = None       # None = unbounded (exact history)
    max_rollups: int = 256             # bounded mode: history bucket cap
    rollups: list = field(default_factory=list)

    def append(self, t: float, v: float) -> None:
        if self.times and t < self.times[-1]:
            raise ValueError(f"non-monotonic append to {self.name}: {t} < {self.times[-1]}")
        self.times.append(float(t))
        self.values.append(float(v))
        if self.maxlen is not None and len(self.times) > self.maxlen:
            self._evict()

    def _evict(self) -> None:
        """Roll the oldest half of the raw buffer into one bucket."""
        k = max(1, len(self.times) // 2)
        ev_t, ev_v = self.times[:k], np.asarray(self.values[:k])
        self.rollups.append(Rollup(ev_t[0], ev_t[-1], k, float(ev_v.mean()),
                                   float(ev_v.min()), float(ev_v.max())))
        del self.times[:k]
        del self.values[:k]
        if len(self.rollups) > self.max_rollups:
            # halve historical resolution instead of growing
            self.rollups = [a.merge(b) for a, b in
                            zip(self.rollups[::2], self.rollups[1::2])] + \
                           (self.rollups[-1:] if len(self.rollups) % 2 else [])

    def __len__(self) -> int:
        return len(self.times)

    # -- lifetime aggregates (rollups + live samples) ------------------------
    def lifetime_count(self) -> int:
        return len(self.times) + sum(r.count for r in self.rollups)

    def lifetime_mean(self, default: float = float("nan")) -> float:
        n = self.lifetime_count()
        if n == 0:
            return default
        s = float(np.sum(self.values)) + sum(r.mean * r.count
                                             for r in self.rollups)
        return s / n

    def lifetime_max(self, default: float = float("nan")) -> float:
        cands = ([max(self.values)] if self.values else []) + \
                [r.vmax for r in self.rollups]
        return max(cands) if cands else default

    # -- queries -----------------------------------------------------------
    def window(self, t_start: float, t_end: float) -> tuple[np.ndarray, np.ndarray]:
        lo = bisect.bisect_left(self.times, t_start)
        hi = bisect.bisect_right(self.times, t_end)
        return np.asarray(self.times[lo:hi]), np.asarray(self.values[lo:hi])

    def last(self, n: int = 1) -> np.ndarray:
        return np.asarray(self.values[-n:])

    def latest(self, default: float = float("nan")) -> float:
        return self.values[-1] if self.values else default

    def mean_over(self, t_start: float, t_end: float, default: float = float("nan")) -> float:
        _, v = self.window(t_start, t_end)
        return float(v.mean()) if v.size else default

    def percentile_over(self, t_start: float, t_end: float, q: float,
                        default: float = float("nan")) -> float:
        _, v = self.window(t_start, t_end)
        return float(np.percentile(v, q)) if v.size else default

    def smoothed(self, window: int) -> np.ndarray:
        """Centered moving average (the paper's 'averaging window' over W(t))."""
        v = np.asarray(self.values, dtype=np.float64)
        if v.size == 0 or window <= 1:
            return v
        kernel = np.ones(window) / window
        pad = window // 2
        vp = np.pad(v, (pad, window - 1 - pad), mode="edge")
        return np.convolve(vp, kernel, mode="valid")


class MetricsStore:
    """Named time series with lazy creation.

    ``maxlen`` selects the bounded/windowed retention mode for every series
    created through this store (None = unbounded, the default) — the fleet
    metrics plane runs bounded so supervising many jobs under heavy traffic
    holds memory flat.
    """

    def __init__(self, maxlen: Optional[int] = None,
                 max_rollups: int = 256) -> None:
        self._series: dict[str, TimeSeries] = {}
        self.maxlen = maxlen
        self.max_rollups = max_rollups

    def series(self, name: str) -> TimeSeries:
        if name not in self._series:
            self._series[name] = TimeSeries(name, maxlen=self.maxlen,
                                            max_rollups=self.max_rollups)
        return self._series[name]

    def record(self, name: str, t: float, v: float) -> None:
        self.series(name).append(t, v)

    def names(self) -> Iterable[str]:
        return self._series.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._series
