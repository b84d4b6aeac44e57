"""Straggler mitigation — reuses the paper's online-ARIMA anomaly detector
(core/anomaly.py) on per-host step times.

A host whose step-time stream turns anomalous for ``patience`` consecutive
observations is flagged; the runtime's mitigation ladder is
(1) re-balance input shards away from it, (2) evict + elastic rescale
(ft/elastic.py) when it persists.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.arima import OnlineARIMA


@dataclass
class StragglerDetector:
    num_hosts: int
    slow_factor: float = 1.5       # x median counts as slow
    patience: int = 5
    _models: dict = field(default_factory=dict)
    _slow_streak: dict = field(default_factory=dict)
    flagged: set = field(default_factory=set)
    history: list = field(default_factory=list)

    def observe_step(self, t: float, host_step_times: dict) -> list[int]:
        """Feed per-host step times for one step; returns hosts flagged."""
        times = sorted(host_step_times.values())
        mid = len(times) // 2
        # true median: averaging the middle pair matters for even host
        # counts — taking the upper element would compare every host in a
        # 2-host cluster against the SLOWER one, hiding the straggler
        median = times[mid] if len(times) % 2 else \
            0.5 * (times[mid - 1] + times[mid])
        newly = []
        for host, st in host_step_times.items():
            model = self._models.setdefault(host, OnlineARIMA(p=6, d=0, lr=0.1))
            pred, _ = model.update(st)
            slow = st > self.slow_factor * max(median, 1e-9)
            drifting = model.warmed_up and st > self.slow_factor * max(pred, 1e-9)
            streak = self._slow_streak.get(host, 0)
            streak = streak + 1 if (slow or drifting) else 0
            self._slow_streak[host] = streak
            if streak >= self.patience and host not in self.flagged:
                self.flagged.add(host)
                newly.append(host)
                self.history.append((t, host))
        return newly

    def clear(self, host: int) -> None:
        self.flagged.discard(host)
        self._slow_streak[host] = 0
