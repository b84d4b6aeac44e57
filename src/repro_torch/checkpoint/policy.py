"""Checkpoint cadence policy — the knob Khaos turns at runtime.

The interval is in SECONDS (the paper's CI); ``due`` converts against the
job clock.  ``set_interval`` is hot-swappable: the controller's
reconfiguration lands here without a job restart (DESIGN.md §7.1), or via
the simulator's flink-semantics restart path for faithful E1/E2 runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class CheckpointPolicy:
    interval_s: float
    _last_ckpt_t: float = 0.0
    history: list = field(default_factory=list)   # (t, new_interval)

    def set_interval(self, interval_s: float, t: float = 0.0) -> None:
        self.interval_s = float(interval_s)
        self.history.append((t, float(interval_s)))

    def due(self, t: float) -> bool:
        return t - self._last_ckpt_t >= self.interval_s

    def next_due(self, t: float) -> float:
        return self._last_ckpt_t + self.interval_s

    def mark(self, t: float) -> None:
        self._last_ckpt_t = t

    def reset(self, t: float) -> None:
        self._last_ckpt_t = t
