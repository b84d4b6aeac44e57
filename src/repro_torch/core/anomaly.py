"""Online-ARIMA anomaly detector (paper §III-C, after [27]).

Trained on failure-free ("positive") executions of the metrics stream
(input throughput, consumer lag).  A point is anomalous when the
normalized prediction error exceeds a threshold derived from a window of
past errors; *recovery time* is the length of the contiguous anomalous
interval — i.e. from failure until the job is producing results at the
latest offset again (§III-C's availability definition).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.arima import OnlineARIMA


@dataclass
class AnomalyDetector:
    metrics: Sequence[str] = ("throughput", "consumer_lag")
    p: int = 8
    d: int = 1
    threshold_sigma: float = 4.0
    error_window: int = 120           # window of past errors for the threshold
    min_anomaly_len: int = 2          # consecutive hits to enter anomalous
    recovery_normal_len: int = 3      # consecutive normals to exit

    _models: dict = field(default_factory=dict)
    _errors: dict = field(default_factory=dict)
    _state: str = "normal"
    _anomaly_started: Optional[float] = None
    _hit_streak: int = 0
    _normal_streak: int = 0
    recoveries: list = field(default_factory=list)   # (t_start, t_end)

    def __post_init__(self) -> None:
        for m in self.metrics:
            self._models[m] = OnlineARIMA(p=self.p, d=self.d)
            self._errors[m] = []

    # ------------------------------------------------------------------
    def observe(self, t: float, values: dict, learn: bool = True) -> bool:
        """Feed one metrics sample; returns True if currently anomalous.

        ``learn=False`` freezes coefficient updates *and* the error window
        (used during injected failures so the detector doesn't learn the
        anomaly as normal — the paper trains on positive executions).
        """
        hits = 0
        for m in self.metrics:
            model = self._models[m]
            y = float(values[m])
            if not learn and model.warmed_up:
                pred = model.predict()
                err = abs(y - pred) / max(abs(pred), 1e-6)
            else:
                pred, raw_err = model.update(y)
                err = abs(raw_err) / max(abs(pred), 1e-6)
            window = self._errors[m]
            if model.warmed_up and len(window) >= 10:
                mu = float(np.mean(window))
                sd = float(np.std(window)) + 1e-9
                if err > mu + self.threshold_sigma * sd:
                    hits += 1
            if learn:
                window.append(err)
                if len(window) > self.error_window:
                    window.pop(0)
        return self._advance_state(t, hits > 0)

    def _advance_state(self, t: float, hit: bool) -> bool:
        if self._state == "normal":
            self._hit_streak = self._hit_streak + 1 if hit else 0
            if self._hit_streak >= self.min_anomaly_len:
                self._state = "anomalous"
                self._anomaly_started = t
                self._normal_streak = 0
        else:
            self._normal_streak = self._normal_streak + 1 if not hit else 0
            if self._normal_streak >= self.recovery_normal_len:
                self.recoveries.append((self._anomaly_started, t))
                self._state = "normal"
                self._hit_streak = 0
                self._anomaly_started = None
        return self._state == "anomalous"

    # ------------------------------------------------------------------
    @property
    def anomalous(self) -> bool:
        return self._state == "anomalous"

    def last_recovery_time(self) -> Optional[float]:
        if not self.recoveries:
            return None
        s, e = self.recoveries[-1]
        return e - s

    @property
    def warmed_up(self) -> bool:
        return all(m.warmed_up for m in self._models.values())
