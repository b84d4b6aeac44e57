"""Phase 3 TSF — multi-step-ahead workload forecast and the deferral rule
(paper §III-D): if the incoming message rate is expected to decrease by
more than ``defer_drop_fraction`` (10%) before the next optimization cycle,
the reconfiguration decision is deferred.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.arima import OnlineARIMA


@dataclass
class WorkloadForecaster:
    horizon: int = 5
    defer_drop_fraction: float = 0.10
    p: int = 12
    d: int = 1
    _model: OnlineARIMA = field(default=None)
    _last: float = 0.0

    def __post_init__(self) -> None:
        if self._model is None:
            self._model = OnlineARIMA(p=self.p, d=self.d, lr=0.05)

    def observe(self, rate: float) -> None:
        self._model.update(float(rate))
        self._last = float(rate)

    def forecast(self, steps: int = 0) -> np.ndarray:
        return self._model.forecast(steps or self.horizon)

    def should_defer(self) -> bool:
        """True when the forecasted rate drops > defer fraction vs now."""
        if not self._model.warmed_up or self._last <= 0:
            return False
        fc = self.forecast()
        future = float(np.min(fc))   # most optimistic drop within the horizon
        return future < (1.0 - self.defer_drop_fraction) * self._last

    @property
    def warmed_up(self) -> bool:
        return self._model.warmed_up

    def predicted_peak(self) -> float:
        """Highest forecasted rate within the horizon — the load the
        proactive controller must already satisfy when it arrives.  Before
        warm-up (or with no positive observation yet) the forecast is
        meaningless, so the last observation stands in: the proactive rule
        then degenerates to the reactive one instead of acting on noise."""
        if not self._model.warmed_up or self._last <= 0:
            return self._last
        return float(np.max(self.forecast()))
