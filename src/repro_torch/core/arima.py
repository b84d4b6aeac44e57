"""Online ARIMA via online gradient descent (after Anava et al., the method
behind the paper's anomaly detector [27]).

ARIMA(p, d, q) is approximated by an AR(p) model over the d-times
differenced series; the MA(q) component is absorbed by extending the AR
window (Anava's ARIMA-OGD).  Coefficients update per observation with
projected OGD, so the model tracks non-stationary streams — exactly what a
workload monitor needs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class OnlineARIMA:
    p: int = 8              # AR window (covers AR(p') + MA(q) per Anava)
    d: int = 1              # differencing order
    lr: float = 0.05
    clip: float = 10.0      # coefficient L2 projection radius

    w: np.ndarray = field(default=None, repr=False)
    _diffs: list = field(default_factory=list, repr=False)    # last d raw tails
    _hist: np.ndarray = field(default=None, repr=False)       # last p differenced values
    _n: int = 0
    _scale: float = 1.0

    def __post_init__(self) -> None:
        if self.w is None:
            self.w = np.zeros(self.p)
            self.w[0] = 1.0     # start as "predict last value"
        if self._hist is None:
            self._hist = np.zeros(self.p)
        self._tails = np.zeros(self.d) if self.d else np.zeros(0)

    # -- internals ------------------------------------------------------------
    def _difference(self, y: float) -> float:
        """Apply d-order differencing incrementally; returns the d-diffed value."""
        v = y
        for i in range(self.d):
            prev = self._tails[i]
            self._tails[i] = v
            v = v - prev
        return v

    def _undifference(self, dv: float) -> float:
        """Invert differencing for a one-step prediction."""
        v = dv
        for i in reversed(range(self.d)):
            v = v + self._tails[i]
        return v

    # -- API --------------------------------------------------------------
    def predict(self) -> float:
        """One-step-ahead prediction of the raw series."""
        dv = float(self.w @ self._hist)
        return self._undifference(dv)

    def update(self, y: float) -> tuple[float, float]:
        """Observe y; returns (prediction_made_before_seeing_y, error)."""
        pred = self.predict()
        # adaptive scale keeps the OGD step size unit-free
        self._scale = max(0.95 * self._scale, abs(y), 1e-9)
        err = (y - pred) / self._scale
        if self._n > self.p + self.d:
            grad = -2.0 * err * self._hist / self._scale
            self.w = self.w - self.lr * grad
            norm = np.linalg.norm(self.w)
            if norm > self.clip:
                self.w *= self.clip / norm
        dv = self._difference(y)
        self._hist[1:] = self._hist[:-1]   # in-place roll: no allocation
        self._hist[0] = dv
        self._n += 1
        return pred, y - pred

    def forecast(self, steps: int) -> np.ndarray:
        """Multi-step-ahead forecast (feeding predictions back)."""
        hist = self._hist.copy()
        tails = self._tails.copy()
        out = np.empty(steps)
        for s in range(steps):
            dv = float(self.w @ hist)
            v = dv
            for i in reversed(range(self.d)):
                v = v + tails[i]
            out[s] = v
            # roll forward as if v was observed
            vv = v
            for i in range(self.d):
                prev = tails[i]
                tails[i] = vv
                vv = vv - prev
            hist = np.roll(hist, 1)
            hist[0] = vv if self.d else v
        return out

    @property
    def warmed_up(self) -> bool:
        return self._n > 2 * (self.p + self.d)
