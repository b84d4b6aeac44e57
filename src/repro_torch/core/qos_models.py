"""Phase 3 models — performance model M_L : (C, TR) -> L and recovery-time
model M_R : (C, TR) -> R (paper §III-D): multivariate polynomial ridge
regression, plus the prediction-rescaling factor ``p``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _features(ci_n: np.ndarray, tr_n: np.ndarray, ci_raw: np.ndarray,
              degree: int, rational: bool) -> np.ndarray:
    """Design matrix over (ci, tr): full polynomial of ``degree`` plus
    (optionally) rational terms in CI.  Checkpoint economics are rational:
    per-checkpoint overhead scales with 1/CI while lost work scales with CI,
    so 1/ci and tr/ci features capture the recovery/latency surfaces that a
    plain quadratic cannot (this is still "multivariate regression" in the
    paper's sense — only the basis is richer)."""
    if degree == 2:
        # explicit degree-2 columns: same values as the generic loop
        # (integer powers 0/1/2 reduce to 1, x, x*x bit-exactly), ~2x
        # fewer ufunc dispatches on the controllers' per-poll hot path
        cols = [np.ones_like(ci_n), ci_n, tr_n,
                ci_n * ci_n, ci_n * tr_n, tr_n * tr_n]
    else:
        cols = [np.ones_like(ci_n)]
        for dtot in range(1, degree + 1):
            for i in range(dtot + 1):
                cols.append((ci_n ** (dtot - i)) * (tr_n ** i))
    if rational:
        inv = 1.0 / np.maximum(ci_raw, 1e-9)
        cols.append(inv)
        cols.append(inv * tr_n)
        cols.append(inv * inv)
    out = np.empty(np.shape(ci_n) + (len(cols),))
    for j, c in enumerate(cols):
        out[..., j] = c
    return out


@dataclass
class QoSModel:
    """Ridge regression y ~ basis(ci, tr)."""
    degree: int = 2
    ridge_lambda: float = 1e-3
    rational: bool = True
    _beta: Optional[np.ndarray] = None
    _mu: Optional[np.ndarray] = None
    _sd: Optional[np.ndarray] = None

    def _design(self, ci: np.ndarray, tr: np.ndarray) -> np.ndarray:
        return _features((ci - self._mu[0]) / self._sd[0],
                         (tr - self._mu[1]) / self._sd[1],
                         ci, self.degree, self.rational)

    def fit(self, ci: np.ndarray, tr: np.ndarray, y: np.ndarray) -> "QoSModel":
        ci, tr, y = map(lambda a: np.asarray(a, np.float64).ravel(), (ci, tr, y))
        self._mu = np.array([ci.mean(), tr.mean()])
        self._sd = np.array([ci.std() + 1e-9, tr.std() + 1e-9])
        X = self._design(ci, tr)
        lam = self.ridge_lambda * np.eye(X.shape[1])
        lam[0, 0] = 0.0   # don't penalize the intercept
        self._beta = np.linalg.solve(X.T @ X + lam, X.T @ y)
        return self

    def predict(self, ci, tr) -> np.ndarray:
        assert self._beta is not None, "fit first"
        ci = np.asarray(ci, np.float64)
        tr = np.broadcast_to(np.asarray(tr, np.float64), ci.shape)
        # row-independent reduction (not BLAS matmul): each prediction is
        # its own pairwise sum, so predicting a stacked batch of (ci, tr)
        # rows is BIT-identical to predicting them one at a time — the
        # property the controller's shared per-period evaluation
        # (KhaosRuntime.drive_campaign) relies on
        return (self._design(ci, tr) * self._beta).sum(axis=-1)

    def predict_pair(self, other: "QoSModel", ci, tr
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Evaluate this model AND ``other`` with one design matrix.

        Valid whenever both models share basis and normalization (the
        runtime fits M_L and M_R on the same profiling grid, so they
        do); asserted cheaply.  Each output is bit-identical to the
        model's own ``predict`` — same features, same reduction — this
        just halves the feature-building cost on the controllers'
        per-poll hot path.  Falls back to two plain predicts when the
        normalizations differ."""
        if not (self.degree == other.degree
                and self.rational == other.rational
                and np.array_equal(self._mu, other._mu)
                and np.array_equal(self._sd, other._sd)):
            return self.predict(ci, tr), other.predict(ci, tr)
        assert self._beta is not None and other._beta is not None, "fit first"
        ci = np.asarray(ci, np.float64)
        tr = np.broadcast_to(np.asarray(tr, np.float64), ci.shape)
        X = self._design(ci, tr)
        return (X * self._beta).sum(axis=-1), (X * other._beta).sum(axis=-1)

    def avg_percent_error(self, ci, tr, y) -> float:
        """The paper's post-execution error analysis (Tables II(a)/III(a))."""
        pred = self.predict(np.asarray(ci, np.float64), np.asarray(tr, np.float64))
        y = np.asarray(y, np.float64).ravel()
        return float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-9)))

    # -- persistence (fleet.QoSModelRegistry round-trip) ---------------------
    def to_dict(self) -> dict:
        """JSON-safe dump of a FITTED model (hyperparameters + solution)."""
        assert self._beta is not None, "fit first"
        return {"degree": self.degree, "ridge_lambda": self.ridge_lambda,
                "rational": self.rational, "beta": self._beta.tolist(),
                "mu": self._mu.tolist(), "sd": self._sd.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "QoSModel":
        m = cls(degree=int(d["degree"]), ridge_lambda=float(d["ridge_lambda"]),
                rational=bool(d["rational"]))
        m._beta = np.asarray(d["beta"], np.float64)
        m._mu = np.asarray(d["mu"], np.float64)
        m._sd = np.asarray(d["sd"], np.float64)
        return m


def demo_prior_models(ci_lo: float = 5.0, ci_hi: float = 60.0,
                      tr_lo: float = 100.0, tr_hi: float = 800.0,
                      n: int = 64, seed: int = 0
                      ) -> tuple[QoSModel, QoSModel]:
    """Prior-fitted (M_L, M_R) for demos and smoke paths that skip
    Phases 1-2 (installed via ``KhaosRuntime.install_models``): a latency
    surface falling with CI and a recovery surface growing with CI — the
    one source for the recipe ``examples/train_stream.py`` and
    ``launch/train.py --khaos`` share."""
    rng = np.random.default_rng(seed)
    ci = rng.uniform(ci_lo, ci_hi, n)
    tr = rng.uniform(tr_lo, tr_hi, n)
    m_l = QoSModel().fit(ci, tr, 0.05 + 2.0 / ci + tr * 1e-5)
    m_r = QoSModel().fit(ci, tr, 4.0 + 1.0 * ci + tr * 5e-3)
    return m_l, m_r


@dataclass
class RescalingTracker:
    """The paper's correction factor p: average of the k pairwise fractional
    differences between observed latencies and model predictions, used to
    localize M_L to current cluster conditions."""
    k: int = 5
    _pairs: list = field(default_factory=list)

    def track(self, observed: float, predicted: float) -> None:
        if predicted > 1e-12:
            self._pairs.append(observed / predicted)
            if len(self._pairs) > self.k:
                self._pairs.pop(0)

    @property
    def p(self) -> float:
        return float(np.mean(self._pairs)) if self._pairs else 1.0
