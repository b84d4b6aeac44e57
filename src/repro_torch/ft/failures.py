"""Failure vocabulary of the port: the parts the live trainer uses,
copied from the JAX package's ``repro.ft.failures``.

**Crashes** (``CRASH_KINDS`` — task/node/cluster) kill the job: detect →
restart → restore from the newest surviving checkpoint level → offset
rollback → catch-up.  **Degradations** (``DEGRADATION_KINDS``) are gray
failures — ``net_delay`` (directional: ``to_source`` inflates latency,
``to_ckpt_store`` stretches each checkpoint trigger), ``straggler`` (step
time inflated for a window) and ``backpressure`` (triggers held past their
cadence slot).  Both families share one closed ``KINDS`` set and every
constructor validates against it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

#: crashes: the job dies and restores from a checkpoint
CRASH_KINDS = ("task", "node", "cluster")
#: gray failures: the job stays up but its dynamics degrade
DEGRADATION_KINDS = ("net_delay", "straggler", "backpressure")
#: the closed failure vocabulary (validated everywhere, like Decision.KINDS)
KINDS = CRASH_KINDS + DEGRADATION_KINDS

#: directional injection targets for ``net_delay``
DIRECTIONS = ("to_source", "to_ckpt_store")


def jitter_phase(t, t0):
    """Deterministic ±1 jitter phase: alternates each second of the
    degradation window.  Elementwise on arrays and exact on scalars, so
    the scalar simulator and the batched lanes price the same jittered
    delay bit-for-bit (no RNG in the tick loop)."""
    return np.where((t - t0) % 2.0 < 1.0, 1.0, -1.0)


@dataclass
class Degradation:
    """One gray-failure window, starting at ``t`` for ``duration_s``.

    ``severity`` is kind-specific: mean delay seconds (``net_delay``) or
    the step-time inflation factor (``straggler``); ``backpressure`` only
    needs the window (triggers are suppressed for its whole span).
    ``direction`` applies to ``net_delay`` only; ``host`` optionally pins
    a straggler to a concrete host for detector-facing drills.
    """
    t: float
    kind: str
    duration_s: float
    severity: float = 0.0
    jitter_s: float = 0.0
    direction: str = "to_source"
    host: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in DEGRADATION_KINDS:
            raise ValueError(f"unknown degradation kind {self.kind!r}; "
                             f"expected one of {DEGRADATION_KINDS}")
        if self.direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {self.direction!r}; "
                             f"expected one of {DIRECTIONS}")
        if self.duration_s <= 0:
            raise ValueError("degradation window must have duration_s > 0")


class InjectedFailure(RuntimeError):
    """Raised inside the live trainer loop to simulate a host crash.
    ``host=None`` is an untargeted process loss (the node's disk
    survives); a concrete host number kills that host's node-local
    checkpoint files with it (placement-aware injection)."""

    def __init__(self, kind: str = "node", host: Optional[int] = None,
                 t: float = 0.0):
        if kind not in CRASH_KINDS:
            raise ValueError(f"unknown crash kind {kind!r}; expected one of "
                             f"{CRASH_KINDS} (degradations are Degradation "
                             f"windows, not raised failures)")
        where = "" if host is None else f" on host {host}"
        super().__init__(f"injected {kind} failure{where} at t={t:.1f}")
        self.kind = kind
        self.host = host
        self.t = t
