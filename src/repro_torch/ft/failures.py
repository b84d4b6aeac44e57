"""Failure taxonomy and injection (the chaos in Khaos), copied from the
JAX package's ``repro.ft.failures``.

**Crashes** (``CRASH_KINDS`` — task/node/cluster) kill the job: detect →
restart → restore from the newest surviving checkpoint level → offset
rollback → catch-up.  **Degradations** (``DEGRADATION_KINDS``) are gray
failures — ``net_delay`` (directional: ``to_source`` inflates latency,
``to_ckpt_store`` stretches each checkpoint trigger), ``straggler`` (step
time inflated for a window) and ``backpressure`` (triggers held past their
cadence slot).  Both families share one closed ``KINDS`` set and every
constructor validates against it.

* ``FailureModel`` samples failures from exponential (Poisson process)
  or Weibull inter-arrival distributions (background failures and MTBF
  estimates for the Young/Daly baseline).
* ``FailureInjector`` implements the paper's worst-case injection: a
  requested injection time is snapped to just before the *next
  checkpoint completes* (maximizing lost work, §III-C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
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


@dataclass
class FailureModel:
    mtbf_node_s: float = 86_400.0      # per-node MTBF
    num_nodes: int = 64
    distribution: str = "exponential"  # exponential | weibull
    weibull_shape: float = 0.7         # <1: infant mortality
    seed: int = 0
    kinds: tuple = (("task", 0.3), ("node", 0.65), ("cluster", 0.05))

    def __post_init__(self) -> None:
        for kind, _w in self.kinds:
            if kind not in KINDS:
                raise ValueError(f"unknown failure kind {kind!r}; expected "
                                 f"one of {KINDS}")
        self._rng = np.random.default_rng(self.seed)

    @property
    def cluster_mtbf_s(self) -> float:
        return self.mtbf_node_s / max(1, self.num_nodes)

    def next_failure_after(self, t: float) -> float:
        scale = self.cluster_mtbf_s
        if self.distribution == "exponential":
            dt = self._rng.exponential(scale)
        else:
            k = self.weibull_shape
            lam = scale / math.gamma(1 + 1 / k)   # mean matches the MTBF
            dt = lam * self._rng.weibull(k)
        return t + float(max(dt, 1.0))

    def sample_kind(self) -> str:
        kinds, probs = zip(*self.kinds)
        return str(self._rng.choice(kinds, p=probs))

    def sample_host(self) -> int:
        return int(self._rng.integers(self.num_nodes))


@dataclass
class FailureInjector:
    """Deterministic injection scheduler for profiling and baselines.

    Beyond the paper's worst-case *timing* (§III-C), the injector is
    placement-aware: ``worst_case_failure`` targets a specific HOST (so
    the checkpoint plane's host->shard placement decides exactly which
    files die), and ``peer_loss`` composes the worst case for k=1
    replication — the host AND one of its ring replica peers inside the
    same window, leaving some shard with no surviving local copy."""
    epsilon_s: float = 1.0
    log: list = field(default_factory=list)

    def worst_case_time(self, requested_t: float, last_ckpt_t: float,
                        interval_s: float, ckpt_cost_s: float) -> float:
        """Paper §III-C: inject just before the next checkpoint *completes*.

        The next checkpoint after ``requested_t`` starts at the next
        multiple of the interval and completes ``ckpt_cost_s`` later; we
        inject epsilon before that completion so the job replays a full
        interval's worth of work.
        """
        if interval_s <= 0:
            return requested_t
        k = np.ceil(max(requested_t - last_ckpt_t, 0.0) / interval_s)
        next_start = last_ckpt_t + k * interval_s
        if next_start < requested_t:
            next_start += interval_s
        completion = next_start + ckpt_cost_s
        t = max(requested_t, completion - self.epsilon_s)
        self.log.append({"requested": requested_t, "injected": t})
        return float(t)

    def worst_case_failure(self, requested_t: float, last_ckpt_t: float,
                           interval_s: float, ckpt_cost_s: float,
                           kind: str = "node", host: int = 0
                           ) -> InjectedFailure:
        """Host-targeted worst-case injection: the §III-C timing plus a
        placement — ``host``'s node-local files (its primary shards and
        the replicas it held) die with it, so the restore that follows
        exercises the degraded-partial path, not a free local read."""
        if kind not in CRASH_KINDS:
            raise ValueError(f"unknown crash kind {kind!r}; expected one of "
                             f"{CRASH_KINDS}")
        t = self.worst_case_time(requested_t, last_ckpt_t, interval_s,
                                 ckpt_cost_s)
        self.log[-1].update({"kind": kind, "host": host})
        return InjectedFailure(kind=kind, host=host, t=t)

    def peer_loss(self, requested_t: float, last_ckpt_t: float,
                  interval_s: float, ckpt_cost_s: float, host: int,
                  num_hosts: int, replication_factor: int = 1,
                  window_s: float = 5.0) -> list[InjectedFailure]:
        """The k=1 worst case: kill ``host`` at the worst-case time AND
        its first ring replica peer (the host holding ``host``'s shard
        copies) ``window_s`` later — inside the window no new checkpoint
        can complete, so the dead host's shards lose every local copy
        and recovery must fall back per-shard to the remote level.
        Returns the two failures in injection order."""
        from repro_torch.checkpoint.replication import ring_peers

        first = self.worst_case_failure(requested_t, last_ckpt_t,
                                        interval_s, ckpt_cost_s,
                                        kind="node", host=host)
        peers = ring_peers(host, num_hosts, max(1, replication_factor))
        if not peers:
            return [first]
        window_s = min(window_s, max(interval_s - 2 * self.epsilon_s,
                                     self.epsilon_s))
        second = InjectedFailure(kind="node", host=peers[0],
                                 t=first.t + window_s)
        self.log.append({"requested": first.t, "injected": second.t,
                         "kind": "node", "host": peers[0],
                         "scenario": "peer_loss"})
        return [first, second]
