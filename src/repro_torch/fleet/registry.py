"""QoS-model transfer: profile fingerprints, the fleet model registry and
the divergence watchdog that guards transferred models.

Phase 2 (chaos profiling) is the expensive step of the Khaos loop — z x m
campaign lanes per job.  In a fleet, many jobs are near-copies of each
other (same state size, similar arrival envelope, same plan search space),
and their fitted M_L / M_R surfaces are interchangeable.  The registry
exploits that: every fitted job files its models under a coarse
``JobFingerprint``; a newly admitted job whose fingerprint matches a
neighbor adopts the neighbor's models (``KhaosRuntime.adopt_models``) and
skips the campaign entirely.

Transfer is a bet, so it ships with its own guard: a
``DivergenceWatchdog`` compares what the adopted M_L predicts against what
the job actually observes once it is optimizing; a sustained relative
error above threshold means the neighbor did NOT describe this job, and
the supervisor falls back to a real ``reprofile()`` (the PR-8 legal Phase-2
re-entry) — the fast path degrades to the cold path, never to a wrong
steady state.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.core.qos_models import QoSModel


@dataclass(frozen=True)
class JobFingerprint:
    """Coarse profile identity: two jobs with equal fingerprints are
    assumed to share QoS surfaces (until the watchdog says otherwise).

    * ``state_bytes_log2`` — checkpoint state size, log2-binned: write and
      restore durations scale with state bytes, so recovery surfaces only
      transfer between like-sized jobs;
    * ``rate_mean_bin`` / ``rate_peak_bin`` — the arrival-rate envelope
      (log2-binned mean and peak of the recorded W(t)): the throughput
      range the models were fitted over;
    * ``ci_window`` / ``num_configs`` — the plan search dimensions: models
      fitted over a different CI grid extrapolate instead of interpolate.
    """
    state_bytes_log2: int
    rate_mean_bin: int
    rate_peak_bin: int
    ci_window: tuple
    num_configs: int

    def key(self) -> str:
        return (f"sb{self.state_bytes_log2}-rm{self.rate_mean_bin}"
                f"-rp{self.rate_peak_bin}-ci{self.ci_window[0]:g}"
                f"_{self.ci_window[1]:g}-z{self.num_configs}")


def _log2_bin(x: float) -> int:
    return int(round(math.log2(max(float(x), 1.0))))


def fingerprint(cfg: KhaosConfig, recording, state_bytes: float
                ) -> JobFingerprint:
    """Fingerprint a job from its Khaos config, its Phase-1 recording and
    its checkpoint state size (``SimCostModel.state_bytes`` on the sim
    substrate, the measured snapshot size on the live one)."""
    w = recording.workload(cfg.smoothing_window)
    return JobFingerprint(
        state_bytes_log2=_log2_bin(state_bytes),
        rate_mean_bin=_log2_bin(float(np.mean(w))),
        rate_peak_bin=_log2_bin(float(np.max(w))),
        ci_window=(float(cfg.ci_min), float(cfg.ci_max)),
        num_configs=int(cfg.num_configs))


@dataclass
class RegistryEntry:
    fp: JobFingerprint
    m_l: QoSModel
    m_r: QoSModel
    source_job: str


class QoSModelRegistry:
    """Fleet-wide store of fitted (M_L, M_R) pairs, keyed by fingerprint.

    ``lookup`` is exact-match on the fingerprint key — the bins are coarse
    on purpose (factor-of-two rate/state buckets), so "near-copy" jobs
    collide and genuinely different jobs do not.  Persistence round-trips
    through JSON (``save``/``load``) so a fleet restart keeps its learned
    surfaces.
    """

    def __init__(self) -> None:
        self._entries: dict[str, RegistryEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, fp: JobFingerprint, m_l: QoSModel, m_r: QoSModel,
            source_job: str) -> None:
        self._entries[fp.key()] = RegistryEntry(fp, m_l, m_r, source_job)

    def lookup(self, fp: JobFingerprint) -> Optional[RegistryEntry]:
        return self._entries.get(fp.key())

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": "qos_registry/1", "entries": [
            {"fingerprint": {"state_bytes_log2": e.fp.state_bytes_log2,
                             "rate_mean_bin": e.fp.rate_mean_bin,
                             "rate_peak_bin": e.fp.rate_peak_bin,
                             "ci_window": list(e.fp.ci_window),
                             "num_configs": e.fp.num_configs},
             "m_l": e.m_l.to_dict(), "m_r": e.m_r.to_dict(),
             "source_job": e.source_job}
            for e in self._entries.values()]}

    @classmethod
    def from_dict(cls, d: dict) -> "QoSModelRegistry":
        assert d.get("schema") == "qos_registry/1", d.get("schema")
        reg = cls()
        for e in d["entries"]:
            f = e["fingerprint"]
            fp = JobFingerprint(int(f["state_bytes_log2"]),
                                int(f["rate_mean_bin"]),
                                int(f["rate_peak_bin"]),
                                tuple(f["ci_window"]),
                                int(f["num_configs"]))
            reg.put(fp, QoSModel.from_dict(e["m_l"]),
                    QoSModel.from_dict(e["m_r"]), e["source_job"])
        return reg

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "QoSModelRegistry":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclass
class DivergenceWatchdog:
    """Guards a transferred model: sustained relative error between the
    adopted M_L's prediction and the observed latency means the donor's
    surface does not describe this job — time to fall back to a real
    reprofile.  ``observe`` returns True exactly once per divergence
    episode (the supervisor's reprofile trigger)."""
    rel_err_threshold: float = 0.5
    patience: int = 3            # consecutive bad samples before firing
    _streak: int = 0
    _fired: bool = False
    history: list = field(default_factory=list)

    def observe(self, observed: float, predicted: float) -> bool:
        if not (np.isfinite(observed) and np.isfinite(predicted)):
            return False
        rel = abs(observed - predicted) / max(abs(predicted), 1e-9)
        self.history.append(rel)
        if rel > self.rel_err_threshold:
            self._streak += 1
        else:
            self._streak = 0
            self._fired = False
        if self._streak >= self.patience and not self._fired:
            self._fired = True
            return True
        return False

    def reset(self) -> None:
        """Forget the running streak — the supervisor calls this across
        unhealthy windows so a chaos excursion (downtime + backlog
        drain) is not scored as model divergence."""
        self._streak = 0
