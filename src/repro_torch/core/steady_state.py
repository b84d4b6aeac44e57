"""Phase 1 — establishing the steady state (paper §III-B, Eqs. 1–5).

Records the incoming event stream for ``k`` seconds, smooths ``W(t)`` with
an averaging window, and selects ``m`` failure points spanning the observed
throughput range.

The paper's Eq. 4 as printed spaces *timestamps* equidistantly in
[t_min, t_max]; the prose asks for "equidistantly spaced throughput rates".
``mode="throughput"`` implements the prose (default), ``mode="time"`` the
literal equation — see DESIGN.md §7.5.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.stream import WorkloadRecording


@dataclass
class SteadyState:
    recording: WorkloadRecording
    smoothed: np.ndarray
    failure_times: np.ndarray      # F
    failure_rates: np.ndarray      # TR = {W(f) | f in F}


def select_failure_points(recording: WorkloadRecording, m: int,
                          smoothing_window: int = 30,
                          mode: str = "throughput") -> SteadyState:
    if m < 2:
        raise ValueError("need at least 2 failure points")
    w = recording.workload(smoothing_window)
    t = recording.times
    i_min = int(np.argmin(w))      # t_min = argmin W  (Eq. 3)
    i_max = int(np.argmax(w))      # t_max = argmax W

    if mode == "time":
        # Eq. 4 literal: equidistant timestamps between t_min and t_max
        lo, hi = sorted((t[i_min], t[i_max]))
        times = np.linspace(lo, hi, m)
        idx = np.searchsorted(t, times).clip(0, len(t) - 1)
    elif mode == "throughput":
        # prose intent: equidistant throughput levels between W_min and W_max,
        # each mapped to the closest-matching timestamp (distinct per level)
        levels = np.linspace(w[i_min], w[i_max], m)
        idx = []
        taken: set = set()
        for lv in levels:
            order = np.argsort(np.abs(w - lv))
            pick = next((int(j) for j in order if int(j) not in taken), int(order[0]))
            taken.add(pick)
            idx.append(pick)
        idx = np.array(sorted(idx))
    else:
        raise ValueError(mode)

    return SteadyState(
        recording=recording,
        smoothed=w,
        failure_times=t[idx],
        failure_rates=w[idx],
    )
