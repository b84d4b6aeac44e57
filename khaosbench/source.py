"""The benchmark's load generator: events created on the wall clock and
handed to the job through its own stream and batcher.

``Arrivals`` draws a window's event creation times from the seed.  A
``saturated`` mix has every event waiting at the window's start (the
backlog after an outage, or a replay); a ``poisson`` mix has
``round(rate * seconds)`` events at sorted uniform times over the window
(a Poisson process given its count, so every seed offers the same number
of events, in another order of gaps).  With ``count_every_s`` the count
is fixed in every interval of that length too (``round(rate * t)``
events by each multiple ``t`` of it), each interval's events at uniform
times inside it: every seed offers the same work in every second, and
the seed draws only where in its second each event falls.

``WallClockStream`` is an ``EventStream`` whose producer is the wall
clock: an event exists once its creation time has passed, whatever the
job's own clock says.  ``WaitingBatcher`` wraps the job's batcher: before
each batch it waits on the wall clock until a whole batch has arrived
(so the job's idle branch never runs its clock ahead), and it is where
the harness closes the window and injects failures, at wall-clock
offsets.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.data.stream import EventStream

SATURATED = 10 ** 15        # events "produced" by a saturated source


class WindowClosed(Exception):
    """Raised inside the job's loop when the measured window is over."""


def arrivals(traffic: dict, seed: int, seconds: float) -> Optional[np.ndarray]:
    """Creation times (s from the window's start) of the window's events,
    or None for a saturated source."""
    if traffic["source"] == "saturated":
        return None
    if traffic["source"] != "poisson":
        raise ValueError(f"unknown source {traffic['source']!r}")
    rate = traffic["rate_events_per_s"]
    every = traffic.get("count_every_s", seconds)
    edges = np.append(np.arange(0.0, seconds, every), seconds)
    counts = np.diff(np.round(rate * edges).astype(np.int64))
    rng = np.random.default_rng([seed, 0x5EED])
    if len(counts) == 1:
        return np.sort(rng.uniform(0.0, seconds, int(counts[0])))
    return np.sort(rng.uniform(np.repeat(edges[:-1], counts),
                               np.repeat(edges[1:], counts)))


class WallClockStream(EventStream):
    """Events exist once the wall clock passes their creation time.

    Before ``start`` (the set-up) the source is saturated.  ``start``
    pins the offset of the window's first event to the job's cursor and
    the window's time origin to now."""

    def __init__(self, rate: float = 0.0):
        super().__init__(schedule=lambda t: rate)
        self.produced = SATURATED
        self.times: Optional[np.ndarray] = None
        self.base = 0
        self.t0 = 0.0

    def start(self, times: Optional[np.ndarray], cursor: int) -> None:
        self.times, self.base, self.t0 = times, cursor, time.perf_counter()
        self.produced = SATURATED if times is None else cursor

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def arrived(self, at: float) -> int:
        """Events created by window time ``at`` (all, when saturated)."""
        if self.times is None:
            return SATURATED
        return int(np.searchsorted(self.times, at, side="right"))

    def produce_until(self, t: float) -> None:     # the job's clock: unused
        if self.times is not None:
            self.produced = self.base + self.arrived(self.now())

    def next_arrival(self, count: int) -> float:
        """Window time at which ``count`` events will have arrived."""
        if self.times is None or count <= 0:
            return 0.0
        if count > len(self.times):
            return float("inf")
        return float(self.times[count - 1])


class WaitingBatcher:
    """The job's batcher, with a wait for a whole batch on the wall clock
    in front of it.  ``hooks(now)`` runs at each poll and may raise
    ``WindowClosed`` or ``InjectedFailure``; ``deadline()`` is the next
    window time at which it has something to do."""

    def __init__(self, inner, stream: WallClockStream,
                 hooks: Callable[[float], None],
                 deadline: Callable[[], float],
                 span: Callable = lambda label: contextlib.nullcontext()):
        self.inner = inner
        self.stream = stream
        self.hooks = hooks
        self.deadline = deadline
        self.span = span
        self.taken: list = []        # (first_offset, count) per batch

    def next_batch(self):
        need = self.inner.global_batch
        with self.span("source_wait"):
            while True:
                now = self.stream.now()
                self.hooks(now)
                self.stream.produce_until(0.0)
                if self.stream.lag >= need:
                    break
                due = self.stream.next_arrival(
                    self.stream.consumed - self.stream.base + need)
                wake = min(due, self.deadline())
                if wake > now:
                    time.sleep(min(wake - now, 0.05))
        batch = self.inner.next_batch()
        self.taken.append((batch["first_offset"], need))
        return batch

    def __getattr__(self, name):
        return getattr(self.inner, name)
