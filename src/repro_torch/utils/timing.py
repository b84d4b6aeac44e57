"""Wall-clock helpers (real time for the live path; the simulator keeps its own clock)."""
from __future__ import annotations

import time


def now() -> float:
    return time.monotonic()


class Timer:
    """Context-manager timer: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self) -> "Timer":
        self._t0 = time.monotonic()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.monotonic() - self._t0
