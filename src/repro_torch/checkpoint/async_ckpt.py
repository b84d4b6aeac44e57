"""Asynchronous commit: at most one checkpoint write in flight on a
background thread, double-buffered — a new trigger while busy either
blocks ('block') or is dropped ('skip').  The blocking part of an async
save shrinks to the snapshot (see ``pipeline.ChunkedHostSnapshot``).

Crash-consistency: the store only publishes a manifest after all shards
land, so a failure mid-write leaves the previous checkpoint as the newest
valid one.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class BackgroundCommitter:
    """At most one commit thunk in flight on a daemon thread."""

    def __init__(self, busy_policy: str = "skip"):
        assert busy_policy in ("skip", "block")
        self.busy_policy = busy_policy
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.commits = 0
        self.skips = 0
        self.errors: list = []

    def submit(self, thunk: Callable[[], None]) -> bool:
        """Run ``thunk`` in the background. Returns False if skipped."""
        if self._thread is not None and self._thread.is_alive():
            if self.busy_policy == "skip":
                self.skips += 1
                return False
            self._thread.join()

        def work():
            try:
                thunk()
                with self._lock:
                    self.commits += 1
            except Exception as e:   # noqa: BLE001
                with self._lock:
                    self.errors.append(repr(e))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
