"""Asynchronous commit: at most one checkpoint write in flight on a
background thread, double-buffered — a new trigger while busy either
blocks ('block') or is dropped ('skip').  The blocking part of an async
save shrinks to the snapshot (see ``pipeline.ChunkedHostSnapshot``).

Crash-consistency: the store only publishes a manifest after all shards
land, so a failure mid-write leaves the previous checkpoint as the newest
valid one.

``BackgroundCommitter`` is the reusable piece (one in-flight commit thunk
+ busy policy + error capture); ``AsyncCheckpointer`` is the older
store-bound wrapper over it, and ``manager.CheckpointManager`` drives the
committer with composed (delta/multilevel) commit thunks.

A torch tensor, unlike a JAX array, can be changed in place after
``save`` returns.  The snapshot holds each tensor it has not copied yet
with its ``_version``, so such a change ends in one of two ways: the leaf
was already copied and the checkpoint holds the values it had at
``save``, or the copy sees the new version, raises
``pipeline.SnapshotMutationError`` in the worker, the error lands in
``errors`` and no manifest is published.  A checkpoint of changed values
is never written.  Numpy leaves are copied in ``save``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.pipeline import ChunkedHostSnapshot
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.utils.trees import tensor_to_numpy, tree_map


def snapshot_to_host(state: Any) -> Any:
    """Monolithic device -> host copy of every leaf (the blocking cost the
    chunked snapshot replaced; the calibration measures it).  Nothing in
    the result aliases ``state``: tensors through ``tensor_to_numpy``,
    every other leaf through ``np.array(copy=True)``."""
    return tree_map(lambda x: tensor_to_numpy(x)
                    if isinstance(x, torch.Tensor)
                    else np.array(x, copy=True), state)


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


class AsyncCheckpointer:
    """Full snapshots of a state into one ``CheckpointStore``, written in
    the background."""

    def __init__(self, store: CheckpointStore, busy_policy: str = "skip"):
        self.store = store
        self._committer = BackgroundCommitter(busy_policy)

    @property
    def busy_policy(self) -> str:
        return self._committer.busy_policy

    def _snapshot(self, state: Any) -> Any:
        # chunked: numpy leaves copy now, tensor chunks stream to the
        # background write through the transfer pool
        return ChunkedHostSnapshot(state)

    def save(self, step: int, state: Any, timestamp: float = 0.0,
             extra: Optional[dict] = None) -> bool:
        """Snapshot now, write in background. Returns False if skipped."""
        if self._committer.busy and self._committer.busy_policy == "skip":
            self._committer.skips += 1
            return False
        snap = self._snapshot(state)
        return self._committer.submit(
            lambda: self.store.save(step, snap, timestamp, extra))

    def wait(self) -> None:
        self._committer.wait()

    @property
    def busy(self) -> bool:
        return self._committer.busy

    @property
    def writes(self) -> int:
        return self._committer.commits

    @property
    def skips(self) -> int:
        return self._committer.skips

    @property
    def errors(self) -> list:
        return self._committer.errors

    def stats(self) -> dict:
        return {"writes": self.writes, "skips": self.skips,
                "errors": len(self.errors)}
