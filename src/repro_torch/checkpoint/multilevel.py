"""Multi-level checkpointing: which storage level survives which failure.

Level 1  memory  — in-process snapshot; survives task restarts within the
                   same process/host (transient failures), lost on node loss
Level 2  local   — node-local disk (lost with the node unless peers hold
                   replicas: ``replication.PeerReplicatedStore``)
Level 3  remote  — durable remote store (slowest, survives everything)

Schedule (``MultiLevelCheckpointer``, the older store-bound API):
level-1 on every trigger, level-2 every ``local_every``-th, level-3 every
``remote_every``-th.  Restore walks levels newest-first, constrained by
the failure type's coverage.  The survival rules are a copy of the JAX
package's ``repro.checkpoint.multilevel``; ``CheckpointManager.restore``
walks the surviving levels the same way.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.utils.trees import tree_to_numpy

#: failure kind -> minimum level that survives it at the default
#: replication factor k=1 (``derived_coverage(1)``; ``sim.costmodel.
#: SimCostModel`` asserts the two agree at construction)
LEVEL_COVERAGE = {
    "task": "memory",
    "node": "local",
    "cluster": "remote",
}
_LEVELS = ("memory", "local", "remote")
_KINDS = ("task", "node", "cluster")


def level_survives(level: str, failure_kind: str,
                   replication_factor: int = 1) -> bool:
    """Whether one storage level survives one failure kind — the single
    derivation both the store substrate and the cost model price from.

    * ``memory`` lives in the process: only task restarts keep it.
    * ``local`` always survives a task restart; it survives a NODE loss
      iff k >= 1 peers hold replicas of the dead host's shards (the
      mechanism ``PeerReplicatedStore`` implements); a cluster failure
      takes every node's disk with it regardless of k.
    * ``remote`` is durable against everything modeled.
    """
    if level not in _LEVELS:
        raise ValueError(f"unknown level {level!r}; levels are {_LEVELS}")
    if failure_kind not in _KINDS:
        raise ValueError(
            f"unknown failure kind {failure_kind!r}; known kinds are "
            f"{sorted(_KINDS)}")
    if level == "remote":
        return True
    if level == "memory":
        return failure_kind == "task"
    # local
    if failure_kind == "task":
        return True
    return failure_kind == "node" and replication_factor >= 1


def derived_coverage(replication_factor: int = 1) -> dict[str, str]:
    """failure kind -> minimum surviving level, derived from
    ``level_survives`` at the given replication factor.
    ``derived_coverage(1) == LEVEL_COVERAGE``;
    ``derived_coverage(0)["node"] == "remote"``."""
    return {kind: next(l for l in _LEVELS
                       if level_survives(l, kind, replication_factor))
            for kind in _KINDS}


@dataclass
class MultiLevelCheckpointer:
    local_store: Optional[CheckpointStore] = None
    remote_store: Optional[CheckpointStore] = None
    local_every: int = 2
    remote_every: int = 8
    _memory: dict = field(default_factory=dict)     # step -> state snapshot
    _count: int = 0
    saves_by_level: dict = field(default_factory=lambda: {l: 0 for l in _LEVELS})

    def save(self, step: int, state: Any, timestamp: float = 0.0,
             extra: Optional[dict] = None) -> list[str]:
        levels = ["memory"]
        if self.local_store and self._count % self.local_every == 0:
            levels.append("local")
        if self.remote_store and self._count % self.remote_every == 0:
            levels.append("remote")
        # tensors are copied off their device; a numpy leaf is kept as the
        # reference's ``np.asarray`` keeps it: aliased, so a caller that
        # changes it in place changes the memory level too
        snap = tree_to_numpy(state)
        self._memory = {step: snap}                 # keep newest only
        self.saves_by_level["memory"] += 1
        if "local" in levels:
            self.local_store.save(step, snap, timestamp, extra)
            self.saves_by_level["local"] += 1
        if "remote" in levels:
            self.remote_store.save(step, snap, timestamp, extra)
            self.saves_by_level["remote"] += 1
        self._count += 1
        return levels

    def restore(self, treedef_like: Any, failure_kind: str = "task"
                ) -> tuple[Any, int, str]:
        """Restore the newest checkpoint that survives ``failure_kind``.
        Returns (state, step, level)."""
        min_level = LEVEL_COVERAGE[failure_kind]
        allowed = _LEVELS[_LEVELS.index(min_level):]
        candidates: list[tuple[int, str]] = []
        if "memory" in allowed and self._memory:
            candidates.append((max(self._memory), "memory"))
        if "local" in allowed and self.local_store:
            s = self.local_store.newest()
            if s is not None:
                candidates.append((s, "local"))
        if "remote" in allowed and self.remote_store:
            s = self.remote_store.newest()
            if s is not None:
                candidates.append((s, "remote"))
        if not candidates:
            raise FileNotFoundError(f"no checkpoint survives {failure_kind}")
        # newest step wins; on ties prefer the fastest level to restore from
        speed = {"memory": 2, "local": 1, "remote": 0}
        step, level = max(candidates, key=lambda c: (c[0], speed[c[1]]))
        if level == "memory":
            return copy.deepcopy(self._memory[step]), step, level
        store = self.local_store if level == "local" else self.remote_store
        state, _ = store.restore(treedef_like, step)
        return state, step, level

    def on_node_failure(self) -> None:
        """Node loss wipes the in-memory level (local disk loss is the
        caller's cost model's to price)."""
        self._memory.clear()

    def stats(self) -> dict:
        return {"saves": self._count,
                "saves_by_level": dict(self.saves_by_level)}


def allowed_levels(failure_kind: str, replication_factor: int = 1
                   ) -> tuple[str, ...]:
    """Levels that survive ``failure_kind``, fastest-to-restore first,
    derived from ``level_survives`` at ``replication_factor``.  Unknown
    kinds are an error, not a silent worst-case default — a typo'd kind
    would otherwise quietly restore from the wrong level."""
    if failure_kind not in _KINDS:
        raise ValueError(
            f"unknown failure kind {failure_kind!r}; known kinds are "
            f"{sorted(_KINDS)}")
    return tuple(l for l in _LEVELS
                 if level_survives(l, failure_kind, replication_factor))
