"""Multi-level checkpointing: which storage level survives which failure.

Level 1  memory  — in-process snapshot; survives task restarts within the
                   same process/host (transient failures), lost on node loss
Level 2  local   — node-local disk (lost with the node unless peers hold
                   replicas: ``replication.PeerReplicatedStore``)
Level 3  remote  — durable remote store (slowest, survives everything)

A copy of the survival rules of the JAX package's
``repro.checkpoint.multilevel``; ``CheckpointManager.restore`` walks the
surviving levels newest-first.
"""
from __future__ import annotations

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
