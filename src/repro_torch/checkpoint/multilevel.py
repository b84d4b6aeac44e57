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
