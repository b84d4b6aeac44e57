from repro_torch.checkpoint.async_ckpt import (AsyncCheckpointer,
                                              BackgroundCommitter,
                                              snapshot_to_host)
from repro_torch.checkpoint.incremental import (IncrementalCheckpointer,
                                                apply_delta,
                                                read_delta_manifest,
                                                write_delta)
from repro_torch.checkpoint.manager import (CheckpointManager, Checkpointer,
                                            RestoreReport, SaveReport)
from repro_torch.checkpoint.multilevel import MultiLevelCheckpointer
from repro_torch.checkpoint.pipeline import (ChunkedHostSnapshot,
                                             DeltaLeafSource,
                                             DeviceDeltaBase, FlatLayout,
                                             LeafSource, PlainLeafSource,
                                             SnapshotMutationError,
                                             as_leaf_source)
from repro_torch.checkpoint.policy import CheckpointPolicy
from repro_torch.checkpoint.replication import (PeerReplicatedStore,
                                                ReplicaStats,
                                                ReplicationError,
                                                retry_with_backoff,
                                                ring_peers)
from repro_torch.checkpoint.store import (HAVE_ZSTD, CheckpointMeta,
                                          CheckpointStore)
from repro_torch.config import CheckpointPlan

__all__ = [
    "CheckpointStore", "CheckpointMeta", "AsyncCheckpointer",
    "BackgroundCommitter", "IncrementalCheckpointer",
    "MultiLevelCheckpointer", "CheckpointPolicy", "CheckpointManager",
    "Checkpointer", "CheckpointPlan", "SaveReport", "RestoreReport",
    "HAVE_ZSTD", "ChunkedHostSnapshot", "DeltaLeafSource", "DeviceDeltaBase",
    "FlatLayout", "LeafSource", "PlainLeafSource", "as_leaf_source",
    "PeerReplicatedStore", "ReplicaStats", "ReplicationError",
    "retry_with_backoff", "ring_peers",
    # the port's additions
    "snapshot_to_host", "apply_delta", "read_delta_manifest", "write_delta",
    "SnapshotMutationError",
]
