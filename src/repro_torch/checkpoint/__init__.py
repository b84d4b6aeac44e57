from repro_torch.checkpoint.async_ckpt import BackgroundCommitter
from repro_torch.checkpoint.incremental import (apply_delta,
                                                read_delta_manifest,
                                                write_delta)
from repro_torch.checkpoint.manager import (CheckpointManager, RestoreReport,
                                            SaveReport)
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
from repro_torch.checkpoint.store import HAVE_ZSTD, CheckpointStore
from repro_torch.config import CheckpointPlan

__all__ = [
    "BackgroundCommitter", "apply_delta", "read_delta_manifest",
    "write_delta", "CheckpointManager", "RestoreReport",
    "SaveReport", "ChunkedHostSnapshot", "DeltaLeafSource",
    "DeviceDeltaBase", "FlatLayout", "LeafSource", "PlainLeafSource",
    "SnapshotMutationError", "as_leaf_source", "CheckpointPolicy",
    "PeerReplicatedStore", "ReplicaStats", "ReplicationError",
    "retry_with_backoff", "ring_peers", "HAVE_ZSTD", "CheckpointStore",
    "CheckpointPlan",
]
