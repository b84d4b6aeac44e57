"""Elastic rescaling: derive a runnable mesh from the surviving hosts and
restore the latest checkpoint onto it.

The checkpoint store's manifest-driven restore is shard-count agnostic
(checkpoint/store.py), so a rescale is: plan new mesh -> restore -> resume
from the checkpointed stream cursor.  The planner keeps the TP degree
(model-parallel sharding must divide weight dims) and shrinks the data
axis to the largest value that fits — spare hosts become hot standbys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.config import MeshConfig


@dataclass
class RescalePlan:
    old: MeshConfig
    new: MeshConfig
    hosts_alive: int
    hosts_used: int
    standby: int
    batch_ok: bool         # global batch still divisible by the new dp

    @property
    def changed(self) -> bool:
        return self.new.shape != self.old.shape


def plan_rescale(mesh: MeshConfig, hosts_alive: int, chips_per_host: int = 4,
                 global_batch: Optional[int] = None) -> RescalePlan:
    """Largest (data' x model) mesh that fits the surviving chips.

    TP ('model') is pinned: resharding TP requires repartitioning every
    weight, while shrinking 'data' only re-spreads the batch and FSDP
    shards — exactly what manifest-driven restore gives us for free.
    """
    chips = hosts_alive * chips_per_host
    model = mesh.model
    pods = mesh.pods if mesh.multi_pod else 1
    if chips < model:
        raise ValueError(f"cannot keep TP={model} with only {chips} chips")
    # keep multi-pod only if both pods can stay symmetric
    new_multi = mesh.multi_pod and chips >= 2 * model
    per_pod_chips = chips // (2 if new_multi else 1)
    new_data = max(1, per_pod_chips // model)
    # data axis must divide the global batch for clean batch sharding
    if global_batch:
        dp_total = new_data * (2 if new_multi else 1)
        while new_data > 1 and global_batch % dp_total != 0:
            new_data -= 1
            dp_total = new_data * (2 if new_multi else 1)
    new = MeshConfig(multi_pod=new_multi, data=new_data, model=model,
                     pods=2 if new_multi else mesh.pods)
    used_chips = new.num_devices
    batch_ok = (global_batch is None) or (
        global_batch % (new_data * (2 if new_multi else 1)) == 0)
    return RescalePlan(
        old=mesh, new=new, hosts_alive=hosts_alive,
        hosts_used=-(-used_chips // chips_per_host),
        standby=hosts_alive - (-(-used_chips // chips_per_host)),
        batch_ok=batch_ok)


@dataclass
class RecoveryPlan:
    """How a node failure lands: replace the dead hosts from hot standbys
    (mesh unchanged) when any remain, otherwise rescale DOWN onto the
    survivors.  ``rescale`` is None on the standby path."""
    mesh: MeshConfig
    hosts_lost: int
    standbys_used: int
    standbys_left: int
    rescale: Optional[RescalePlan] = None

    @property
    def rescaled(self) -> bool:
        return self.rescale is not None and self.rescale.changed


def plan_recovery(mesh: MeshConfig, hosts_lost: int, standbys: int,
                  chips_per_host: int = 4,
                  global_batch: Optional[int] = None) -> RecoveryPlan:
    """Compose failure recovery with elasticity: the degraded partial
    restore (checkpoint/replication.py) rebuilds the dead hosts' shards,
    and THIS decides which mesh receives them.  While hot standbys cover
    the losses the mesh shape is untouched (restore is a same-shape shard
    rebuild); once standbys are exhausted, recovery lands on the smaller
    mesh ``plan_rescale`` derives from the true survivor count — the
    manifest-driven restore reshards onto it for free."""
    if hosts_lost < 0:
        raise ValueError(f"hosts_lost must be >= 0, got {hosts_lost}")
    if hosts_lost <= standbys:
        return RecoveryPlan(mesh=mesh, hosts_lost=hosts_lost,
                            standbys_used=hosts_lost,
                            standbys_left=standbys - hosts_lost)
    in_mesh = -(-mesh.num_devices // chips_per_host)
    alive = in_mesh + standbys - hosts_lost
    rs = plan_rescale(mesh, alive, chips_per_host, global_batch)
    return RecoveryPlan(mesh=rs.new, hosts_lost=hosts_lost,
                        standbys_used=standbys, standbys_left=0,
                        rescale=rs)
