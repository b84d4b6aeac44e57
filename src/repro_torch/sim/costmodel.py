"""Cost model for the discrete-event simulator (a copy of the JAX
package's ``repro.sim.costmodel``: the same fields, defaults and prices).

Two calibration sources:
  * the paper's cluster scale (E1/E2 analogues) — defaults below;
  * a real architecture: ``costmodel_from_arch`` derives checkpoint bytes
    from the TrainState size and step capacity from the dry-run roofline
    record (bound_step_s), so the same simulator answers "what CI should a
    grok-1 training job on 2 pods use?".

The model prices the whole checkpoint *plane*, not just one write: per-kind
durations (full snapshot vs compressed delta), per-level write/restore
factors (in-RAM snapshot vs node-local disk vs durable remote store), the
async commit tax, AND the host CPU an incremental trigger burns encoding +
compressing the delta (``delta_encode_s_per_byte * state_bytes`` — on
small states the encode can exceed the write win, so an uncalibrated model
over-recommends delta plans).  Instead of hand-setting those knobs, load
them from the artifact ``benchmarks/torch_bench_ckpt.py`` measures (the
same ``bench_ckpt/3`` schema ``benchmarks/bench_ckpt.py`` writes):

    cost = SimCostModel.from_calibration("BENCH_ckpt_torch.json",
                                         capacity_eps=3000.0)

``write_duration``/``restore_duration``/``plan_*`` are the single source
the simulator, the plan optimizer and the controller all price a
``CheckpointPlan`` with; ``ckpt_duration_s`` remains the full-sync-local
reference point so existing calibrations keep their meaning.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from typing import Any, Optional, Union

from functools import lru_cache

import numpy as np

from repro_torch.config import CheckpointPlan

#: required keys of the bench_ckpt calibration artifact (written by
#: benchmarks/torch_bench_ckpt.py, or the JAX package's bench_ckpt.py)
CALIBRATION_KEYS = ("schema", "state_bytes", "full_write_s", "restore_s",
                    "delta_fraction", "delta_int8_fraction",
                    "delta_encode_s_per_byte")

#: accepted artifact schemas; "bench_ckpt/2" adds the ``device`` section
#: (per-codec on-device encode measurements); "bench_ckpt/3" re-measures it
#: for the FLAT fused encode and adds ``pack_s`` (the per-trigger pack
#: dispatch) and ``per_leaf_encode_s`` (the pre-flat per-leaf dispatch
#: baseline the CI gate regresses against).  Older artifacts stay loadable:
#: /1 keeps the device fields at their modeled defaults, /2 keeps pack_s
#: at 0 (the per-leaf path had no pack step)
CALIBRATION_SCHEMAS = ("bench_ckpt/1", "bench_ckpt/2", "bench_ckpt/3")

#: per-codec keys of each ``device`` entry in a bench_ckpt/2 artifact
DEVICE_CALIBRATION_KEYS = ("bytes_on_link", "link_fraction", "encode_s")

#: additional per-codec keys a bench_ckpt/3 ``device`` entry must carry
DEVICE_CALIBRATION_KEYS_V3 = DEVICE_CALIBRATION_KEYS + (
    "pack_s", "per_leaf_encode_s")


def levels_due(plan: CheckpointPlan, trigger_index: int
               ) -> list[tuple[str, str]]:
    """Which (level, kind) writes trigger number ``trigger_index`` performs
    — the routing itself lives on the plan (``CheckpointPlan.levels_due``)
    so the manager executes and this model prices the SAME schedule.  The
    model idealizes away runtime self-healing (a delta upgraded to a full
    after an async skip or a post-failure base reset)."""
    return plan.levels_due(trigger_index)


@dataclass(frozen=True)
class SimCostModel:
    capacity_eps: float = 3000.0      # events/s the job sustains at steady state
    base_latency_s: float = 0.45      # floor end-to-end latency
    ckpt_duration_s: float = 2.5      # full sync local write duration (bytes / bw)
    ckpt_sync_penalty: float = 1.0    # fraction of capacity lost while writing (sync)
    async_mode: bool = False
    async_overhead: float = 0.12      # capacity fraction lost while async write in flight
    detect_s: float = 50.0            # failure detection timeout (Flink default)
    restart_s: float = 30.0           # scheduler/restart/init time
    restore_s: float = 10.0           # full local state restore time
    reconfig_restart_s: float = 30.0  # controlled restart (savepoint -> restart)
    # -- checkpoint-plane structure (full vs delta, per-level costs) --------
    delta_fraction: float = 0.15      # lossless delta bytes / full bytes
    delta_int8_fraction: float = 0.05 # int8 group-quantized delta fraction
    memory_write_factor: float = 0.02 # RAM snapshot vs local disk write
    remote_write_factor: float = 4.0  # durable remote store vs local disk
    memory_restore_factor: float = 0.05
    remote_restore_factor: float = 4.0
    delta_apply_factor: float = 0.25  # delta decode+apply, fraction of restore_s
    # -- measured host-CPU cost of the delta encode (calibrated) ------------
    delta_encode_s_per_byte: float = 0.0   # encode+compress CPU s per STATE byte
    state_bytes: float = 0.0               # full state size the above scales by
    # -- device-placement delta encode (plan.encode_placement == "device"):
    #    the ckpt_delta kernels run in front of D2H, so the host-CPU encode
    #    term above is replaced by the measured on-device encode+payload-
    #    transfer seconds, and bytes on the link shrink to the payload.
    #    Defaults model the payload sizes analytically (lossless: f32 delta
    #    + skipped all-zero residual ~= 1.0x; int8: q + 1/256 scales
    #    ~= 0.26x); bench_ckpt/2 artifacts replace all four with measured
    #    values
    device_link_fraction: float = 1.0       # lossless payload / state bytes
    device_link_fraction_int8: float = 0.26 # int8 payload / state bytes
    device_encode_s: float = 0.0            # per-trigger device encode (lossless)
    device_encode_s_int8: float = 0.0       # per-trigger device encode (int8)
    # the flat path's per-trigger pack dispatch (the new state's f32
    # subtree -> one mega-buffer) — measured separately from encode_s so
    # the bench can regress the fused encode against the per-leaf baseline
    # without the pack term muddying the comparison
    device_pack_s: float = 0.0              # per-trigger pack (lossless)
    device_pack_s_int8: float = 0.0         # per-trigger pack (int8)
    # -- peer-replication plane (checkpoint/replication.py) ------------------
    #    level-2 survival of a node loss is DERIVED from the plan's
    #    replication factor (k ring-peer replicas per shard), and its price
    #    has two sides: each level-2 write additionally pushes k copies of
    #    its payload over the node interconnect (replica_push_factor x the
    #    local write duration per copy — 0 models the push as fully
    #    overlapped with the primary write, the transfer-pool behavior
    #    measured on this substrate), and a node-failure restore at the
    #    local level is a DEGRADED PARTIAL restore (only the dead host's
    #    shards pulled from peers) scaled by replica_restore_factor
    #    (1.0 = neutral: same duration as a healthy local restore)
    replica_push_factor: float = 0.0
    replica_restore_factor: float = 1.0

    # 7) degradation pricing (gray failures, ft.failures.DEGRADATION_KINDS):
    #    a straggler's inflated step time hits capacity through the
    #    synchronous barrier — straggler_barrier_fraction is how much of
    #    the pipeline the slowest host gates (1.0 = fully barriered, the
    #    data-parallel default; 0.0 = fully decoupled, stragglers free);
    #    net_delay_*_factor scale how much of a directional network delay
    #    lands on the checkpoint barrier (to_ckpt_store) vs the reported
    #    end-to-end latency (to_source)
    straggler_barrier_fraction: float = 1.0
    net_delay_store_factor: float = 1.0
    net_delay_source_factor: float = 1.0

    def __post_init__(self) -> None:
        # the priced restore paths hang off the survival derivation in
        # checkpoint.multilevel; assert the mechanism-backed rule (k>=1
        # ring replicas -> node failures survive at level-2, k=0 -> they
        # degrade to remote) still matches the documented LEVEL_COVERAGE
        # table so the store substrate and the priced model cannot
        # silently diverge
        from repro_torch.checkpoint.multilevel import (LEVEL_COVERAGE,
                                                       derived_coverage)
        assert derived_coverage(1) == LEVEL_COVERAGE == \
            {"task": "memory", "node": "local", "cluster": "remote"}, (
            f"survival derivation drifted: derived_coverage(1)="
            f"{derived_coverage(1)!r} vs LEVEL_COVERAGE={LEVEL_COVERAGE!r} "
            "— the replicated-store mechanism and this cost model price "
            "the same rule; recalibrate before relaxing it")
        assert derived_coverage(0)["node"] == "remote", (
            "with replication disabled a node failure must degrade to the "
            f"remote level, got {derived_coverage(0)!r}")

    # -- calibration ---------------------------------------------------------
    @classmethod
    def from_calibration(cls, source: Union[str, "os.PathLike[str]", dict],
                         **overrides: Any) -> "SimCostModel":
        """Build a cost model from a ``bench_ckpt`` calibration artifact
        (``benchmarks/torch_bench_ckpt.py``; path or already-loaded dict),
        replacing the hand-set ``delta_fraction``/level knobs with the
        measured ones.  ``overrides`` pass through any field the artifact
        does not cover (``capacity_eps``, ``detect_s``, ...)."""
        if isinstance(source, dict):
            cal = source
        else:
            with open(source) as f:
                cal = json.load(f)
        missing = [k for k in CALIBRATION_KEYS if k not in cal]
        if missing:
            raise ValueError(f"calibration artifact missing keys {missing}")
        if cal["schema"] not in CALIBRATION_SCHEMAS:
            raise ValueError(f"unknown calibration schema {cal['schema']!r}")
        kw: dict[str, Any] = {
            "ckpt_duration_s": float(cal["full_write_s"]),
            "restore_s": float(cal["restore_s"]),
            "delta_fraction": float(cal["delta_fraction"]),
            "delta_int8_fraction": float(cal["delta_int8_fraction"]),
            "delta_encode_s_per_byte": float(cal["delta_encode_s_per_byte"]),
            "state_bytes": float(cal["state_bytes"]),
        }
        if cal["schema"] in ("bench_ckpt/2", "bench_ckpt/3"):
            dev = cal.get("device")
            if not isinstance(dev, dict):
                raise ValueError(f"{cal['schema']} artifact missing the "
                                 "'device' measurement section")
            required = (DEVICE_CALIBRATION_KEYS_V3
                        if cal["schema"] == "bench_ckpt/3"
                        else DEVICE_CALIBRATION_KEYS)
            for codec in ("lossless", "int8"):
                entry = dev.get(codec)
                bad = [k for k in required
                       if not isinstance((entry or {}).get(k), (int, float))]
                if entry is None or bad:
                    raise ValueError(
                        f"device section entry {codec!r} missing or "
                        f"non-numeric keys {bad or list(required)}")
            kw["device_link_fraction"] = float(dev["lossless"]["link_fraction"])
            kw["device_link_fraction_int8"] = float(dev["int8"]["link_fraction"])
            kw["device_encode_s"] = float(dev["lossless"]["encode_s"])
            kw["device_encode_s_int8"] = float(dev["int8"]["encode_s"])
            if cal["schema"] == "bench_ckpt/3":
                kw["device_pack_s"] = float(dev["lossless"]["pack_s"])
                kw["device_pack_s_int8"] = float(dev["int8"]["pack_s"])
        # bench_ckpt/1: device fields keep their modeled defaults (the
        # versioned fallback — old artifacts stay loadable); bench_ckpt/2:
        # pack_s stays 0 (the per-leaf path packed nothing)
        known = {f.name for f in fields(cls)}
        unknown = set(overrides) - known
        if unknown:
            raise TypeError(f"unknown SimCostModel fields {sorted(unknown)}")
        kw.update(overrides)
        return cls(**kw)

    # -- legacy single-knob interface ---------------------------------------
    def effective_capacity(self, checkpointing: bool,
                           sync: Optional[bool] = None) -> float:
        if not checkpointing:
            return self.capacity_eps
        if sync is None:
            sync = not self.async_mode
        if not sync:
            return self.capacity_eps * (1.0 - self.async_overhead)
        return self.capacity_eps * (1.0 - self.ckpt_sync_penalty)

    def downtime_s(self) -> float:
        return self.detect_s + self.restart_s + self.restore_s

    # -- degradation pricing (gray failures) --------------------------------
    # Elementwise on arrays AND exact on scalars: the scalar simulator and
    # the batched lanes call the same methods, so the priced effect is
    # bit-identical in both engines (the parity invariant).
    def straggler_capacity_scale(self, slow_factor):
        """Capacity multiplier while one host runs ``slow_factor`` x slower:
        under a barrier fraction f the effective step time inflates to
        ``1 + f*(slow_factor - 1)`` of nominal."""
        return 1.0 / (1.0 + self.straggler_barrier_fraction
                      * (np.maximum(slow_factor, 1.0) - 1.0))

    def net_delay_barrier_penalty(self, delay_s, jitter_s, phase):
        """Extra seconds a to-checkpoint-store network delay adds to one
        trigger's composite write (``phase`` = ±1 from ``jitter_phase``)."""
        return self.net_delay_store_factor * delay_s + jitter_s * phase

    def net_delay_latency_penalty(self, delay_s, jitter_s, phase):
        """Extra end-to-end latency seconds a to-source network delay adds
        at one tick (``phase`` = ±1 from ``jitter_phase``)."""
        return self.net_delay_source_factor * delay_s + jitter_s * phase

    # -- per-kind / per-level pricing ---------------------------------------
    def write_duration(self, kind: str = "full", level: str = "local",
                       encoding: str = "lossless",
                       placement: str = "host", replicas: int = 0) -> float:
        """Seconds one write of ``kind`` takes at ``level``.  A host-encoded
        delta write additionally pays the host encode+compress CPU (which
        reads the whole state regardless of how small the delta
        compresses) — priced so ``optimize_plan`` stops recommending delta
        plans whose encode exceeds the write win.  A device-encoded delta
        (``plan.encode_placement == "device"``) replaces that term with the
        measured per-trigger pack + fused on-device encode+payload-transfer
        seconds — the placement dimension the optimizer searches over.
        ``replicas`` peers each receiving a copy of a LOCAL write's payload
        add ``replica_push_factor`` x the payload-move duration per copy
        (0.0 models pushes fully overlapped with the primary write)."""
        d = self.ckpt_duration_s * {"memory": self.memory_write_factor,
                                    "local": 1.0,
                                    "remote": self.remote_write_factor}[level]
        if kind == "delta":
            d *= (self.delta_int8_fraction if encoding == "int8"
                  else self.delta_fraction)
        if level == "local" and replicas > 0:
            d += d * replicas * self.replica_push_factor
        if kind == "delta":
            if placement == "device":
                d += (self.device_pack_s_int8 + self.device_encode_s_int8
                      if encoding == "int8"
                      else self.device_pack_s + self.device_encode_s)
            else:
                d += self.delta_encode_s_per_byte * self.state_bytes
        return d

    def restore_duration(self, level: str = "local",
                         with_delta: bool = False,
                         degraded: bool = False) -> float:
        """``degraded=True`` prices the replicated store's partial restore
        (surviving shards read locally, only the dead host's shards pulled
        from peer replicas) — the level term scales by
        ``replica_restore_factor``; 1.0 keeps it at the healthy price."""
        d = self.restore_s * {"memory": self.memory_restore_factor,
                              "local": 1.0,
                              "remote": self.remote_restore_factor}[level]
        if degraded:
            d *= self.replica_restore_factor
        if with_delta:
            d += self.restore_s * self.delta_apply_factor
        return d

    def restore_duration_for(self, plan: CheckpointPlan, failure_kind: str,
                             level: str) -> float:
        """The restore price of recovering ``plan`` from ``level`` after
        ``failure_kind`` — folds in the delta-apply term (incremental
        plans) and the degraded-partial path (a node failure restoring
        from replicated level-2 pulls only the dead host's shards)."""
        with_delta = plan.mode == "incremental" and level != "memory"
        degraded = (failure_kind == "node" and level == "local"
                    and plan.effective_replication >= 1)
        return self.restore_duration(level, with_delta, degraded=degraded)

    def wiped_levels(self, plan: CheckpointPlan,
                     failure_kind: str) -> tuple[str, ...]:
        """Levels ``failure_kind`` destroys under this plan — derived from
        the same ``level_survives`` rule the store substrate implements
        (node loss wipes local disk only when no peer holds replicas)."""
        from repro_torch.checkpoint.multilevel import _LEVELS, level_survives
        return tuple(l for l in _LEVELS
                     if not level_survives(l, failure_kind,
                                           plan.effective_replication))

    # -- plan pricing --------------------------------------------------------
    def trigger_write_duration(self, plan: CheckpointPlan,
                               trigger_index: int) -> float:
        """Total write seconds for trigger number ``trigger_index``."""
        return sum(self.write_duration(kind, level, plan.delta_codec,
                                       plan.encode_placement,
                                       replicas=plan.effective_replication)
                   for level, kind in levels_due(plan, trigger_index))

    @lru_cache(maxsize=4096)
    def avg_write_duration(self, plan: CheckpointPlan) -> float:
        """Steady-state average write seconds per checkpoint trigger.
        Memoized: both ``self`` and ``plan`` are frozen (value-hashable)
        and the cadence walk is pure, so the Eq.-8 searches that re-price
        the same variants every optimization period hit the cache."""
        period = self._cadence_period(plan)
        return sum(self.trigger_write_duration(plan, i)
                   for i in range(period)) / period

    @staticmethod
    def _cadence_period(plan: CheckpointPlan) -> int:
        import math
        return max(1, math.lcm(max(plan.full_every, 1),
                               max(plan.local_every, 1),
                               max(plan.remote_every, 1)))

    # -- link-traffic accounting (bytes_on_link, priced per trigger) ---------
    def trigger_link_bytes(self, plan: CheckpointPlan,
                           trigger_index: int) -> float:
        """Pre-compression bytes trigger ``trigger_index`` moves across the
        device->host link — the modeled twin of ``SaveReport.bytes_on_link``.
        Host placement ships the raw state every trigger (the snapshot IS
        the transfer); device placement ships only the encoded payload
        (``device_link_fraction*``), plus the raw state again whenever a
        disk level takes a FULL this trigger (remote cadence / self-heal
        fulls pull raw leaves even from a delta source)."""
        due = plan.levels_due(trigger_index)
        if plan.encode_placement != "device" \
                or plan.is_full_trigger(trigger_index):
            return self.state_bytes
        frac = (self.device_link_fraction_int8
                if plan.delta_codec == "int8" else self.device_link_fraction)
        link = self.state_bytes * frac
        if any(kind == "full" for level, kind in due if level != "memory"):
            link += self.state_bytes
        return link

    def avg_link_bytes(self, plan: CheckpointPlan) -> float:
        """Steady-state average ``bytes_on_link`` per trigger — what the
        Jayasekara-style transfer term costs in bytes under each
        (placement, codec); calibrated by the bench_ckpt/2 ``device``
        section and compared against the measured per-plan
        ``bytes_on_link_per_trigger`` of the bench's plans table."""
        period = self._cadence_period(plan)
        return sum(self.trigger_link_bytes(plan, i)
                   for i in range(period)) / period

    # -- replica-traffic accounting (bytes over the node interconnect) -------
    def trigger_replica_bytes(self, plan: CheckpointPlan,
                              trigger_index: int) -> float:
        """Replica bytes trigger ``trigger_index`` pushes over the peer
        interconnect: k copies of each level-2 payload (full state, or the
        delta fraction for delta triggers) — the modeled twin of the
        replicated store's ``ReplicaStats.replica_bytes``.  Zero when the
        plan has no local level or replication is disabled."""
        k = plan.effective_replication
        if k == 0:
            return 0.0
        out = 0.0
        for level, kind in plan.levels_due(trigger_index):
            if level != "local":
                continue
            frac = 1.0 if kind == "full" else (
                self.delta_int8_fraction if plan.delta_codec == "int8"
                else self.delta_fraction)
            out += k * frac * self.state_bytes
        return out

    def avg_replica_bytes(self, plan: CheckpointPlan) -> float:
        """Steady-state average replica bytes per trigger — what the
        controller trades against recovery time when it searches the
        ``replication_factor`` plan dimension."""
        period = self._cadence_period(plan)
        return sum(self.trigger_replica_bytes(plan, i)
                   for i in range(period)) / period

    def plan_overhead_fraction(self, plan: CheckpointPlan,
                               ci_s: Optional[float] = None) -> float:
        """Steady-state fraction of capacity spent on checkpointing: the
        write duty cycle scaled by the sync pause (or the async tax over
        the write window)."""
        ci = ci_s if ci_s is not None else plan.interval_s
        duty = self.avg_write_duration(plan) / max(ci, 1e-9)
        tax = self.ckpt_sync_penalty if plan.sync else self.async_overhead
        return min(1.0, duty * tax)

    def plan_overhead_fractions(self, plan: CheckpointPlan,
                                ci_values) -> np.ndarray:
        """``plan_overhead_fraction`` vectorized over a CI grid.  The
        average write duration is CI-independent, so it is priced ONCE and
        divided across the grid — the plan optimizer sweeps grid x
        variants every re-plan, and walking the cadence period per grid
        point is what used to dominate the controller tick."""
        ci = np.maximum(np.asarray(ci_values, np.float64), 1e-9)
        tax = self.ckpt_sync_penalty if plan.sync else self.async_overhead
        return np.minimum(1.0, self.avg_write_duration(plan) / ci * tax)

    @lru_cache(maxsize=4096)
    def surviving_levels(self, plan: CheckpointPlan,
                         failure_kind: str) -> tuple[str, ...]:
        """Plan levels surviving ``failure_kind`` (fastest first), DERIVED
        from the plan's replication factor: with k>=1 ring replicas the
        level-2 store survives a node loss (the PeerReplicatedStore
        mechanism), with k=0 a node failure degrades to remote.  Raises
        ``ValueError`` on an unknown failure kind — silently defaulting
        would price a typo'd kind as an arbitrary recovery path."""
        from repro_torch.checkpoint.multilevel import allowed_levels
        return tuple(
            l for l in allowed_levels(failure_kind,
                                      plan.effective_replication)
            if l in plan.levels)

    def restore_level(self, plan: CheckpointPlan,
                      failure_kind: str) -> Optional[str]:
        """The fastest level that survives ``failure_kind`` under the plan
        (restore walks newest-first, and faster levels are written at least
        as often as slower ones)."""
        surviving = self.surviving_levels(plan, failure_kind)
        return surviving[0] if surviving else None

    @lru_cache(maxsize=4096)
    def plan_downtime_s(self, plan: CheckpointPlan, failure_kind: str = "node"
                        ) -> float:
        level = self.restore_level(plan, failure_kind)
        if level is None:
            # nothing survives: model a cold restart at the worst price
            return self.detect_s + self.restart_s + self.restore_duration("remote")
        return (self.detect_s + self.restart_s
                + self.restore_duration_for(plan, failure_kind, level))

    @lru_cache(maxsize=4096)
    def plan_lost_work_multiplier(self, plan: CheckpointPlan,
                                  failure_kind: str = "node") -> float:
        """Lost work after a failure, as a multiple of the base CI: the
        cadence of the fastest *surviving* level (a cluster failure falls
        back to the remote level's every-Nth-trigger fulls)."""
        level = self.restore_level(plan, failure_kind)
        if level is None:
            return float("inf")
        return {"memory": 1.0, "local": float(plan.local_every),
                "remote": float(plan.remote_every)}[level]


def costmodel_from_arch(param_count: int, bound_step_s: float,
                        tokens_per_step: float, seq_len: int,
                        n_hosts: int = 64, disk_bw_per_host: float = 1.0e9,
                        opt_state_bytes_per_param: float = 12.0,
                        async_mode: bool = False) -> SimCostModel:
    """Calibrate the simulator for a real training job.

    * one "event" = one sequence (seq_len tokens), matching the data
      pipeline's event == document semantics;
    * capacity = sequences/s from the roofline-bound step time;
    * checkpoint duration = full TrainState over the per-host disk bw.
    """
    seqs_per_step = tokens_per_step / seq_len
    capacity = seqs_per_step / max(bound_step_s, 1e-6)
    state_bytes = param_count * opt_state_bytes_per_param
    ckpt_duration = state_bytes / (n_hosts * disk_bw_per_host)
    return SimCostModel(
        capacity_eps=capacity,
        base_latency_s=bound_step_s,
        ckpt_duration_s=max(ckpt_duration, 0.05),
        async_mode=async_mode,
        restore_s=max(ckpt_duration, 0.05),
    )
