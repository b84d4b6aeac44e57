"""Unified checkpoint plane: one manager executing a ``CheckpointPlan``.

The port of ``repro.checkpoint.manager``.  ``CheckpointManager`` composes
the store, delta, multi-level and async layers behind a single protocol,
configured by ``config.CheckpointPlan``:

        trigger            CheckpointPolicy.due(t)   (the Khaos CI knob)
           |
        snapshot           chunked D2H transfer (pipeline.ChunkedHost-
           |               Snapshot): mutable host leaves copy eagerly,
           |               device chunks stream on the transfer pool —
           |               only the first chunk's device sync blocks
           |
        encode             full snapshot, or delta vs the last full
           |                 (lossless sub+XOR-residual or int8, both with
           |                  a kernels/ckpt_delta CUDA codec and its
           |                  plain version), leaf-parallel on the
           |                  io pool, overlapped with the D2H stream;
           |                  unchanged leaves short-circuit to a "zero"
           |                  manifest marker.
           |               plan.encode_placement == "device" swaps the
           |                 order of the two stages above: ONE fused
           |                 CUDA kernel encodes the packed f32 subtree
           |                 against the device-resident flat base
           |                 (pipeline.DeltaLeafSource) and only the
           |                 encoded payload crosses the link — bytes_on_-
           |                 link drops to ~0.26x state bytes for int8
           |
        compress           zstd when installed, zlib otherwise; the codec
           |                 used is recorded in the delta manifest
           |
        level routing      memory  — in-RAM snapshot, every trigger
           |               local   — node-local store, every local_every-th
           |               remote  — durable store, every remote_every-th
           |                 (remote only ever receives FULL snapshots;
           |                  deltas stay with their base full's level)
           |
        commit             sync (blocks the step stream) or async via a
                           BackgroundCommitter (double-buffered, at most
                           one write in flight, skip/block busy policy);
                           shards write concurrently on the io pool either
                           way

    restore(treedef, failure_kind) walks the levels that survive the
    failure kind (multilevel.allowed_levels) newest-step-first, applies
    the newest matching delta on top of its base full, and reports which
    (level, kind) served the recovery — the controller prices exactly this
    path when it optimizes over plans.

Every save/restore returns a report carrying bytes + durations, the
quantities the trainer's metrics and ``chip_smoke.py`` account.
"""
from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.checkpoint.async_ckpt import BackgroundCommitter
from repro_torch.checkpoint.incremental import (apply_delta,
                                                newest_delta_step,
                                                read_delta_manifest,
                                                write_delta)
from repro_torch.checkpoint.multilevel import allowed_levels
from repro_torch.checkpoint.pipeline import (ChunkedHostSnapshot,
                                             DeltaLeafSource,
                                             DeviceDeltaBase, HostLanding,
                                             PlainLeafSource)
from repro_torch.checkpoint.policy import CheckpointPolicy
from repro_torch.checkpoint.replication import PeerReplicatedStore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.config import CheckpointPlan
from repro_torch.utils.trees import resolve_device, tree_map


@dataclass
class SaveReport:
    """What one save() actually did (all byte/duration accounting flows
    from here into metrics, the simulator calibration and benchmarks)."""
    step: int
    kind: str                       # full | delta | skipped
    levels: tuple = ()              # levels written this trigger
    bytes_written: int = 0          # post-compression bytes on disk
    bytes_on_link: int = 0          # pre-compression post-encode bytes the
                                    # trigger moved device->host — raw state
                                    # for host-encode paths, encoded payload
                                    # for device-encode deltas; the quantity
                                    # bench_ckpt/2 and the cost model price,
                                    # NOT the same thing as bytes_written
    duration_s: float = 0.0         # total write work (wall)
    blocking_s: float = 0.0         # portion that blocked the caller
    encode_s: float = 0.0           # delta encode+compress CPU seconds
    paths: tuple = ()
    synchronous: bool = True

    def __bool__(self) -> bool:     # truthy iff something was persisted
        return self.kind != "skipped"


@dataclass
class RestoreReport:
    state: Any
    step: int
    level: str                      # memory | local | remote
    kind: str                       # memory | full | full+delta
    duration_s: float
    extra: dict = field(default_factory=dict)
    degraded: bool = False          # a degraded partial restore: some shard
                                    # was rebuilt from peer replicas (or the
                                    # per-shard remote fallback)
    restored_bytes: int = 0         # bytes PULLED to rebuild dead shards —
                                    # the recovery-drill gate compares this
                                    # against the full checkpoint size


class CheckpointManager:
    """Executes a ``CheckpointPlan``; the single checkpoint entry point."""

    def __init__(self, directory: str, plan: CheckpointPlan,
                 policy: Optional[CheckpointPolicy] = None,
                 device: Any = None):
        self.directory = directory
        self.plan = plan
        # where device-placed deltas decode on restore: the CUDA device
        # unless the caller names another (the tests pass "cpu")
        self.device = resolve_device(device)
        self.policy = policy or CheckpointPolicy(plan.interval_s)
        os.makedirs(directory, exist_ok=True)
        self.stores: dict[str, CheckpointStore] = {}
        for level in plan.disk_levels:
            if level == "local" and plan.effective_replication >= 1:
                # the replicated level-2 store: each host pushes its shard
                # to k ring peers, so a node loss is survivable HERE — the
                # survival rule the cost model derives from the same k
                self.stores[level] = PeerReplicatedStore(
                    os.path.join(directory, level),
                    num_shards=plan.num_shards, keep=plan.keep,
                    replication_factor=plan.effective_replication)
            else:
                self.stores[level] = CheckpointStore(
                    os.path.join(directory, level),
                    num_shards=plan.num_shards, keep=plan.keep)
        # first disk level is the primary: it anchors the delta chain
        self.primary_level: Optional[str] = (plan.disk_levels[0]
                                             if plan.disk_levels else None)
        self._memory: Optional[tuple[int, Any, dict]] = None   # newest only
        self._base: Optional[Any] = None       # last full snapshot (host)
        self._base_step: Optional[int] = None
        # device-resident twin of the host base (plan.encode_placement ==
        # "device"): immutable references to the last full's device leaves,
        # refreshed on every full trigger/savepoint so delta triggers can
        # encode on device without a host round trip
        self._device_base: Optional[DeviceDeltaBase] = None
        # the host memory device-delta payloads land in, reused per trigger
        self._landing = HostLanding()
        self._count = 0
        self._committer = (None if plan.sync
                           else BackgroundCommitter(plan.busy_policy))
        # accounting
        self.link_bytes = 0           # pre-compression post-encode (D2H)
        self.bytes_by_kind = {"full": 0, "delta": 0}
        self.saves_by_level = {l: 0 for l in ("memory", "local", "remote")}
        self.skips = 0
        self.savepoints = 0
        self.late_saves = 0           # triggers landing past their cadence
        self.late_by_s = 0.0          # slot, and by how much in total — a
                                      # backpressured trigger widens the
                                      # lost-work window the controller's
                                      # CI assumption prices, so the slip
                                      # is measured rather than silent
        self.restores: list[tuple[int, str, str]] = []

    def _mark_trigger(self, timestamp: float) -> None:
        """Advance the cadence clock, accounting how late the trigger ran
        relative to the slot that made it due (regular triggers only —
        ``savepoint`` is cadence-exempt and marks directly)."""
        slot = self.policy.next_due(timestamp)
        slip = timestamp - slot
        # polling quantization lands every trigger a little past its slot;
        # only a slip a controller could care about (5% of the interval)
        # counts as late — backpressure windows exceed this by design
        if slip > 0.05 * self.policy.interval_s:
            self.late_saves += 1
            self.late_by_s += slip
        self.policy.mark(timestamp)

    # -- save ---------------------------------------------------------------
    def _kind(self) -> str:
        if self._base is None:     # no live base: the chain must restart
            return "full"
        return "full" if self.plan.is_full_trigger(self._count) else "delta"

    def save(self, step: int, state: Any, timestamp: float = 0.0,
             extra: Optional[dict] = None) -> SaveReport:
        extra = extra or {}
        if self._committer is not None and self._committer.busy:
            if self.plan.busy_policy == "skip":
                self.skips += 1
                self._count += 1          # the trigger happened; cadence moves on
                self._mark_trigger(timestamp)
                return SaveReport(step, "skipped", synchronous=False)
            self._committer.wait()

        t0 = time.monotonic()
        kind = self._kind()
        levels = [l for l, _ in self.plan.levels_due(self._count)
                  if l == "memory" or l in self.stores]
        # a real copy when the snapshot outlives this call (async write in
        # flight, or parked at the memory level / as the delta base) —
        # aliasing host arrays the caller may mutate would corrupt it.
        # ChunkedHostSnapshot copies only the mutable host leaves up front;
        # immutable device chunks stream to the io workers in background,
        # so blocking_s is the first chunk's device sync, not the full copy.
        # plan.eager_snapshot disables the deferral (donated-buffer states:
        # the "immutable" device arrays are re-used by the next step)
        need_copy = (self._committer is not None or "memory" in levels
                     or self.plan.mode == "incremental")
        device_delta = (kind == "delta"
                        and self.plan.encode_placement == "device"
                        and self._device_base is not None)
        if device_delta:
            # encode in front of D2H: only the encoded payload crosses the
            # link; raw leaves stay lazily reachable (memory-level parking,
            # delta-upgraded-to-full self-heal) through immutable refs
            snap = DeltaLeafSource(state, self._device_base,
                                   codec=self.plan.delta_codec,
                                   chunk_bytes=self.plan.chunk_bytes,
                                   landing=self._landing)
        else:
            snap = (ChunkedHostSnapshot(
                        state, self.plan.chunk_bytes,
                        defer_device=not self.plan.eager_snapshot)
                    if need_copy else PlainLeafSource(state))
        if "memory" in levels:
            # the memory level always holds the decoded newest state (as a
            # possibly-still-transferring snapshot source) — a task restart
            # restores from RAM without touching the codec path
            self._memory = (step, snap, dict(extra))
            self.saves_by_level["memory"] += 1
        if kind == "full":
            self._base, self._base_step = snap, step
            if self.plan.encode_placement == "device":
                self._device_base = DeviceDeltaBase(state)
        base, base_step = self._base, self._base_step
        self._count += 1

        disk = [l for l in levels if l in self.stores]
        report = SaveReport(step, kind, tuple(levels), synchronous=self._committer is None)

        def commit() -> None:
            nbytes, paths, encode_s = 0, [], 0.0
            for level in disk:
                store = self.stores[level]
                # remote only ever receives fulls; a delta whose base full
                # is missing at a level would be unrestorable there
                write_full = (kind == "full" or level == "remote"
                              or store.newest() != base_step)
                if write_full:
                    paths.append(store.save(step, snap, timestamp,
                                            {**extra, "kind": "full"}))
                    n = store.total_bytes(step)
                    nbytes += n
                    self.bytes_by_kind["full"] += n
                else:
                    p, n, enc = write_delta(store.directory, step, snap,
                                            base, base_step, timestamp,
                                            extra,
                                            self.plan.delta_codec,
                                            self.plan.codec)
                    paths.append(p)
                    nbytes += n
                    encode_s += enc
                    self.bytes_by_kind["delta"] += n
                    if isinstance(store, PeerReplicatedStore):
                        # deltas aren't physically replicated (the post-
                        # failure chain restarts from a full) but their
                        # mirror traffic is priced — keep the measured
                        # replica_bytes twin honest
                        store.account_delta_mirror(n)
                self.saves_by_level[level] += 1
            report.bytes_written = nbytes
            report.bytes_on_link = snap.bytes_on_link()
            self.link_bytes += report.bytes_on_link
            report.encode_s = encode_s
            report.paths = tuple(paths)
            report.duration_s = time.monotonic() - t0

        if self._committer is None:
            commit()
            report.blocking_s = report.duration_s
        else:
            self._committer.submit(commit)
            report.blocking_s = time.monotonic() - t0   # snapshot only
        self._mark_trigger(timestamp)
        return report

    # -- savepoint (cadence-exempt checkpoint-now) ---------------------------
    def savepoint(self, step: int, state: Any, timestamp: float = 0.0,
                  extra: Optional[dict] = None) -> SaveReport:
        """Durable checkpoint-now: drain any in-flight commit, then write a
        FULL snapshot synchronously to EVERY configured level — ignoring
        the every-Nth level cadences, which gate regular triggers only.
        This is the drain barrier under a controlled reconfiguration:
        after it returns, nothing the job has processed can be lost, even
        if the next action discards this manager (a plan switch rebuild).
        Does not advance the trigger count (cadence patterns are
        unaffected); does anchor a fresh delta chain at ``step``."""
        extra = extra or {}
        self.wait()
        t0 = time.monotonic()
        snap = ChunkedHostSnapshot(state, self.plan.chunk_bytes,
                                   defer_device=not self.plan.eager_snapshot)
        levels = []
        if "memory" in self.plan.levels:
            self._memory = (step, snap, dict(extra))
            self.saves_by_level["memory"] += 1
            levels.append("memory")
        self._base, self._base_step = snap, step
        if self.plan.encode_placement == "device":
            # the savepoint anchors a fresh delta chain; refresh the
            # device-resident base so post-drain deltas encode against it
            self._device_base = DeviceDeltaBase(state)
        nbytes, paths = 0, []
        for level, store in self.stores.items():
            paths.append(store.save(step, snap, timestamp,
                                    {**extra, "kind": "full"}))
            n = store.total_bytes(step)
            nbytes += n
            self.bytes_by_kind["full"] += n
            self.saves_by_level[level] += 1
            levels.append(level)
        self.savepoints += 1
        self.policy.mark(timestamp)
        dur = time.monotonic() - t0
        self.link_bytes += snap.bytes_on_link()
        return SaveReport(step, "full", tuple(levels), nbytes,
                          bytes_on_link=snap.bytes_on_link(),
                          duration_s=dur, blocking_s=dur,
                          paths=tuple(paths), synchronous=True)

    # -- restore ------------------------------------------------------------
    def _remote_steps(self) -> tuple[int, ...]:
        remote = self.stores.get("remote")
        return tuple(remote.list_steps()) if remote is not None else ()

    def _disk_candidate(self, level: str) -> Optional[tuple[int, int]]:
        """(restore_step, base_full_step) for a disk level, or None."""
        store = self.stores.get(level)
        if store is None:
            return None
        if isinstance(store, PeerReplicatedStore):
            # a degraded step (some shards only on replicas, or coverable
            # per-shard by the remote store AT THE SAME STEP) still counts
            full = store.newest_restorable(self._remote_steps())
        else:
            full = store.newest()
        if full is None:
            return None
        dstep = newest_delta_step(store.directory)
        if dstep is not None and dstep > full:
            meta = read_delta_manifest(store.directory, dstep)
            if meta is not None and meta["base_step"] == full:
                return dstep, full
        return full, full

    def restore(self, treedef_like: Any,
                failure_kind: str = "task") -> RestoreReport:
        self.wait()
        t0 = time.monotonic()
        allowed = allowed_levels(failure_kind,
                                 self.plan.effective_replication)
        candidates: list[tuple[int, int, str]] = []   # (step, speed, level)
        speed = {"memory": 2, "local": 1, "remote": 0}
        if "memory" in allowed and self._memory is not None:
            candidates.append((self._memory[0], speed["memory"], "memory"))
        for level in ("local", "remote"):
            if level in allowed:
                cand = self._disk_candidate(level)
                if cand is not None:
                    candidates.append((cand[0], speed[level], level))
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint survives a {failure_kind} failure")
        step, _, level = max(candidates)
        if level == "memory":
            mstep, snap, extra = self._memory
            # deep copy so the caller can't corrupt the parked snapshot
            state = tree_map(lambda x: np.array(x, copy=True),
                             snap.as_pytree())
            report = RestoreReport(state, mstep, "memory", "memory",
                                   time.monotonic() - t0, dict(extra))
        else:
            store = self.stores[level]
            restore_step, full_step = self._disk_candidate(level)
            degraded, restored_bytes = False, 0
            if isinstance(store, PeerReplicatedStore):
                # degraded partial restore: dead shards come from peer
                # replicas, and a shard with NO local copy falls back
                # per-shard to the remote store at the same step
                remote = self.stores.get("remote")
                fallback = remote.read_leaves if remote is not None else None
                state, extra = store.restore(treedef_like, full_step,
                                             shard_fallback=fallback)
                degraded = store.last_restore.get("degraded", False)
                restored_bytes = store.last_restore.get("restored_bytes", 0)
            else:
                state, extra = store.restore(treedef_like, full_step)
            kind = "full"
            if restore_step > full_step:
                meta = read_delta_manifest(store.directory, restore_step)
                # decode where this plan encodes; blobs are byte-compatible
                # across placements, so a host-written delta restores here
                # and a device-written one restores under a host plan
                state = apply_delta(store.directory, restore_step, state,
                                    placement=self.plan.encode_placement,
                                    device=self.device)
                extra = meta.get("extra", extra)
                kind = "full+delta"
            report = RestoreReport(state, restore_step, level, kind,
                                   time.monotonic() - t0, extra,
                                   degraded=degraded,
                                   restored_bytes=restored_bytes)
        self.restores.append((report.step, report.level, report.kind))
        return report

    # -- lifecycle / failure hooks -----------------------------------------
    def adopt_runtime_state(self, old: "CheckpointManager") -> None:
        """Carry the in-RAM snapshot and delta base over from a manager
        this one replaces (the plan-switch rebuild): the predecessor's
        drain savepoint is the newest state, so task restarts keep their
        RAM path and incremental plans delta against the drained full —
        the invariant lives here, next to the fields it protects.  The
        device-resident delta base rides along, so a plan switch onto (or
        between) device-encode plans deltas against the drained full
        without re-uploading it, and so does the payload landing."""
        self._memory = old._memory
        self._base, self._base_step = old._base, old._base_step
        self._device_base = old._device_base
        self._landing = old._landing

    def wait(self) -> None:
        """Drain any in-flight async commit."""
        if self._committer is not None:
            self._committer.wait()

    def on_failure(self, failure_kind: str,
                   host: Optional[int] = None) -> None:
        """Apply a failure's destruction to the levels it wipes out.
        A host-targeted node failure (``host`` given) additionally kills
        that host's node-local disk — its primary shards and the replicas
        it held for peers — which is what makes the subsequent restore a
        DEGRADED partial restore instead of a free local read.  With no
        ``host`` the node failure models a process loss whose disk
        survives (the pre-replication semantics, kept for back-compat)."""
        # the restore that follows holds the base, the payload and the
        # decoded state in host memory at once: give the landing's pages
        # back (the next device-delta trigger registers them again) once
        # no commit still copies into them (restore waits for it anyway)
        self.wait()
        self._landing.release()
        if failure_kind in ("node", "cluster"):
            self._memory = None
            self._base = None     # host RAM gone: next save must be a full
            self._base_step = None
            self._device_base = None   # the device died with the job too
        if failure_kind == "node" and host is not None \
                and "local" in self.stores:
            self.stores["local"].kill_host(host)
        if failure_kind == "cluster" and "local" in self.stores:
            # the sim's cluster failure loses node-local disks too; real
            # deployments re-point the store at an empty scratch dir
            shutil.rmtree(self.stores["local"].directory, ignore_errors=True)
            os.makedirs(self.stores["local"].directory, exist_ok=True)

    def stats(self) -> dict:
        errors = (list(self._committer.errors)
                  if self._committer is not None else [])
        return {
            "saves": self._count,
            "skips": self.skips,
            "savepoints": self.savepoints,
            "late_saves": self.late_saves,
            "late_by_s": self.late_by_s,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "bytes_written": sum(self.bytes_by_kind.values()),
            "bytes_on_link": self.link_bytes,
            "saves_by_level": dict(self.saves_by_level),
            "restores": list(self.restores),
            "async_errors": errors,
            "plan": self.plan.name,
        }
