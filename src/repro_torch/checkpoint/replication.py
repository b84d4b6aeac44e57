"""Peer replication — the mechanism that EARNS level-2 node survival.

Level-2 (node-local) checkpoints survive a node loss only if a peer
holds a copy; this module provides the copies (the port of
``repro.checkpoint.replication``).

``PeerReplicatedStore`` on this single-process substrate:

* each simulated host owns the shards ``_assign_shards`` places on it
  (owner of shard j = ``j % num_hosts``, recorded in the manifest's
  ``placement`` section);
* after the primary shards land, each host pushes its shard to its k
  ring-neighbor peers (``ring_peers``) through the shared transfer pool,
  each push wrapped in bounded retry with jittered backoff;
* the save COMMITS (manifest written, directory published) only if every
  shard collected >= k replica acks — the quorum rule.  A failed quorum
  raises ``ReplicationError`` and leaves no manifest, so the previous
  checkpoint still wins;
* ``kill_host(h)`` simulates losing host h's node-local disk: its owned
  primary shards AND every replica it held for others vanish;
* restore is a DEGRADED PARTIAL restore: surviving primary shards load
  locally, only the failed host's shards are pulled from peer replicas
  (``replica_stats.restored_bytes`` counts exactly those pulled bytes),
  and a shard with zero surviving copies falls back per-shard to the
  remote store via ``shard_fallback`` — never a full remote restore when
  any local copy survives.

Scope note: incremental deltas are not physically replicated — the cost
model prices their mirror traffic via ``account_delta_mirror`` and a
post-failure delta chain restarts from a full (the manager already resets
the base on node loss), so correctness never depends on replicated
deltas.
"""
from __future__ import annotations

import os
import random
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.store import (CheckpointStore, load_npz,
                                          restore_into)


class ReplicationError(RuntimeError):
    """A level-2 save failed its replication quorum and was not committed."""


def ring_peers(host: int, num_hosts: int, k: int) -> tuple[int, ...]:
    """The k ring-neighbor peers host ``host`` replicates to:
    ``(host+1, ..., host+k) mod num_hosts``, never including itself.
    A ring of H hosts has at most H-1 distinct peers."""
    if num_hosts <= 1 or k <= 0:
        return ()
    peers = []
    for i in range(1, min(k, num_hosts - 1) + 1):
        p = (host + i) % num_hosts
        if p != host and p not in peers:
            peers.append(p)
    return tuple(peers)


def retry_with_backoff(fn: Callable[[], Any], attempts: int = 4,
                       base_s: float = 0.01, factor: float = 2.0,
                       jitter: float = 0.5,
                       rng: Optional[random.Random] = None,
                       sleep: Optional[Callable[[float], None]] = None,
                       on_retry: Optional[Callable[[int, BaseException],
                                                   None]] = None) -> Any:
    """Run ``fn`` with bounded retries and jittered exponential backoff.

    Retries only ``OSError`` (the transient-IO class: flaky disk, NFS
    hiccup, interrupted copy); anything else propagates immediately.
    Attempt i sleeps ``base_s * factor**i * (1 + jitter*U[0,1))`` before
    retrying — the jitter decorrelates concurrent pushers hammering the
    same recovering disk.  After ``attempts`` failures the last error
    propagates (bounded, never infinite).  ``sleep``/``rng`` are
    injectable so tests run instantly and deterministically.
    """
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    rng = rng if rng is not None else random.Random()
    sleep = sleep if sleep is not None else time.sleep
    for i in range(attempts):
        try:
            return fn()
        except OSError as e:
            if i == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(i, e)
            sleep(base_s * (factor ** i) * (1.0 + jitter * rng.random()))


@dataclass
class ReplicaStats:
    """Byte/attempt accounting for the replica plane — the measured twin
    of ``SimCostModel.avg_replica_bytes`` / the degraded-restore price."""
    pushes: int = 0             # replica copies attempted (incl. retries' firsts)
    push_retries: int = 0       # backoff retries taken
    push_failures: int = 0      # pushes dead after bounded retry
    acks: int = 0               # replica copies that landed + checksummed
    replica_bytes: int = 0      # bytes of replica traffic (incl. delta mirror)
    degraded_restores: int = 0  # restores that had to touch replicas/remote
    shards_from_primary: int = 0
    shards_from_peer: int = 0   # shards rebuilt from a peer replica
    shards_from_remote: int = 0  # shards with no local copy, pulled remote
    restored_bytes: int = 0     # bytes PULLED during degraded restores
                                # (replica reads + remote fallback), i.e. the
                                # partial-restore traffic — local primary
                                # reads are free and not counted

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class PeerReplicatedStore(CheckpointStore):
    """A ``CheckpointStore`` whose saves are durable against a single
    node loss: see the module docstring for the protocol."""

    def __init__(self, directory: str, num_shards: int = 4, keep: int = 3,
                 num_hosts: Optional[int] = None,
                 replication_factor: int = 1,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 push_attempts: int = 4, push_backoff_s: float = 0.01,
                 seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None):
        super().__init__(directory, num_shards=num_shards, keep=keep,
                         num_hosts=num_hosts, fault_hook=fault_hook)
        self.replication_factor = max(0, min(replication_factor,
                                             self.num_hosts - 1))
        self.push_attempts = push_attempts
        self.push_backoff_s = push_backoff_s
        self.replica_stats = ReplicaStats()
        self.last_restore: dict = {}
        self._rng = random.Random(seed)
        self._sleep = sleep

    # -- replica push (runs inside save(), between shards and manifest) ----
    def _push_replicas(self, tmp: str, checksums: dict) -> Optional[dict]:
        """Push every shard to its owner's ring peers on the transfer
        pool.  Returns the manifest ``replicas`` section, or raises
        ``ReplicationError`` if any shard misses quorum (>= k acks) —
        in that case save() never writes the manifest, so the half-
        replicated checkpoint is invisible."""
        from repro_torch.checkpoint.pipeline import transfer_pool

        k = self.replication_factor
        if k == 0:
            return None
        stats = self.replica_stats
        jobs = []   # (shard_fname, crc, peer, replica_fname, future)
        for fname, crc in checksums.items():
            owner = self._file_host(fname)
            for peer in ring_peers(owner, self.num_hosts, k):
                rname = f"replica_h{peer:03d}_{fname}"
                jobs.append((fname, crc, peer, rname,
                             transfer_pool().submit(
                                 self._push_one, tmp, fname, rname)))
        replicas: dict[str, dict] = {}
        acked = {fname: 0 for fname in checksums}
        errors = []
        for fname, crc, peer, rname, fut in jobs:
            try:
                fut.result()
            except OSError as e:
                stats.push_failures += 1
                errors.append(f"{rname}: {e}")
                continue
            stats.acks += 1
            stats.replica_bytes += os.path.getsize(os.path.join(tmp, rname))
            acked[fname] += 1
            replicas[rname] = {"shard": fname, "crc": crc, "host": peer}
        short = sorted(f for f, n in acked.items() if n < k)
        if short:
            raise ReplicationError(
                f"replication quorum failed (need {k} acks/shard): shards "
                f"{short} under-replicated after bounded retry "
                f"[{'; '.join(errors) or 'no push errors recorded'}]")
        return replicas

    def _push_one(self, tmp: str, fname: str, rname: str) -> None:
        """One shard->peer push: a retried copy through the node-
        interconnect stand-in (same-dir file copy on this substrate)."""
        stats = self.replica_stats
        stats.pushes += 1
        src = os.path.join(tmp, fname)
        dst = os.path.join(tmp, rname)

        def attempt() -> None:
            if self.fault_hook is not None:
                self.fault_hook(dst)
            shutil.copyfile(src, dst)

        def note_retry(i: int, e: BaseException) -> None:
            stats.push_retries += 1

        retry_with_backoff(attempt, attempts=self.push_attempts,
                           base_s=self.push_backoff_s, rng=self._rng,
                           sleep=self._sleep, on_retry=note_retry)

    def account_delta_mirror(self, nbytes: int) -> None:
        """Price the replica traffic of a delta write (k mirrors of the
        delta payload).  Deltas are not physically replicated (module
        docstring: the post-failure chain restarts from a full), but
        their mirror bytes must still show up in measured replica
        traffic so the cost model's ``avg_replica_bytes`` has a
        measured twin under incremental plans."""
        self.replica_stats.replica_bytes += nbytes * self.replication_factor

    # -- failure injection --------------------------------------------------
    # ``kill_host`` is inherited: the base deletes every file whose
    # ``_file_host`` is the dead host, and the override below makes the
    # replicas a host holds for its peers count as living on it too.
    def _file_host(self, fname: str) -> Optional[int]:
        if fname.startswith("replica_h"):
            return int(fname[9:12])
        return super()._file_host(fname)

    # -- validity: a shard is covered if ANY copy of it is intact ----------
    def _valid(self, name: str) -> Optional[dict]:
        manifest = self._manifest(name)
        if manifest is None:
            return None
        replicas = manifest.get("replicas") or {}
        for fname, crc in manifest["checksums"].items():
            if self._file_ok(name, fname, crc):
                continue
            covered = any(
                info["shard"] == fname
                and self._file_ok(name, rname, info["crc"])
                for rname, info in replicas.items())
            if not covered:
                return None
        return manifest

    def restorable_steps(self, remote_steps: Any = ()) -> list[int]:
        """Steps restorable at this level, counting per-shard remote
        fallback: a step whose manifest loads but whose shards lost every
        local copy is still restorable iff the remote store holds the
        SAME step (mixed-step shards would not be bit-exact)."""
        remote_steps = set(remote_steps)
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if self._valid(name) is not None:
                out.append(int(name.split("_")[1]))
            elif self._manifest(name) is not None \
                    and int(name.split("_")[1]) in remote_steps:
                out.append(int(name.split("_")[1]))
        return out

    def newest_restorable(self, remote_steps: Any = ()) -> Optional[int]:
        steps = self.restorable_steps(remote_steps)
        return steps[-1] if steps else None

    # -- degraded partial restore ------------------------------------------
    def restore(self, treedef_like: Any, step: Optional[int] = None,
                shard_fallback: Optional[Callable[[int, list],
                                                  dict]] = None
                ) -> tuple[Any, dict]:
        """Restore, pulling ONLY what the failure destroyed: intact
        primary shards load locally for free; a dead primary loads from
        a surviving peer replica; a shard with no local copy at all is
        fetched per-shard from ``shard_fallback(step, leaf_names)`` (the
        manager wires this to the remote store's ``read_leaves`` at the
        SAME step).  ``last_restore``/``replica_stats`` record the
        degraded-pull bytes the recovery actually moved."""
        from repro_torch.checkpoint.pipeline import io_pool

        step = step if step is not None else self.newest()
        if step is None:
            raise FileNotFoundError("no valid checkpoint found")
        name = f"step_{step:010d}"
        manifest = self._manifest(name)
        if manifest is None:
            raise FileNotFoundError(f"checkpoint {name} is corrupt or missing")
        replicas = manifest.get("replicas") or {}
        stats = self.replica_stats
        pulled_bytes = 0
        from_peer = from_remote = from_primary = 0
        plan: list[tuple[str, str]] = []     # (load_path kind, fname)
        missing: list[str] = []              # shard fnames with no local copy
        for fname, crc in manifest["checksums"].items():
            if self._file_ok(name, fname, crc):
                plan.append(("primary", fname))
                continue
            rep = next((rname for rname, info in replicas.items()
                        if info["shard"] == fname
                        and self._file_ok(name, rname, info["crc"])), None)
            if rep is not None:
                plan.append(("peer", rep))
            else:
                missing.append(fname)

        data: dict[str, np.ndarray] = {}
        futs = [(src, fname, io_pool().submit(
                    load_npz, os.path.join(self.directory, name, fname)))
                for src, fname in plan]
        for src, fname, fut in futs:
            data.update(fut.result())
            if src == "primary":
                from_primary += 1
            else:
                from_peer += 1
                pulled_bytes += os.path.getsize(
                    os.path.join(self.directory, name, fname))
        assign = manifest["assign"]
        for fname in missing:
            j = int(fname[6:11])
            leaf_names = sorted(n for n, s in assign.items() if s == j)
            if shard_fallback is None:
                raise FileNotFoundError(
                    f"{name}: shard {fname} has no surviving local copy "
                    "and no remote fallback was provided")
            fetched = shard_fallback(step, leaf_names)
            still = [n for n in leaf_names if n not in fetched]
            if still:
                raise FileNotFoundError(
                    f"{name}: remote fallback missing leaves {still[:5]}")
            data.update({n: fetched[n] for n in leaf_names})
            from_remote += 1
            pulled_bytes += sum(int(np.asarray(fetched[n]).nbytes)
                                for n in leaf_names)
        degraded = bool(from_peer or from_remote)
        if degraded:
            stats.degraded_restores += 1
        stats.shards_from_primary += from_primary
        stats.shards_from_peer += from_peer
        stats.shards_from_remote += from_remote
        stats.restored_bytes += pulled_bytes
        self.last_restore = {"step": step, "degraded": degraded,
                             "restored_bytes": pulled_bytes,
                             "shards_from_primary": from_primary,
                             "shards_from_peer": from_peer,
                             "shards_from_remote": from_remote}

        return restore_into(treedef_like, data), manifest["extra"]

    def stats(self) -> dict:
        out = super().stats()
        out["replication_factor"] = self.replication_factor
        out["replica"] = self.replica_stats.as_dict()
        return out
