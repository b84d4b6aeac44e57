"""Sharded atomic checkpoint store (the port's copy of
``repro.checkpoint.store``; the on-disk format is unchanged).

Layout (one directory per checkpoint):

    <dir>/step_00001234/
        shard_00000.npz ... shard_000HH.npz    # per-host leaf groups
        manifest.json                          # written LAST = commit marker

Shards are written concurrently on ``pipeline.io_pool`` (save accepts a
still-transferring chunked snapshot; each shard worker blocks only on the
leaves it holds), then the manifest — per-shard CRC32 checksums, the
leaf->shard assignment, dtypes and shapes — is written to a temp file and
renamed into place.  A checkpoint without a valid manifest (or with a
checksum mismatch) is invisible to ``newest``/``restore``.

Leaf names are the slash-joined state paths with "/" stored as "::", so
checkpoints written by the JAX package restore here and the other way
round.  Checksums and framed payloads are read in bounded pieces, so a
multi-gigabyte shard never has to sit in host memory twice.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.utils.trees import (np_dtype, tree_flatten_with_names,
                                     tree_leaves, tree_structure,
                                     tree_unflatten)

# ---------------------------------------------------------------------------
# Compression codecs (zstd when installed, zlib always available)
# ---------------------------------------------------------------------------

try:
    import zstandard as _zstd
    HAVE_ZSTD = True
except ImportError:          # the card's machine has no zstandard: zlib
    _zstd = None
    HAVE_ZSTD = False


def resolve_codec(name: str = "auto") -> str:
    """Map a requested codec name to an available one."""
    if name in ("auto", "zstd"):
        return "zstd" if HAVE_ZSTD else "zlib"
    if name != "zlib":
        raise ValueError(f"unknown codec {name!r}")
    return "zlib"


def get_compressor(name: str = "auto", level: int = 3
                   ) -> tuple[str, Callable[[bytes], bytes]]:
    """Returns (resolved_codec_name, compress_fn).  The resolved name is
    recorded in the manifest so restore picks the matching codec."""
    codec = resolve_codec(name)
    if codec == "zstd":
        # fresh context per call: zstd contexts are not thread-safe
        return codec, lambda data: _zstd.ZstdCompressor(level=level).compress(data)
    return codec, lambda data: zlib.compress(data, level)


def get_decompressor(name: str) -> Callable[[bytes], bytes]:
    """Decompressor for a codec name read back from a manifest."""
    codec = resolve_codec(name)
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise RuntimeError("checkpoint was written with zstd but "
                               "zstandard is not installed")
        return lambda data: _zstd.ZstdDecompressor().decompress(data)
    return zlib.decompress


# ---------------------------------------------------------------------------
# Framed compression for large single-array payloads (the flat delta
# planes): independent fixed-size frames, compressed and decompressed in
# parallel, their compressed lengths recorded in the manifest
# ---------------------------------------------------------------------------

FLAT_FRAME_BYTES = 8 << 20
_READ_BYTES = 64 << 20


def compress_frames(arr: np.ndarray, compress, pool,
                    frame_bytes: int = FLAT_FRAME_BYTES
                    ) -> tuple[list, list, float]:
    """Compress ``arr``'s bytes as independent frames, concurrently on
    ``pool``.  Returns (frames, frame_lens, cpu_s)."""
    data = memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")

    def one(a: int) -> tuple[bytes, float]:
        t0 = time.thread_time()
        blob = compress(bytes(data[a:a + frame_bytes]))
        return blob, time.thread_time() - t0

    futs = [pool.submit(one, a) for a in range(0, len(data), frame_bytes)]
    results = [f.result() for f in futs]
    frames = [blob for blob, _ in results]
    return frames, [len(b) for b in frames], sum(c for _, c in results)


def decompress_frames(path: str, frame_lens: list, dtype, decompress,
                      pool) -> np.ndarray:
    """Inverse of ``compress_frames``: each worker reads its own frame
    (``os.pread``) and decompresses it straight into the output array."""
    offs = [0]
    for n in frame_lens:
        offs.append(offs[-1] + int(n))
    nf = len(frame_lens)
    if nf == 0:
        return np.zeros(0, dtype)
    fd = os.open(path, os.O_RDONLY)
    try:
        def raw(i: int) -> bytes:
            return decompress(os.pread(fd, offs[i + 1] - offs[i], offs[i]))

        # every frame but the last holds the same byte count: the first
        # and last frames give the output size, then each worker
        # decompresses its frame straight into place
        first = raw(0)
        last = raw(nf - 1) if nf > 1 else first
        frame = len(first)
        out = np.empty(frame * (nf - 1) + len(last), np.uint8)
        out[:frame] = np.frombuffer(first, np.uint8)
        out[frame * (nf - 1):] = np.frombuffer(last, np.uint8)

        def fill(i: int) -> None:
            out[i * frame:(i + 1) * frame] = np.frombuffer(raw(i), np.uint8)

        for fut in [pool.submit(fill, i) for i in range(1, nf - 1)]:
            fut.result()
    finally:
        os.close(fd)
    return out.view(dtype)


def file_crc32(path: str) -> int:
    """CRC32 of a file, read in bounded pieces."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(_READ_BYTES)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


# ---------------------------------------------------------------------------
# Atomic-publish helpers
# ---------------------------------------------------------------------------

def write_json_atomic(path: str, obj: dict) -> None:
    """Write JSON via temp-file + rename; the rename is the commit point."""
    with open(path + ".part", "w") as f:
        json.dump(obj, f)
    os.rename(path + ".part", path)


def publish_dir_atomic(tmp: str, path: str) -> None:
    """Atomically publish a fully-written temp directory at ``path``
    (superseding an older copy of the same step)."""
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def fresh_tmp_dir(path: str) -> str:
    """Create (or recreate) the scratch dir a checkpoint is staged in."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


@dataclass
class CheckpointMeta:
    """What a checkpoint's manifest says of it."""
    step: int
    timestamp: float
    num_shards: int
    extra: dict

    @property
    def name(self) -> str:
        return f"step_{self.step:010d}"


def _assign_shards(sizes_by_name: list[tuple[str, int]], num_shards: int):
    """Greedy balanced bin-packing of leaves into shards by bytes."""
    sizes = sorted(((nb, name) for name, nb in sizes_by_name), reverse=True)
    loads = [0] * num_shards
    assign: dict[str, int] = {}
    for nbytes, name in sizes:
        j = int(np.argmin(loads))
        loads[j] += nbytes
        assign[name] = j
    return assign


def load_npz(path: str, wanted: Optional[set] = None
             ) -> dict[str, np.ndarray]:
    """One shard's leaves by state name (all, or those in ``wanted``)."""
    with np.load(path) as z:
        return {k.replace("::", "/"): z[k] for k in z.files
                if wanted is None or k.replace("::", "/") in wanted}


def restore_into(treedef_like: Any, data: dict) -> Any:
    """Arrange loaded leaves into the structure of ``treedef_like`` (a
    pytree of tensors or arrays), cast to each leaf's dtype."""
    names = [n for n, _ in tree_flatten_with_names(treedef_like)]
    missing = [n for n in names if n not in data]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    leaves = tree_leaves(treedef_like)
    restored = [np.asarray(data[n], dtype=np_dtype(s))
                if hasattr(s, "dtype") else data[n]
                for n, s in zip(names, leaves)]
    return tree_unflatten(tree_structure(treedef_like), restored)


class CheckpointStore:
    def __init__(self, directory: str, num_shards: int = 4, keep: int = 3,
                 num_hosts: Optional[int] = None,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 write_attempts: int = 4, write_backoff_s: float = 0.01):
        self.directory = directory
        self.num_shards = num_shards
        # shard j lives on simulated host ``j % num_hosts`` — the manifest
        # records this placement so failure injection can kill exactly one
        # host's files (on this substrate hosts == shards by default)
        self.num_hosts = num_hosts if num_hosts is not None else num_shards
        self.keep = keep
        # transient-IO injection point for tests: called with the target
        # path before every file write attempt
        self.fault_hook = fault_hook
        self.write_attempts = write_attempts
        self.write_backoff_s = write_backoff_s
        self.saves = 0
        self.bytes_written = 0
        self.write_retries = 0
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, timestamp: float = 0.0,
             extra: Optional[dict] = None) -> str:
        """Write one checkpoint.  ``state`` is a pytree or a
        ``pipeline.LeafSource``: shards are planned from leaf specs alone,
        then written concurrently on the io pool; the manifest is written
        only after every shard has."""
        from repro_torch.checkpoint.pipeline import as_leaf_source, io_pool
        from repro_torch.checkpoint.replication import retry_with_backoff

        src = as_leaf_source(state)
        assign = _assign_shards([(n, src.nbytes(n)) for n in src.names],
                                self.num_shards)
        name = f"step_{step:010d}"
        path = os.path.join(self.directory, name)
        tmp = fresh_tmp_dir(path)

        def write_shard(j: int) -> tuple[str, int]:
            shard = {n.replace("/", "::"): np.asarray(src.get(n))
                     for n in src.names if assign[n] == j}
            fpath = os.path.join(tmp, f"shard_{j:05d}.npz")

            # transient IO errors get bounded retries with jittered
            # backoff; a persistent error propagates and the un-manifested
            # .tmp dir stays invisible to restore
            def attempt() -> int:
                if self.fault_hook is not None:
                    self.fault_hook(fpath)
                np.savez(fpath, **shard)
                return file_crc32(fpath)

            def note_retry(i: int, e: BaseException) -> None:
                self.write_retries += 1

            crc = retry_with_backoff(attempt, attempts=self.write_attempts,
                                     base_s=self.write_backoff_s,
                                     on_retry=note_retry)
            return f"shard_{j:05d}.npz", crc

        futures = [io_pool().submit(write_shard, j)
                   for j in range(self.num_shards)]
        checksums = dict(f.result() for f in futures)
        # the replica-push phase (PeerReplicatedStore) runs BETWEEN the
        # primary shard writes and the manifest commit
        replicas = self._push_replicas(tmp, checksums)

        specs = {n: src.spec(n) for n in src.names}
        manifest = {
            "step": step,
            "timestamp": timestamp,
            "num_shards": self.num_shards,
            "assign": assign,
            "checksums": checksums,
            "placement": {
                "num_hosts": self.num_hosts,
                "owners": {f: self._file_host(f) for f in checksums},
            },
            "dtypes": {n: str(dt) for n, (_, dt) in specs.items()},
            "shapes": {n: list(shape) for n, (shape, _) in specs.items()},
            "extra": extra or {},
        }
        if replicas:
            manifest["replicas"] = replicas
        write_json_atomic(os.path.join(tmp, "manifest.json"), manifest)
        publish_dir_atomic(tmp, path)
        self.saves += 1
        self.bytes_written += self.total_bytes(step)
        self._gc()
        return path

    def _push_replicas(self, tmp: str, checksums: dict) -> Optional[dict]:
        """Replication hook between shard writes and the manifest commit;
        the plain store replicates nothing."""
        return None

    def stats(self) -> dict:
        return {"saves": self.saves, "bytes_written": self.bytes_written,
                "write_retries": self.write_retries}

    # -- host placement -------------------------------------------------------
    def _file_host(self, fname: str) -> Optional[int]:
        """Which simulated host's disk a checkpoint file lives on (None
        for files not owned by any single host, e.g. the manifest)."""
        if fname.startswith("shard_") and fname.endswith(".npz"):
            return int(fname[6:11]) % self.num_hosts
        return None

    def kill_host(self, host: int) -> list[str]:
        """Failure injection: host ``host``'s node-local disk dies, taking
        every checkpoint file placed on it (across all steps) with it."""
        removed = []
        for name in sorted(os.listdir(self.directory)):
            d = os.path.join(self.directory, name)
            if not name.startswith("step_") or not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                if self._file_host(fname) == host:
                    os.remove(os.path.join(d, fname))
                    removed.append(os.path.join(name, fname))
        return removed

    # -- introspection --------------------------------------------------------
    def _manifest(self, name: str) -> Optional[dict]:
        """Load a step's manifest without checksum validation."""
        mpath = os.path.join(self.directory, name, "manifest.json")
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None

    def _file_ok(self, name: str, fname: str, crc: int) -> bool:
        fpath = os.path.join(self.directory, name, fname)
        if not os.path.exists(fpath):
            return False
        return file_crc32(fpath) == crc

    def _valid(self, name: str) -> Optional[dict]:
        manifest = self._manifest(name)
        if manifest is None:
            return None
        for fname, crc in manifest["checksums"].items():
            if not self._file_ok(name, fname, crc):
                return None
        return manifest

    def list_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if self._valid(name) is not None:
                    out.append(int(name.split("_")[1]))
        return out

    def newest(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # -- restore ---------------------------------------------------------------
    def restore(self, treedef_like: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``treedef_like`` (a pytree of
        tensors or arrays).  Returns (state of numpy arrays, extra)."""
        from repro_torch.checkpoint.pipeline import io_pool

        step = step if step is not None else self.newest()
        if step is None:
            raise FileNotFoundError("no valid checkpoint found")
        name = f"step_{step:010d}"
        manifest = self._valid(name)
        if manifest is None:
            raise FileNotFoundError(f"checkpoint {name} is corrupt or missing")
        data: dict[str, np.ndarray] = {}
        for fut in [io_pool().submit(
                load_npz, os.path.join(self.directory, name,
                                       f"shard_{j:05d}.npz"))
                    for j in range(manifest["num_shards"])]:
            data.update(fut.result())
        return restore_into(treedef_like, data), manifest["extra"]

    def read_leaves(self, step: int, names: list) -> dict[str, np.ndarray]:
        """Load only the shards holding ``names`` — the per-shard remote
        fallback of a degraded partial restore."""
        from repro_torch.checkpoint.pipeline import io_pool

        name = f"step_{step:010d}"
        manifest = self._valid(name)
        if manifest is None:
            raise FileNotFoundError(f"checkpoint {name} is corrupt or missing")
        assign = manifest["assign"]
        missing = [n for n in names if n not in assign]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        wanted = set(names)
        data: dict[str, np.ndarray] = {}
        for fut in [io_pool().submit(
                load_npz, os.path.join(self.directory, name,
                                       f"shard_{j:05d}.npz"), wanted)
                    for j in sorted({assign[n] for n in names})]:
            data.update(fut.result())
        return data

    def total_bytes(self, step: int) -> int:
        name = f"step_{step:010d}"
        p = os.path.join(self.directory, name)
        return sum(os.path.getsize(os.path.join(p, f)) for f in os.listdir(p))

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
