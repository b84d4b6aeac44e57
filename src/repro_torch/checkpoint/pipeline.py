"""Pipelined checkpoint hot path: chunked device->host transfer feeding a
parallel compression/write worker pool, with the delta encode placeable on
EITHER side of the link (the port of ``repro.checkpoint.pipeline``).

Host placement ships the raw state and encodes behind the link:

    trigger -> chunked D2H transfer  ||  encode  ||  compress  ||  write

Device placement runs the ``kernels/ckpt_delta`` CUDA codec in front of
D2H (``DeltaLeafSource``), so only the encoded payload crosses the link:

    trigger -> pack -> ONE fused encode -> chunked D2H of encoded payload
                                                 ||  compress  ||  write

The f32 subtree of the state is packed into one contiguous GROUP-aligned
buffer (``FlatLayout``: each leaf zero-padded to whole 1024-element
groups, so per-group change statistics map exactly onto leaves), diffed
against the equally-packed ``DeviceDeltaBase.flat`` by one
``flat_lossless_encode``/``flat_int8_encode`` launch, and the encoded
payload streams off the device in byte-bounded chunks.

Mutability.  The JAX reference holds references to device arrays between
``save()`` and their transfer — free there, because JAX arrays never
change.  Torch tensors can be changed in place, which would silently
corrupt a deferred snapshot or the delta base.  The port's train step is
functional (new tensors every step), and this module makes the hazard
loud instead of silent: every held tensor's ``_version`` is recorded when
it is taken and checked again whenever it is encoded or copied; an
in-place change in between raises ``SnapshotMutationError``.

Streams.  D2H copies run on ``transfer_pool`` threads as synchronous
copies into host memory on the default stream, so they are ordered after
the encode that produced their input; no ``non_blocking`` copy is ever
made.  A device delta's encoded payload lands in the manager's
``HostLanding`` (page-locked for CUDA tensors, reused from trigger to
trigger); raw leaves land in pageable numpy arrays.

  * ``ChunkedHostSnapshot``: mutable host leaves (``np.ndarray``) are
    deep-copied eagerly; tensors are held by reference (version-checked),
    the first byte-bounded chunk is copied synchronously (the blocking
    cost) and the rest transfer on ``transfer_pool``.
  * ``LeafSource`` is the uniform interface the parallel writers consume:
    names/specs immediately, ``get(name)`` blocks until that leaf is on
    the host.
  * Two pools: D2H transfers on ``transfer_pool``, compression/writes on
    ``io_pool``; IO tasks wait on transfers, never the reverse.
"""
from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.ckpt_delta.ref import GROUP
from repro_torch.utils.trees import (np_dtype, tensor_to_numpy,
                                     tree_flatten_with_names, tree_structure,
                                     tree_unflatten)

DEFAULT_CHUNK_BYTES = 4 << 20     # D2H granularity: first chunk = blocking

_pool_lock = threading.Lock()
_transfer_pool: Optional[ThreadPoolExecutor] = None
_io_pool: Optional[ThreadPoolExecutor] = None


def transfer_pool() -> ThreadPoolExecutor:
    """Background device->host chunk transfers (small: D2H is one link)."""
    global _transfer_pool
    with _pool_lock:
        if _transfer_pool is None:
            _transfer_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="ckpt-d2h")
        return _transfer_pool


def io_pool() -> ThreadPoolExecutor:
    """Shared encode/compress/write workers for all checkpoint stores."""
    global _io_pool
    with _pool_lock:
        if _io_pool is None:
            _io_pool = ThreadPoolExecutor(
                max_workers=min(8, max(2, (os.cpu_count() or 2))),
                thread_name_prefix="ckpt-io")
        return _io_pool


class SnapshotMutationError(RuntimeError):
    """A tensor held by a snapshot or delta base was changed in place
    after the checkpoint took it."""


class HeldTensor:
    """A tensor reference plus the ``_version`` it had when taken."""

    __slots__ = ("name", "tensor", "version")

    def __init__(self, name: str, tensor: torch.Tensor):
        self.name = name
        self.tensor = tensor
        self.version = tensor._version

    def check(self) -> torch.Tensor:
        if self.tensor._version != self.version:
            raise SnapshotMutationError(
                f"leaf {self.name!r} was modified in place after save() "
                f"took it (version {self.version} -> "
                f"{self.tensor._version}); the train step must build new "
                f"tensors, or the plan must set eager_snapshot")
        return self.tensor

    def to_numpy(self) -> np.ndarray:
        arr = tensor_to_numpy(self.check())
        self.check()           # a change during the copy is caught too
        return arr


def _unregister(buf: np.ndarray) -> None:
    torch.cuda.cudart().cudaHostUnregister(buf.ctypes.data)


class HostLanding:
    """Host memory a device delta's payload planes land in, kept and
    reused from trigger to trigger (one per ``CheckpointManager``, carried
    across plan switches).  For planes on a CUDA device it is registered
    with CUDA (page-locked) once, at its exact size, when a trigger first
    needs more than it holds: the D2H copies then run at the link's DMA
    rate, and a trigger allocates and pins nothing.  The manager releases
    it when it handles a failure, so a restore has the host memory.

    ``take`` hands out the planes of ONE trigger, end to end; they stay
    valid until the next ``take``.  ``generation`` counts the takes, so a
    source whose planes were handed out again raises instead of writing
    another trigger's bytes (``DeltaLeafSource.flat_payload``).  A
    manager's next delta trigger comes after the last one's commit (sync
    commit, or an async commit waited for or skipped), so this never
    fires on the manager's own path."""

    ALIGN = 64            # bytes; every plane starts on this boundary

    def __init__(self):
        self.buf: Optional[np.ndarray] = None
        self.pinned = False
        self.generation = 0
        self._unpin: Optional[weakref.finalize] = None

    def take(self, planes: list, pin: bool) -> list[np.ndarray]:
        """One array per ``(count, dtype)`` of ``planes``; ``pin`` registers
        the memory with CUDA (the planes come from a CUDA device)."""
        offsets, total = [], 0
        for n, dtype in planes:
            offsets.append(total)
            nbytes = n * np.dtype(dtype).itemsize
            total += -(-nbytes // self.ALIGN) * self.ALIGN
        if self.buf is None or self.buf.nbytes < total or self.pinned != pin:
            self.release()
            buf = np.empty(max(total, self.ALIGN), np.uint8)
            if pin:
                err = int(torch.cuda.cudart().cudaHostRegister(
                    buf.ctypes.data, buf.nbytes, 0))
                if err:
                    raise RuntimeError(f"cudaHostRegister of {buf.nbytes} "
                                       f"bytes failed: cudaError {err}")
                self._unpin = weakref.finalize(self, _unregister, buf)
            self.buf, self.pinned = buf, pin
        self.generation += 1
        return [self.buf[o:o + n * np.dtype(dt).itemsize].view(dt)
                for o, (n, dt) in zip(offsets, planes)]

    def release(self) -> None:
        """Unregister and free the memory (the next ``take`` makes more)."""
        if self._unpin is not None:
            self._unpin()
        self.buf, self.pinned, self._unpin = None, False, None


def _spec_of(leaf: Any) -> tuple[tuple, np.dtype]:
    return tuple(leaf.shape), np_dtype(leaf)


class LeafSource:
    """Leaf-level access to a checkpoint state for the pipelined writers.

    ``names``/``spec`` are available immediately so shard assignment and
    manifests never wait on bytes; ``get(name)`` blocks until that leaf is
    host-resident.
    """

    names: list
    treedef: Any

    def spec(self, name: str) -> tuple[tuple, np.dtype]:
        raise NotImplementedError

    def nbytes(self, name: str) -> int:
        shape, dtype = self.spec(name)
        return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape \
            else dtype.itemsize

    def get(self, name: str) -> np.ndarray:
        raise NotImplementedError

    def bytes_on_link(self) -> int:
        """Bytes this snapshot moves across the device->host link
        (pre-compression, post-encode); ``DeltaLeafSource`` overrides with
        the encoded-payload accounting."""
        return sum(self.nbytes(n) for n in self.names)

    def wait(self) -> None:
        """Block until every leaf is host-resident."""

    def as_pytree(self) -> Any:
        self.wait()
        return tree_unflatten(self.treedef, [self.get(n) for n in self.names])


class PlainLeafSource(LeafSource):
    """A fully host-resident pytree (numpy leaves may alias the caller's
    arrays; use ``ChunkedHostSnapshot`` when the snapshot must survive
    in-place mutation)."""

    def __init__(self, state: Any):
        named = tree_flatten_with_names(state)
        self.treedef = tree_structure(state)
        self.names = [n for n, _ in named]
        self._leaves = {n: (tensor_to_numpy(l) if isinstance(l, torch.Tensor)
                            else np.asarray(l)) for n, l in named}

    def spec(self, name: str) -> tuple[tuple, np.dtype]:
        leaf = self._leaves[name]
        return tuple(leaf.shape), leaf.dtype

    def get(self, name: str) -> np.ndarray:
        return self._leaves[name]


class ChunkedHostSnapshot(LeafSource):
    """Point-in-time host snapshot with chunked, overlapped D2H transfer.

    Blocking work (done in ``__init__``): deep-copy of every host leaf +
    synchronous copy of the first tensor chunk (the device sync).
    Everything else lands on ``transfer_pool`` and is pulled by
    ``get``/``wait``.  ``defer_device=False`` copies every tensor before
    returning (``CheckpointPlan.eager_snapshot``).
    """

    def __init__(self, state: Any, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 defer_device: bool = True):
        named = tree_flatten_with_names(state)
        self.treedef = tree_structure(state)
        self.names = [n for n, _ in named]
        self._spec: dict[str, tuple[tuple, np.dtype]] = {}
        self._leaves: dict[str, np.ndarray] = {}
        self._future_of: dict[str, Future] = {}

        deferred: list[HeldTensor] = []
        for name, leaf in named:
            if isinstance(leaf, torch.Tensor):
                self._spec[name] = _spec_of(leaf)
                held = HeldTensor(name, leaf)
                if defer_device:
                    deferred.append(held)
                else:
                    self._leaves[name] = held.to_numpy()
            else:
                # mutable host memory (or a scalar): copy NOW — the caller
                # may mutate it the moment save() returns
                arr = np.array(leaf, copy=True)
                self._spec[name] = (tuple(arr.shape), arr.dtype)
                self._leaves[name] = arr

        chunks: list[list[HeldTensor]] = []
        cur, cur_bytes = [], 0
        for held in deferred:
            cur.append(held)
            cur_bytes += self.nbytes(held.name)
            if cur_bytes >= chunk_bytes:
                chunks.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            chunks.append(cur)

        if chunks:      # first chunk synchronously: the device sync point
            self._leaves.update(self._materialize(chunks[0]))
        pool = transfer_pool()
        for chunk in chunks[1:]:
            fut = pool.submit(self._materialize, chunk)
            for held in chunk:
                self._future_of[held.name] = fut

    @staticmethod
    def _materialize(chunk: list) -> dict[str, np.ndarray]:
        return {held.name: held.to_numpy() for held in chunk}

    def spec(self, name: str) -> tuple[tuple, np.dtype]:
        return self._spec[name]

    def get(self, name: str) -> np.ndarray:
        fut = self._future_of.get(name)
        if fut is not None:
            return fut.result()[name]
        return self._leaves[name]

    def wait(self) -> None:
        for fut in self._future_of.values():
            fut.result()


@dataclass(frozen=True)
class FlatEntry:
    """One leaf's extent inside the packed buffer (element units)."""

    name: str
    offset: int          # GROUP-aligned start
    size: int            # true (unpadded) element count
    shape: tuple

    @property
    def padded(self) -> int:
        return -(-self.size // GROUP) * GROUP


class FlatLayout:
    """Where each f32 leaf lives inside the packed buffer.

    Every leaf is zero-padded to a whole number of GROUP(=1024)-element
    groups, so offsets are GROUP-aligned and every group belongs to
    exactly ONE leaf: per-group change statistics reduce exactly to
    per-leaf counts via ``group_leaf``, int8 scale groups never straddle
    leaves, and the decoder slices any leaf back out by ``(offset, size,
    shape)``.  ``to_manifest()`` is the delta manifest's ``"flat"`` rows.
    """

    def __init__(self, named_shapes: list):
        self.entries: list[FlatEntry] = []
        off = 0
        for name, shape in named_shapes:
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            entry = FlatEntry(name, off, size, tuple(shape))
            self.entries.append(entry)
            off += entry.padded
        self.total = off
        self.by_name = {e.name: e for e in self.entries}
        self.names = [e.name for e in self.entries]
        group_leaf = np.zeros(self.total // GROUP, np.int32)
        for i, entry in enumerate(self.entries):
            group_leaf[entry.offset // GROUP:
                       (entry.offset + entry.padded) // GROUP] = i
        self.group_leaf = group_leaf
        self._group_leaf_dev: dict[str, torch.Tensor] = {}

    def group_leaf_device(self, device: Any) -> torch.Tensor:
        """The group->leaf index map on ``device`` (int64, the index type
        of ``index_add_``), uploaded once per device and cached."""
        key = str(torch.device(device))
        if key not in self._group_leaf_dev:
            self._group_leaf_dev[key] = torch.from_numpy(
                self.group_leaf.astype(np.int64)).to(device)
        return self._group_leaf_dev[key]

    def to_manifest(self) -> list:
        return [[e.name, e.offset, e.size, list(e.shape)]
                for e in self.entries]


class DeviceDeltaBase:
    """The delta base held on the device across triggers — per-leaf
    references (version-checked) plus the PACKED flat buffer the fused
    encoder diffs against.

    The f32 tensors of the state are packed into ``flat`` under ``layout``
    once per refresh (a copy, so later steps cannot disturb it) and the
    packed buffer is reused by every delta trigger until the next full.
    Host leaves are deep-copied.  ``CheckpointManager`` refreshes this on
    every full trigger/savepoint and carries it across plan-switch
    rebuilds (``adopt_runtime_state``).
    """

    def __init__(self, state: Any):
        from repro_torch.kernels.ckpt_delta.ops import pack_flat

        self.leaves: dict[str, Any] = {}
        packable: list[tuple[str, torch.Tensor]] = []
        for name, leaf in tree_flatten_with_names(state):
            if isinstance(leaf, torch.Tensor):
                self.leaves[name] = HeldTensor(name, leaf)
                if leaf.dtype == torch.float32 and leaf.numel() > 0:
                    packable.append((name, leaf))
            else:
                self.leaves[name] = np.array(leaf, copy=True)
        self.layout: Optional[FlatLayout] = None
        self.flat: Optional[torch.Tensor] = None
        if packable:
            devices = {leaf.device for _, leaf in packable}
            if len(devices) != 1:
                raise ValueError(f"f32 leaves span devices {devices}")
            self.layout = FlatLayout(
                [(name, tuple(leaf.shape)) for name, leaf in packable])
            self.flat = pack_flat([leaf for _, leaf in packable])

    @property
    def device(self) -> Optional[torch.device]:
        return None if self.flat is None else self.flat.device

    def flat_subset(self, names: list) -> tuple[FlatLayout, torch.Tensor]:
        """The packed base restricted to ``names`` (in that order): the
        resident buffer as-is when the subtree matches, else the
        surviving GROUP-aligned extents re-concatenated."""
        assert self.layout is not None and self.flat is not None
        if names == self.layout.names:
            return self.layout, self.flat
        sub = FlatLayout([(n, self.layout.by_name[n].shape) for n in names])
        parts = [self.flat[e.offset:e.offset + e.padded]
                 for e in (self.layout.by_name[n] for n in names)]
        return sub, torch.cat(parts)


class DeltaLeafSource(LeafSource):
    """Delta-encode on the device with ONE fused kernel over the packed
    flat buffer, then stream only the ENCODED payload D2H in chunks.

    ``__init__`` does the blocking part: pack the new state's f32 subtree,
    run one ``flat_lossless_encode``/``flat_int8_encode`` against the
    resident ``DeviceDeltaBase.flat``, read the per-LEAF change counts
    (that small read is the device sync), then copy the FIRST payload
    chunk synchronously and queue the rest on ``transfer_pool``.

    Consumed two ways:

      * ``layout`` + ``flat_payload()`` + ``zero_names`` — the flat
        protocol ``incremental.write_delta`` detects: the packed extents,
        the host payload arrays ("d"/"r" lossless, "q"/"s" int8; the
        ``"zero"`` marker for a residual plane whose D2H was skipped), and
        the leaves whose fused change count was 0.  Leaves outside the
        packed subtree (non-f32, host-resident, empty, or drifted in
        shape) take the per-leaf host-encode path.
      * ``get(name)`` — the raw leaf, copied lazily (version-checked).

    The lossless residual is all-zero for any element within 2x of its
    base (Sterbenz), so when the per-leaf nonzero counts sum to 0 the
    residual plane never crosses the link.  int8 payloads are q (1 B per
    element) + per-1024 f32 scales.  When every packed leaf is unchanged
    nothing crosses the link at all.
    """

    placement = "device"

    def __init__(self, state: Any, base: DeviceDeltaBase,
                 codec: str = "lossless",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 landing: Optional[HostLanding] = None):
        assert codec in ("lossless", "int8"), codec
        from repro_torch.kernels.ckpt_delta.ops import (flat_int8_encode,
                                                        flat_lossless_encode,
                                                        pack_flat)
        self.codec = codec
        named = tree_flatten_with_names(state)
        self.treedef = tree_structure(state)
        self.names = [n for n, _ in named]
        self._spec: dict[str, tuple[tuple, np.dtype]] = {}
        self._raw: dict[str, Any] = {}
        self._payload: dict[str, Any] = {}       # suffix -> host np / "zero"
        self._chunk_futs: list[Future] = []
        self._link_lock = threading.Lock()
        self._link_bytes = 0
        self.layout: Optional[FlatLayout] = None
        self.zero_names: tuple = ()
        # without the manager's landing, a source lands in one of its own
        self._landing = landing or HostLanding()
        self._generation = 0

        packed: list[HeldTensor] = []
        for name, leaf in named:
            if isinstance(leaf, torch.Tensor):
                self._spec[name] = _spec_of(leaf)
                held = HeldTensor(name, leaf)
                self._raw[name] = held
                entry = None if base.layout is None \
                    else base.layout.by_name.get(name)
                if (entry is not None and leaf.dtype == torch.float32
                        and entry.shape == tuple(leaf.shape)
                        and leaf.device == base.device):
                    packed.append(held)
                # else: fallback leaf — per-leaf host encode; its raw D2H
                # is accounted when write_delta pulls it through get()
            else:
                arr = np.array(leaf, copy=True)   # mutable host leaf
                self._spec[name] = (tuple(arr.shape), arr.dtype)
                self._raw[name] = arr
                self._account(arr.nbytes)

        if not packed:
            return

        layout, base_flat = base.flat_subset([h.name for h in packed])
        self.layout = layout
        new_flat = pack_flat([h.check() for h in packed])
        group_leaf = layout.group_leaf_device(base_flat.device)
        if codec == "lossless":
            d, r, leaf_changed, leaf_rnnz = flat_lossless_encode(
                new_flat, base_flat, group_leaf, len(packed))
            del new_flat
            changed = leaf_changed.cpu().numpy()   # stats read = device sync
            arrays: list[tuple[str, torch.Tensor]] = []
            if changed.any():
                arrays.append(("d", d))
                if int(leaf_rnnz.sum()):
                    arrays.append(("r", r))
                else:           # residual known all-zero: skip its D2H —
                    self._payload["r"] = "zero"   # decoder reconstructs
        else:
            q, s, leaf_changed = flat_int8_encode(
                new_flat, base_flat, group_leaf, len(packed))
            del new_flat
            changed = leaf_changed.cpu().numpy()   # stats read = device sync
            arrays = [("q", q), ("s", s)] if changed.any() else []
        self.zero_names = tuple(
            entry.name for entry, c in zip(layout.entries, changed) if not c)
        self._start_transfers(arrays, chunk_bytes)

    def _start_transfers(self, arrays: list, chunk_bytes: int) -> None:
        """Chunk the encoded payload arrays and stream them D2H: first
        chunk synchronously (the blocking cost), the rest on the pool."""
        # the residual's int32 bits are the on-disk u32 words
        planes = [(int(dev.numel()),
                   np.dtype(np.uint32) if sfx == "r" else np_dtype(dev))
                  for sfx, dev in arrays]
        if not planes:
            return
        hosts = self._landing.take(planes,
                                   pin=any(d.is_cuda for _, d in arrays))
        self._generation = self._landing.generation
        tasks: list[tuple] = []
        for (sfx, dev), host in zip(arrays, hosts):
            self._payload[sfx] = host
            per = max(GROUP, chunk_bytes // host.itemsize)
            for a in range(0, host.size, per):
                tasks.append((host, dev, a, min(host.size, a + per)))
        if not tasks:
            return
        self._pull_chunk(*tasks[0])
        pool = transfer_pool()
        self._chunk_futs = [pool.submit(self._pull_chunk, *task)
                            for task in tasks[1:]]

    def _pull_chunk(self, host: np.ndarray, dev: torch.Tensor, a: int,
                    b: int) -> None:
        view = host[a:b].view(np.int32) if host.dtype == np.uint32 \
            else host[a:b]
        # a synchronous copy on the default stream: ordered after the
        # encode that produced ``dev``
        torch.from_numpy(view).copy_(dev[a:b])
        self._account((b - a) * host.itemsize)

    def _account(self, nbytes: int) -> None:
        with self._link_lock:
            self._link_bytes += int(nbytes)

    # -- flat protocol for incremental.write_delta ----------------------
    def flat_payload(self) -> dict:
        """suffix -> host payload array, or the ``"zero"`` marker for a
        skipped all-zero residual plane; empty when every packed leaf was
        unchanged.  Blocks until every chunk has landed."""
        self.wait()
        if self._generation and \
                self._landing.generation != self._generation:
            raise SnapshotMutationError(
                "this delta's payload planes were handed to a later trigger "
                "before it was written")
        return dict(self._payload)

    # -- LeafSource interface -------------------------------------------
    def spec(self, name: str) -> tuple[tuple, np.dtype]:
        return self._spec[name]

    def get(self, name: str) -> np.ndarray:
        leaf = self._raw[name]
        if isinstance(leaf, np.ndarray):
            return leaf
        arr = leaf.to_numpy()
        with self._link_lock:
            cur = self._raw[name]
            if isinstance(cur, np.ndarray):     # another worker won the race
                return cur
            self._raw[name] = arr
            # a raw pull IS link traffic — count it so bytes_on_link never
            # under-reports
            self._link_bytes += arr.nbytes
        return arr

    def wait(self) -> None:
        for fut in self._chunk_futs:
            fut.result()

    def bytes_on_link(self) -> int:
        self.wait()
        with self._link_lock:
            return self._link_bytes


def as_leaf_source(state: Any) -> LeafSource:
    """Adapt ``state`` (pytree or LeafSource) for the pipelined writers."""
    if isinstance(state, LeafSource):
        return state
    return PlainLeafSource(state)
