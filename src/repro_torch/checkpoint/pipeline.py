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

Streams.  A device delta's payload and the plain path's chunks are
copied on ``transfer_pool`` threads as synchronous copies on the default
stream, so they are ordered after the encode that produced their input.
A delta's encoded payload lands in the manager's ``HostLanding``
(page-locked for CUDA tensors, reused from trigger to trigger).  A
snapshot's CUDA leaves never touch the default stream: they are copied on
their device's own transfer stream, ordered after the step that made them
by one event, through a small page-locked ``StagingRing`` into pageable
numpy arrays.

  * ``ChunkedHostSnapshot``: mutable host leaves (``np.ndarray``) are
    deep-copied eagerly; tensors are held by reference (version-checked).
    Contiguous CUDA tensors are laid end to end and cut by bytes, within
    a leaf where it is larger than a slot, into chunks of one ring slot
    each: each chunk is a ``non_blocking`` copy on the transfer stream,
    and one of the ring's threads waits for its event, copies the slot
    into the leaves' host arrays and frees the slot.  Nothing of this
    waits for the device before ``save`` returns.  Other tensors (CPU,
    non-contiguous) are grouped, whole leaves at a time, into chunks of
    at least ``chunk_bytes``; the first is copied synchronously and the
    rest on ``transfer_pool``.
  * ``LeafSource`` is the uniform interface the parallel writers consume:
    names/specs immediately, ``get(name)`` blocks until that leaf is on
    the host.
  * Two pools: D2H transfers on ``transfer_pool`` (and the staging
    rings' own threads), compression/writes on ``io_pool``; IO tasks wait
    on transfers, never the reverse.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.ckpt_delta.ref import GROUP
from repro_torch.utils import timing
from repro_torch.utils.trees import (np_dtype, tensor_to_numpy,
                                     tree_flatten_with_names, tree_structure,
                                     tree_unflatten)

# D2H granularity.  A device delta's payload planes are cut into chunks of
# this many bytes, and a ChunkedHostSnapshot's plain path (CPU or
# non-contiguous tensors) groups whole leaves until a chunk holds at least
# this many.  Its CUDA leaves go through the staging ring instead, in
# chunks of one slot (STAGING_SLOT_BYTES), cut within a leaf.
DEFAULT_CHUNK_BYTES = 4 << 20
# The staging ring of a CUDA device: this many page-locked slots of this
# many bytes (256 MiB pinned once per device and process).
STAGING_SLOTS = 4
STAGING_SLOT_BYTES = 64 << 20

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
            with timing.span("ckpt.landing.pin"):
                buf = np.empty(max(total, self.ALIGN), np.uint8)
                if pin:
                    err = int(torch.cuda.cudart().cudaHostRegister(
                        buf.ctypes.data, buf.nbytes, 0))
                    if err:
                        raise RuntimeError(f"cudaHostRegister of "
                                           f"{buf.nbytes} bytes failed: "
                                           f"cudaError {err}")
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


def plan_chunks(nbytes: list, slot_bytes: int) -> list:
    """The leaves' bytes laid end to end in leaf order and cut into chunks
    of at most ``slot_bytes``: each chunk a list of ``(leaf, start, end)``
    byte pieces.  A leaf larger than the room left in a chunk is cut, so
    every chunk but the last is exactly one slot."""
    chunks, cur, room = [], [], slot_bytes
    for leaf, n in enumerate(nbytes):
        a = 0
        while a < n:
            b = min(n, a + room)
            cur.append((leaf, a, b))
            room -= b - a
            a = b
            if room == 0:
                chunks.append(cur)
                cur, room = [], slot_bytes
    if cur:
        chunks.append(cur)
    return chunks


class StagingRing:
    """A device's transfer stream and a few page-locked host slots its
    tensors are staged through on their way to pageable host memory.

    A chunk takes a free slot, is copied into it with ``non_blocking``
    copies on ``stream`` and marked by the slot's event; one of the ring's
    own two ``ckpt-d2h-ring`` threads waits for the event (the GIL
    released), copies the slot out and frees it, which starts the next
    queued chunk.  So the copies never run on, or wait behind, the default
    stream, at most ``slots`` chunks are in flight, and a delta's payload
    pulls on ``transfer_pool`` never queue behind a full's copy-out.  One
    ring per device for the process (``staging_ring``), made once and
    reused by every snapshot; the queue is shared, in order.  On the CPU
    (tests) the copies are plain synchronous ones."""

    def __init__(self, device: Any, slots: int = STAGING_SLOTS,
                 slot_bytes: int = STAGING_SLOT_BYTES):
        self.device = torch.device(device)
        self.slot_bytes = int(slot_bytes)
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._events = [torch.cuda.Event(blocking=True) if cuda else None
                        for _ in range(slots)]
        self._buf = torch.empty(slots * self.slot_bytes, dtype=torch.uint8,
                                pin_memory=cuda)
        self._host = self._buf.numpy()
        self._free = list(range(slots))
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._landers = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="ckpt-d2h-ring")

    def ready(self) -> Optional[torch.cuda.Event]:
        """An event on the device's current stream: what a snapshot taken
        now must come after (None on the CPU)."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def submit(self, transfer: "RingTransfer", chunks: list,
               ready: Optional[torch.cuda.Event]) -> None:
        """Queue ``transfer``'s chunks behind ``ready``."""
        with self._lock:
            if ready is not None:
                self.stream.wait_event(ready)
            self._queue.extend((transfer, chunk) for chunk in chunks)
        self._pump()

    def _pump(self) -> None:
        while True:
            with self._lock:
                if not (self._free and self._queue):
                    return
                slot = self._free.pop()
                transfer, chunk = self._queue.popleft()
            transfer.copy_in(slot, chunk)
            self._landers.submit(transfer.land, slot, chunk)

    def on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def slot(self, slot: int) -> torch.Tensor:
        return self._buf[slot * self.slot_bytes:(slot + 1) * self.slot_bytes]

    def host(self, slot: int) -> np.ndarray:
        return self._host[slot * self.slot_bytes:
                          (slot + 1) * self.slot_bytes]

    def record(self, slot: int) -> None:
        if self.stream is not None:
            self._events[slot].record(self.stream)

    def synchronize(self, slot: int) -> None:
        if self.stream is not None:
            self._events[slot].synchronize()

    def release(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)
        self._pump()


_rings: dict = {}


def staging_ring(device: Any) -> StagingRing:
    """The process's staging ring of CUDA ``device``, made at first use."""
    key = str(torch.device(device))
    with _pool_lock:
        if key not in _rings:
            _rings[key] = StagingRing(device)
        return _rings[key]


class RingTransfer:
    """One snapshot's tensors of one device on their way through its
    ``StagingRing`` into ``hosts`` (the snapshot's host arrays, one a
    leaf).  ``futures[i]`` resolves to ``{name: host array}`` once every
    piece of leaf ``i`` has landed.  A leaf's tensor is version-checked
    before its first piece is copied and after its last piece's event has
    completed, and only then released: the caching allocator cannot hand
    its memory to the next step while the transfer stream still reads it.
    ``on_landed(nbytes)`` is called once for each chunk, after it landed."""

    def __init__(self, held: list, hosts: list, ring: StagingRing,
                 on_landed):
        self.held = list(held)
        self.hosts = hosts
        self.futures = [Future() for _ in held]
        self._bytes = [h.reshape(-1).view(np.uint8) for h in hosts]
        self._ring, self._on_landed = ring, on_landed
        self._error: list = [None] * len(held)
        self._lock = threading.Lock()
        self.chunks = plan_chunks([b.size for b in self._bytes],
                                  ring.slot_bytes)
        self._left = [0] * len(held)
        for chunk in self.chunks:
            for leaf, _, _ in chunk:
                self._left[leaf] += 1
        for leaf, left in enumerate(self._left):
            if not left:                     # an empty leaf: nothing to copy
                self._finish(leaf)

    def start(self) -> None:
        """Queue the chunks behind the work on the current stream."""
        self._ring.submit(self, self.chunks, self._ring.ready())

    def copy_in(self, slot: int, chunk: list) -> None:
        """Enqueue the chunk's pieces into ``slot`` and mark it."""
        ring, off = self._ring, 0
        dst = ring.slot(slot)
        with ring.on_stream():
            for leaf, a, b in chunk:
                if self._error[leaf] is None:
                    try:
                        if a == 0:
                            self.held[leaf].check()
                        src = self.held[leaf].tensor.detach().reshape(-1)
                        dst[off:off + b - a].copy_(
                            src.view(torch.uint8)[a:b], non_blocking=True)
                    except Exception as exc:   # lands as this leaf's error
                        self._error[leaf] = exc
                off += b - a
            ring.record(slot)

    def land(self, slot: int, chunk: list) -> None:
        """Wait for the slot's copies, copy it out, free it; resolve the
        leaves whose last piece this was."""
        ring, off = self._ring, 0
        try:
            ring.synchronize(slot)
            src = ring.host(slot)
            for leaf, a, b in chunk:
                if self._error[leaf] is None:
                    np.copyto(self._bytes[leaf][a:b], src[off:off + b - a])
                off += b - a
        except Exception as exc:
            for leaf, _, _ in chunk:
                self._error[leaf] = self._error[leaf] or exc
        finally:
            ring.release(slot)
        done, moved = [], 0
        with self._lock:
            for leaf, a, b in chunk:
                moved += (b - a) if self._error[leaf] is None else 0
                self._left[leaf] -= 1
                if not self._left[leaf]:
                    done.append(leaf)
        self._on_landed(moved)
        for leaf in done:
            self._finish(leaf)

    def _finish(self, leaf: int) -> None:
        held, self.held[leaf] = self.held[leaf], None
        error = self._error[leaf]
        if error is None:
            try:
                held.check()        # a change while it was in flight
            except SnapshotMutationError as exc:
                error = exc
        name = held.name
        del held                    # released before anyone is woken
        if error is not None:
            self.futures[leaf].set_exception(error)
        else:
            self.futures[leaf].set_result({name: self.hosts[leaf]})


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


def _stageable(tensor: torch.Tensor) -> bool:
    """A tensor that goes through its device's staging ring."""
    return tensor.is_cuda and tensor.is_contiguous()


class ChunkedHostSnapshot(LeafSource):
    """Point-in-time host snapshot with chunked, overlapped D2H transfer.

    Blocking work (done in ``__init__``): deep-copy of every host leaf,
    and the queueing of every tensor's copy.  Contiguous CUDA tensors go
    through their device's ``StagingRing``: one event on the current
    stream (the one that produced the state) orders the ring's transfer
    stream after it, the leaves are cut by bytes, within a leaf, into
    chunks of one slot (``plan_chunks``; yi-6b's 1.05 GB
    ``opt/m/emb/embed`` spans 16 of 64 MiB), and nothing waits for the
    device before ``__init__`` returns.  Other tensors (CPU, non-contiguous) are
    grouped, whole leaves at a time, into chunks of at least
    ``chunk_bytes``: the first is copied synchronously, the rest on
    ``transfer_pool``.  Each leaf lands in a host array of its own, pulled
    by ``get``/``wait``.  ``staged_bytes`` counts the bytes that have come
    through a ring.  ``defer_device=False`` copies every tensor before
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
        self.staged_bytes = 0
        self._staged_lock = threading.Lock()

        deferred: list[HeldTensor] = []
        staged: dict[torch.device, list[HeldTensor]] = {}
        for name, leaf in named:
            if isinstance(leaf, torch.Tensor):
                self._spec[name] = _spec_of(leaf)
                held = HeldTensor(name, leaf)
                if not defer_device:
                    self._leaves[name] = held.to_numpy()
                elif _stageable(leaf):
                    staged.setdefault(leaf.device, []).append(held)
                else:
                    deferred.append(held)
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

        if not (chunks or staged):
            return
        if chunks:
            with timing.span("ckpt.d2h.first"):   # the device sync point
                self._leaves.update(self._materialize(chunks[0]))
        with timing.span("ckpt.d2h.queue"):
            transfers = []
            for device, held in staged.items():
                hosts = [np.empty(*self._spec[h.name]) for h in held]
                transfer = RingTransfer(held, hosts, staging_ring(device),
                                        self._landed)
                for h, fut in zip(held, transfer.futures):
                    self._future_of[h.name] = fut
                transfers.append(transfer)
            parts = len(chunks) - 1 + sum(len(t.chunks) for t in transfers)
            self._background = timing.pending("ckpt.d2h.background", parts)
            self._background.set(staged_bytes=0)
            pool = transfer_pool()
            for chunk in chunks[1:]:
                fut = pool.submit(self._materialize, chunk, self._background)
                for held in chunk:
                    self._future_of[held.name] = fut
            for transfer in transfers:
                transfer.start()

    @staticmethod
    def _materialize(chunk: list,
                     landed=timing.OFF) -> dict[str, np.ndarray]:
        try:
            return {held.name: held.to_numpy() for held in chunk}
        finally:
            landed.done()

    def _landed(self, nbytes: int) -> None:
        """One ring chunk of this snapshot has landed."""
        with self._staged_lock:
            self.staged_bytes += nbytes
            self._background.set(staged_bytes=self.staged_bytes)
        self._background.done()

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

        with timing.span("ckpt.delta.pack"):
            named = tree_flatten_with_names(state)
            self.treedef = tree_structure(state)
            self.names = [n for n, _ in named]
            packed = self._hold(named, base)
            if packed:
                layout, base_flat = base.flat_subset([h.name for h in packed])
                self.layout = layout
                new_flat = pack_flat([h.check() for h in packed])
                group_leaf = layout.group_leaf_device(base_flat.device)
        if not packed:
            return

        if codec == "lossless":
            with timing.span("ckpt.delta.encode"):
                d, r, leaf_changed, leaf_rnnz = flat_lossless_encode(
                    new_flat, base_flat, group_leaf, len(packed))
                del new_flat
            with timing.span("ckpt.delta.stats"):
                changed = leaf_changed.cpu().numpy()   # the device sync
                arrays: list[tuple[str, torch.Tensor]] = []
                if changed.any():
                    arrays.append(("d", d))
                    if int(leaf_rnnz.sum()):
                        arrays.append(("r", r))
                    else:       # residual known all-zero: skip its D2H —
                        self._payload["r"] = "zero"   # decoder reconstructs
        else:
            with timing.span("ckpt.delta.encode"):
                q, s, leaf_changed = flat_int8_encode(
                    new_flat, base_flat, group_leaf, len(packed))
                del new_flat
            with timing.span("ckpt.delta.stats"):
                changed = leaf_changed.cpu().numpy()   # the device sync
                arrays = [("q", q), ("s", s)] if changed.any() else []
        self.zero_names = tuple(
            entry.name for entry, c in zip(layout.entries, changed) if not c)
        self._start_transfers(arrays, chunk_bytes)

    def _hold(self, named: list, base: DeviceDeltaBase) -> list[HeldTensor]:
        """Hold every tensor leaf (version-checked) and copy every host
        leaf; the tensors the base packed, at their shapes, are returned:
        they are encoded on the device."""
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
        return packed

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
        with timing.span("ckpt.d2h.first"):
            self._pull_chunk(*tasks[0])
        with timing.span("ckpt.d2h.queue"):
            landed = timing.pending("ckpt.d2h.background", len(tasks) - 1)
            pool = transfer_pool()
            self._chunk_futs = [pool.submit(self._pull_chunk, *task, landed)
                                for task in tasks[1:]]

    def _pull_chunk(self, host: np.ndarray, dev: torch.Tensor, a: int,
                    b: int, landed=timing.OFF) -> None:
        try:
            view = host[a:b].view(np.int32) if host.dtype == np.uint32 \
                else host[a:b]
            # a synchronous copy on the default stream: ordered after the
            # encode that produced ``dev``
            torch.from_numpy(view).copy_(dev[a:b])
            self._account((b - a) * host.itemsize)
        finally:
            landed.done()

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
        with timing.span("ckpt.d2h.wait"):
            self.wait()
        with self._link_lock:
            return self._link_bytes


def as_leaf_source(state: Any) -> LeafSource:
    """Adapt ``state`` (pytree or LeafSource) for the pipelined writers."""
    if isinstance(state, LeafSource):
        return state
    return PlainLeafSource(state)
