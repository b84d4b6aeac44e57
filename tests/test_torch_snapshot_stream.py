"""``ChunkedHostSnapshot``'s staged path (``checkpoint.pipeline``): a CUDA
device's tensors are cut by bytes, within a leaf, into chunks of one
staging slot, copied on the device's own transfer stream into page-locked
slots and out into each leaf's host array.  The planner covers every byte
once and in order; a snapshot through the ring reassembles bit for bit,
releases the tensors it held and counts the bytes it staged; a change in
place between two pieces of one leaf raises; CPU tensors keep the plain
copy.  On the CPU the ring is a plain one (``StagingRing("cpu")``, the
copies synchronous), put in place of the CUDA ring by ``monkeypatch``;
the last test runs the real one on a card."""
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import pipeline
from repro_torch.checkpoint.pipeline import (ChunkedHostSnapshot,
                                             RingTransfer,
                                             SnapshotMutationError,
                                             StagingRing, plan_chunks)
from repro_torch.utils import timing
from repro_torch.utils.trees import tensor_to_numpy


@pytest.mark.parametrize("slot", [1, 7, 64, 1000])
@pytest.mark.parametrize("sizes", [[0], [5], [13, 0, 1, 129, 64, 3],
                                   [1000, 999, 1001], [2, 2, 2, 2, 2]])
def test_the_planner_covers_every_byte_once_in_order(slot, sizes):
    chunks = plan_chunks(sizes, slot)
    pieces = [p for chunk in chunks for p in chunk]
    assert all(0 < sum(b - a for _, a, b in c) <= slot for c in chunks)
    # every chunk but the last fills its slot
    assert all(sum(b - a for _, a, b in c) == slot for c in chunks[:-1])
    assert [leaf for leaf, _, _ in pieces] == sorted(
        leaf for leaf, _, _ in pieces)
    for leaf, n in enumerate(sizes):
        mine = [(a, b) for i, a, b in pieces if i == leaf]
        covered = [x for a, b in mine for x in range(a, b)]
        assert covered == list(range(n))      # once each, in order
    assert sum(b - a for _, a, b in pieces) == sum(sizes)


@pytest.fixture
def cpu_ring(monkeypatch):
    """Every tensor staged, through one small CPU ring (3 slots of 48
    bytes: most leaves below are cut)."""
    ring = StagingRing("cpu", slots=3, slot_bytes=48)
    monkeypatch.setattr(pipeline, "_stageable", lambda t: True)
    monkeypatch.setattr(pipeline, "staging_ring", lambda device: ring)
    return ring


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(37, generator=g),            # 148 B: cut in 4
            "b": {"c": torch.randint(-9, 9, (3, 5), generator=g,
                                     dtype=torch.int64),
                  "d": torch.rand(11, generator=g) > 0.5},
            "e": torch.zeros(0),
            "f": torch.tensor(3, dtype=torch.int32),
            "g": torch.randn(2, 7, generator=g, dtype=torch.float64),
            "h": np.arange(5, dtype=np.int16)}


def test_a_staged_snapshot_reassembles_bit_exactly(cpu_ring):
    timing.reset()
    timing.enable()
    try:
        state = _state()
        want = {k: (tensor_to_numpy(v) if isinstance(v, torch.Tensor)
                    else v.copy())
                for k, v in pipeline.tree_flatten_with_names(state)}
        refs = [weakref.ref(v) for _, v in
                pipeline.tree_flatten_with_names(state)
                if isinstance(v, torch.Tensor)]
        snap = ChunkedHostSnapshot(state)
        del state
        snap.wait()
    finally:
        timing.disable()
    for name, arr in want.items():
        got = snap.get(name)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert got.tobytes() == arr.tobytes()
    # every tensor went through the ring, and none is held any more
    nbytes = sum(a.nbytes for k, a in want.items() if k != "h")
    assert snap.staged_bytes == nbytes
    assert all(r() is None for r in refs)
    bg = [s for s in timing.spans() if s.name == "ckpt.d2h.background"]
    assert len(bg) == 1 and bg[0].attrs["staged_bytes"] == nbytes
    names = [s.name for s in timing.spans()]
    assert "ckpt.d2h.queue" in names and "ckpt.d2h.first" not in names
    timing.reset()
    tree = snap.as_pytree()
    assert tree["b"]["c"].tobytes() == want["b/c"].tobytes()


def test_a_change_in_place_between_two_pieces_raises(cpu_ring, monkeypatch):
    """``a`` is cut into four pieces; it is changed in place right after
    its first piece was copied.  ``get`` raises for it, and only for it."""
    state = _state()
    a_host = tensor_to_numpy(state["a"])
    real = RingTransfer.copy_in
    seen = []

    def copy_in(self, slot, chunk):
        real(self, slot, chunk)
        if not seen and any(leaf == 0 and x == 0 for leaf, x, _ in chunk):
            seen.append(chunk)
            state["a"].add_(1.0)
    monkeypatch.setattr(RingTransfer, "copy_in", copy_in)
    snap = ChunkedHostSnapshot(state)
    assert seen and max(b for leaf, _, b in seen[0] if leaf == 0) < \
        a_host.nbytes                     # the change fell inside the leaf
    with pytest.raises(SnapshotMutationError, match="'a'"):
        snap.get("a")
    assert snap.get("g").tobytes() == tensor_to_numpy(state["g"]).tobytes()
    with pytest.raises(SnapshotMutationError):
        snap.wait()


def test_cpu_tensors_take_the_plain_copy(monkeypatch):
    def no_ring(device):
        raise AssertionError("a CPU tensor reached the staging ring")
    monkeypatch.setattr(pipeline, "staging_ring", no_ring)
    timing.reset()
    timing.enable()
    try:
        state = _state()
        snap = ChunkedHostSnapshot(state, chunk_bytes=64)
        snap.wait()
    finally:
        timing.disable()
    for name, leaf in pipeline.tree_flatten_with_names(state):
        want = tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor) \
            else leaf
        assert snap.get(name).tobytes() == want.tobytes()
    assert snap.staged_bytes == 0
    spans = timing.spans()
    timing.reset()
    assert [s.name for s in spans if s.parent is None] == [
        "ckpt.d2h.first", "ckpt.d2h.queue"]
    bg = [s for s in spans if s.name == "ckpt.d2h.background"]
    assert len(bg) == 1 and bg[0].attrs["staged_bytes"] == 0


def test_snapshots_share_one_ring_under_thread_switches(cpu_ring):
    """Eight threads take snapshots through one three-slot ring at once,
    with the interpreter switching threads every microsecond: each lands
    bit for bit, and the ring gets every slot back."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    bad, snaps = [], []

    def take(seed):
        state = _state(seed)
        snap = ChunkedHostSnapshot(state)
        snaps.append(snap)
        for name, leaf in pipeline.tree_flatten_with_names(state):
            want = tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor) \
                else leaf
            if snap.get(name).tobytes() != want.tobytes():
                bad.append((seed, name))
    try:
        threads = [threading.Thread(target=take, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert bad == [] and len(snaps) == 8
    assert sorted(cpu_ring._free) == [0, 1, 2] and not cpu_ring._queue


@pytest.mark.cuda
def test_a_cuda_snapshot_through_the_ring():
    """On a card: a state with a leaf larger than the whole ring, made by
    kernels just before the snapshot, while the default stream runs other
    work after it, lands bit-equal to ``tensor_to_numpy`` of each leaf;
    every byte went through the ring; no tensor is held after ``wait``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ring = pipeline.staging_ring(dev)
    big = ring.slot_bytes * len(ring._events) // 4 + 12345   # > the ring
    g = torch.Generator(device=dev).manual_seed(7)
    state = {"big": torch.randn(big, generator=g, device=dev) * 3.0,
             "m": torch.randn(4097, 33, generator=g, device=dev),
             "i": torch.randint(0, 100, (1001,), generator=g, device=dev,
                                dtype=torch.int32),
             "step": torch.zeros((), dtype=torch.int32, device=dev) + 5}
    want = {k: tensor_to_numpy(v) for k, v in state.items()}
    refs = [weakref.ref(v) for v in state.values()]
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    snap = ChunkedHostSnapshot(state)
    del state
    x = torch.randn(4096, 4096, device=dev)
    for _ in range(50):                  # the default stream stays busy
        x = torch.tanh(x @ x * 1e-3)
    snap.wait()
    torch.cuda.synchronize()
    for k, arr in want.items():
        assert snap.get(k).tobytes() == arr.tobytes(), k
    assert snap.staged_bytes == nbytes
    assert all(r() is None for r in refs)
    assert sorted(ring._free) == list(range(len(ring._events)))
