"""The port's older store-bound checkpoint API (``CheckpointStore``,
``AsyncCheckpointer``, ``IncrementalCheckpointer``,
``MultiLevelCheckpointer``, ``snapshot_to_host``, the ``Checkpointer``
protocol and ``CheckpointManager.restore_candidates``) against the JAX
package's, on the same numpy states made from a seed.

Each of ``tests/test_checkpoint.py``'s tests has a twin here that runs the
same scenario through both packages.  Across packages: delta blobs and
manifests byte for byte, lossless chains restored by the other package bit
for bit, the three byte counters equal, and the restore ranking equal.
Tolerance: none where the reference is exact (every restore, the int8
codec included, must give the reference's bits); the reference's own
tolerances where it states one against the saved state.
"""
import importlib.util
import json
import os
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import AsyncCheckpointer as JAsync
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import CheckpointMeta as JMeta
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import CheckpointStore as JStore
from repro.checkpoint import IncrementalCheckpointer as JInc
from repro.checkpoint import MultiLevelCheckpointer as JMulti
from repro.checkpoint.async_ckpt import snapshot_to_host as j_snapshot
from repro.config import CheckpointPlan as JPlan
from repro.utils import trees as jtrees
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointManager,
                                    CheckpointMeta, CheckpointPlan,
                                    CheckpointPolicy, CheckpointStore,
                                    Checkpointer, IncrementalCheckpointer,
                                    MultiLevelCheckpointer,
                                    snapshot_to_host)
from repro_torch.checkpoint.pipeline import transfer_pool
from repro_torch.utils import (tree_allclose, tree_count,
                               tree_flatten_with_names, tree_leaves,
                               tree_map, tree_zeros_like)

jax.config.update("jax_platform_name", "cpu")


def _state(seed=0, n=1000):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w1": rng.standard_normal((n, 8)).astype(np.float32),
                   "w2": rng.standard_normal((n,)).astype(np.float32)},
        "opt": {"m": {"w1": rng.standard_normal((n, 8)).astype(np.float32),
                      "w2": np.zeros((n,), np.float32)}},
        "step": np.int32(7),
    }


def _plus(s, by):
    """Every float32 leaf + ``by`` (new arrays)."""
    return tree_map(lambda x: x + np.float32(by)
                    if np.asarray(x).dtype == np.float32 else x, s)


def _leaves(tree) -> dict:
    return {n: (l.numpy() if isinstance(l, torch.Tensor) else np.asarray(l))
            for n, l in tree_flatten_with_names(tree)}


def _bit_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape
        and la[k].tobytes() == lb[k].tobytes() for k in la)


def _both(make, tmp_path):
    """(port object, JAX object) of ``make(StoreClass, directory)``, each
    package in its own directory."""
    return (make(CheckpointStore, str(tmp_path / "port")),
            make(JStore, str(tmp_path / "jax")))


# -- store -------------------------------------------------------------------

def test_store_roundtrip(tmp_path):
    s = _state()
    for store in _both(lambda S, d: S(d, num_shards=3), tmp_path):
        store.save(7, s, timestamp=1.0, extra={"cursor": 42})
        restored, extra = store.restore(s)
        assert tree_allclose(s, restored) and _bit_equal(s, restored)
        assert extra["cursor"] == 42
    # each package reads the other's checkpoint
    got_j, _ = JStore(str(tmp_path / "port"), num_shards=1).restore(s)
    got_t, _ = CheckpointStore(str(tmp_path / "jax"), num_shards=1).restore(s)
    assert _bit_equal(got_j, s) and _bit_equal(got_t, s)


def test_store_reshard_restore_across_host_counts(tmp_path):
    """Saved with 8 shards, restored through a store of 2: restore follows
    the manifest, whatever the shard count (elastic rescale)."""
    s = _state(1)
    CheckpointStore(str(tmp_path), num_shards=8).save(3, s)
    restored, _ = CheckpointStore(str(tmp_path), num_shards=2).restore(s)
    assert tree_allclose(s, restored) and _bit_equal(s, restored)
    got_j, _ = JStore(str(tmp_path), num_shards=2).restore(s)
    assert _bit_equal(got_j, s)


def test_store_atomicity_corrupt_shard_falls_back(tmp_path):
    s1, s2 = _state(1), _state(2)
    for store in _both(lambda S, d: S(d, num_shards=2, keep=5), tmp_path):
        store.save(1, s1)
        store.save(2, s2)
        p = os.path.join(store.directory, "step_0000000002",
                         "shard_00000.npz")
        with open(p, "r+b") as f:
            f.seek(10)
            f.write(b"\x00\x00\x00\x00")
        assert store.newest() == 1      # checksum mismatch hides step 2
        restored, _ = store.restore(s1)
        assert _bit_equal(s1, restored)


def test_store_missing_manifest_invisible(tmp_path):
    for store in _both(lambda S, d: S(d, num_shards=1), tmp_path):
        store.save(5, _state())
        os.remove(os.path.join(store.directory, "step_0000000005",
                               "manifest.json"))
        assert store.newest() is None


def test_store_gc_keeps_newest(tmp_path):
    port, ref = _both(lambda S, d: S(d, num_shards=1, keep=2), tmp_path)
    for step in [1, 2, 3, 4]:
        port.save(step, _state(step))
        ref.save(step, _state(step))
    assert port.list_steps() == ref.list_steps() == [3, 4]
    assert port.stats()["saves"] == ref.stats()["saves"] == 4


# -- async -------------------------------------------------------------------

def test_async_checkpointer_writes_and_skips(tmp_path):
    """One save writes; a save while the write is held is skipped.  Both
    packages count the same writes, skips and errors."""
    s = _state()
    stats = []
    for S, A, d in ((CheckpointStore, AsyncCheckpointer, "port"),
                    (JStore, JAsync, "jax")):
        gate = threading.Event()
        store = S(str(tmp_path / d), num_shards=1,
                  fault_hook=lambda path: gate.wait(30))
        ac = A(store, busy_policy="skip")
        assert ac.busy_policy == "skip"
        assert ac.save(1, s)
        assert ac.busy and not ac.save(2, s)      # in flight: skipped
        gate.set()
        ac.wait()
        assert store.newest() == 1 and store.list_steps() == [1]
        assert not ac.errors and not ac.busy
        stats.append(ac.stats())
    assert stats[0] == stats[1] == {"writes": 1, "skips": 1, "errors": 0}


def test_async_snapshot_isolation(tmp_path):
    """Changing a numpy leaf in place after save() does not reach the
    snapshot: numpy leaves are copied in save()."""
    for S, A, d in ((CheckpointStore, AsyncCheckpointer, "port"),
                    (JStore, JAsync, "jax")):
        store = S(str(tmp_path / d), num_shards=1)
        ac = A(store)
        s = {"w": np.ones(10, np.float32)}
        ac.save(1, s)
        s["w"][:] = 999.0
        ac.wait()
        restored, _ = store.restore({"w": np.zeros(10, np.float32)})
        assert np.allclose(restored["w"], 1.0)


@pytest.mark.parametrize("changed", ["first_chunk", "later_chunk"])
def test_async_tensor_changed_in_place_never_reaches_a_checkpoint(
        tmp_path, changed):
    """A tensor changed in place after save() (unlike a JAX array, it can
    be): the order is held, not timed.  The transfer pool's two workers
    are kept busy, so only the snapshot's first chunk (4 MiB, copied in
    save()) is on the host.  A change to a leaf of the first chunk leaves
    the checkpoint with the values of save(); a change to a leaf of a
    later chunk raises SnapshotMutationError in the write, which lands in
    ``errors``, and no manifest is published."""
    rng = np.random.default_rng(0)
    big = rng.standard_normal((1 << 20) + 1).astype(np.float32)   # > 4 MiB
    small = rng.standard_normal(300).astype(np.float32)
    live = {"a": torch.from_numpy(big.copy()),       # chunk 1 (sorted first)
            "b": torch.from_numpy(small.copy())}     # chunk 2
    store = CheckpointStore(str(tmp_path), num_shards=2)
    ac = AsyncCheckpointer(store)
    hold = threading.Event()
    held = [transfer_pool().submit(hold.wait, 30) for _ in range(2)]
    try:
        assert ac.save(1, live)
        live["a" if changed == "first_chunk" else "b"].add_(1.0)
    finally:
        hold.set()
        for f in held:
            f.result()
    ac.wait()
    if changed == "first_chunk":
        assert not ac.errors and store.newest() == 1
        got, _ = store.restore({"a": big, "b": small})
        assert _bit_equal(got, {"a": big, "b": small})
    else:
        assert len(ac.errors) == 1
        assert "SnapshotMutationError" in ac.errors[0] and "'b'" in \
            ac.errors[0]
        assert store.newest() is None and ac.writes == 0
    assert ac.stats()["errors"] == len(ac.errors)


def test_snapshot_to_host_never_aliases():
    s = _state(2)
    live = {"np": s, "t": {"w": torch.from_numpy(s["params"]["w1"].copy())}}
    snap = snapshot_to_host(live)
    want = {k: v.copy() for k, v in _leaves(live).items()}
    s["params"]["w1"][:] = -1.0
    live["t"]["w"].add_(1.0)
    assert _bit_equal(snap, want)
    assert all(isinstance(l, np.ndarray) for l in _leaves(snap).values())
    assert _bit_equal(snapshot_to_host(_state(3)), j_snapshot(_state(3)))


# -- incremental -------------------------------------------------------------

def _inc_pair(tmp_path, **kw):
    return _both(lambda S, d: (IncrementalCheckpointer if S is
                               CheckpointStore else JInc)(
        S(d, num_shards=2), **kw), tmp_path)


@pytest.mark.parametrize("mode", ["lossless", "int8"])
def test_incremental_roundtrip(tmp_path, mode):
    s = _state(3)
    s2 = _plus(s, 0.01)
    got = []
    for inc in _inc_pair(tmp_path, full_every=4, mode=mode):
        inc.save(0, s)
        inc.save(1, s2)
        restored, step = inc.restore(s)
        assert step == 1 and inc.newest_delta() == 1
        got.append(restored)
    restored = got[0]
    if mode == "lossless":
        assert tree_allclose(s2, restored, rtol=1e-6, atol=1e-6)
        assert _bit_equal(s2, restored)
    else:
        for a, b in zip(_leaves(s2).values(), _leaves(restored).values()):
            if a.dtype == np.float32:
                assert np.max(np.abs(a - b)) < 1e-3
    assert _bit_equal(got[0], got[1])     # the reference's bits, int8 too


def test_incremental_delta_smaller_than_full(tmp_path):
    s = _state(4, n=20_000)
    s2 = _plus(s, 1e-4)
    port, ref = _both(lambda S, d: (IncrementalCheckpointer if S is
                                    CheckpointStore else JInc)(
        S(d, num_shards=1), full_every=4, mode="lossless"), tmp_path)
    for inc in (port, ref):
        inc.save(0, s)
        inc.save(1, s2)
        assert inc.bytes_written_delta < 0.5 * inc.bytes_written_full
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("codec", ["auto", "zlib"])
@pytest.mark.parametrize("mode", ["lossless", "int8"])
def test_incremental_delta_blobs_byte_identical_to_jax(tmp_path, mode,
                                                       codec):
    """Full, two deltas, a second full and its delta: every delta file of
    the port equals the JAX package's byte for byte (manifests as JSON),
    and so do the three byte counters."""
    s = _state(5)
    chain = [s, _plus(s, 1e-3), _plus(s, -2.5), _plus(s, 7.0),
             _plus(s, 7.0 + 1e-3)]
    chain[2]["step"] = np.int32(9)           # a changed integer leaf
    port, ref = _inc_pair(tmp_path, full_every=3, mode=mode, codec=codec)
    for step, si in enumerate(chain):
        pt, pj = port.save(step, si, float(step), {"i": step}), \
            ref.save(step, si, float(step), {"i": step})
        assert os.path.basename(pt) == os.path.basename(pj)
    for step in (1, 2, 4):
        sub = f"delta_{step:010d}"
        dt, dj = (os.path.join(str(tmp_path / d), sub)
                  for d in ("port", "jax"))
        files = sorted(os.listdir(dt))
        assert files == sorted(os.listdir(dj))
        assert any(f.endswith(".bin") for f in files)
        for f in files:
            with open(os.path.join(dt, f), "rb") as a, \
                    open(os.path.join(dj, f), "rb") as b:
                if f.endswith(".json"):
                    assert json.load(a) == json.load(b), f
                else:
                    assert a.read() == b.read(), f
    assert port.stats() == ref.stats()
    assert port.bytes_on_link == 5 * sum(a.nbytes for a in
                                         _leaves(s).values())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lossless_chain_restores_across_packages(tmp_path, writer):
    """A chain one package wrote (full, deltas, full, delta) restores bit
    for bit through the other package's IncrementalCheckpointer, and a
    delta of an older chain is not applied to a newer full."""
    s = _state(6)
    chain = [s, _plus(s, 0.5), _plus(s, 0.25), _plus(s, 3.0)]
    store = (CheckpointStore if writer == "port" else JStore)(
        str(tmp_path), num_shards=2)
    inc = (IncrementalCheckpointer if writer == "port" else JInc)(
        store, full_every=3, mode="lossless")
    reader = (JInc(JStore(str(tmp_path), num_shards=2))
              if writer == "port" else
              IncrementalCheckpointer(CheckpointStore(str(tmp_path),
                                                      num_shards=2)))
    for step, si in enumerate(chain[:3]):
        inc.save(step, si)
        got, got_step = reader.restore(s)
        assert got_step == step and _bit_equal(got, si)
    inc.save(3, chain[3])                  # a new full: the chain restarts
    got, got_step = reader.restore(s)
    assert got_step == 3 and _bit_equal(got, chain[3])
    assert reader.newest_delta() == 2       # of the older chain: skipped


# -- multilevel --------------------------------------------------------------

def _multilevel(S, M, d):
    return M(local_store=S(os.path.join(d, "local"), num_shards=1),
             remote_store=S(os.path.join(d, "remote"), num_shards=1),
             local_every=2, remote_every=4)


def test_multilevel_coverage(tmp_path):
    s = _state(5)
    seen = []
    for S, M, d in ((CheckpointStore, MultiLevelCheckpointer, "port"),
                    (JStore, JMulti, "jax")):
        ml = _multilevel(S, M, str(tmp_path / d))
        levels = [ml.save(i, _plus(s, i)) for i in range(5)]
        got = []
        # task failure: memory has the newest (step 4)
        got.append(ml.restore(s, "task"))
        # node failure: memory lost, local has step 4 (4 % 2 == 0)
        ml.on_node_failure()
        got.append(ml.restore(s, "node"))
        # cluster failure: only remote survives (step 4: 4 % 4 == 0)
        got.append(ml.restore(s, "cluster"))
        assert [(st, lv) for _, st, lv in got] == \
            [(4, "memory"), (4, "local"), (4, "remote")]
        assert all(_bit_equal(r, _plus(s, 4)) for r, _, _ in got)
        seen.append((levels, [(st, lv) for _, st, lv in got], ml.stats()))
    assert seen[0] == seen[1]


def test_multilevel_memory_level_aliases_numpy_leaves():
    """The reference keeps ``np.asarray(leaf)`` at the memory level: a
    caller's numpy leaf changed in place after save() changes what a task
    restart returns, in both packages.  A tensor leaf is copied off its
    device, so a change to it does not reach the memory level."""
    got = []
    for M in (MultiLevelCheckpointer, JMulti):
        s = _state(7)
        ml = M()
        assert ml.save(1, s) == ["memory"]
        s["params"]["w2"][:] = 5.0
        restored, step, level = ml.restore(s, "task")
        assert (step, level) == (1, "memory")
        assert np.all(restored["params"]["w2"] == 5.0)
        restored["params"]["w1"][:] = 0.0        # a deep copy comes back
        again, _, _ = ml.restore(s, "task")
        assert np.any(again["params"]["w1"] != 0.0)
        got.append(restored)
    assert _bit_equal(got[0], got[1])
    ml = MultiLevelCheckpointer()
    t = {"w": torch.ones(8)}
    ml.save(1, t)
    t["w"].add_(1.0)
    assert np.all(ml.restore(t, "task")[0]["w"] == 1.0)
    with pytest.raises(FileNotFoundError, match="cluster"):
        ml.restore(t, "cluster")


# -- manager: restore ranking and the protocol --------------------------------

def test_restore_candidates_and_newest_step_equal_reference(tmp_path):
    """The same plan and the same saves and failures on both managers: the
    (step, level) options, best first, and ``newest_step`` are the
    reference's after every event."""
    kw = dict(mode="incremental", full_every=3,
              levels=("memory", "local", "remote"), local_every=1,
              remote_every=4, codec="zlib", replication_factor=0)
    tm = CheckpointManager(str(tmp_path / "port"), CheckpointPlan(**kw),
                           device="cpu")
    jm = JManager(str(tmp_path / "jax"), JPlan(**kw))
    assert tm.restore_candidates() == jm.restore_candidates() == []
    assert tm.newest_step() is None and jm.newest_step() is None
    s = _state(8)
    events = [("save", 0), ("save", 1), ("save", 2), ("fail", "task"),
              ("save", 3), ("save", 4), ("fail", "node"), ("save", 5),
              ("fail", "cluster"), ("save", 6)]
    for what, arg in events:
        for m in (tm, jm):
            if what == "save":
                m.save(arg, _plus(s, arg), float(arg))
            else:
                m.on_failure(arg)
        assert tm.restore_candidates() == jm.restore_candidates(), \
            (what, arg)
        assert tm.newest_step() == jm.newest_step()
    assert tm.restore_candidates()[0] == (6, "memory")


def test_checkpointer_protocol_and_small_names(tmp_path):
    mgr = CheckpointManager(str(tmp_path), CheckpointPlan(), device="cpu")
    assert isinstance(mgr, Checkpointer)
    assert not isinstance(object(), Checkpointer)
    meta, jmeta = CheckpointMeta(12, 3.5, 4, {"k": 1}), \
        JMeta(12, 3.5, 4, {"k": 1})
    assert meta.name == jmeta.name == "step_0000000012"
    for codec in ("lossless", "int8"):
        plan = CheckpointPlan(mode="incremental", delta_codec=codec)
        assert plan.delta_encoding == codec == \
            JPlan(mode="incremental", delta_codec=codec).delta_encoding
        with pytest.raises(AttributeError):
            plan.delta_encoding = "int8"


def test_tree_helpers_match_reference():
    s = _state(9, n=50)
    t = tree_map(lambda x: torch.from_numpy(np.array(x)), s)
    assert tree_count(s) == tree_count(t) == jtrees.tree_count(s) == 901
    assert tree_allclose(s, t) and tree_allclose(t, s)
    assert tree_allclose(s, _plus(s, 1e-7)) == \
        jtrees.tree_allclose(s, _plus(s, 1e-7)) is True
    assert tree_allclose(s, _plus(s, 1e-3)) == \
        jtrees.tree_allclose(s, _plus(s, 1e-3)) is False
    assert not tree_allclose(s, {"params": s["params"]})
    assert tree_allclose(torch.ones(3, dtype=torch.bfloat16), np.ones(3))
    zeros = tree_zeros_like(t)
    want = jax.tree_util.tree_map(np.asarray, jtrees.tree_zeros_like(s))
    assert _bit_equal(zeros, want)
    assert all(isinstance(z, torch.Tensor) for z in tree_leaves(zeros))
    assert _bit_equal(tree_zeros_like(s), want)     # numpy leaves: on the CPU


# -- policy ------------------------------------------------------------------

def test_policy_hot_swap():
    hist = []
    for P in (CheckpointPolicy, JPolicy):
        p = P(60.0)
        p.reset(0.0)
        assert not p.due(30.0)
        assert p.due(61.0)
        p.set_interval(10.0, t=61.0)
        p.mark(61.0)
        assert p.due(71.5)
        assert p.history[-1] == (61.0, 10.0)
        hist.append((p.history, p.next_due(80.0)))
    assert hist[0] == hist[1]


# -- the card's check, rehearsed on the CPU ------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_legacy_check_runs_on_the_cpu(tmp_path):
    """``chip_smoke.legacy_check`` at the bench's smallest scale on the
    CPU: the same checks the card runs (bit-equal lossless, int8 within
    its bound, the multilevel (step, level)s, an in-place change that
    never reaches a published checkpoint), here on CPU tensors."""
    out = _chip_smoke().legacy_check(torch.device("cpu"), tmp_path / "l",
                                     scale=1)
    assert out["multilevel"] == [["task", 4, "memory"],
                                 ["node", 4, "local"],
                                 ["cluster", 4, "remote"]]
    assert out["int8_margin"] <= 0
    assert out["async_outcome"] in (
        "refused (SnapshotMutationError, no manifest)",
        "pre-mutation values restored bit-equal")
    assert out["lossless_stats"]["bytes_on_link"] == 2 * out["state_bytes"]
    assert not (tmp_path / "l").exists()
