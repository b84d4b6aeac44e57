"""The port's checkpoint plane against the JAX package's, on the same
numpy states made from a seed.

Checkpoints cross frameworks in both directions through the two
``CheckpointManager``s sharing one directory: full snapshots, deltas under
host/device placement x lossless/int8 codecs (device placement writes the
v3 flat manifest), and a degraded restore under k=1 peer replication after
``kill_host``.  Tolerance: none — restores must agree BIT FOR BIT (the
int8 codec is lossy but deterministic, so both frameworks must decode the
same bits), and the port's delta blobs must equal the JAX package's byte
for byte.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.config import CheckpointPlan as JaxPlan
from repro_torch.checkpoint import (CheckpointManager, CheckpointPlan,
                                    DeltaLeafSource, DeviceDeltaBase,
                                    SnapshotMutationError,
                                    read_delta_manifest)
from repro_torch.checkpoint.pipeline import HostLanding
from repro_torch.utils.trees import tree_flatten_with_names

jax.config.update("jax_platform_name", "cpu")

GROUP = 1024


def _np_pair(seed: int = 0):
    """A train-state-like pair (base, next): f32 params and moments of
    awkward sizes, an unchanged leaf, a residual-bearing leaf, an int32
    step and a host-resident leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    s0 = {"params": {"w": f(3000), "b": f(5, 7), "frozen": f(256)},
          "opt": {"m": f(3000), "v": np.abs(f(3000))},
          "host": f(65), "step": np.int32(4)}
    s1 = {"params": {"w": s0["params"]["w"] + np.float32(1e-3),
                     "b": s0["params"]["b"] * np.float32(-3.0),
                     "frozen": s0["params"]["frozen"].copy()},
          "opt": {"m": s0["opt"]["m"] * np.float32(0.9) + np.float32(0.01),
                  "v": s0["opt"]["v"] + np.float32(1e-4)},
          "host": s0["host"] + np.float32(0.5), "step": np.int32(5)}
    return s0, s1


def _to_jax(s):
    out = {k: (_to_jax(v) if isinstance(v, dict) else
               (v.copy() if k == "host" else jnp.asarray(v)))
           for k, v in s.items()}
    return out


def _to_port(s):
    return {k: (_to_port(v) if isinstance(v, dict) else
                (v.copy() if k == "host" else torch.from_numpy(np.array(v))))
            for k, v in s.items()}


def _leaves(tree) -> dict:
    out = {}
    for n, l in tree_flatten_with_names(tree):
        a = l.numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
        out[n] = a
    return out


def _bit_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape
        and la[k].tobytes() == lb[k].tobytes() for k in la)


def _plans(mode, placement, codec, **kw):
    args = dict(mode=mode, full_every=4, encode_placement=placement,
                delta_codec=codec, codec="zlib", **kw)
    return CheckpointPlan(**args), JaxPlan(**args)


def _managers(d, tplan, jplan):
    return CheckpointManager(d, tplan, device="cpu"), JaxManager(d, jplan)


VARIANTS = [("full", "host", "lossless"),
            ("incremental", "host", "lossless"),
            ("incremental", "host", "int8"),
            ("incremental", "device", "lossless"),
            ("incremental", "device", "int8")]


@pytest.mark.parametrize("mode,placement,codec", VARIANTS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_framework_restore_bit_exact(tmp_path, mode, placement, codec,
                                           writer):
    s0, s1 = _np_pair(1)
    tplan, jplan = _plans(mode, placement, codec)
    tm, jm = _managers(str(tmp_path), tplan, jplan)
    w, conv = (tm, _to_port) if writer == "port" else (jm, _to_jax)
    w.save(0, conv(s0), 0.0, {"t": 0.0})
    rep = w.save(1, conv(s1), 1.0, {"t": 1.0})
    assert rep.kind == ("full" if mode == "full" else "delta")
    if mode == "incremental":
        meta = read_delta_manifest(str(tmp_path / "local"), 1)
        assert ("flat" in meta) == (placement == "device")   # v3 flat
    got_t = CheckpointManager(str(tmp_path), tplan, device="cpu").restore(
        _to_port(s0), "node")
    got_j = JaxManager(str(tmp_path), jplan).restore(_to_jax(s0), "node")
    assert got_t.step == got_j.step == 1
    assert got_t.extra == got_j.extra and got_t.extra["t"] == 1.0
    assert _bit_equal(got_t.state, got_j.state)
    if codec == "lossless":
        assert _bit_equal(got_t.state, s1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_degraded_restore_after_kill_host_crosses_frameworks(tmp_path,
                                                             writer):
    """k=1 ring replication: the full's shards of a dead host come back
    from their peer replicas, the delta on top, bit-exact."""
    s0, s1 = _np_pair(2)
    tplan, jplan = _plans("incremental", "device", "lossless",
                          num_shards=4, replication_factor=1)
    tm, jm = _managers(str(tmp_path), tplan, jplan)
    w, conv = (tm, _to_port) if writer == "port" else (jm, _to_jax)
    w.save(0, conv(s0), 0.0)
    w.save(1, conv(s1), 1.0)
    # the OTHER framework's manager suffers the node loss and restores
    r = JaxManager(str(tmp_path), jplan) if writer == "port" else \
        CheckpointManager(str(tmp_path), tplan, device="cpu")
    r.on_failure("node", host=1)
    got = r.restore(_to_jax(s0) if writer == "port" else _to_port(s0),
                    "node")
    assert got.degraded and got.restored_bytes > 0
    assert got.kind == "full+delta" and got.step == 1
    assert _bit_equal(got.state, s1)


@pytest.mark.parametrize("placement,codec", [("device", "lossless"),
                                             ("device", "int8"),
                                             ("host", "lossless"),
                                             ("host", "int8")])
def test_delta_blobs_byte_identical_to_jax(tmp_path, placement, codec):
    s0, s1 = _np_pair(3)
    tplan, jplan = _plans("incremental", placement, codec)
    dt, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    tm = CheckpointManager(dt, tplan, device="cpu")
    jm = JaxManager(dj, jplan)
    for step, s in enumerate((s0, s1)):
        tm.save(step, _to_port(s), float(step), {"t": step})
        jm.save(step, _to_jax(s), float(step), {"t": step})
    sub = os.path.join("local", "delta_0000000001")
    ft = sorted(os.listdir(os.path.join(dt, sub)))
    fj = sorted(os.listdir(os.path.join(dj, sub)))
    assert ft == fj and any(f.endswith(".bin") for f in ft)
    for f in ft:
        with open(os.path.join(dt, sub, f), "rb") as a, \
                open(os.path.join(dj, sub, f), "rb") as b:
            if f.endswith(".json"):
                assert json.load(a) == json.load(b), f
            else:
                assert a.read() == b.read(), f


def test_in_place_mutation_after_save_raises(tmp_path):
    """The port's train step is functional; a caller that mutates a held
    tensor in place after save() gets an error, not a silently corrupt
    checkpoint.  Here the memory level parks the device delta source,
    whose raw leaves are copied only when a task restart reads them."""
    s0, s1 = _np_pair(4)
    plan = CheckpointPlan(mode="incremental", full_every=4,
                          encode_placement="device",
                          levels=("memory", "local"), codec="zlib")
    mgr = CheckpointManager(str(tmp_path), plan, device="cpu")
    mgr.save(0, _to_port(s0), 0.0)
    live = _to_port(s1)
    assert mgr.save(1, live, 1.0).kind == "delta"
    live["params"]["w"].add_(1.0)             # in place, after save()
    with pytest.raises(SnapshotMutationError, match="params/w"):
        mgr.restore(_to_port(s0), "task")


def test_delta_source_guards_lazily_copied_leaves():
    s0, s1 = _np_pair(5)
    live = _to_port(s1)
    src = DeltaLeafSource(live, DeviceDeltaBase(_to_port(s0)))
    live["step"] += 1                          # not packed: copied lazily
    with pytest.raises(SnapshotMutationError, match="step"):
        src.get("step")
    assert src.flat_payload()["d"].dtype == np.float32


def test_host_landing_lays_planes_end_to_end_and_grows():
    landing = HostLanding()
    d, r = landing.take([(3000, np.float32), (3000, np.uint32)], pin=False)
    assert (d.dtype, r.dtype, d.size, r.size) == \
        (np.float32, np.uint32, 3000, 3000)
    base = landing.buf.ctypes.data
    assert [a.ctypes.data - base for a in (d, r)] == [0, 12032]  # 64-B aligned
    buf = landing.buf
    landing.take([(100, np.int8), (1, np.float32)], pin=False)
    assert landing.buf is buf                     # fits: reused
    landing.take([(10 ** 5, np.float32)], pin=False)
    assert landing.buf is not buf and landing.generation == 3
    landing.release()
    assert landing.buf is None


def test_device_deltas_reuse_the_managers_landing(tmp_path):
    """Every device-delta trigger's payload lands in the manager's one
    HostLanding; the deltas still restore bit for bit."""
    s0, s1 = _np_pair(6)
    s2 = {**s1, "params": {**s1["params"],
                           "w": s1["params"]["w"] * np.float32(1.5)},
          "step": np.int32(6)}
    plan = CheckpointPlan(mode="incremental", full_every=4,
                          encode_placement="device", codec="zlib")
    mgr = CheckpointManager(str(tmp_path), plan, device="cpu")
    mgr.save(0, _to_port(s0), 0.0, {"t": 0.0})
    assert mgr.save(1, _to_port(s1), 1.0, {"t": 1.0}).kind == "delta"
    buf = mgr._landing.buf
    assert mgr.save(2, _to_port(s2), 2.0, {"t": 2.0}).kind == "delta"
    assert mgr._landing.buf is buf and mgr._landing.generation == 2
    mgr.on_failure("task")                  # the restore gets the memory
    assert mgr._landing.buf is None
    got = CheckpointManager(str(tmp_path), plan, device="cpu").restore(
        _to_port(s0), "node")
    assert got.step == 2 and _bit_equal(got.state, s2)


def test_a_payload_handed_to_a_later_trigger_raises():
    s0, s1 = _np_pair(7)
    base = DeviceDeltaBase(_to_port(s0))
    landing = HostLanding()
    first = DeltaLeafSource(_to_port(s1), base, landing=landing)
    second = DeltaLeafSource(_to_port(s1), base, landing=landing)
    assert second.flat_payload()["d"].dtype == np.float32
    with pytest.raises(SnapshotMutationError, match="later trigger"):
        first.flat_payload()


def test_manager_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(str(tmp_path), CheckpointPlan())
