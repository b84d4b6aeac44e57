"""The port's checkpoint calibration (``benchmarks/torch_bench_ckpt.py``)
closes the loop with both packages' cost models: its CPU smoke writes a
``bench_ckpt/3`` artifact that the port's AND the JAX package's
``SimCostModel.from_calibration`` load into equal fields (both are the
same NumPy code: exact equality), and that both packages' bench
validators accept.  The validators' one timing check (the fused encode
under the per-leaf baseline) is held on constructed times: CPU timings of
the plain versions decide nothing, and these tests read no clock.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from repro.sim import SimCostModel as JCost
from repro_torch.sim import SimCostModel as TCost

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _load(name: str):
    """A bench module by file path, without touching ``sys.path``."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("calibration")
    cal = _load("torch_bench_ckpt").smoke(str(tmp / "smoke"), device="cpu")
    return cal, tmp / "smoke" / "BENCH_ckpt_torch.json"


def _timed(cal: dict, fused: float, per_leaf: float) -> dict:
    """``cal`` with every codec's fused and per-leaf encode seconds set."""
    out = json.loads(json.dumps(cal))
    for entry in out["device"].values():
        entry.update(encode_s=fused, per_leaf_encode_s=per_leaf)
    return out


def test_smoke_writes_a_bench_ckpt_v3_artifact(artifact):
    cal, path = artifact
    assert path.exists()
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == "bench_ckpt/3"
    assert set(on_disk["plans"]) == set(_load("torch_bench_ckpt").PLANS)
    for codec in ("lossless", "int8"):
        entry = on_disk["device"][codec]
        assert entry["bytes_on_link"] > 0
        assert entry["pack_s"] >= 0 and entry["encode_s"] > 0
    assert on_disk["device"]["int8"]["link_fraction"] <= 0.26
    assert on_disk == json.loads(json.dumps(cal))


def test_both_cost_models_load_it_into_equal_fields(artifact):
    _, path = artifact
    kw = dict(capacity_eps=1234.0, detect_s=7.0)
    jc, tc = JCost.from_calibration(str(path), **kw), \
        TCost.from_calibration(str(path), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.state_bytes > 0 and tc.device_encode_s > 0
    assert tc.device_link_fraction_int8 < tc.device_link_fraction


def test_both_validators_accept_it(artifact):
    _, path = artifact
    cal = json.loads(path.read_text())
    twin = _load("torch_bench_ckpt")
    twin.validate_calibration(cal, timings=False)
    timed = _timed(cal, fused=0.4, per_leaf=0.5)
    twin.validate_calibration(timed)
    _load("bench_ckpt").validate_calibration(timed)
    bad = dict(cal, delta_fraction=-1.0)
    with pytest.raises(ValueError, match="non-negative"):
        twin.validate_calibration(bad, timings=False)


@pytest.mark.parametrize("per_leaf", [0.4, 0.3], ids=["equal", "faster"])
def test_both_validators_refuse_a_fused_encode_not_under_per_leaf(
        artifact, per_leaf):
    _, path = artifact
    timed = _timed(json.loads(path.read_text()), fused=0.4,
                   per_leaf=per_leaf)
    for mod in ("torch_bench_ckpt", "bench_ckpt"):
        with pytest.raises(ValueError, match="regressed"):
            _load(mod).validate_calibration(timed)
    _load("torch_bench_ckpt").validate_calibration(timed, timings=False)


MEAS_KEYS = {"state_bytes", "snapshot_full_copy_s", "full_write_s",
             "async_blocking_s", "restore_s", "delta_fraction_lossless",
             "delta_fraction_int8"}


def test_bench_checkpoint_measures_through_the_older_classes(tmp_path,
                                                             monkeypatch):
    """``bench_checkpoint`` measures as the reference's does: the copy
    through ``snapshot_to_host``, the async blocking through an
    ``AsyncCheckpointer`` over a bare store, the delta fractions from an
    ``IncrementalCheckpointer``'s byte counters.  Its measurements carry
    the reference's keys, and no ``CheckpointManager`` is made."""
    twin = _load("torch_bench_ckpt")
    calls = []

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapper

    for name in ("snapshot_to_host", "AsyncCheckpointer",
                 "IncrementalCheckpointer"):
        monkeypatch.setattr(twin, name, counted(name, getattr(twin, name)))

    def no_manager(*a, **kw):
        raise AssertionError("bench_checkpoint made a CheckpointManager")

    monkeypatch.setattr(twin, "CheckpointManager", no_manager)
    rows, meas = twin.bench_checkpoint(str(tmp_path / "port"), scale=1,
                                       device="cpu")
    assert calls == ["snapshot_to_host", "AsyncCheckpointer",
                     "IncrementalCheckpointer", "IncrementalCheckpointer"]
    _, ref_meas = _load("bench_ckpt").bench_checkpoint(
        str(tmp_path / "jax"), scale=1)
    assert set(meas) == set(ref_meas) == MEAS_KEYS
    assert [r[0] for r in rows] == [
        "ckpt_snapshot_full_copy", "ckpt_sync_save", "ckpt_async_block",
        "ckpt_restore", "ckpt_incr_lossless", "ckpt_incr_int8"]
    assert all(meas[k] > 0 for k in MEAS_KEYS)
    assert meas["delta_fraction_int8"] < meas["delta_fraction_lossless"] < 1


def test_delta_fractions_equal_the_reference_checkpointer(tmp_path):
    """On the bench's own state and bump, both packages naming zlib, the
    port's delta fractions equal the JAX package's
    ``IncrementalCheckpointer`` ratios exactly: the blobs are the same
    bytes."""
    from repro.checkpoint import CheckpointStore as JStore
    from repro.checkpoint import IncrementalCheckpointer as JInc
    from repro_torch.checkpoint import snapshot_to_host
    from repro_torch.utils import tree_leaves

    twin = _load("torch_bench_ckpt")
    _, meas = twin.bench_checkpoint(str(tmp_path / "port"), scale=1,
                                    device="cpu", codec="zlib")
    state = twin._mk_state(1, "cpu")
    s0, s1 = snapshot_to_host(state), snapshot_to_host(twin._bump(state))
    assert meas["state_bytes"] == sum(a.nbytes for a in tree_leaves(s0))
    for mode in ("lossless", "int8"):
        inc = JInc(JStore(str(tmp_path / f"jax_{mode}"), num_shards=2),
                   full_every=8, mode=mode, codec="zlib")
        inc.save(0, s0)
        inc.save(1, s1)
        ratio = inc.bytes_written_delta / max(inc.bytes_written_full, 1)
        assert meas[f"delta_fraction_{mode}"] == ratio, mode


def test_bench_optimize_plan_chooses_the_reference_plan():
    """The acceptance scenario: the optimizer leaves the full-sync
    baseline, and the port picks the reference's plan, CI and overhead
    exactly (the same NumPy code on the same seeded samples)."""
    port = _load("torch_bench_ckpt").bench_optimize_plan()
    ref = _load("bench_ckpt").bench_optimize_plan()
    assert port.plan.name != port.baseline.plan.name == "full-sync"
    assert port.overhead < port.baseline.overhead
    assert (port.plan.name, port.ci, port.overhead) == \
        (ref.plan.name, ref.ci, ref.overhead)
    assert [(c.plan.name, c.feasible, c.ci, c.objective, c.overhead)
            for c in port.candidates] == \
        [(c.plan.name, c.feasible, c.ci, c.objective, c.overhead)
         for c in ref.candidates]


def test_main_asserts_the_plan_scenario_before_the_calibrated_one(
        tmp_path, monkeypatch):
    """``main`` runs ``bench_optimize_plan`` (and so its assertion) before
    ``bench_calibrated_optimize``, as the reference's does."""
    twin = _load("torch_bench_ckpt")
    order = []
    monkeypatch.setattr(twin, "bench_checkpoint",
                        lambda *a, **kw: ([], {}))
    monkeypatch.setattr(twin, "bench_plans", lambda *a, **kw: ([], {}))
    monkeypatch.setattr(twin, "bench_device_delta", lambda **kw: {})
    fake = {"full_write_s": 1.0, "device": {
        c: {"encode_s": 0.1} for c in ("lossless", "int8")}}
    monkeypatch.setattr(twin, "emit_calibration", lambda *a, **kw: fake)
    monkeypatch.setattr(twin, "bench_optimize_plan",
                        lambda: order.append("plan"))
    monkeypatch.setattr(twin, "bench_calibrated_optimize",
                        lambda cal: order.append("calibrated"))
    assert twin.main(str(tmp_path / "out.json"), device="cpu") is fake
    assert order == ["plan", "calibrated"]
