"""Bench twins of the port's control plane on the CPU: the runtime drill
(``benchmarks/torch_bench_runtime.py``: phases 1 -> 2 -> 3 over a 4-lane
campaign on the torch lane engine and a micro trainer's plan switch) and
``torch_bench_ckpt.bench_calibrated_optimize`` against the JAX package's
``bench_ckpt.bench_calibrated_optimize`` on one measured calibration.
"""
import importlib.util
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"

#: the calibration ``chip_smoke.py`` measured on an H100 (2-layer yi-6b
#: width train state; plans omitted, the cost model does not read them)
CALIBRATION = {
    "schema": "bench_ckpt/3", "state_bytes": 10444062724,
    "full_write_s": 27.20688843100001, "restore_s": 71.43035221299999,
    "delta_fraction": 0.7040415721920497,
    "delta_int8_fraction": 0.0011523929102791263,
    "delta_encode_s_per_byte": 6.127883534530074e-11,
    "snapshot_full_copy_s": 0.004376117999981943,
    "async_blocking_s": 0.0032494189999852097,
    "device": {
        "lossless": {"pack_s": 0.007319359000007353,
                     "encode_s": 0.4004025329999905,
                     "per_leaf_encode_s": 0.44726991400000315,
                     "bytes_on_link": 10444062720,
                     "link_fraction": 0.9999999996170073},
        "int8": {"pack_s": 0.007319359000007353,
                 "encode_s": 0.057633983999991756,
                 "per_leaf_encode_s": 0.0698233299999913,
                 "bytes_on_link": 2621214960,
                 "link_fraction": 0.2509765624038778}}}


def _load(name: str):
    """A bench module by file path, without touching ``sys.path``."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_runtime_drill_runs_on_the_cpu(tmp_path):
    out = _load("torch_bench_runtime").smoke(str(tmp_path / "runtime"),
                                             device="cpu")
    assert out["phases"] == ["steady_state", "profiled", "optimizing"]
    assert out["campaign"]["lanes"] == 4
    assert sum(out["campaign"]["decisions_by_kind"].values()) >= 4 * 19
    assert out["device_chunks"] >= 20          # one chunk per period at least
    assert out["trainer"]["plan_switches"] == 1
    assert out["trainer"]["checkpoints"] >= 2  # the savepoint and a save
    assert not (tmp_path / "runtime").exists()


def test_runtime_drill_refuses_a_phase_out_of_order(tmp_path, monkeypatch):
    """The drill's own gate fires: with the phase check removed from the
    runtime, Phase 2 before Phase 1 is reported."""
    mod = _load("torch_bench_runtime")
    from repro_torch.core import KhaosRuntime

    def unchecked(self, deployment, **kw):
        return None
    monkeypatch.setattr(KhaosRuntime, "run_profiling", unchecked)
    with pytest.raises(ValueError, match="Phase 2 ran before Phase 1"):
        mod.smoke(str(tmp_path / "runtime"), device="cpu")


def test_calibrated_optimize_matches_reference():
    port = _load("torch_bench_ckpt").bench_calibrated_optimize(CALIBRATION)
    ref = _load("bench_ckpt").bench_calibrated_optimize(CALIBRATION)
    assert (port.plan.name if port.plan else None) == \
        (ref.plan.name if ref.plan else None)
    assert (port.feasible, port.ci, port.objective, port.overhead) == \
        (ref.feasible, ref.ci, ref.objective, ref.overhead)
    assert [c.plan.name for c in port.candidates] == \
        [c.plan.name for c in ref.candidates]
    for a, b in zip(port.candidates, ref.candidates):
        assert (a.ci, a.feasible, a.objective, a.overhead) == \
            (b.ci, b.feasible, b.objective, b.overhead)
