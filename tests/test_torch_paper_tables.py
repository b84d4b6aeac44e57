"""E1/E2 of the port (``benchmarks/torch_bench_tables.py`` over
``benchmarks/torch_common.py``) against the JAX package's
``bench_tables.py`` over ``common.py``: the paper's Tables II/III at a
shortened day (21,600 s) and one repetition, every ``RunResult`` field and
the error analysis equal bit for bit; and Phase 2 (``make_khaos``) on the
torch lane engine (CPU) equal to the NumPy lanes' grids and fitted QoS
models."""
import dataclasses
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
DURATION = 21_600.0


def _port(name: str):
    """A port bench by path, registered under its own name (as its
    siblings load one another)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name,
                                                      BENCH / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _reference(monkeypatch, exp: str) -> tuple:
    """The schedule, cost model and seed the JAX package's bench hands its
    ``run_experiment`` (captured, not run), and its ``common`` module."""
    monkeypatch.syspath_prepend(str(ROOT))
    tables = importlib.import_module("benchmarks.bench_tables")
    common = importlib.import_module("benchmarks.common")
    seen = {}

    def capture(name, sched, cost, duration, seed, repeats):
        seen.update(name=name, sched=sched, cost=cost, duration=duration,
                    seed=seed)
        return [], {}
    monkeypatch.setattr(tables, "run_experiment", capture)
    monkeypatch.setattr(tables, "print_table", lambda *a: None)
    getattr(tables, {"iot": "bench_iot_vehicles", "ysb": "bench_ysb"}[exp])(
        repeats=1)
    return seen, common


def _port_setup(exp: str):
    tables = _port("torch_bench_tables")
    return (tables.iot_setup if exp == "iot" else tables.ysb_setup)()


@pytest.mark.parametrize("exp", ["iot", "ysb"])
def test_tables_match_the_reference(monkeypatch, exp):
    seen, rcommon = _reference(monkeypatch, exp)
    sched, cost, seed = _port_setup(exp)
    assert seed == seen["seed"] and seen["duration"] == 86_400.0
    assert dataclasses.asdict(cost) == dataclasses.asdict(seen["cost"])
    ts = np.linspace(0.0, 2 * 86_400.0, 977)
    assert [sched(t) for t in ts] == [seen["sched"](t) for t in ts]

    want_rows, want_err = rcommon.run_experiment(
        seen["name"], seen["sched"], seen["cost"], duration=DURATION,
        seed=seed, repeats=1)
    common = _port("torch_common")
    rows, err = common.run_experiment(seen["name"], sched, cost,
                                      duration=DURATION, seed=seed,
                                      repeats=1, engine="device",
                                      device="cpu")
    assert [dataclasses.asdict(r) for r in rows] == \
        [dataclasses.asdict(r) for r in want_rows]
    assert err == want_err
    assert [r.name for r in rows] == ["Khaos", "10s", "30s", "60s", "90s",
                                      "120s"]
    assert all(r.recoveries for r in rows)


@pytest.mark.parametrize("exp", ["iot", "ysb"])
def test_make_khaos_device_engine_equals_numpy_lanes(exp):
    from repro_torch.data.stream import record_workload

    common = _port("torch_common")
    sched, cost, seed = _port_setup(exp)
    recording = record_workload(sched, duration=14_400.0, seed=seed)
    ctl_d, prof_d = common.make_khaos(recording, cost, seed,
                                      engine="device", device="cpu")
    ctl_n, prof_n = common.make_khaos(recording, cost, seed, engine="numpy")
    for f in ("ci_values", "failure_rates", "latencies", "recoveries"):
        a, b = getattr(prof_d, f), getattr(prof_n, f)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert prof_d.recoveries.shape == (5, 6)
    for m in ("m_l", "m_r"):
        for f in ("_mu", "_sd", "_beta"):
            a = getattr(getattr(ctl_d, m), f)
            b = getattr(getattr(ctl_n, m), f)
            assert a.tobytes() == b.tobytes(), (m, f)
    assert ctl_d.cfg == ctl_n.cfg
