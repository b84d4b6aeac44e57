"""The full E4 of the port (``benchmarks/torch_bench_recovery.py``): the
432-lane scenario grid equal to the JAX package's ``bench_recovery`` lane
for lane and in ``bench_grid``'s non-timing keys, the grid on the torch
lane engine (CPU) equal to the NumPy lanes per lane, the eight-CI sweep's
lanes equal to the scalar oracle and to the reference's rows, and
``bench_recovery_vs_ci``'s ``bench_sim/3`` artifact (with the smoke
drills' E10/E12 sections standing in) accepted by both packages'
validators."""
import importlib.util
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
TIMING = ("wall_s", "lane_ticks_per_s")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mods():
    return _load("torch_bench_recovery"), _load("bench_recovery")


def test_grid_lanes_match_the_reference(mods):
    port, ref = mods
    got, want = port.grid_lanes(port._e4_cost()), ref.grid_lanes(
        ref._e4_cost())
    assert len(got) == len(want) == 432
    assert port.GRID_HORIZON == ref.GRID_HORIZON
    assert [n for n, _ in port.GRID_PLANS] == [n for n, _ in ref.GRID_PLANS]
    assert port.GRID_KINDS == ref.GRID_KINDS
    for a, b in zip(got, want):
        assert a.ci_s == b.ci_s and a.failures == b.failures
        assert a.tag == b.tag and a.t0 == b.t0
        assert a.rates.tobytes() == b.rates.tobytes()
        assert repr(a.plan) == repr(b.plan)


def test_bench_grid_matches_the_reference(mods):
    port, ref = mods
    got = port.bench_grid(port._e4_cost(), repeats=1, device="cpu")
    want = ref.bench_grid(ref._e4_cost(), repeats=1)
    assert got["wall_s"] > 0 and got["lane_ticks_per_s"] > 0
    strip = lambda d: {k: v for k, v in d.items() if k not in TIMING}  # noqa: E731
    assert strip(got) == strip(want)
    assert got["lanes_compacted"] > 0 and 0 < got["recovered_fraction"] <= 1


def test_grid_device_engine_equals_numpy_lane_for_lane(mods):
    port, ref = mods
    cost = port._e4_cost()
    lanes = port.grid_lanes(cost)
    dev = port.grid_campaign(cost, lanes, device="cpu")
    np_ = port.grid_campaign(cost, lanes, engine="numpy")
    want = ref.BatchedCampaign(ref._e4_cost(), ref.grid_lanes(ref._e4_cost()),
                               record_history=False, early_exit=True).run()
    assert dev.recoveries == np_.recoveries == want.recoveries
    for f in ("ticks_run", "compactions", "lanes_compacted"):
        assert getattr(dev, f) == getattr(np_, f) == getattr(want, f), f
    assert sum(1 for r in dev.recoveries if r) > 400


def test_e4_sweep_lanes_equal_the_scalar_oracle(mods):
    port, ref = mods
    cost = port._e4_cost()
    scalar, _, ticks = port.scalar_e4(cost)
    batched, _ = port.batched_e4(cost, device="cpu")
    want, _, want_ticks = ref.scalar_e4(ref._e4_cost())
    assert scalar == batched == want and ticks == want_ticks
    assert [r[0] for r in scalar] == list(port.E4_CIS)


def test_bench_recovery_vs_ci_writes_a_valid_artifact(mods, tmp_path):
    port, ref = mods
    # the smoke drills' sections stand in for the full E10 and E12
    proactive = _load("torch_bench_proactive").smoke(device="cpu")
    device_sec = _load("torch_bench_campaign").device_section(smoke=True,
                                                              device="cpu")
    path = tmp_path / "BENCH_sim_torch.json"
    art = port.bench_recovery_vs_ci(str(path), proactive=proactive,
                                    device_sec=device_sec, device="cpu")
    on_disk = json.loads(path.read_text())
    assert on_disk == json.loads(json.dumps(art))
    assert on_disk["schema"] == "bench_sim/3"
    assert on_disk["grid"]["lanes"] == 432
    assert on_disk["e4"]["recovery_s"] == on_disk["e4"]["recovery_s_batched"]
    assert on_disk["e4"]["latency_ms"] == on_disk["e4"]["latency_ms_batched"]
    port.validate_sim_artifact(on_disk)
    ref.validate_sim_artifact(on_disk)
    assert port.bench_recovery_vs_ci.__defaults__[0] == "BENCH_sim_torch.json"
