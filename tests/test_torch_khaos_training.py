"""E9 of the port (``benchmarks/torch_bench_khaos_training.py``) against
the JAX package's ``bench_khaos_training.py`` at a shortened day (the JAX
module's ``DAY`` set through ``monkeypatch``; the twin's ``day=``): per
configuration goodput and recovery violation, recoveries, checkpoint
counts, reconfigurations and the controller's decisions, bit for bit, on
the NumPy lanes and on the torch lane engine (CPU)."""
import importlib.util
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
DAY = 21_600.0


def _load(name: str, register: bool = False):
    spec = importlib.util.spec_from_file_location(
        name if register else f"_bench_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    if register:
        sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    """The reference's day, with its campaign and supervision captured."""
    ref = _load("bench_khaos_training")
    seen = {}

    class Campaign(ref.BatchedCampaign):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["camp"] = self

    class Runtime(ref.KhaosRuntime):
        def drive_campaign(self, *a, **kw):
            seen["sup"] = super().drive_campaign(*a, **kw)
            seen["phases"] = self.phase_sequence()
            return seen["sup"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "DAY", DAY)
        mp.setattr(ref, "BatchedCampaign", Campaign)
        mp.setattr(ref, "KhaosRuntime", Runtime)
        seen["results"] = ref.bench_khaos_training()
    return seen


@pytest.mark.parametrize("engine,device", [("numpy", None),
                                           ("device", "cpu")])
def test_e9_matches_the_reference(reference, engine, device):
    mod = _load("torch_bench_khaos_training")
    got = mod.bench_khaos_training(day=DAY, engine=engine, device=device)
    camp, sup = reference["camp"], reference["sup"]
    names = list(got["results"])
    assert got["results"] == reference["results"]
    assert names[0] == "Khaos" and len(names) == 4
    for i, name in enumerate(names):
        assert got["recoveries"][name] == \
            [r["recovery_s"] for r in camp.recoveries[i]]
        assert got["ckpts"][name] == int(camp.ckpt_count[i])
    assert got["reconfigurations"]["Khaos"] == len(sup.reconfigurations(0))
    assert got["decisions_by_kind"] == sup.summary()["decisions_by_kind"]
    assert got["phases"] == reference["phases"] == \
        ["steady_state", "profiled", "optimizing"]
    assert got["failures"] == len(camp.lanes[0].failures) >= 1


def test_e9_uses_the_reference_default_step_bound():
    """The twin reads no dry-run record: its bound is the reference's
    default, and its cost model is the reference's at that bound."""
    mod = _load("torch_bench_khaos_training")
    ref = _load("bench_khaos_training")
    _, cm, bound = mod._arch_costmodel()
    _, rcm, rbound = ref._arch_costmodel(dryrun_path="/nonexistent.json")
    assert bound == rbound == mod.ASSUMED_BOUND_S == 2.0
    for f in ("capacity_eps", "base_latency_s", "ckpt_duration_s",
              "restore_s"):
        assert getattr(cm, f) == getattr(rcm, f), f
