"""Bench twins of the chaos campaigns on the CPU: the proactive-control
drill (``benchmarks/torch_bench_proactive.py``) on the torch lane engine
takes the same decisions as the JAX package's ``bench_proactive.smoke`` on
its NumPy lanes, and the recovery drill (``benchmarks/torch_bench_recovery
.py``) writes a ``bench_sim/3`` artifact into a temporary directory that
its validators accept and that the JAX package's validator accepts too;
the validators refuse a divergent parity section and a worse exhaustive
sweep.
"""
import importlib.util
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _load(name: str):
    """A bench module by file path, without touching ``sys.path``."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def proactive():
    return _load("torch_bench_proactive").smoke(device="cpu")


def test_proactive_drill_matches_reference(proactive):
    ref = _load("bench_proactive").smoke()
    assert proactive["first_proactive_t"] == ref["first_proactive_t"]
    assert proactive["phase_sequence"] == ref["phase_sequence"]
    assert proactive["bp_suppressed"] == ref["bp_suppressed"]
    assert proactive["first_proactive_t"] < 3600.0
    assert proactive["decisions_by_kind"]["proactive"] >= 1


@pytest.fixture(scope="module")
def artifact(proactive, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recovery")
    art = _load("torch_bench_recovery").smoke(str(tmp), proactive=proactive,
                                              device="cpu")
    return art, tmp / "BENCH_sim.json"


def test_recovery_drill_writes_a_valid_bench_sim_artifact(artifact):
    art, path = artifact
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == "bench_sim/3"
    assert on_disk == json.loads(json.dumps(art))
    assert on_disk["e4"]["recovery_s"] == on_disk["e4"]["recovery_s_batched"]
    assert on_disk["device"]["parity"]["divergent_lanes"] == 0
    assert on_disk["grid"]["lanes_compacted"] == 4
    # the JAX package's validator takes the port's artifact as it is
    _load("bench_recovery").validate_sim_artifact(on_disk)


@pytest.mark.parametrize("bad", ["divergent", "worse_sweep", "no_reprofile"])
def test_validators_refuse_a_broken_artifact(artifact, bad):
    mod = _load("torch_bench_recovery")
    art = json.loads(json.dumps(artifact[0]))
    if bad == "divergent":
        art["device"]["parity"]["divergent_lanes"] = 1
        match = "diverged"
    elif bad == "worse_sweep":
        art["device"]["sweep"] = {"replayed_topk": 3,
                                  "replayed_exhaustive": 13,
                                  "topk_objective": 0.9,
                                  "exhaustive_objective": 1.0}
        match = "WORSE"
    else:
        art["proactive"]["phase_sequence"] = ["steady_state", "profiled",
                                              "optimizing"]
        match = "reprofile"
    with pytest.raises(ValueError, match=match):
        mod.validate_sim_artifact(art)
