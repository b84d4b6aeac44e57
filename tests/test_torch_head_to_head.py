"""The full E10 of the port (``torch_bench_proactive.head_to_head``) against
the JAX package's ``bench_proactive.head_to_head`` at the reference's
period (14,400 s): every key of the section but the port's host wall time
equal, on the NumPy lanes and on the torch lane engine (CPU); the section
passes both packages' ``_validate_proactive`` (the strict proactive win)."""
import importlib.util
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
PERIOD = 14_400.0


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    return _load("bench_proactive").head_to_head(period=PERIOD,
                                                 verbose=False)


def _exact(d: dict) -> str:
    return json.dumps({k: v for k, v in d.items() if k != "wall_s"},
                      sort_keys=True)


@pytest.mark.parametrize("engine,device", [("numpy", None),
                                           ("device", "cpu")])
def test_head_to_head_matches_the_reference(reference, engine, device):
    got = _load("torch_bench_proactive").head_to_head(
        period=PERIOD, verbose=False, engine=engine, device=device)
    assert got["wall_s"] > 0
    assert _exact(got) == _exact(reference)
    _load("torch_bench_recovery")._validate_proactive(got)
    _load("bench_recovery")._validate_proactive(got)
    qos = got["qos_violation_s"]
    assert qos["Khaos-proactive"] < qos["Khaos-reactive"]
    assert got["proactive_decisions"] >= 1 and got["lead_s"] > 0


def test_validator_refuses_a_reactive_win(reference):
    bad = json.loads(json.dumps(reference))
    bad["qos_violation_s"]["Khaos-proactive"] = \
        bad["qos_violation_s"]["Khaos-reactive"]
    with pytest.raises(ValueError, match="strictly beat"):
        _load("torch_bench_recovery")._validate_proactive(bad)
