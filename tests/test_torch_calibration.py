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
