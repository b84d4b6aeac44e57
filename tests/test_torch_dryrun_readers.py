"""The readers of the port's dry-run record against the JAX package's
readers of its own: E9's ``_arch_costmodel(dryrun_path=...)``
(``benchmarks/torch_bench_khaos_training.py`` against
``bench_khaos_training.py``) on one hand-written record file and on a
missing one, and E7's table (``benchmarks/torch_bench_dryrun.py``
against ``bench_dryrun.py``) on one hand-written record file."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_readers_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _run(cell: dict, **kw) -> dict:
    rec = {"n_devices": 256, "plan": {}, "hbm_gb_per_dev": 12.5,
           "t_compute_s": 0.1234, "t_memory_s": 0.5, "t_collective_s": 0.25,
           "dominant": "memory", "useful_flops_ratio": 0.8125,
           "bound_step_s": 0.5}
    rec.update(cell, **kw)
    return rec


RECORDS = [
    _run({"arch": "yi-6b", "shape": "train_4k", "mesh": "2x16x16"},
         bound_step_s=9.0),
    _run({"arch": "yi-6b", "shape": "train_4k", "mesh": "16x16"},
         bound_step_s=1.375),
    _run({"arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "16x16"},
         bound_step_s=3.0, hbm_gb_per_dev=95.0, dominant="collective"),
    {"arch": "yi-6b", "shape": "long_500k", "mesh": "-",
     "skipped": "long-context needs sub-quadratic attention"},
]


@pytest.fixture
def record(tmp_path):
    path = tmp_path / "dryrun_torch.json"
    recs = [dict(r) for r in RECORDS]
    for r in recs:
        if "skipped" not in r:
            fits = r["hbm_gb_per_dev"] <= 16.0
            r["fits_16gb"], r["fits_80gb"] = fits, r["hbm_gb_per_dev"] <= 80
    path.write_text(json.dumps(recs))
    return path


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "rwkv6-3b"])
@pytest.mark.parametrize("present", [True, False])
def test_e9_reads_the_record_like_the_reference(record, tmp_path, arch,
                                                present):
    mod = _load("torch_bench_khaos_training")
    ref = _load("bench_khaos_training")
    path = str(record if present else tmp_path / "missing.json")
    cfg, cm, bound = mod._arch_costmodel(arch, dryrun_path=path)
    rcfg, rcm, rbound = ref._arch_costmodel(arch, dryrun_path=path)
    assert bound == rbound
    want = {"yi-6b": 1.375, "olmoe-1b-7b": 3.0}.get(arch) if present \
        else None
    assert bound == (want if want is not None else mod.ASSUMED_BOUND_S)
    assert cfg.param_count() == rcfg.param_count()
    assert vars(cm) == vars(rcm)


def test_e7_prints_the_reference_table(record, capsys):
    mod, ref = _load("torch_bench_dryrun"), _load("bench_dryrun")
    runs = mod.bench_dryrun(str(record))
    got = capsys.readouterr().out.splitlines()
    rruns = ref.bench_dryrun(str(record))
    want = capsys.readouterr().out.splitlines()
    assert runs == rruns and len(runs) == 3
    assert got[2:-1] == want[2:-1]          # the header and every row
    assert got[1] == "=== Multi-pod dry-run: 3 traced cells, " \
        "1 documented skips ==="
    assert got[-1] == "fits 80GB H100 HBM: 2/3 cells"
    assert want[-1].startswith("fits 16GB v5e HBM: 2/3 cells")


def test_e7_without_a_record_says_how_to_make_it(tmp_path, capsys):
    mod = _load("torch_bench_dryrun")
    assert mod.bench_dryrun(str(tmp_path / "none.json")) == []
    out = capsys.readouterr().out
    assert "not found" in out and "python -m repro_torch.launch.dryrun" in out
