"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
repository's root names the cells; each configuration is
``khaosbench/configs/<config>.json``, each traffic mix
``khaosbench/traffic/<traffic>.json``, each metric
``khaosbench/metrics/<metric>.py`` (a module with ``read(record)``) and
each architecture ``khaosbench/models/<model>.py``, the module a
configuration names by its ``"model"`` key (what it owes:
``models/decoder.py``).  Adding a cell, a configuration, a mix, a metric
or a model is adding its files and its entry; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metrics_for(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced; a metric without ``workloads`` belongs to every cell."""
    out = []
    for m in bench["per_layer" if traced else "end_to_end"]:
        if cell_name in m.get("workloads", [cell_name]):
            out.append(m)
    return out


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod      # a dataclass in it looks itself up
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load(here / "metrics" / f"{name}.py",
                 "khaosbench_metric_" + name.replace(".", "_")).read


def model(name: str, here: Path = HERE):
    """The model module ``models/<name>.py``."""
    return _load(here / "models" / f"{name}.py",
                 "khaosbench_model_" + name.replace(".", "_").replace("-", "_"))
