"""A new cell, configuration, traffic mix or metric is found by its name:
adding its file and its entry is enough, with no edit of the harness."""
import json
import shutil
from pathlib import Path

from khaosbench import spec

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "khaosbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "khaosbench" / sub, here / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "khaosbench/configs/yi-6b.2l.json").read_text())
    cfg["num_hidden_layers"] = 1
    (here / "configs" / "yi-6b.1l.json").write_text(json.dumps(cfg))
    (here / "traffic" / "burst.json").write_text(json.dumps(
        {"source": "poisson", "rate_events_per_s": 3.0, "ci_s": 1.0,
         "plan": {}, "failures": [], "failure_kind": "task"}))
    (here / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.step_walls))\n")
    bench["configs"].append({"name": "yi-6b.1l", "source": "https://x",
                             "file": "khaosbench/configs/yi-6b.1l.json",
                             "reduced": ["num_hidden_layers"], "why": "y"})
    bench["workloads"].append({"name": "yi6b1.burst", "config": "yi-6b.1l",
                               "traffic": "burst", "chips": 1, "why": "z"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "runtime.trainer",
                               "moves": "setup_s",
                               "workloads": ["yi6b1.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(tmp_path)
    cell = spec.cell(loaded, "yi6b1.burst")
    assert spec.config(loaded, cell["config"], tmp_path)[
        "num_hidden_layers"] == 1
    assert spec.traffic(cell["traffic"], here)["rate_events_per_s"] == 3.0
    names = [m["name"] for m in spec.metrics_for(loaded, "yi6b1.burst", True)]
    assert names == ["steps_seen"]

    class Rec:
        step_walls = [0.1, 0.2]
    assert spec.reader("steps_seen", here)(Rec()) == 2.0
    # a cell's untraced metrics are the end-to-end ones that name it or all
    e2e = [m["name"] for m in spec.metrics_for(loaded, "yi6b1.burst", False)]
    assert e2e == ["setup_s"]
