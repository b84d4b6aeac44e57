"""BENCHMARK.json against the benchmark's contract: keys, names and
units, the files it names, and the bounds and lengths it sets."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()
    assert (ROOT / ".gitignore").read_text().count("chiprun_out/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        published, run = cfg["reduced"][key]
        assert cfg[key] == run != published
        assert not re.search(r"(_dim|_rank|size|heads|experts_per_tok)$",
                             key), "a width may not be reduced"
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in BENCH["configs"]}
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and _line(w["why"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (ROOT / "khaosbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert four <= max(1, len(names) // 4)


def test_metrics_names_units_and_bounds():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] == 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "khaosbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    def has(m):
        return cell in m.get("workloads", [cell])
    e2e = [m["name"] for m in BENCH["end_to_end"] if has(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(has(m) for m in BENCH["per_layer"])
