"""The full mode of ``benchmarks/torch_run.py`` (``run.py`` without
``--smoke``): its sections in ``run.py``'s order, with stubs; ``--quick``;
exit code 1 on a failed section; the E7 line; and, in a subprocess, the
full mode's modules and a reduced run of its sections load neither
``jax`` nor the JAX package ``repro``."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RUN = ROOT / "benchmarks" / "torch_run.py"
#: run.py's full mode, in its order, as (module, function) of the port
ORDER = [("torch_bench_tables", "bench_iot_vehicles"),
         ("torch_bench_tables", "bench_ysb"),
         ("torch_bench_proactive", "main"),
         ("torch_bench_campaign", "main"),
         ("torch_bench_recovery", "main"),
         ("torch_bench_replication", "main"),
         ("torch_bench_fleet", "main"),
         ("torch_bench_khaos_training", "main"),
         ("torch_bench_ckpt", "main"),
         ("torch_bench_kernels", "main")]


def _runner():
    spec = importlib.util.spec_from_file_location("_torch_run_full", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stubbed(monkeypatch, fail: str = ""):
    """The runner with every section module replaced by a recorder; the
    section ``fail`` raises a ``ValueError``."""
    mod = _runner()
    calls = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def call(*a, **kw):
                calls.append((self.name, fn, a, kw))
                if f"{self.name}.{fn}" == fail:
                    raise ValueError(f"{fn} gate failed")
                return {"section": (self.name, fn)}
            return call
    monkeypatch.setattr(mod, "_sibling", Fake)
    return mod, calls


def test_full_mode_runs_run_py_sections_in_order(monkeypatch, capsys):
    mod, calls = _stubbed(monkeypatch)
    mod.main(["--device", "cpu"])
    assert [(n, f) for n, f, _, _ in calls] == ORDER
    kw = {c[0]: c[3] for c in calls}
    e4 = kw["torch_bench_recovery"]
    assert e4["proactive"] == {"section": ("torch_bench_proactive", "main")}
    assert e4["device_sec"] == {"section": ("torch_bench_campaign", "main")}
    assert all(c[3].get("device") == "cpu" for c in calls[:-1])
    assert calls[-1][2] == (["--device", "cpu"],)
    out = capsys.readouterr().out
    assert "full run done in" in out


@pytest.mark.parametrize("argv,repeats", [([], 3), (["--quick"], 1)])
def test_quick_gives_e1_e2_one_repetition(monkeypatch, argv, repeats):
    mod, calls = _stubbed(monkeypatch)
    mod.main(argv)
    assert [c[3]["repeats"] for c in calls[:2]] == [repeats, repeats]
    assert calls[0][3]["device"] is None


def test_a_failing_section_exits_1(monkeypatch, capsys):
    mod, calls = _stubbed(monkeypatch, fail="torch_bench_proactive.main")
    with pytest.raises(SystemExit) as e:
        mod.main(["--quick"])
    assert e.value.code == 1
    assert "FULL RUN FAILED: main gate failed" in capsys.readouterr().err
    assert [(n, f) for n, f, _, _ in calls] == ORDER[:3]


def test_the_e7_line_is_printed(monkeypatch, capsys):
    mod, calls = _stubbed(monkeypatch)
    mod.main(["--quick"])
    lines = capsys.readouterr().out.splitlines()
    e7 = [ln for ln in lines if ln.startswith("E7 ")]
    assert e7 == [mod.E7_LINE]
    assert "launch/dryrun.py" in e7[0] and "ROADMAP" in e7[0]
    assert not any("dryrun" in n for n, _, _, _ in calls)


def test_full_mode_loads_neither_jax_nor_repro(tmp_path):
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('torch_run', "
        f"{str(RUN)!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "sys.modules['torch_run'] = run\n"
        "spec.loader.exec_module(run)\n"
        f"for name in {sorted({n for n, _ in ORDER})!r}:\n"
        "    run._sibling(name)\n"
        "from repro_torch.launch import profile_run\n"
        "tables = run._sibling('torch_bench_tables')\n"
        "sched, cost, seed = tables.iot_setup()\n"
        "rows, err = run._sibling('torch_common').run_experiment(\n"
        "    'IoT', sched, cost, duration=3600.0, seed=seed, repeats=1,\n"
        "    device='cpu')\n"
        "e9 = run._sibling('torch_bench_khaos_training')"
        ".bench_khaos_training(\n"
        "    day=3600.0, device='cpu')\n"
        "e10 = run._sibling('torch_bench_proactive').head_to_head(\n"
        "    period=3600.0, verbose=False, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'bad': bad, 'rows': len(rows),\n"
        "                  'e9': sorted(e9['results']),\n"
        "                  'e10': sorted(e10['qos_violation_s'])}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["rows"] == 6 and len(res["e9"]) == 4
    assert res["e10"] == ["Khaos-proactive", "Khaos-reactive", "static 40s",
                          "static 480s"]
