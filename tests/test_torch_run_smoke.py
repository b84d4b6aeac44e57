"""``benchmarks/torch_run.py --smoke``, the twin of ``run.py --smoke``: all
seven drill twins of the port on the CPU, in a process that loads neither
``jax`` nor the JAX package ``repro``, and the runner's exit codes."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RUN = ROOT / "benchmarks" / "torch_run.py"
DRILLS = ["ckpt", "proactive", "campaign", "recovery", "replication",
          "runtime", "fleet"]


def test_smoke_runs_every_drill_without_jax_or_repro(tmp_path):
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('torch_run', "
            f"{str(RUN)!r})\n"
            "run = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(run)\n"
            f"out = run.smoke({str(tmp_path / 'smoke')!r}, device='cpu')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps({'drills': list(out['seconds']), 'bad': bad,\n"
            "                  'fleet': out['fleet']['rejected'],\n"
            "                  'peer_loss': out['replication']"
            "['peer_loss']['degraded']}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["drills"] == DRILLS
    assert res["bad"] == []
    assert res["fleet"] == ["firehose"] and res["peer_loss"]


def _runner():
    spec = importlib.util.spec_from_file_location("_torch_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_runner_exits_1_on_a_failed_drill(monkeypatch, capsys):
    mod = _runner()

    def broken(tmpdir, device=None, device_sec=None):
        raise AssertionError("degraded partial restore is not bit-exact")
    monkeypatch.setattr(mod, "smoke", broken)
    monkeypatch.setattr(sys, "argv", ["torch_run.py", "--smoke",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        mod.main()
    assert e.value.code == 1
    assert "SMOKE FAILED: degraded partial restore" in capsys.readouterr().err


def test_runner_refuses_the_unported_full_mode(monkeypatch, capsys):
    """The full mode no longer leaves a section out: E7 (the dry run) is
    ported, so the runner loads E7's twin and runs it last, and no line
    says a section waits for the port."""
    mod = _runner()
    loaded = []

    class Fake:
        def __init__(self, name):
            loaded.append(name)

        def __getattr__(self, fn):
            return lambda *a, **kw: {}
    monkeypatch.setattr(mod, "_sibling", Fake)
    monkeypatch.setattr(sys, "argv", ["torch_run.py", "--quick"])
    mod.main()
    out = capsys.readouterr().out.splitlines()
    assert not hasattr(mod, "E7_LINE")
    assert not any("waits for" in ln for ln in out)
    assert loaded[-1] == "torch_bench_dryrun"


def test_caller_section_replaces_the_campaign_drill(monkeypatch, tmp_path):
    """A caller's device section (the card's full-size one) stands in for
    drill 3, and drill 4's artifact embeds it."""
    mod = _runner()
    calls = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def call(*a, **kw):
                calls.append((self.name, fn, kw.get("device_sec")))
                return {"seconds": {}}
            return call
    monkeypatch.setattr(mod, "_sibling", Fake)
    section = {"parity": {"divergent_lanes": 0}}
    out = mod.smoke(str(tmp_path), device="cpu", device_sec=section)
    names = [c[0] for c in calls]
    assert "torch_bench_campaign" not in names
    assert names == ["torch_bench_ckpt", "torch_bench_proactive",
                     "torch_bench_recovery", "torch_bench_replication",
                     "torch_bench_runtime", "torch_bench_fleet"]
    assert calls[2][2] is section
    assert list(out["seconds"]) == [d for d in DRILLS if d != "campaign"]
