"""The ``examples/torch_*.py`` twins of the JAX package's examples: each
runs to its end on the CPU (``--device cpu``: the lane engine, trainer,
checkpoint manager and server take the CPU) in a subprocess that loads
neither jax nor repro, with arguments that keep it short; the three
simulator examples (quickstart, chaos_profiling, fleet_supervision) print
the reference script's stdout line for line.  Neither of the three prints
a wall-clock number (every latency and recovery in them is simulated), so
nothing is masked; both sides run under ``PYTHONHASHSEED=0``, since the
quickstart prints a dict built from a set of strings."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

_RUN = ("import runpy, sys\n"
        "path = sys.argv[1]\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_path(path, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n")


def _run(script: Path, args: list, cwd: Path, timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0")
    return subprocess.run([sys.executable, "-c", _RUN, str(script), *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=str(cwd))


def _twin(name: str, args: list, tmp_path: Path) -> list:
    proc = _run(EXAMPLES / f"torch_{name}.py", ["--device", "cpu", *args],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "LOADED []", lines[-1]
    return lines[:-1]


@pytest.mark.parametrize("name", ["quickstart", "chaos_profiling",
                                  "fleet_supervision"])
def test_simulator_examples_print_the_references_stdout(name, tmp_path):
    got = _twin(name, [], tmp_path)
    ref = _run(EXAMPLES / f"{name}.py", [], tmp_path)
    assert ref.returncode == 0, ref.stderr[-4000:]
    want = ref.stdout.splitlines()[:-1]       # its own LOADED line
    assert len(got) == len(want) > 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)


def test_train_stream_example_trains_fails_and_restores(tmp_path):
    """The failure comes late (virtual second 120 of 180): a node loss
    drops the in-flight asynchronous writes, and on a loaded CPU the
    first full at second 10 was still in flight at the default second
    35, so the run restored nothing."""
    out = _twin("train_stream", ["--ckpt-dir", str(tmp_path / "ckpt"),
                                 "--duration", "180", "--fail-at", "120"],
                tmp_path)
    text = "\n".join(out)
    assert "=== train_stream summary ===" in text
    assert "failures: 1" in text and "restores: 1" in text
    assert "phase machine: steady_state -> profiled -> optimizing" in text


def test_elastic_recovery_example_restores_bit_for_bit(tmp_path):
    out = _twin("elastic_recovery", ["--dir", str(tmp_path / "elastic")],
                tmp_path)
    assert out[-2].endswith("bitwise identical: True")
    assert out[-1] == ("elastic recovery complete: resume training on the "
                       "smaller mesh")
    assert "rescale plan: (16, 16) -> (8, 16)" in out[2]


def test_serve_stream_example_serves_and_supervises(tmp_path):
    out = _twin("serve_stream", ["--batches", "2", "--fleet"], tmp_path)
    batches = [ln for ln in out if ln.startswith("batch ")]
    assert len(batches) == 2 and all("served 4 requests" in b
                                     for b in batches)
    assert out[-4:-1] == ["cold:      admit", "transfer:  admit_transfer",
                          "rejected:  reject"]
    assert "'serve-xl': 'rejected'" in out[-1]


def test_every_example_has_a_twin():
    ref = sorted(p.name for p in EXAMPLES.glob("*.py")
                 if not p.name.startswith("torch_"))
    twins = sorted(p.name[len("torch_"):] for p in EXAMPLES.glob("torch_*.py"))
    assert ref == twins and len(ref) == 6
