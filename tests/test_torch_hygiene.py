"""The port stands alone: it imports torch and numpy, never jax and never
the JAX package ``repro`` (not even its NumPy-only modules), and its entry
points run on the CUDA device unless the caller names another."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the port's benchmarks: they import the port, never the JAX package
PORT_BENCHES = sorted((ROOT / "benchmarks").glob("torch_*.py"))


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.runtime.trainer" in mods
    assert "repro_torch.launch.train" in mods
    assert "repro_torch.core.runtime" in mods
    benches = [str(p) for p in PORT_BENCHES]
    assert any(p.endswith("torch_bench_ckpt.py") for p in benches)
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"for i, path in enumerate({benches!r}):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        f'_port_bench_{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.') or m == 'repro'\n"
            "             or m.startswith('repro.'))\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_no_port_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + PORT_BENCHES + \
        [ROOT / "chip_smoke.py"]
    assert len(PORT_BENCHES) >= 1
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_trainer_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.stream import EventStream, constant_rate
    from repro_torch.runtime import ResilientTrainer, TrainerConfig

    tcfg = TrainerConfig(batch=4, seq_len=16, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResilientTrainer(get_smoke_config("yi-6b"), tcfg,
                         EventStream(schedule=constant_rate(500.0)))
