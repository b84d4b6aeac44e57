"""What the benchmark may import: nothing of JAX or the JAX package
anywhere in khaosbench/ (top-level names compared whole, so
``repro_torch`` is allowed and ``repro`` is not), nothing of the program
in the reference, and nothing of the older ``benchmarks/`` folder."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
BENCH_DIR = ROOT / "khaosbench"
FILES = sorted(BENCH_DIR.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN
    if "tests" not in path.parts:
        assert "benchmarks/" not in path.read_text()


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert top_level_imports(path) <= {"__future__", "math", "typing",
                                           "numpy", "torch"}, path


def test_the_run_command_checks_modules_by_whole_name(monkeypatch):
    sys.path.insert(0, str(BENCH_DIR))
    import run
    monkeypatch.setattr(sys, "modules", {"repro_torch": sys, "numpy": sys,
                                         "repro_torch.models.zoo": sys})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"repro.sim.device": sys,
                                         "jaxlib": sys, "repro_torch": sys})
    assert run.forbidden_modules() == ["jaxlib", "repro"]
