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
#: the port's twins of the examples
PORT_EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


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
    for mod in ("sim.batched", "sim.device", "core.profiler",
                "core.ci_optimizer", "core.controller", "fleet",
                "fleet.registry", "fleet.admission", "fleet.supervisor",
                "runtime.server", "launch.serve", "launch.profile_run",
                "utils.timing", "configs.codeqwen1_5_7b",
                "configs.internlm2_20b", "configs.olmoe_1b_7b",
                "configs.qwen2_5_14b", "configs.qwen2_vl_7b",
                "configs.whisper_small", "sharding", "launch.mesh",
                "optim.compression", "roofline", "launch.dryrun"):
        assert f"repro_torch.{mod}" in mods
    for family in ("ckpt_delta", "flash_attention", "rglru", "rwkv6"):
        for part in ("", ".kernel", ".ops", ".ref"):
            assert f"repro_torch.kernels.{family}{part}" in mods
    benches = [str(p) for p in PORT_BENCHES]
    for name in ("ckpt", "kernels", "runtime", "proactive", "campaign",
                 "recovery", "fleet", "replication", "serve", "tables",
                 "khaos_training", "dryrun"):
        assert any(p.endswith(f"torch_bench_{name}.py") for p in benches)
    assert any(p.endswith("torch_run.py") for p in benches)
    assert any(p.endswith("torch_common.py") for p in benches)
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
    files = sorted(PORT.rglob("*.py")) + PORT_BENCHES + PORT_EXAMPLES + \
        [ROOT / "chip_smoke.py"]
    assert len(PORT_BENCHES) >= 1 and len(PORT_EXAMPLES) == 6
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


def test_serve_launcher_defaults_to_cuda(monkeypatch):
    """``launch.serve``'s ``--device`` defaults to cuda."""
    from repro_torch.launch import serve

    asked = []

    def resolve(device):
        asked.append(device)
        raise SystemExit(0)

    monkeypatch.setattr("repro_torch.utils.trees.resolve_device", resolve)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "yi-6b", "--local"])
    assert asked == ["cuda"]


# ---------------------------------------------------------------------------
# name parity: a twin of every public name of the JAX package
# ---------------------------------------------------------------------------

REF = ROOT / "src" / "repro"
_HLO = ("the HLO text walker has no PyTorch input: the port counts a step "
        "traced once (flops by FlopCounterMode, per-op bytes on meta "
        "tensors) in", "roofline.py", "count_step")
_PALLAS = "the Pallas entry point's CUDA twin is"
_ORACLE = "the numpy oracle's plain PyTorch twin is"
#: (module, name) of the JAX package with no counterpart of the same name
#: in the same module of the port -> (why, module, counterpart name) where
#: something else stands in for it, or (why,) where nothing does
NAME_ALLOWLIST = {
    ("roofline.py", "HloModule"): _HLO,
    ("roofline.py", "HloModule.__init__"): _HLO,
    ("roofline.py", "HloModule.cost"): _HLO,
    ("roofline.py", "HloModule.trip_count"): _HLO,
    ("roofline.py", "Instr"): _HLO,
    ("roofline.py", "Instr.result_bytes"): _HLO,
    ("roofline.py", "Instr.result_dims"): _HLO,
    ("roofline.py", "analyze_hlo_text"): _HLO,
    ("roofline.py", "HloCosts"): (_HLO[0], "roofline.py", "StepCosts"),
    ("roofline.py", "HloCosts.add"): _HLO,
    ("kernels/ckpt_delta/kernel.py", "flat_lossless_encode_fwd"):
        (_PALLAS, "kernels/ckpt_delta/kernel.py", "lossless_encode_groups"),
    ("kernels/ckpt_delta/kernel.py", "flat_delta_encode_fwd"):
        (_PALLAS, "kernels/ckpt_delta/kernel.py", "int8_encode_groups"),
    ("kernels/ckpt_delta/kernel.py", "lossless_decode_fwd"):
        (_PALLAS, "kernels/ckpt_delta/kernel.py", "lossless_decode"),
    ("kernels/ckpt_delta/kernel.py", "delta_decode_fwd"):
        (_PALLAS, "kernels/ckpt_delta/kernel.py", "delta_decode"),
    ("kernels/ckpt_delta/kernel.py", "lossless_encode_fwd"):
        (_PALLAS, "kernels/ckpt_delta/kernel.py", "lossless_encode"),
    ("kernels/ckpt_delta/kernel.py", "delta_encode_fwd"):
        (_PALLAS, "kernels/ckpt_delta/kernel.py", "int8_encode"),
    ("kernels/flash_attention/kernel.py", "flash_attention_fwd"):
        (_PALLAS, "kernels/flash_attention/kernel.py", "flash_attention"),
    ("kernels/rglru/kernel.py", "rglru_scan_fwd"):
        (_PALLAS, "kernels/rglru/kernel.py", "rglru_scan"),
    ("kernels/rwkv6/kernel.py", "wkv6_fwd"):
        (_PALLAS, "kernels/rwkv6/kernel.py", "wkv6"),
    ("kernels/ckpt_delta/ref.py", "encode_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "int8_encode"),
    ("kernels/ckpt_delta/ref.py", "decode_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "delta_decode"),
    ("kernels/ckpt_delta/ref.py", "lossless_encode_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "lossless_encode"),
    ("kernels/ckpt_delta/ref.py", "lossless_decode_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "lossless_decode"),
    ("kernels/ckpt_delta/ref.py", "pack_flat_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "pack_flat"),
    ("kernels/ckpt_delta/ref.py", "flat_lossless_encode_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "lossless_encode_groups"),
    ("kernels/ckpt_delta/ref.py", "flat_int8_encode_ref"):
        (_ORACLE, "kernels/ckpt_delta/ref.py", "int8_encode_groups"),
    ("kernels/ckpt_delta/ops.py", "default_interpret"):
        ("Pallas interpret mode has no use under PyTorch: an op takes the "
         "plain version for a CPU tensor",),
    ("sim/device.py", "ensure_bitexact_cpu"):
        ("an XLA CPU flag (--xla_cpu_max_isa) has no use under PyTorch",),
}
#: arguments of the JAX package's functions that the port does not take,
#: by name, and why
ARG_REASONS = {
    "interpret": "Pallas interpret mode (a CPU tensor takes the plain "
                 "version)",
    "block_groups": "Pallas tiling: the CUDA kernels pick their own tiles",
    "block_q": "Pallas tiling", "block_kv": "Pallas tiling",
    "block_d": "Pallas tiling", "chunk_t": "Pallas tiling",
    "key": "a jax.random key: the port's init takes a torch.Generator",
    "rng": "a jax.random key: the port's init takes a torch.Generator",
}
#: (module, function, argument) -> the port's argument in its place, or
#: None with why
ARG_COUNTERPARTS = {
    ("kernels/ckpt_delta/ops.py", "lossless_decode", "delta"): "d",
    ("kernels/ckpt_delta/ops.py", "lossless_decode", "resid"): "r",
    ("optim/compression.py", "compressed_psum", "axis_name"): "group",
    ("launch/dryrun.py", "run_cell", "keep_hlo"):
        (None, "no HLO text under PyTorch"),
}
#: the names the older checkpoint API and its helpers brought to the port:
#: their signatures are the reference's, argument for argument
LEGACY = {
    "checkpoint/async_ckpt.py": ["snapshot_to_host", "AsyncCheckpointer",
                                 "AsyncCheckpointer.__init__",
                                 "AsyncCheckpointer.save",
                                 "AsyncCheckpointer.wait",
                                 "AsyncCheckpointer.stats"],
    "checkpoint/incremental.py": ["IncrementalCheckpointer",
                                  "IncrementalCheckpointer.__init__",
                                  "IncrementalCheckpointer.save",
                                  "IncrementalCheckpointer.restore",
                                  "IncrementalCheckpointer.newest_delta",
                                  "IncrementalCheckpointer.stats"],
    "checkpoint/multilevel.py": ["MultiLevelCheckpointer",
                                 "MultiLevelCheckpointer.save",
                                 "MultiLevelCheckpointer.restore",
                                 "MultiLevelCheckpointer.on_node_failure",
                                 "MultiLevelCheckpointer.stats"],
    "checkpoint/manager.py": ["Checkpointer", "Checkpointer.save",
                              "Checkpointer.restore", "Checkpointer.stats",
                              "CheckpointManager.newest_step",
                              "CheckpointManager.restore_candidates"],
    "checkpoint/store.py": ["CheckpointMeta", "CheckpointMeta.name"],
    "config.py": ["CheckpointPlan.delta_encoding"],
    "utils/trees.py": ["tree_count", "tree_allclose", "tree_zeros_like"],
}


def _public(path: Path) -> dict:
    """Public top-level functions and classes of a module, and each public
    class's public methods (and ``__init__``), by AST: name -> node."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        if not isinstance(node, ast.ClassDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out[node.name] = node
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not sub.name.startswith("_")
                             or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _ref_modules() -> list[str]:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _args(fn: ast.FunctionDef) -> list[tuple[str, str]]:
    """(argument, default source or "") in order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [""] * (len(pos) - len(a.defaults)) + \
        [ast.unparse(d) for d in a.defaults]
    out = list(zip((x.arg for x in pos), defaults))
    out += [(x.arg, ast.unparse(d) if d is not None else "")
            for x, d in zip(a.kwonlyargs, a.kw_defaults)]
    out += [("*" + a.vararg.arg, "")] if a.vararg else []
    out += [("**" + a.kwarg.arg, "")] if a.kwarg else []
    return out


def _fields(cls: ast.ClassDef) -> list[tuple[str, str]]:
    """A dataclass's fields: (name, default source or "")."""
    return [(n.target.id, ast.unparse(n.value) if n.value else "")
            for n in cls.body if isinstance(n, ast.AnnAssign)]


def test_every_public_name_of_the_jax_package_has_a_twin():
    """Each public top-level function, class and class method of each
    ``src/repro/**.py`` has a counterpart of the same name in the same
    module of ``src/repro_torch/``, or an allowlist entry that names what
    stands in for it or why nothing does.  No entry is stale."""
    mods = _ref_modules()
    assert len(mods) > 60 and "checkpoint/incremental.py" in mods
    missing = set()
    for mod in mods:
        port = PORT / mod
        assert port.is_file(), f"no twin of src/repro/{mod}"
        missing |= {(mod, n) for n in set(_public(REF / mod))
                    - set(_public(port))}
    assert missing - set(NAME_ALLOWLIST) == set(), \
        sorted(missing - set(NAME_ALLOWLIST))
    assert set(NAME_ALLOWLIST) - missing == set(), \
        f"stale allowlist entries: {sorted(set(NAME_ALLOWLIST) - missing)}"
    for key, entry in NAME_ALLOWLIST.items():
        assert entry[0], key
        if len(entry) == 3:
            assert entry[2] in _public(PORT / entry[1]), (key, entry)


def test_every_argument_of_the_jax_package_has_a_twin():
    """Each argument of a public function or method of the JAX package is
    an argument of the port's twin, or is one the port names otherwise or
    has no use for."""
    unexplained, used = [], set()
    for mod in _ref_modules():
        port = _public(PORT / mod)
        for name, node in _public(REF / mod).items():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or name not in port:
                continue
            theirs = [a.lstrip("*") for a, _ in _args(port[name])]
            for arg, _ in _args(node):
                arg = arg.lstrip("*")
                if arg in theirs or arg in ARG_REASONS:
                    continue
                key = (mod, name, arg)
                other = ARG_COUNTERPARTS.get(key)
                used.add(key)
                if other is None:
                    unexplained.append(key)
                elif isinstance(other, str):
                    assert other in theirs, (key, theirs)
    assert not unexplained, unexplained
    assert used == set(ARG_COUNTERPARTS), \
        f"stale entries: {sorted(set(ARG_COUNTERPARTS) - used)}"


def test_the_older_checkpoint_api_keeps_the_reference_signatures():
    for mod, names in LEGACY.items():
        ref, port = _public(REF / mod), _public(PORT / mod)
        for name in names:
            a, b = ref[name], port[name]
            assert type(a) is type(b), (mod, name)
            if isinstance(a, ast.ClassDef):
                assert _fields(a) == _fields(b), (mod, name)
                assert [ast.unparse(x) for x in a.bases] == \
                    [ast.unparse(x) for x in b.bases], (mod, name)
            else:
                assert _args(a) == _args(b), (mod, name)


def _all_of(path: Path) -> list[str]:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and \
                any(getattr(t, "id", "") == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("package", ["checkpoint", "utils", "ft"])
def test_package_exports_cover_the_reference(package):
    ref = REF / package / "__init__.py"
    port = PORT / package / "__init__.py"
    if package == "ft":      # ft/ exports by import, not by __all__
        want = {a.asname or a.name for n in ast.parse(ref.read_text()).body
                if isinstance(n, ast.ImportFrom) for a in n.names}
        got = {a.asname or a.name for n in ast.parse(port.read_text()).body
               if isinstance(n, ast.ImportFrom) for a in n.names}
        assert want <= got, sorted(want - got)
        return
    assert set(_all_of(ref)) <= set(_all_of(port)), \
        sorted(set(_all_of(ref)) - set(_all_of(port)))
