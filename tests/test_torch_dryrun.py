"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``repro.launch.dryrun``.

* ``default_plan`` and ``recommended_plan``: dict-equal to the
  reference's over every arch x shape x data-parallel size 16 and 32 (the
  reference's functions are taken from its source: importing its module
  would set ``XLA_FLAGS`` for this process);
* the tiny 8-rank cell (the reference's ``test_real_compile_on_8_fake_
  devices`` config): the JAX side lowers and compiles in a subprocess on
  an Auto-axis (4, 2) mesh of 8 host devices, the port's side is traced
  over a ``fake`` group of 8 ranks.  Flops per device and argument bytes
  are EQUAL (155,189,248 and 647,684); ``model_flops`` equal; total
  collective bytes within 2x of the walker's (a model of the rules'
  placements against XLA's choice of collectives); HBM bytes and temp
  are printed beside the reference's and not gated (eager per-op traffic
  and PyTorch's working set against XLA's fusions and buffer assignment);
* the shortcuts against a full trace: one microbatch x accum, and the
  layer extrapolation of prefill and decode (flops, bytes and the peak;
  train's flops and bytes too), EXACTLY equal on SMOKE configs of a
  dense, a hybrid, an MoE and the audio family (the collectives are
  counted from the placements at full depth, no shortcut);
* one full-width cell through ``main`` in a subprocess that loads
  neither jax nor repro: yi-6b train_4k 16x16, the record E9 reads — its
  keys are the reference record's (``fits_16gb``, ``lower_s`` and
  ``compile_s`` renamed), ``model_flops_global`` the reference's, and
  ``arg_gb_per_dev`` the bytes of the reference's own shard shapes,
  counted from its specs and the mesh sizes without compiling;
* ``main``'s SKIP records, FAIL lines and exit code 1.
"""
import ast
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.config import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models import zoo as jzoo
from repro.optim import make_optimizer as jax_make_optimizer
from repro.roofline import HloCosts, model_flops as jax_model_flops
from repro.roofline import roofline_terms as jax_roofline_terms
from repro.sharding import ShardingRules as JaxShardingRules
from repro.utils.trees import tree_flatten_with_names as jax_names
from repro_torch.config import (ALL_SHAPES, ModelConfig, OptimizerConfig,
                                ShapeConfig, replace)
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_abstract_mesh, make_test_mesh
from repro_torch.models import zoo
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.roofline import model_flops, trace_accumulated, trace_step
from repro_torch.utils.trees import (tree_leaves, tree_structure,
                                     tree_unflatten)

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro" / "launch" / "dryrun.py"
TINY = dict(name="t", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
TINY_PLAN = {"accum": 2, "state_dtype": "float32", "accum_dtype": "float32",
             "remat": None, "sharding": {"fsdp_min_params": 0}}


def _reference_functions() -> dict:
    """``default_plan``, ``_PAD_HEADS`` and ``recommended_plan`` of the
    reference, compiled from its source alone."""
    tree = ast.parse(REF.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in
                ("default_plan", "recommended_plan"))
            or (isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_PAD_HEADS"
                for t in n.targets))]
    assert len(keep) == 3
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(REF), "exec"),
         ns)
    return ns


def _reference_record_keys() -> set:
    """The keys ``repro.launch.dryrun.run_cell`` writes: its dict literal,
    its ``rec[...] =`` lines and ``roofline_terms``'s keys."""
    tree = ast.parse(REF.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx,
                                                          ast.Store):
            keys.add(node.slice.value)
    keys.discard("_hlo")          # only with keep_hlo
    return keys | set(jax_roofline_terms(HloCosts()))


@pytest.mark.parametrize("dp", [16, 32])
def test_plans_equal_the_reference(dp):
    ref = _reference_functions()
    assert dryrun._PAD_HEADS == ref["_PAD_HEADS"]
    n = 0
    for arch in ARCH_IDS:
        for shape in ALL_SHAPES:
            assert dryrun.default_plan(arch, shape.name, dp) == \
                ref["default_plan"](arch, shape.name, dp)
            assert dryrun.recommended_plan(arch, shape.name, dp) == \
                ref["recommended_plan"](arch, shape.name, dp)
            n += 1
    assert n == 40


# ---------------------------------------------------------------------------
# the tiny 8-rank cell
# ---------------------------------------------------------------------------

_JAX_CELL = textwrap.dedent("""
    import json
    import jax
    from jax.sharding import AxisType
    from repro.config import (ModelConfig, OptimizerConfig, ShapeConfig,
                              ShardingConfig)
    from repro.models import zoo
    from repro.optim import make_optimizer
    from repro.roofline import analyze_hlo_text, model_flops
    from repro.sharding import ShardingRules
    cfg = ModelConfig(**json.loads(__import__("sys").argv[1]))
    shape = ShapeConfig("t", "train", 64, 8)
    opt_cfg = OptimizerConfig()
    opt = make_optimizer(opt_cfg)
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    with jax.set_mesh(mesh):
        rules = ShardingRules(cfg, mesh, ShardingConfig(fsdp_min_params=0))
        state = zoo.state_specs(cfg, opt)
        batch = zoo.input_specs(cfg, shape)
        fn = zoo.make_train_step(cfg, opt, opt_cfg, accum=2,
                                 ann=rules.annotator())
        out = jax.eval_shape(fn, state, batch)
        jt = jax.jit(fn, in_shardings=(rules.state_shardings(state),
                                       rules.batch_shardings(batch)),
                     out_shardings=(rules.state_shardings(out[0]),
                                    jax.tree_util.tree_map(
                                        lambda _: rules.replicated(),
                                        out[1])),
                     donate_argnums=0)
        compiled = jt.lower(state, batch).compile()
    ma = compiled.memory_analysis()
    c = analyze_hlo_text(compiled.as_text())
    print(json.dumps({"flops": c.flops, "bytes": c.bytes,
                      "collective_bytes": c.collective_bytes,
                      "by_type": c.by_type,
                      "arg": ma.argument_size_in_bytes,
                      "temp": ma.temp_size_in_bytes,
                      "model_flops": model_flops(cfg, shape)}))
""")


def test_tiny_cell_on_8_ranks_matches_the_walker():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _JAX_CELL,
                           json.dumps(TINY)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])

    cfg = ModelConfig(**TINY)
    shape = ShapeConfig("t", "train", 64, 8)
    with dryrun.fake_group(8):
        mesh = make_test_mesh(4, 2, device_type="cpu")
        cell = dryrun.build_step(cfg, shape, mesh, dict(TINY_PLAN))
        counted = dryrun.count_cell(cell)
        rec = dryrun.cell_record(cell, counted)
    print(f"\nper device      port            walker\n"
          f"flops     {rec['hlo_flops_per_dev']:14.0f} {ref['flops']:14.0f}\n"
          f"HBM bytes {rec['hlo_bytes_per_dev']:14.0f} {ref['bytes']:14.0f}\n"
          f"coll      {rec['collective_bytes_per_dev']:14.0f} "
          f"{ref['collective_bytes']:14.0f}\n"
          f"arg       {rec['arg_gb_per_dev'] * 2**30:14.0f} {ref['arg']:14d}\n"
          f"temp      {rec['temp_gb_per_dev'] * 2**30:14.0f} "
          f"{ref['temp']:14d}\n"
          f"by type   {rec['collective_by_type']} {ref['by_type']}")
    assert ref["flops"] == 155_189_248
    assert rec["hlo_flops_per_dev"] == ref["flops"]
    assert ref["arg"] == 647_684
    assert rec["arg_gb_per_dev"] * 2**30 == ref["arg"]
    assert rec["model_flops_global"] == ref["model_flops"] == \
        model_flops(cfg, shape)
    ratio = rec["collective_bytes_per_dev"] / ref["collective_bytes"]
    assert 0.5 <= ratio <= 2.0, ratio


# ---------------------------------------------------------------------------
# the shortcuts against a full trace
# ---------------------------------------------------------------------------

FAMILIES = ["yi-6b", "recurrentgemma-2b", "olmoe-1b-7b", "whisper-small"]
MESH = make_abstract_mesh((4, 2), ("data", "model"))


def _deep(arch: str, units: int) -> ModelConfig:
    """The arch's SMOKE config with ``units`` repeated units (layers;
    groups for hybrid; both stacks for audio)."""
    cfg = get_smoke_config(arch)
    if cfg.family == "hybrid":
        pat = len(cfg.recurrent.block_pattern)
        return replace(cfg, num_layers=units * pat + cfg.num_layers % pat)
    if cfg.family == "audio":
        return replace(cfg, num_layers=units, num_decoder_layers=units + 1)
    return replace(cfg, num_layers=units)


def _plan(accum=1):
    return {"accum": accum, "state_dtype": "float32",
            "accum_dtype": "float32", "remat": None,
            "sharding": {"fsdp_min_params": 0}}


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_microbatch_times_accum_equals_the_full_trace(arch):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("t", "train", 64, 8)
    cell = dryrun.build_step(cfg, shape, MESH, _plan(accum=4))
    full = trace_step(cell.fn, *cell.args)
    parts = trace_accumulated(cell.fn, *cell.args, 4)
    assert (parts.flops, parts.bytes, parts.peak_bytes, parts.output_bytes) \
        == (full.flops, full.bytes, full.peak_bytes, full.output_bytes)
    assert full.flops > 0 and full.peak_bytes > 0


def _pre_split_step(cfg, opt, ocfg, accum: int):
    """``zoo.make_train_step`` as it was before it was split into
    ``parts``: one body, the unclipped gradients rebound by the clip
    before the update."""
    loss_fn = zoo.make_loss_fn(cfg)
    adt = torch.float32

    def grad_fn(params, batch):
        treedef = tree_structure(params)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    def train_step(state, batch):
        params = state["params"]
        if accum <= 1:
            loss, metrics, grads = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            lead = batch.get("tokens", batch.get("frames"))
            bsz = lead.shape[0]
            mbs = {k: zoo._split_micro(v, accum, bsz)
                   for k, v in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=adt, device=p.device)
                    for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=lead.device)
            for i in range(accum):
                l, _, g = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                gsum = [a + b.to(adt) for a, b in zip(gsum, tree_leaves(g))]
                loss = loss + l
                del g
            grads = tree_unflatten(tree_structure(params),
                                   [(g / accum).to(torch.float32)
                                    for g in gsum])
            del gsum
            loss = loss / accum
            metrics = {"ce": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        grads, gnorm = clip_by_global_norm(grads, ocfg.grad_clip)
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, state["opt"], params,
                                             state["step"])
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, \
            {"loss": loss, "grad_norm": gnorm.detach(), **metrics}
    return train_step


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("seq,batch", [(64, 8), (8, 4)])
def test_the_split_step_keeps_the_pre_split_peak(seq, batch, accum, remat):
    """The step built of ``parts`` holds what the one-body step held: the
    same output bytes, flops and traffic, and the same peak of live
    storage within three float32 scalars (a version that kept the
    unclipped gradients through the update added one float32 copy of
    the params).  The scalars: the one-body loop keeps a microbatch's
    loss and its metrics ``ce`` and ``aux`` bound through the next
    microbatch, which ``micro`` drops when it returns (12 bytes less
    while the backward sets the peak, at 64 x 8), and ``train_step``'s
    frame keeps the loss sum through ``finish`` (4 bytes more while the
    optimizer update sets the peak, at 8 x 4)."""
    cfg = replace(get_smoke_config("yi-6b"), remat_policy=remat)
    cell = dryrun.build_step(cfg, ShapeConfig("t", "train", seq, batch),
                             MESH, _plan(accum=accum))
    ocfg = OptimizerConfig(state_dtype="float32")
    split = trace_step(cell.fn, *cell.args)
    one = trace_step(_pre_split_step(cfg, make_optimizer(ocfg), ocfg, accum),
                     *cell.args)
    assert (split.output_bytes, split.flops, split.bytes) \
        == (one.output_bytes, one.flops, one.bytes)
    assert abs(split.peak_bytes - one.peak_bytes) <= 3 * 4
    params = sum(t.numel() * 4 for t in tree_leaves(cell.args[0]["params"]))
    assert split.peak_bytes > params


SHORTCUT_SHAPES = {"train": ShapeConfig("t", "train", 64, 8),
                   "prefill": ShapeConfig("p", "prefill", 64, 8),
                   "decode": ShapeConfig("d", "decode", 64, 8)}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_layer_extrapolation_equals_the_full_trace(arch, mode):
    cfg = _deep(arch, 6)
    cell = dryrun.build_step(cfg, SHORTCUT_SHAPES[mode], MESH,
                             _plan(accum=2 if mode == "train" else 1))
    full = dryrun.count_full(cell)
    ext = dryrun.count_extrapolated(cell)
    assert ext.flops == full.flops and ext.bytes == full.bytes
    if mode != "train":       # a train step's peak is not linear in depth
        assert ext.peak == full.peak
        got, want = dryrun.memory_terms(cell, ext.out, ext.peak), \
            dryrun.memory_terms(cell, full.out, full.peak)
        assert got == want


def test_count_cell_extrapolates_prefill_and_decode_only(monkeypatch):
    calls = []
    monkeypatch.setattr(dryrun, "count_full",
                        lambda cell: calls.append("full") or len(calls))
    monkeypatch.setattr(dryrun, "count_extrapolated",
                        lambda cell: calls.append("ext") or len(calls))
    memo: dict = {}
    for mode in ("train", "prefill", "decode", "decode"):
        cell = dryrun.build_step(_deep("yi-6b", 4), SHORTCUT_SHAPES[mode],
                                 MESH, _plan())
        dryrun.count_cell(cell, memo)
    assert calls == ["full", "ext", "ext"]      # the second decode: memo


# ---------------------------------------------------------------------------
# one full-width cell through main
# ---------------------------------------------------------------------------

def _reference_arg_bytes(arch: str, shape_name: str, accum: int) -> int:
    """The bytes of the reference's own shard shapes of the cell's state
    and batch: its specs on its abstract (16, 16) mesh, each dim divided
    by the sizes of the axes the spec puts on it."""
    cfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
    mesh = jax_abstract_mesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    from repro.config import ShardingConfig as JaxShardingConfig
    rules = JaxShardingRules(cfg, mesh, JaxShardingConfig())
    opt = jax_make_optimizer(JaxOptimizerConfig(state_dtype="float32"))
    state = jzoo.state_specs(cfg, opt)
    batch = jzoo.input_specs(cfg, shape)
    total = 0
    for tree, shard in ((state, rules.state_shardings(state)),
                        (batch, rules.batch_shardings(batch))):
        specs = dict(jax_names(shard))
        for name, leaf in jax_names(tree):
            dims = list(leaf.shape)
            for d, entry in enumerate(specs[name].spec):
                for a in (entry if isinstance(entry, tuple) else
                          (entry,) if entry else ()):
                    assert dims[d] % sizes[a] == 0
                    dims[d] //= sizes[a]
            total += math.prod(dims) * leaf.dtype.itemsize
    return total


def test_full_width_yi6b_train_cell_through_main(tmp_path):
    out = tmp_path / "dryrun_torch.json"
    code = (
        "import json, sys\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'yi-6b', '--shape', 'train_4k', "
        f"'--mesh', 'single', '--out', {str(out)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=900, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["bad"] == []
    (rec,) = json.loads(out.read_text())
    want = _reference_record_keys() - {"fits_16gb", "lower_s",
                                       "compile_s"}
    assert set(rec) == want | {"fits_80gb", "trace_s"}
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"]) == \
        ("yi-6b", "train_4k", "16x16", 256)
    assert rec["plan"]["accum"] == 16
    assert rec["model_flops_global"] == jax_model_flops(
        jax_get_config("yi-6b"), JAX_SHAPES["train_4k"])
    assert rec["arg_gb_per_dev"] * 2**30 == \
        _reference_arg_bytes("yi-6b", "train_4k", 16)
    assert rec["bound_step_s"] == max(rec["t_compute_s"], rec["t_memory_s"],
                                      rec["t_collective_s"]) > 0
    assert rec["fits_80gb"] == (rec["hbm_gb_per_dev"] <= 80.0)
    assert 0 < rec["alias_gb_per_dev"] <= rec["output_gb_per_dev"]


def test_main_skips_inapplicable_shapes_and_fails_loudly(tmp_path, monkeypatch,
                                                        capsys):
    out = tmp_path / "d.json"
    recs = dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                        "--out", str(out)])
    assert recs == [{"arch": "yi-6b", "shape": "long_500k", "mesh": "-",
                     "skipped": "long-context needs sub-quadratic attention"}]
    assert json.loads(out.read_text()) == recs

    def boom(*a, **k):
        raise RuntimeError("data-dependent shape")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "rwkv6-3b", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(out)])
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert "FAIL rwkv6-3b decode_32k multi=False: data-dependent shape" \
        in text
    assert "FAIL rwkv6-3b decode_32k multi=True" in text
    assert "wrote 0 records" in text and "2 failures" in text
    import torch.distributed as dist
    assert not dist.is_initialized()
