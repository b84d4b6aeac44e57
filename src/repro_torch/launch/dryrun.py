"""Multi-pod dry run of the port: every (arch x shape x mesh) cell's step
traced once on ``meta`` tensors over a production ``DeviceMesh``, with its
memory, cost and roofline terms (``repro_torch.roofline``) on a model of
an H100 mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both [--out experiments/dryrun_torch.json]

The JAX package lowers and compiles each cell against 256 or 512
placeholder XLA host devices; here a ``fake`` process group of 256 or 512
ranks in this one process stands behind the production mesh
(``launch/mesh.py``), so the rules' placements are real ``DeviceMesh``
placements, while the step runs on the GLOBAL shapes as ``meta`` tensors
(no data, no device).  The record has the reference's keys, with
``fits_80gb`` (one H100's HBM) for ``fits_16gb`` and ``trace_s`` for
``lower_s``/``compile_s``.  Memory per device:

  * ``arg_gb_per_dev``: the local-shard bytes of the step's arguments
    (state or params and caches, plus the batch) under the rules'
    placements — exact, as XLA's argument size is;
  * ``temp_gb_per_dev``: the peak of live ``meta`` storage bytes the step
    makes over its trace (its outputs excluded), over n_dev — eager
    PyTorch's working set, where XLA's temp is its buffer assignment's;
  * ``output_gb_per_dev``: the local bytes of the outputs;
    ``alias_gb_per_dev``: those of them that reuse a donated argument of
    the same shape, dtype and placements (the train step donates its
    state, decode its caches: ``donate_argnums`` in the reference).

Two shortcuts keep the trace of a full-width cell to seconds, each equal
to the full trace (``tests/test_torch_dryrun.py``):

  * a train step with ``accum`` microbatches counts its first part, ONE
    microbatch's loss and gradient, and its update, in one trace; the
    microbatch's flops and bytes count ``accum`` times (the reference's
    walker multiplies a ``while`` body by its trip count), and the peak
    is the trace's (every microbatch runs on the same live set);
  * prefill and decode cells count a model of ``a`` and of ``a + 1``
    identical layers and extrapolate, cost(L) = cost(a) + (L - a) *
    (cost(a + 1) - cost(a)) — per group for the hybrid family, per stack
    for the audio family — for flops, bytes and the peak.  A train cell
    traces its full depth: its peak moves between the activations and
    the update as layers are added, so it is not linear in depth.  The
    collectives are counted from the placements at full depth.

An op with a data-dependent shape, or a ``.item()``, fails on ``meta``:
such a cell is a ``FAIL`` line and a failure, never skipped.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Any, Callable, Optional

import torch

from repro_torch.config import (ALL_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                OptimizerConfig, ShapeConfig, ShardingConfig,
                                applicable_shapes)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.roofline import (StepCosts, Trace, collective_costs,
                                  local_numel, mesh_sizes, model_flops,
                                  roofline_terms, trace_accumulated,
                                  trace_step)
from repro_torch.sharding import ShardingRules
from repro_torch.utils.trees import (tree_flatten_with_names, tree_leaves,
                                     tree_map_with_names)

#: where the record goes (the JAX package writes experiments/dryrun.json)
DEFAULT_OUT = "experiments/dryrun_torch.json"
#: the layers a prefill/decode cell traces: a and a + 1
EXTRAPOLATE_FROM = 2
HBM_GB = 80.0               # one H100 SXM


def default_plan(arch: str, shape_name: str, dp_total: int) -> dict:
    """Per-cell feasibility plan (microbatching / optimizer-state dtypes).

    These are the *baseline* settings; §Perf hillclimb overrides arrive via
    --plan or --recommended.
    """
    plan = {"accum": 1, "state_dtype": "float32", "accum_dtype": "float32",
            "remat": None, "sharding": {}}
    if shape_name == "train_4k":
        batch = 256
        plan["accum"] = max(1, batch // dp_total)       # 1-seq-per-device microbatches
        if arch == "grok-1-314b":
            plan["state_dtype"] = "bfloat16"            # m/v in bf16 (316B params)
            plan["accum_dtype"] = "bfloat16"
            plan["remat"] = "full"
    return plan


# §Perf winners (EXPERIMENTS.md): head padding for TP-unfriendly head
# counts, larger flash chunks, sequence parallelism for train, int8 KV for
# decode, MoE capacity 1.0 for grok.
_PAD_HEADS = {"qwen2.5-14b": 48, "qwen2-vl-7b": 32}


def recommended_plan(arch: str, shape_name: str, dp_total: int) -> dict:
    plan = default_plan(arch, shape_name, dp_total)
    if arch in _PAD_HEADS:
        plan["num_heads"] = _PAD_HEADS[arch]
    if shape_name in ("train_4k", "prefill_32k"):
        plan["attn_chunk_q"] = 1024
        plan["attn_chunk_kv"] = 4096
    if shape_name == "train_4k":
        # SP shards the hidden SEQ dim — poison for time-sequential mixers
        # (WKV / RG-LRU scans reshard every chunk): measured 5x regression
        # on rwkv6, so recurrent families stay batch-sharded.
        if arch not in ("rwkv6-3b", "recurrentgemma-2b"):
            plan["sharding"] = {"seq_shard_hidden": True}
        if arch not in ("grok-1-314b",):
            plan["accum"] = max(1, min(8, 256 // dp_total))
    if shape_name == "decode_32k" and arch not in ("rwkv6-3b",):
        plan["kv_cache_dtype"] = "int8"
    if arch == "grok-1-314b":
        plan["capacity_factor"] = 1.0
    return plan


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks in this process
    (the stand-in for the reference's placeholder devices), destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclass
class Cell:
    """One cell's step and its ``meta`` arguments, as ``build_cell`` makes
    them (the reference returns the jitted step and its args)."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    rules: ShardingRules
    fn: Callable
    args: tuple
    plan: dict
    make: Callable            # cfg -> (fn, args) for another depth
    donate: int | None        # the argument the step donates


def plan_cfg(cfg: ModelConfig, p: dict) -> ModelConfig:
    """The config a plan asks for (head padding keeps the head width)."""
    if "num_heads" in p and "head_dim" not in p:
        # head padding must preserve the ORIGINAL head_dim (function-
        # preserving: extra heads have zero-init wo rows); otherwise the
        # derived d_model//num_heads silently changes the architecture.
        p["head_dim"] = cfg.resolved_head_dim
    if p.get("remat"):
        cfg = dc_replace(cfg, remat_policy=p["remat"])
    for k in ("attn_chunk_q", "attn_chunk_kv", "kv_cache_dtype", "attn_impl",
              "num_heads", "head_dim", "param_dtype"):
        if k in p:
            cfg = dc_replace(cfg, **{k: p[k]})
    if "capacity_factor" in p and cfg.moe is not None:
        cfg = dc_replace(cfg, moe=dc_replace(cfg.moe,
                                             capacity_factor=p["capacity_factor"]))
    return cfg


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, p: dict) -> Cell:
    """The step of ``shape``'s mode at ``cfg`` on ``mesh`` under plan
    ``p``, with ``meta`` arguments."""
    scfg = ShardingConfig(**p.get("sharding", {}))
    rules = ShardingRules(cfg, mesh, scfg)
    ann = rules.annotator()

    if shape.mode == "train":
        opt_cfg = OptimizerConfig(state_dtype=p["state_dtype"])
        opt = make_optimizer(opt_cfg)

        def make(c):
            fn = zoo.make_train_step(c, opt, opt_cfg, accum=p["accum"],
                                     ann=ann, accum_dtype=p["accum_dtype"])
            return fn, (zoo.state_specs(c, opt), zoo.input_specs(c, shape))
        donate = 0
    elif shape.mode == "prefill":
        def make(c):
            return zoo.make_prefill_step(c, ann=ann), (
                zoo.init_params(c, torch.Generator(), "meta"),
                zoo.input_specs(c, shape))
        donate = None
    else:
        def make(c):
            return zoo.make_decode_step(c, ann=ann), (
                zoo.init_params(c, torch.Generator(), "meta"),
                zoo.cache_specs(c, shape), zoo.input_specs(c, shape))
        donate = 1
    fn, args = make(cfg)
    return Cell(cfg, shape, mesh, rules, fn, args, p, make, donate)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               plan: dict | None = None, recommended: bool = False,
               device_type: str = "cpu") -> Cell:
    """The cell's step on the production mesh (256 or 512 ranks of the
    process group the caller has initialised)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    dp_total = math.prod(s for a, s in mesh_sizes(mesh).items()
                         if a != "model")
    maker = recommended_plan if recommended else default_plan
    p = maker(arch, shape_name, dp_total)
    p.update(plan or {})
    return build_step(plan_cfg(cfg, p), shape, mesh, p)


# ---------------------------------------------------------------------------
# Memory terms from the placements
# ---------------------------------------------------------------------------

def _local_bytes(t: torch.Tensor, spec, sizes: dict) -> int:
    return local_numel(tuple(t.shape), spec, sizes) * t.element_size()


def _leaf_specs(cell: Cell, which: str, tree) -> list:
    """(tensor, spec) of every leaf of an argument or output tree."""
    r = cell.rules
    spec_of = {"state": r.state_spec, "params": r.param_spec,
               "batch": r.input_spec, "cache": r.cache_spec}[which]
    return [(t, spec_of(n, tuple(t.shape)))
            for n, t in tree_flatten_with_names(tree)]


def _arg_kinds(cell: Cell) -> tuple:
    return {"train": ("state", "batch"), "prefill": ("params", "batch"),
            "decode": ("params", "cache", "batch")}[cell.shape.mode]


def _out_leaf_specs(cell: Cell, out) -> list:
    r = cell.rules
    if cell.shape.mode == "train":
        return _leaf_specs(cell, "state", out[0]) + \
            [(t, r.replicated().spec) for t in tree_leaves(out[1])]
    return [(out[0], r.dp_vector(tuple(out[0].shape)).spec)] + \
        _leaf_specs(cell, "cache", out[1])


def memory_terms(cell: Cell, out, peak_global: int) -> dict:
    """The record's memory keys, in bytes per device."""
    sizes = mesh_sizes(cell.mesh)
    n_dev = math.prod(sizes.values())
    args = [ls for kind, tree in zip(_arg_kinds(cell), cell.args)
            for ls in _leaf_specs(cell, kind, tree)]
    arg = sum(_local_bytes(t, s, sizes) for t, s in args)
    outs = _out_leaf_specs(cell, out)
    output = sum(_local_bytes(t, s, sizes) for t, s in outs)
    alias = 0
    if cell.donate is not None:
        kind = _arg_kinds(cell)[cell.donate]
        free: dict = {}
        for t, s in _leaf_specs(cell, kind, cell.args[cell.donate]):
            key = (tuple(t.shape), t.dtype, tuple(s))
            free[key] = free.get(key, 0) + 1
        for t, s in outs:
            key = (tuple(t.shape), t.dtype, tuple(s))
            if free.get(key):
                free[key] -= 1
                alias += _local_bytes(t, s, sizes)
    return {"arg": arg, "temp": peak_global / n_dev, "output": output,
            "alias": alias}


# ---------------------------------------------------------------------------
# Counting: one microbatch x accum; a and a + 1 layers
# ---------------------------------------------------------------------------

def _trace(cell_fn: Callable, args: tuple, cell: Cell) -> Trace:
    accum = cell.plan.get("accum", 1) if cell.shape.mode == "train" else 1
    if accum > 1:
        return trace_accumulated(cell_fn, *args, accum)
    return trace_step(cell_fn, *args)


def _collectives(cell: Cell) -> StepCosts:
    """The collectives of the rules' placements at the cell's full depth
    (counted, not traced: see ``repro_torch.roofline``)."""
    args = cell.args
    params = args[0]["params"] if cell.shape.mode == "train" else args[0]
    act = torch.empty((), dtype=getattr(torch, cell.cfg.dtype)).element_size()
    return collective_costs(cell.rules, params, args[-1],
                            mode=cell.shape.mode,
                            accum=cell.plan.get("accum", 1), act_bytes=act)


def _depths(cfg: ModelConfig, a: int) -> list:
    """Configs at a and a + 1 repeated units, with each unit's count in
    the full config: [(base cfg), [(cfg one unit deeper, full units), ...]]."""
    if cfg.family == "hybrid":
        pat = len(cfg.recurrent.block_pattern)
        G, tail = divmod(cfg.num_layers, pat)
        return [dc_replace(cfg, num_layers=a * pat + tail),
                [(dc_replace(cfg, num_layers=(a + 1) * pat + tail), G)]]
    if cfg.family == "audio":
        return [dc_replace(cfg, num_layers=a, num_decoder_layers=a),
                [(dc_replace(cfg, num_layers=a + 1, num_decoder_layers=a),
                  cfg.num_layers),
                 (dc_replace(cfg, num_layers=a, num_decoder_layers=a + 1),
                  cfg.num_decoder_layers)]]
    return [dc_replace(cfg, num_layers=a),
            [(dc_replace(cfg, num_layers=a + 1), cfg.num_layers)]]


def _units(cfg: ModelConfig) -> list:
    if cfg.family == "hybrid":
        return [cfg.num_layers // len(cfg.recurrent.block_pattern)]
    if cfg.family == "audio":
        return [cfg.num_layers, cfg.num_decoder_layers]
    return [cfg.num_layers]


@dataclass
class Counted:
    """A cell's traced global counts and its outputs at full depth."""
    flops: float
    bytes: float
    peak: float
    out: Any


def count_full(cell: Cell) -> Counted:
    """The whole step at the cell's depth (one microbatch x accum)."""
    t = _trace(cell.fn, cell.args, cell)
    return Counted(t.flops, t.bytes, t.peak_bytes, t.out)


def count_extrapolated(cell: Cell) -> Counted:
    """The step of ``a`` and ``a + 1`` repeated units (``a`` =
    ``EXTRAPOLATE_FROM``), extrapolated to the cell's depth."""
    a = EXTRAPOLATE_FROM
    if min(_units(cell.cfg)) <= a + 1:
        return count_full(cell)
    base_cfg, deeper = _depths(cell.cfg, a)
    t0 = _trace(*cell.make(base_cfg), cell)
    flops, nbytes, peak = t0.flops, t0.bytes, t0.peak_bytes
    for c, units in deeper:
        t1 = _trace(*cell.make(c), cell)
        n = units - a
        flops += n * (t1.flops - t0.flops)
        nbytes += n * (t1.bytes - t0.bytes)
        peak += n * (t1.peak_bytes - t0.peak_bytes)
    return Counted(flops, nbytes, peak, _full_depth_out(cell, t0.out))


def _full_depth_out(cell: Cell, out):
    """The outputs of the step at ``a`` units (prefill: the token and its
    caches, stacked per layer) restacked to the cell's depth; decode's
    caches are the full-depth arguments it was given."""
    if cell.shape.mode == "decode":
        return out[0], cell.args[1]
    units = _units(cell.cfg)

    def restack(name: str, t: torch.Tensor) -> torch.Tensor:
        top = name.split("/")[0]
        if top == "tail":
            lead = t.shape[0]
        elif cell.cfg.family == "audio":
            lead = units[1]
        else:
            lead = units[0]
        return torch.empty((lead,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device="meta")
    return out[0], tree_map_with_names(restack, out[1])


def count_cell(cell: Cell, memo: Optional[dict] = None) -> Counted:
    """Train cells trace their full depth, prefill and decode cells
    extrapolate.  ``memo`` keeps the counts of a global step that another
    mesh's cell already traced: prefill and decode run the same global
    program on both meshes (but for the MoE group count)."""
    key = (repr(cell.cfg), cell.shape, json.dumps(cell.plan, sort_keys=True),
           cell.rules.dp_size if cell.cfg.family == "moe" else None)
    if memo is not None and key in memo:
        return memo[key]
    counted = count_full(cell) if cell.shape.mode == "train" else \
        count_extrapolated(cell)
    if memo is not None:
        memo[key] = counted
    return counted


def cell_record(cell: Cell, counted: Counted) -> dict:
    """The roofline and memory keys of one counted cell."""
    n_dev = math.prod(mesh_sizes(cell.mesh).values())
    costs = StepCosts(flops=counted.flops / n_dev,
                      bytes=counted.bytes / n_dev)
    costs.add(_collectives(cell))
    terms = roofline_terms(costs)
    mem = memory_terms(cell, counted.out, counted.peak)
    mf_global = model_flops(cell.cfg, cell.shape)
    mf_per_dev = mf_global / n_dev
    rec = {
        "arg_gb_per_dev": mem["arg"] / 2**30,
        "temp_gb_per_dev": mem["temp"] / 2**30,
        "output_gb_per_dev": mem["output"] / 2**30,
        "alias_gb_per_dev": mem["alias"] / 2**30,
        "model_flops_global": mf_global,
        "model_flops_per_dev": mf_per_dev,
        "useful_flops_ratio": (mf_per_dev / costs.flops)
        if costs.flops else 0.0,
        **terms,
    }
    # peak HBM estimate: args + temps (aliased outputs reuse arg space)
    rec["hbm_gb_per_dev"] = rec["arg_gb_per_dev"] + rec["temp_gb_per_dev"] + \
        max(0.0, rec["output_gb_per_dev"] - rec["alias_gb_per_dev"])
    rec["fits_80gb"] = rec["hbm_gb_per_dev"] <= HBM_GB
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan: dict | None = None, recommended: bool = False,
             memo: Optional[dict] = None, device_type: str = "cpu") -> dict:
    """One cell's record; the caller holds a process group of the mesh's
    size (``fake_group``, or the launchers' real one)."""
    t0 = time.time()
    cell = build_cell(arch, shape_name, multi_pod, plan, recommended,
                      device_type)
    counted = count_cell(cell, memo)
    n_dev = math.prod(mesh_sizes(cell.mesh).values())
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "plan": cell.plan,
        "trace_s": round(time.time() - t0, 2),
        **cell_record(cell, counted),
    }
    return rec


def production(arch: str, shape_name: str, multi_pod: bool,
               device: str) -> dict:
    """The production launchers' path (``launch/train.py`` and
    ``launch/serve.py`` without ``--local``): the cell's record on the
    process group the caller has initialised (under ``torchrun``, from the
    environment), printed.  With no group of the mesh's size it exits with
    the mesh's own error; the mesh is never shrunk."""
    import torch.distributed as dist

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    try:
        rec = run_cell(arch, shape_name, multi_pod, device_type=device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    print(f"{SHAPES_BY_NAME[shape_name].mode} step:", json.dumps(rec))
    return rec


def fmt_row(r: dict) -> str:
    return (f"{r['arch']:>18s} {r['shape']:>11s} {r['mesh']:>7s} "
            f"trace={r['trace_s']:6.1f}s hbm={r['hbm_gb_per_dev']:7.2f}GB "
            f"tc={r['t_compute_s']*1e3:9.3f}ms tm={r['t_memory_s']*1e3:9.3f}ms "
            f"tcoll={r['t_collective_s']*1e3:9.3f}ms dom={r['dominant']:>10s} "
            f"useful={r['useful_flops_ratio']*100:5.1f}%")


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--plan", default=None, help="JSON dict of plan overrides")
    ap.add_argument("--recommended", action="store_true",
                    help="apply the EXPERIMENTS.md §Perf recommended plans")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    plan = json.loads(args.plan) if args.plan else None

    records, failures, memo = [], [], {}
    for arch in archs:
        cfg = get_config(arch)
        shapes = [s.name for s in applicable_shapes(cfg)]
        if args.shape != "all":
            shapes = [s for s in args.shape.split(",") if s in shapes or
                      SHAPES_BY_NAME.get(s)]
            shapes = [s for s in shapes
                      if s in [x.name for x in applicable_shapes(cfg)]]
        skipped = [s.name for s in ALL_SHAPES
                   if s.name not in [x.name for x in applicable_shapes(cfg)]]
        for sk in skipped:
            if args.shape in ("all",) or sk in args.shape.split(","):
                records.append({"arch": arch, "shape": sk, "mesh": "-",
                                "skipped": "long-context needs sub-quadratic attention"})
                print(f"{arch:>18s} {sk:>11s}    SKIP (full attention; DESIGN.md §4)")
        for shape_name in shapes:
            for multi in meshes:
                try:
                    with fake_group(512 if multi else 256):
                        r = run_cell(arch, shape_name, multi, plan,
                                     recommended=args.recommended, memo=memo)
                    records.append(r)
                    print(fmt_row(r), flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape_name, multi, repr(e)))
                    print(f"FAIL {arch} {shape_name} multi={multi}: {e}", flush=True)
                    traceback.print_exc()
                    if args.fail_fast:
                        raise

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"\nwrote {len(records)} records to {args.out}; {len(failures)} failures")
    if failures:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
