"""Roofline model of the port's step on one H100 SXM card of a mesh.

The JAX package derives its three roofline terms by walking the
post-optimization HLO text of the partitioned program.  A PyTorch step
has no such text, so the walker (``HloModule``, ``analyze_hlo_text``) is
not ported; ``count_step`` counts the port's own program instead, by
running it once on ``meta`` tensors (shapes and dtypes, no data):

  * FLOPs        — ``torch.utils.flop_counter.FlopCounterMode`` over the
                   step (every matmul, forward, backward and remat
                   recomputation), divided by ``n_dev``: the step runs on
                   the GLOBAL shapes, and the rules shard every product
                   evenly, so global / n_dev is one device's share.  On the
                   reference's tiny dense cell this equals the walker's
                   per-device dot count exactly.
  * HBM bytes    — the input plus output bytes of every aten op the step
                   dispatches, divided by ``n_dev``.  View and metadata
                   ops (views, ``detach``, ``empty``) are skipped, as the
                   walker skips bitcast, tuple and get-tuple-element, and so
                   are ops that read a tensor not on ``meta`` (a constant
                   brought in, such as the RoPE table's first copy: the
                   walker skips ``constant``).  This is EAGER per-op
                   traffic: every intermediate goes through HBM.  The
                   walker counts at fusion granularity, where a fusion's
                   internals stay on chip, so this term is larger than
                   the reference's for the same step — a model of what
                   the port's eager step moves, not a measurement.
  * collectives  — not traced (the model runs on plain tensors): counted
                   from the sharding rules' placements by
                   ``collective_costs``, as operand bytes per device like
                   the walker's, under the walker's type names: FSDP
                   all-gathers of each sharded weight (forward, and again
                   in the backward), reduce-scatter of their gradients,
                   all-reduce of replicated gradients over the data axes,
                   the tensor-parallel all-reduce of each row-parallel
                   output (forward) and of its column-parallel partner's
                   input gradient (backward), and the MoE all-to-all
                   (dispatch and combine) where experts shard over
                   'model'.  XLA may hoist, fuse or pick other collectives
                   (the walker's tiny cell shows all-reduce where this
                   model has reduce-scatter), so this term is a model too.

All numbers are PER DEVICE.  Hardware model: one H100 SXM — the dense
bf16 tensor-core peak and the HBM3 rate of NVIDIA's H100 data sheet
(``kernels/rates.py``), and the per-card inter-node link of NVIDIA's DGX
H100 data sheet (one ConnectX-7 400 Gb/s NDR InfiniBand port per GPU,
50 GB/s), which a collective over a 256- or 512-card mesh spanning many
nodes runs at.

``roofline_terms`` and ``model_flops`` are the reference's arithmetic.
The record keys stay the reference's, ``hlo_*_per_dev`` included, so both
packages' records are read by the same keys; here those keys hold the
counts above, not an HLO walk.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.rates import card_rates
from repro_torch.utils.trees import tree_flatten_with_names, tree_leaves

_H100 = card_rates("H100")
PEAK_FLOPS = _H100.bf16      # 989e12 dense bf16 per card
HBM_BW = _H100.hbm           # 3.35e12 bytes/s per card
LINK_BW = 50e9               # bytes/s per card, 400 Gb/s NDR InfiniBand

_aten = torch.ops.aten
#: ops that allocate or relabel without moving data
_NO_TRAFFIC = {_aten.detach.default, _aten.alias.default,
               _aten.lift_fresh.default, _aten.empty.memory_format,
               _aten.empty_strided.default, _aten.empty_like.default,
               _aten.new_empty.default, _aten.new_empty_strided.default}


@dataclass
class StepCosts:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    by_type: dict = field(default_factory=dict)

    def add(self, other: "StepCosts", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.by_type.items():
            self.by_type[k] = self.by_type.get(k, 0.0) + v * mult


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Sums the input and output bytes of every aten op and keeps the
    timeline of the storages the ops create (``events``: (+1 | -1,
    serial, bytes)), from which ``peak_bytes`` reads the live peak."""

    def __init__(self, keep: tuple = ()):
        super().__init__()
        self.bytes = 0
        self.events: list = []
        self._keep = {id(s): s for s in keep}   # storages made before
        self._live: dict = {}
        self._serial = 0

    def _made(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) in self._keep or id(st) in self._live:
            return
        n, k = st.nbytes(), self._serial
        self._serial += 1
        self.events.append((1, k, n))
        self._live[id(st)] = k
        weakref.finalize(st, self._freed, id(st), k, n)

    def _freed(self, sid: int, k: int, n: int) -> None:
        self.events.append((-1, k, n))
        if self._live.get(sid) == k:
            del self._live[sid]

    def made_by(self, out) -> dict:
        """serial -> bytes of the live storages under ``out``'s tensors
        that the traced ops made."""
        made = {}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                k = self._live.get(id(t.untyped_storage()))
                if k is not None:
                    made[k] = t.untyped_storage().nbytes()
        return made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _NO_TRAFFIC or func.is_view:
            return out
        ins = [a for a in _pt_leaves((args, kwargs or {}))
               if isinstance(a, torch.Tensor)]
        if any(a.device.type != "meta" for a in ins):
            return out          # a constant brought onto the device
        outs = [t for t in _pt_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(a) for a in ins) + \
            sum(_nbytes(t) for t in outs)
        for t in outs:
            self._made(t)
        return out

    def peak_bytes(self, exclude: set = frozenset()) -> int:
        live = peak = 0
        for sign, k, n in self.events:
            if k in exclude:
                continue
            live += sign * n
            peak = max(peak, live)
        return peak


@dataclass
class Trace:
    """One run of a step on ``meta`` tensors: its global counts."""
    flops: int
    bytes: int
    peak_bytes: int          # live storages the step made, outputs excluded
    output_bytes: int        # storages of the outputs the step made
    out: Any


def trace_step(fn: Callable, *args) -> Trace:
    """Run ``fn(*args)`` once under the flop counter and the traffic
    mode; the args are ``meta`` tensors (trees of them)."""
    keep = tuple(a.untyped_storage() for a in tree_leaves(args)
                 if isinstance(a, torch.Tensor))
    fc = FlopCounterMode(display=False)
    tr = _Traffic(keep)
    with fc, tr:
        out = fn(*args)
    made = tr.made_by(out)
    return Trace(int(fc.get_total_flops()), int(tr.bytes),
                 int(tr.peak_bytes(set(made))), int(sum(made.values())),
                 out)


def trace_accumulated(fn: Callable, state, batch, accum: int) -> Trace:
    """A train step with ``accum`` microbatches counted from one trace of
    its parts (``make_train_step``'s ``parts``): begin, ONE microbatch,
    whose flops and bytes count ``accum`` times, and finish.  Every
    microbatch runs on the same live set, so the peak is the trace's.
    Equal to ``trace_step`` of the whole step."""
    begin, micro, finish = fn.parts
    keep = tuple(a.untyped_storage() for a in tree_leaves((state, batch)))
    fc = FlopCounterMode(display=False)
    tr = _Traffic(keep)
    params = state["params"]
    with fc, tr:
        mbs, gsum, loss = begin(params, batch)
        f0, b0 = fc.get_total_flops(), tr.bytes
        gsum, loss = micro(params, {k: v[0] for k, v in mbs.items()},
                           gsum, loss)
        f1, b1 = fc.get_total_flops(), tr.bytes
        out = finish(state, gsum, loss)
    made = tr.made_by(out)
    flops = fc.get_total_flops() + (accum - 1) * (f1 - f0)
    nbytes = tr.bytes + (accum - 1) * (b1 - b0)
    return Trace(int(flops), int(nbytes), int(tr.peak_bytes(set(made))),
                 int(sum(made.values())), out)


def count_step(fn: Callable, *args, n_dev: int = 1) -> StepCosts:
    """Per-device flops and bytes of one call of ``fn(*args)`` on
    ``meta`` tensors (the traced terms over ``n_dev``); the collectives,
    the third term, come from ``collective_costs``."""
    t = trace_step(fn, *args)
    return StepCosts(flops=t.flops / n_dev, bytes=t.bytes / n_dev)


# ---------------------------------------------------------------------------
# Collectives from the rules' placements
# ---------------------------------------------------------------------------

#: (f, d) weights whose 'model'-sharded first dim makes them row-parallel
_ROW_PARALLEL = ("w_down", "w_out", "cm_wv", "w_o", "wB")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_axes(spec) -> set:
    return {a for e in spec for a in _axes(e)}


def local_numel(shape, spec, sizes: dict) -> int:
    """Elements of one device's shard of a ``shape`` tensor under
    ``spec`` (the rules shard only dims the axes divide)."""
    n = math.prod(shape)
    for e in spec:
        for a in _axes(e):
            n //= sizes[a]
    return n


def _stack_of(name: str) -> str:
    """"enc" for the audio encoder's weights, "dec" for every other."""
    return "enc" if name.split("/")[0] == "enc_layers" else "dec"


def collective_costs(rules, params: Any, batch: dict, *, mode: str,
                     accum: int = 1, act_bytes: int = 2) -> StepCosts:
    """Operand bytes per device of the collectives the rules' placements
    imply for one step of ``mode`` ("train", "prefill" or "decode") on
    ``batch`` (the GLOBAL batch; a train step runs ``accum`` microbatches
    of it).  ``params`` is the params tree (``meta`` tensors are enough);
    ``act_bytes`` the activation dtype's size."""
    cfg = rules.cfg
    sizes = mesh_sizes(rules.mesh)
    n_dev = math.prod(sizes.values())
    dp = set(_axes(rules.dp))
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    fsdp = set(_axes(rules.fsdp))
    tp = rules.tp
    tp_size = sizes[tp] if tp else 1
    train = mode == "train"
    steps = accum if train else 1

    lead = batch.get("tokens", batch.get("frames"))
    B = lead.shape[0] // steps
    if mode == "decode":
        tok = {"enc": B, "dec": B}
    elif cfg.family == "audio":
        tok = {"enc": B * lead.shape[1],
               "dec": B * batch["dec_tokens"].shape[1]}
    else:
        tok = {"enc": B * lead.shape[1], "dec": B * lead.shape[1]}
    b_local = dp_size if B % dp_size == 0 else 1
    local = {k: v // b_local for k, v in tok.items()}

    out = StepCosts()

    def put(kind: str, nbytes: float) -> None:
        out.collective_bytes += nbytes
        out.by_type[kind] = out.by_type.get(kind, 0.0) + nbytes

    passes = 2 if train else 1           # forward (+ backward)
    for name, leaf in tree_flatten_with_names(params):
        shape = tuple(leaf.shape)
        spec = rules.param_spec(name, shape)
        axes = _spec_axes(spec)
        nbytes = local_numel(shape, spec, sizes) * leaf.element_size()
        if axes & fsdp:
            put("all-gather", passes * steps * nbytes)
            if train:
                fs = math.prod(sizes[a] for a in axes & fsdp)
                put("reduce-scatter", steps * nbytes * fs)
        elif train and dp_size > 1 and not axes & dp:
            put("all-reduce", steps * nbytes)
        if tp is None or tp_size == 1 or "/moe/" in f"/{name}/":
            continue            # experts: with their buffers below
        leafname = name.split("/")[-1]
        d = cfg.d_model
        if leafname == "wo":
            base, row = 3, tp in _axes(spec[-3]) or tp in _axes(spec[-2])
        elif leafname in _ROW_PARALLEL:
            base, row = 2, tp in _axes(spec[-2])
        elif leafname == "embed":
            # the vocab-sharded lookup, and the tied logits' backward
            if tp in _axes(spec[-2]):
                n = 1 + (1 if train and cfg.tie_embeddings else 0)
                put("all-reduce", steps * n * local["dec"] * d * act_bytes)
            continue
        elif leafname == "unembed":
            # column-parallel logits: their input gradient (backward)
            if train and tp in _axes(spec[-1]):
                put("all-reduce", steps * local["dec"] * d * act_bytes)
            continue
        else:
            continue
        if row:
            layers = math.prod(shape[:len(shape) - base])
            put("all-reduce", passes * steps * layers *
                local[_stack_of(name)] * shape[-1] * act_bytes)
    if cfg.family == "moe":
        _moe_collectives(rules, put, tok["dec"], passes, steps, n_dev,
                         act_bytes, tp, tp_size, sizes)
    return out


def _moe_collectives(rules, put, tokens: int, passes: int, steps: int,
                     n_dev: int, act_bytes: int, tp, tp_size: int,
                     sizes: dict) -> None:
    """All-to-all of the (G, E, C, d) dispatch buffer (dispatch and
    combine) where experts shard over 'model'; otherwise the experts'
    row-parallel ``w_down`` output all-reduces over 'model'."""
    cfg = rules.cfg
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    G = max(1, min(rules.dp_size, tokens))
    while tokens % G:
        G -= 1
    Tg = tokens // G
    C = min(int(max(4, math.ceil(k * Tg / E * mo.capacity_factor))), k * Tg)
    buf = G * E * C * cfg.d_model * act_bytes      # global buffer bytes
    ea = rules._expert_axis(E)
    if ea is not None:
        put("all-to-all", 2 * passes * steps * cfg.num_layers * buf / n_dev)
    elif tp is not None and tp_size > 1:
        spec = rules.act_spec("moe_buf", (G, E, C, cfg.d_model))
        shard = math.prod(sizes[a] for a in _spec_axes(spec))
        put("all-reduce",
            passes * steps * cfg.num_layers * buf / shard)


def mesh_sizes(mesh) -> dict:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


# ---------------------------------------------------------------------------
# The reference's arithmetic
# ---------------------------------------------------------------------------

def roofline_terms(costs: StepCosts) -> dict:
    """Per-device seconds for the three roofline terms + dominant."""
    t_compute = costs.flops / PEAK_FLOPS
    t_memory = costs.bytes / HBM_BW
    t_collective = costs.collective_bytes / LINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)),
        key=lambda kv: kv[1])[0]
    total = max(t_compute, t_memory, t_collective)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_step_s": total,
        "roofline_fraction": (t_compute / total) if total > 0 else 0.0,
        "collective_by_type": dict(costs.by_type),
        "hlo_flops_per_dev": costs.flops,
        "hlo_bytes_per_dev": costs.bytes,
        "collective_bytes_per_dev": costs.collective_bytes,
    }


def model_flops(cfg, shape, accum_unused: int = 1) -> float:
    """Analytic MODEL_FLOPS (global): 6·N·D train (N_active for MoE),
    2·N·D for inference shapes."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        if cfg.family == "audio":
            tokens = shape.global_batch * (shape.seq_len + shape.seq_len // cfg.dec_ratio)
        else:
            tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "audio":
            tokens = shape.global_batch * (shape.seq_len + shape.seq_len // cfg.dec_ratio)
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
