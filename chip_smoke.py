#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero, before the result line):

  build        compile the ckpt_delta CUDA kernels from the sources in this
               checkout (nvcc, sm_90a) and print the build seconds;
  kernels      hold each of the six kernels against its plain PyTorch
               version on the card, every output bit for bit: the four
               flat kernels (#1-#4) at small awkward sizes and at the packed
               size of the 2-layer yi-6b-width train state (2,611,015,680
               float32 elements, past 2^31), the two per-leaf encodes
               (#5/#6) at awkward leaf sizes and at every leaf shape of that
               state.  Time plain and kernel in turns (plain, kernel,
               kernel, plain) and compute each kernel's bound from the
               bytes it must move and the card's memory rate;
  calibration  the device section of the checkpoint calibration
               (``benchmarks/torch_bench_ckpt.py`` ``bench_device_delta``)
               on a fresh 2-layer yi-6b-width state: the fused encodes
               (#1/#2) against the per-leaf baseline (#5/#6, one launch per
               packed leaf and repetition).  No disk writes;
  lossless     run ``repro_torch``'s ResilientTrainer at yi-6b width with
               num_layers 32 -> 2 (bf16 compute, f32 params and AdamW
               state, batch 2 x 1024 tokens, random weights from a seed)
               under a device-placed incremental lossless plan: a full and
               a delta trigger, an injected task failure restored through
               the decode kernel and checked BIT-EQUAL to the saved state;
  artifact     the ``bench_ckpt/3`` calibration artifact: the host figures
               from the lossless half's own saves and restore, the rest
               from the bench at its own scale, loaded by the port's
               ``SimCostModel.from_calibration``;
  khaos 1-2    ``KhaosRuntime`` records the trainer stream's steady state
               and profiles a (failure point x CI) grid on simulated
               deployments priced by that cost model, fitting M_L and M_R;
  khaos 3      the runtime attaches to the live trainer; the backlog that
               the lossless delta's stall and the failure left (read on
               each side of both) violates the latency constraint and the
               controller's Decision switches the plan to int8;
  int8         under the switched plan: a full, an int8 delta trigger, a
               second failure and a restore checked within the per-group
               max|delta|/254 bound.

Kernel launch counts are set to 0 just before the calibration path and
read just after it (#5/#6), and again around the trainer path, from the
lossless half to the int8 half (#1-#4).  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
With no CUDA device, or without the ``src/repro_torch`` package beside
this file, it exits non-zero and prints no result.  Checkpoints go to
``.chip_smoke_ckpt/`` in the checkout and are removed at the end.
"""
from __future__ import annotations

import os

# set before torch initialises CUDA: the trainer phase holds ~60 GB of
# large, differently sized buffers and must not fragment
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import importlib.util
import json
import math
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CKPT_DIR = ROOT / ".chip_smoke_ckpt"
BENCH = ROOT / "benchmarks" / "torch_bench_ckpt.py"

GROUP = 1024
FLAT_ELEMENTS = 2_611_015_680      # packed 2-layer yi-6b-width train state
CHECK_CHUNK = GROUP << 18          # elements per plain-version comparison
RUN_S = 5e3                        # virtual-second cap of a scripted run()
INT8_SLACK = 1 + 2 ** -16 + 1e-6   # f32 rounding on top of amax/254
# awkward per-leaf shapes: 1, 1023, 1025, 3*1024+7 elements, a multi-dim
# leaf, and an all-unchanged leaf (the last)
LEAF_SHAPES = ((1,), (GROUP - 1,), (GROUP + 1,), (3 * GROUP + 7,),
               (3, 5, 70), (2, GROUP))

# the trainer's stream: a slow wave around STREAM_RATE events/s (one
# event is one 1024-token sequence; the job drains ~20/s on an H100)
STREAM_RATE = 4.0
STREAM_WAVE = 0.25                 # +-25 % over STREAM_PERIOD_S
STREAM_PERIOD_S = 3600.0
DETECT_S, RESTART_S = 2.0, 1.0     # trainer failure detection / restart
LOSSLESS_STEPS = 20                # steps of the lossless half
KHAOS_PERIOD_S = 5.0               # controller optimization period
CI_GRID = (1.5, 3.0, 6.0)          # profiled CIs, x the calibrated full write

KERNELS = {
    # name: (TPU kernel replaced, bytes per element, ops per element)
    "flat_lossless_encode": ("src/repro/kernels/ckpt_delta/kernel.py:198",
                             16 + 8 / GROUP, 5),
    "flat_int8_encode": ("src/repro/kernels/ckpt_delta/kernel.py:240",
                         9 + 8 / GROUP, 9),
    "lossless_decode": ("src/repro/kernels/ckpt_delta/kernel.py:152",
                        16, 2),
    "delta_decode": ("src/repro/kernels/ckpt_delta/kernel.py:267",
                     5 + 4 / GROUP, 2),
    "lossless_encode": ("src/repro/kernels/ckpt_delta/kernel.py:128",
                        16, 3),
    "delta_encode": ("src/repro/kernels/ckpt_delta/kernel.py:82",
                     9 + 4 / GROUP, 7),
}
#: the path whose launch counts each kernel's row reports
CALIBRATION_KERNELS = ("lossless_encode", "delta_encode")
SOURCE = "src/repro_torch/kernels/ckpt_delta/csrc/ckpt_delta.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave no output"


def card_rates(name: str) -> tuple[float, float]:
    """(HBM bytes/s, fp32 non-tensor FLOP/s) of the SKU NVIDIA's data
    sheets name; an unknown card fails the run rather than guess."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    if "H100" in name:
        return 3.35e12, 67e12
    raise SmokeFailure(f"no published rates for card {name!r}")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _diff(a, b) -> tuple[int, float]:
    """(bitwise mismatches, max |a - b|) of two same-shape tensors."""
    import torch
    if a.dtype == torch.float32:
        bits = (a.view(torch.int32) != b.view(torch.int32)).sum()
        err = (a - b).abs().nan_to_num(float("inf")).max() if a.numel() \
            else a.new_zeros(())
    else:
        bits = (a != b).sum()
        err = (a.to(torch.float64) - b.to(torch.float64)).abs().max() \
            if a.numel() else a.new_zeros((), dtype=torch.float64)
    return int(bits), float(err)


def _compare(kernel_out, plain_fn, n: int, group_outs: tuple) -> tuple:
    """Compare kernel outputs with the plain version chunk by chunk (the
    plain version is elementwise per group, so a chunk of whole groups
    gives the same bits as the whole buffer and bounds the memory)."""
    mism, err = 0, 0.0
    for a in range(0, n, CHECK_CHUNK):
        b = min(n, a + CHECK_CHUNK)
        plain = plain_fn(a, b)
        for i, (k, p) in enumerate(zip(kernel_out, plain)):
            sl = slice(a // GROUP, b // GROUP) if i in group_outs \
                else slice(a, b)
            m, e = _diff(k[sl], p)
            mism += m
            err = max(err, e)
        del plain
    return mism, err


def _time(fn, reps: int = 2) -> float:
    """Mean ms of ``reps`` single calls, CUDA events around each; the
    output is freed before the next call."""
    import torch
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        del out
    return total / reps


def _turns(kernel_fn, plain_fn) -> tuple[float, float]:
    """plain, kernel, kernel, plain: (kernel ms, plain ms)."""
    import torch
    for fn in (kernel_fn, plain_fn):      # warm both once, one at a time
        out = fn()
        del out
    torch.cuda.synchronize()
    p1 = _time(plain_fn)
    k1 = _time(kernel_fn)
    k2 = _time(kernel_fn)
    p2 = _time(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_phase(dev, hbm: float, flops: float) -> dict:
    import torch
    from repro_torch.kernels.ckpt_delta import kernel as K
    from repro_torch.kernels.ckpt_delta import ref as R

    results: dict = {}

    def record(name, n, mism, err, timing=None):
        r = results.setdefault(name, {"mismatches": 0, "max_abs_err": 0.0})
        r["mismatches"] += mism
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timing is not None:
            r.update(ms=timing[0], plain_ms=timing[1], elements=n,
                     **_bound(name, n, hbm, flops))

    for n in (7 * GROUP, 3001 * GROUP, FLAT_ELEMENTS):
        big = n == FLAT_ELEMENTS
        t0 = time.monotonic()
        gen = torch.Generator(device=dev).manual_seed(n % 9973)
        base = torch.randn(n, device=dev, generator=gen)
        new = torch.randn(n, device=dev, generator=gen).mul_(1e-3).add_(base)
        new[::97] *= -3.7                       # residual-bearing elements
        new[5::4099] = base[5::4099]            # unchanged elements
        new[:4 * GROUP] = base[:4 * GROUP]      # whole unchanged groups

        # #1 lossless encode
        kout = K.lossless_encode_groups(new, base)
        m, e = _compare(kout, lambda a, b: R.lossless_encode_groups(
            new[a:b], base[a:b]), n, (2, 3))
        check(m == 0, f"flat_lossless_encode differs from plain at n={n}: "
                      f"{m} mismatches")
        check(int(kout[3].sum()) > 0 and int((kout[2] == 0).sum()) >= 4,
              "lossless test data lacks residuals or unchanged groups")
        del kout
        timing = _turns(lambda: K.lossless_encode_groups(new, base),
                        lambda: R.lossless_encode_groups(new, base)) \
            if big else None
        record("flat_lossless_encode", n, m, e, timing)
        d, r = K.lossless_encode_groups(new, base)[:2]

        # #3 lossless decode (of the kernel's own encode): the round trip
        out = K.lossless_decode(base, d, r)
        rt = int((out.view(torch.int32) != new.view(torch.int32)).sum())
        check(rt == 0, f"lossless round trip lost {rt} bit patterns")
        del out, new
        m, e = _compare((K.lossless_decode(base, d, r),),
                        lambda a, b: (R.lossless_decode(base[a:b], d[a:b],
                                                        r[a:b]),), n, ())
        check(m == 0, f"lossless_decode differs from plain at n={n}: {m}")
        timing = _turns(lambda: K.lossless_decode(base, d, r),
                        lambda: R.lossless_decode(base, d, r)) \
            if big else None
        record("lossless_decode", n, m, e, timing)
        del d, r
        torch.cuda.empty_cache()

        # #2 int8 encode (new rebuilt from the same seed)
        gen = torch.Generator(device=dev).manual_seed(n % 9973)
        torch.randn(n, device=dev, generator=gen)          # skip base draw
        new = torch.randn(n, device=dev, generator=gen).mul_(1e-3).add_(base)
        new[::97] *= -3.7
        kout = K.int8_encode_groups(new, base)
        m, e = _compare(kout, lambda a, b: R.int8_encode_groups(
            new[a:b], base[a:b]), n, (1, 2))
        check(m == 0, f"flat_int8_encode differs from plain at n={n}: {m} "
                      f"mismatches (ties included)")
        timing = _turns(lambda: K.int8_encode_groups(new, base),
                        lambda: R.int8_encode_groups(new, base)) \
            if big else None
        record("flat_int8_encode", n, m, e, timing)
        q, s = kout[0], kout[1]
        del kout

        # #4 int8 decode, and the documented error bound
        dq = K.delta_decode(q, s)
        m, e = _compare((dq,), lambda a, b: (R.delta_decode(
            q[a:b], s[a // GROUP:b // GROUP]),), n, ())
        check(m == 0, f"delta_decode differs from plain at n={n}: {m}")
        # |q * scale - d| <= amax/254 per group, in float64, up to the f32
        # roundings of the quotient d / scale (half an ulp of |q| <= 127:
        # 2^-17, i.e. 2^-16 of the half-step) and of scale and q * scale
        worst = 0.0
        for a in range(0, n, CHECK_CHUNK):
            b = min(n, a + CHECK_CHUNK)
            delta = (new[a:b] - base[a:b]).view(-1, GROUP).double()
            bound = delta.abs().amax(1, keepdim=True).clamp_min(1e-12) \
                * (INT8_SLACK / 254)
            err = (dq[a:b].view(-1, GROUP).double() - delta).abs()
            worst = max(worst, float((err / bound).max()))
        check(worst <= 1.0, f"int8 error reaches {worst} x amax/254")
        del dq, new
        timing = _turns(lambda: K.delta_decode(q, s),
                        lambda: R.delta_decode(q, s)) if big else None
        record("delta_decode", n, m, e, timing)
        del q, s, base
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"kernels n={n}: every output equals the plain version "
            f"({time.monotonic() - t0:.1f} s)")
    for name, r in results.items():
        log(f"  {name}: {r['ms']:.3f} ms kernel, {r['plain_ms']:.3f} ms "
            f"plain, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"mismatches {r['mismatches']}, max_abs_err {r['max_abs_err']}")
    return results


def _bound(name: str, n: int, hbm: float, flops: float) -> dict:
    """The least time the card could take for ``n`` elements: bytes over
    the HBM rate or operations over the fp32 rate, whichever is larger."""
    bytes_per, ops_per = KERNELS[name][1], KERNELS[name][2]
    b_ms = n * bytes_per / hbm * 1e3
    o_ms = n * ops_per / flops * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def _state_leaves(model_cfg) -> list:
    """(name, shape) of every f32 leaf of the train state, from a state
    built on the meta device (no memory)."""
    import torch
    from repro_torch.config import OptimizerConfig
    from repro_torch.models import zoo
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.trees import tree_flatten_with_names

    meta = zoo.init_state(model_cfg, make_optimizer(OptimizerConfig()),
                          None, "meta")
    return [(name, tuple(leaf.shape))
            for name, leaf in tree_flatten_with_names(meta)
            if leaf.dtype == torch.float32]


def per_leaf_phase(dev, hbm: float, flops: float, leaves: list) -> dict:
    """Kernels #5/#6 (the per-leaf encodes) against their plain versions:
    at awkward leaf sizes through the wrappers (padding, ``changed``,
    ``resid_nnz``), then at every leaf shape of the train state, as views
    into one packed pair, every output bit for bit; then timed over all
    the leaves in turns."""
    import torch
    from repro_torch.checkpoint.pipeline import FlatLayout
    from repro_torch.kernels.ckpt_delta import kernel as K
    from repro_torch.kernels.ckpt_delta import ops
    from repro_torch.kernels.ckpt_delta import ref as R

    res = {name: {"mismatches": 0, "max_abs_err": 0.0}
           for name in CALIBRATION_KERNELS}

    def record(name, outs, plain):
        r = res[name]
        for k, p in zip(outs, plain):
            m, e = _diff(k, p)
            r["mismatches"] += m
            r["max_abs_err"] = max(r["max_abs_err"], e)

    gen = torch.Generator(device=dev).manual_seed(5)
    for i, shape in enumerate(LEAF_SHAPES):
        base = torch.randn(shape, device=dev, generator=gen)
        new = base.clone()
        if i < len(LEAF_SHAPES) - 1:                 # the last: unchanged
            new += 1e-2 * torch.randn(shape, device=dev, generator=gen)
            new.view(-1)[::7] *= -3.7                # residual-bearing
        nf, bf = R.pad_to_groups(new), R.pad_to_groups(base)
        d, r, changed, nnz = ops.lossless_encode_leaf(new, base)
        pd, pr = R.lossless_encode(nf, bf)
        record("lossless_encode", (d, r), (pd, pr))
        check(bool(changed) == bool((new != base).any()) and
              int(nnz) == int(torch.count_nonzero(pr)),
              f"lossless_encode_leaf stats wrong at shape {shape}")
        q, s, changed8 = ops.int8_encode_leaf(new, base)
        record("delta_encode", (q, s), R.int8_encode(nf, bf))
        check(bool(changed8) == bool(changed),
              f"int8_encode_leaf changed flag wrong at shape {shape}")

    layout = FlatLayout(leaves)
    check(layout.total == FLAT_ELEMENTS,
          f"train state packs to {layout.total}, not {FLAT_ELEMENTS}")
    base = torch.randn(layout.total, device=dev, generator=gen)
    new = torch.randn(layout.total, device=dev,
                      generator=gen).mul_(1e-3).add_(base)
    new[::97] *= -3.7
    new[5::4099] = base[5::4099]
    views = [(new[e.offset:e.offset + e.size].view(e.shape),
              base[e.offset:e.offset + e.size].view(e.shape))
             for e in layout.entries]
    seen = set()
    for (nv, bv), entry in zip(views, layout.entries):
        if entry.shape in seen:
            continue
        seen.add(entry.shape)
        nf, bf = R.pad_to_groups(nv), R.pad_to_groups(bv)
        record("lossless_encode", K.lossless_encode(nf, bf),
               R.lossless_encode(nf, bf))
        record("delta_encode", K.int8_encode(nf, bf), R.int8_encode(nf, bf))
    for name in CALIBRATION_KERNELS:
        check(res[name]["mismatches"] == 0,
              f"{name} differs from plain: {res[name]['mismatches']} "
              f"mismatches")
    log(f"per-leaf kernels: every output equals the plain version at "
        f"{len(LEAF_SHAPES)} awkward shapes and all {len(seen)} leaf "
        f"shapes of the train state")

    def over_leaves(fn):
        def run():
            for nv, bv in views:
                fn(R.pad_to_groups(nv), R.pad_to_groups(bv))
        return run

    for name, kfn, pfn in (("lossless_encode", K.lossless_encode,
                            R.lossless_encode),
                           ("delta_encode", K.int8_encode, R.int8_encode)):
        ms, plain_ms = _turns(over_leaves(kfn), over_leaves(pfn))
        res[name].update(ms=ms, plain_ms=plain_ms, elements=layout.total,
                         **_bound(name, layout.total, hbm, flops))
        r = res[name]
        log(f"  {name}: {r['ms']:.3f} ms kernel over {len(views)} leaves, "
            f"{r['plain_ms']:.3f} ms plain, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})")
    del views, base, new
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def calibration_phase(model_cfg, dev) -> dict:
    """The device section of the checkpoint calibration on a fresh train
    state of its own (freed after): fused encodes vs the per-leaf
    baseline, and one DeltaLeafSource trigger's bytes on the link."""
    import torch
    from repro_torch.config import OptimizerConfig
    from repro_torch.models import zoo
    from repro_torch.optim import make_optimizer

    bench = _bench()
    gen = torch.Generator(device=dev).manual_seed(1)
    state = zoo.init_state(model_cfg, make_optimizer(OptimizerConfig()),
                           gen, dev)
    torch.cuda.synchronize()
    device_section = bench.bench_device_delta(state=state, reps=5)
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return device_section


def _bench():
    """``benchmarks/torch_bench_ckpt.py``, by path."""
    spec = importlib.util.spec_from_file_location("torch_bench_ckpt", BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# trainer phase
# ---------------------------------------------------------------------------

def _flat(state: dict) -> dict:
    from repro_torch.utils.trees import tree_flatten_with_names
    return {n: a for n, a in tree_flatten_with_names(state)}


def _on(x, device):
    import torch
    return torch.from_numpy(x).to(device) if not isinstance(x, torch.Tensor) \
        else x


def _check_bit_equal(got: dict, want: dict, what: str) -> None:
    """``got``: the live state's tensors; ``want``: host copies.  Compared
    on the device, byte for byte."""
    import torch
    check(got.keys() == want.keys(), f"{what}: leaf names differ")
    for k, a in got.items():
        b = _on(want[k], a.device)
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {k} dtype/shape differ")
        check(torch.equal(a.reshape(-1).view(torch.uint8),
                          b.reshape(-1).view(torch.uint8)),
              f"{what}: {k} is not bit-equal")


def _check_int8_bound(got: dict, want: dict, base: dict) -> float:
    """Every f32 element within max|delta_group|/254 of the saved value
    (times INT8_SLACK, plus one ulp each for the two f32 roundings of
    delta and base + delta); every other leaf exact.  Computed on the
    device in float64.  Returns the worst bound margin."""
    import torch
    worst = -float("inf")
    for k, a in got.items():
        w, b = _on(want[k], a.device), _on(base[k], a.device)
        if w.dtype != torch.float32:
            check(torch.equal(a, w), f"int8 restore: {k} differs")
            continue
        a, w, b = a.reshape(-1), w.reshape(-1), b.reshape(-1)
        n = w.numel()
        dw = torch.nn.functional.pad(w - b, (0, (-n) % GROUP))
        amax = dw.view(-1, GROUP).abs().amax(1).clamp_min(1e-12)
        bound = (amax.double() * (INT8_SLACK / 254)).repeat_interleave(
            GROUP)[:n]
        big = torch.maximum(w.abs(), b.abs())
        ulp = (torch.nextafter(big, big.new_tensor(float("inf"))) - big)
        err = (a.double() - w.double()).abs()
        margin = err - bound - 2 * ulp.double()
        worst = max(worst, float(margin.max()))
    check(worst <= 0, f"int8 restore exceeds the amax/254 bound by {worst}")
    return worst


class _StopRun(Exception):
    """Raised by a scripted on-step callback to end a trainer run between
    two steps."""


def wave_rate(base: float, amplitude: float, period: float):
    """The stream's rate schedule: ``base * (1 + amplitude * sin(2 pi t /
    period))`` events/s (its trough and peak lie inside one period, where
    Phase 1 finds them)."""
    return lambda t: base * (1.0 + amplitude * math.sin(2 * math.pi * t
                                                        / period))


class TrainerRun:
    """The live trainer and the scripts that drive it, phase by phase."""

    def __init__(self, model_cfg, device, ckpt_dir: Path, batch: int,
                 seq_len: int):
        from repro_torch.config import CheckpointPlan, OptimizerConfig
        from repro_torch.data.stream import EventStream
        from repro_torch.runtime import (ResilientTrainer, TrainerConfig,
                                         TrainerJobHandle)

        # replication_factor 0: the card's machine takes at most 45 GiB of
        # disk writes per run, and the run writes three full snapshots
        # (10.44 GB each) and two deltas; one ring replica per shard would
        # double every full (the replicated store is exercised by the CPU
        # tests).  keep 1: every newest()/gc CRC-reads each kept full
        self.plan = CheckpointPlan(interval_s=1e9, mode="incremental",
                                   full_every=2, encode_placement="device",
                                   delta_codec="lossless", levels=("local",),
                                   sync=True, codec="zlib",
                                   replication_factor=0, keep=1)
        self.schedule = wave_rate(STREAM_RATE, STREAM_WAVE, STREAM_PERIOD_S)
        self.tcfg = TrainerConfig(batch=batch, seq_len=seq_len,
                                  ckpt_dir=str(ckpt_dir), detect_s=DETECT_S,
                                  restart_s=RESTART_S, plan=self.plan)
        self.tr = ResilientTrainer(
            model_cfg, self.tcfg, EventStream(schedule=self.schedule),
            OptimizerConfig(total_steps=1000, lr=1e-4, warmup_steps=1),
            seed=0, device=device)
        self.job = TrainerJobHandle(self.tr)
        self.saved: dict = {}
        self.lags: dict = {}      # name -> the stream's backlog (events)

    # -- scripted actions ----------------------------------------------
    def trigger(self):
        """Make the next loop's cadence check due, once: the interval (1e9
        s between the scripted triggers) stays; the last trigger moves one
        interval back."""
        policy = self.tr.policy
        policy.mark(self.tr.t - policy.interval_s)

    def quiet(self):
        """No cadence trigger: the checkpoints are the script's."""
        self.job.reconfigure(1e9)

    def read_lag(self, name: str):
        """Record the stream's backlog at the job's clock now (the
        loop's next ``produce_until`` would bring it to the same)."""
        def read():
            self.tr.stream.produce_until(self.tr.t)
            self.lags[name] = self.tr.stream.lag
        return read

    def copy(self, key: str):
        from repro_torch.models.zoo import state_to_numpy
        self.saved[key] = _flat(state_to_numpy(self.tr.state))

    def run_script(self, script: dict) -> None:
        """Run until the script's ``"stop"`` step: at step k (counted from
        this call) run ``script[k]``'s actions."""
        tr, k0 = self.tr, len(self.tr.losses)

        def on_step(info):
            k = len(tr.losses) - k0
            log(f"  step {int(tr.state['step'].item())}: loss "
                f"{info['loss']:.6f}, lag {info['lag']}")
            for action in script.get(k, ()):
                if action == "stop":
                    raise _StopRun
                action()
        try:
            tr.run(duration_s=RUN_S, on_second=on_step)
        except _StopRun:
            return
        raise SmokeFailure(f"script {sorted(script)} did not reach its stop")

    def fail_and_restore(self) -> None:
        """A task failure now; the run lasts exactly the detection and
        restart time, so it returns right after the restore."""
        self.tr.inject_failure_at(self.tr.t, "task")
        self.tr.run(duration_s=self.tcfg.detect_s + self.tcfg.restart_s)
        check(self.tr.events[-1]["event"] == "restore",
              f"no restore after the failure: {self.tr.events[-3:]}")

    def ckpt_events(self) -> list:
        return [e for e in self.tr.events
                if e["event"] in ("checkpoint", "restore")]

    # -- phases ----------------------------------------------------------
    def lossless_half(self) -> None:
        """Full at step 2, lossless delta at step 4, task failure after
        step LOSSLESS_STEPS (the steps between give the job's step time),
        and a restore through the decode kernel checked bit-equal.  The
        backlog is read on each side of the delta's stall (its trigger
        blocks before step 5) and of the failure and restore."""
        self.run_script({2: [self.trigger],
                         4: [self.read_lag("before_delta"),
                             lambda: self.copy("lossless"), self.trigger],
                         5: [self.read_lag("after_delta")],
                         LOSSLESS_STEPS: [self.read_lag("before_failure"),
                                          "stop"]})
        self.fail_and_restore()
        self.read_lag("after_restore")()
        ev = self.ckpt_events()
        check([e["kind"] for e in ev] == ["full", "delta", "full+delta"],
              f"lossless phase events {ev}")
        _check_bit_equal(_flat(self.tr.state), self.saved.pop("lossless"),
                         "lossless full+delta restore")
        log("lossless full+delta restore is bit-equal to the saved state")

    def int8_half(self, n_before: int) -> float:
        """Under the int8 plan Khaos switched to: full, int8 delta, failure,
        and a restore within the per-group amax/254 bound."""
        self.quiet()
        self.run_script({1: [lambda: self.copy("base"), self.trigger],
                         3: [lambda: self.copy("int8"), self.trigger],
                         4: ["stop"]})
        self.fail_and_restore()
        ev = self.ckpt_events()[n_before:]
        check([e["kind"] for e in ev] ==
              ["savepoint", "full", "delta", "full+delta"],
              f"int8 phase events {ev}")
        margin = _check_int8_bound(_flat(self.tr.state), self.saved["int8"],
                                   self.saved["base"])
        log(f"int8 full+delta restore within max|delta|/254 (worst margin "
            f"{margin:.3e})")
        return margin

    def step_s(self) -> float:
        """Median step time of the run so far."""
        import numpy as np
        return float(np.median(self.tr.metrics.series("step_time").values))


def calibration_artifact(run: TrainerRun, device_section: dict,
                         bench_dir: Path, device) -> tuple[dict, dict]:
    """The bench_ckpt/3 artifact: state bytes, full write, restore and the
    lossless delta fraction from the lossless half's own saves and
    restore; the rest from the bench at its own scale (4) — it would take
    disk writes the run cannot afford at full width.  Returns (artifact,
    where each figure came from)."""
    from repro_torch.utils.trees import tree_bytes

    bench = _bench()
    ev = run.ckpt_events()
    full, delta, restore = ev[0], ev[1], ev[2]
    _, meas = bench.bench_checkpoint(str(bench_dir / "micro"), scale=4,
                                     device=device)
    _, plans = bench.bench_plans(str(bench_dir / "plans"), triggers=6,
                                 scale=4, device=device)
    shutil.rmtree(bench_dir, ignore_errors=True)
    meas.update(state_bytes=tree_bytes(run.tr.state),
                full_write_s=full["blocking_s"],
                restore_s=restore["duration_s"],
                delta_fraction_lossless=(delta["bytes_written"]
                                         / full["bytes_written"]))
    cal = bench.build_calibration(meas, plans, device_section)
    bench.validate_calibration(cal)
    sources = {
        "trainer (lossless half, full width)": [
            "state_bytes", "full_write_s", "restore_s", "delta_fraction"],
        "bench_checkpoint (scale 4)": [
            "delta_int8_fraction", "snapshot_full_copy_s",
            "async_blocking_s"],
        "bench_plans (scale 4, 6 triggers)": [
            "delta_encode_s_per_byte", "plans"],
        "bench_device_delta (full width)": ["device"]}
    return cal, sources


def khaos_phases(run: TrainerRun, cal: dict) -> dict:
    """Phases 1 and 2 on the host, then Phase 3 over the live trainer.

    The constraints, as a user would set them from the calibrated costs:
    the job may lag by the backlog that ONE lossless device delta, as the
    calibrated model prices its write, leaves behind (rate x priced write
    / capacity); recovery may take up to twice what the calibrated models
    predict for the job at its current CI.  The job runs at 1.5x the
    calibrated full write: the profiled grid spans 1.5x-6x of it."""
    import numpy as np
    from repro_torch.config import CheckpointPlan, KhaosConfig, replace
    from repro_torch.core import KhaosRuntime, optimize_plan
    from repro_torch.core.ci_optimizer import _variant_predictions
    from repro_torch.data.stream import record_workload
    from repro_torch.sim import SimCostModel, SimDeployment

    tr, plan = run.tr, run.tr.ckpt.plan
    int8 = replace(plan, delta_codec="int8")
    step_s = run.step_s()
    capacity = run.tcfg.batch / step_s
    cost = SimCostModel.from_calibration(
        cal, capacity_eps=capacity,
        base_latency_s=step_s,
        detect_s=run.tcfg.detect_s, restart_s=run.tcfg.restart_s)
    cis = [f * cost.ckpt_duration_s for f in CI_GRID]
    recording = record_workload(run.schedule, duration=STREAM_PERIOD_S,
                                seed=0)
    priced_lossless = cost.write_duration("delta", "local", "lossless",
                                          "device")
    l_const = float(recording.counts.mean()) * priced_lossless / capacity
    rt = KhaosRuntime(KhaosConfig(latency_constraint=l_const,
                                  optimization_period=KHAOS_PERIOD_S,
                                  ci_min=cis[0], ci_max=cis[-1],
                                  num_failure_points=2,
                                  num_configs=len(cis)),
                      cost=cost, plan_variants=[plan, int8])
    t0 = time.monotonic()
    rt.record_steady_state(recording)
    rt.run_profiling(lambda ci: SimDeployment(ci, recording, cost),
                     ci_values=cis)
    info = rt.phase_log[-1].info
    log(f"khaos phases 1-2: {rt.phase_sequence()}, {info['cells']} cells, "
        f"M_L error {info['m_l_pct_error']:.4f}, M_R error "
        f"{info['m_r_pct_error']:.4f} ({time.monotonic() - t0:.1f} s); "
        f"latencies {rt.profile.latencies.tolist()}, recoveries "
        f"{rt.profile.recoveries.tolist()}")

    # Phase 3: the job runs at cis[0]; its recovery priced there by the
    # optimizer's own re-pricing (on the optimizer's CI grid)
    tr_now = float(recording.counts.mean())
    _, recs, _ = _variant_predictions(rt.m_l, rt.m_r, cost, [plan],
                                      np.linspace(cis[0], cis[-1], 128),
                                      tr_now, CheckpointPlan())
    priced_recovery = float(recs[0][0])
    check(priced_recovery > 0, f"the fitted models price the job's recovery "
                               f"at {priced_recovery} s")
    rt.cfg = replace(rt.cfg, recovery_constraint=2.0 * priced_recovery)
    log(f"khaos constraints: latency {l_const:.4f} s (rate "
        f"{tr_now:.3f}/s x priced lossless delta {priced_lossless:.3f} s / "
        f"capacity {capacity:.3f}/s), recovery {rt.cfg.recovery_constraint:.3f}"
        f" s (2 x {priced_recovery:.3f} s priced at CI {cis[0]:.3f} s)")
    run.job.reconfigure(cis[0])
    # the recovered job restarts its checkpoint timer, as the simulated
    # job does on restart: the next trigger is one CI after the restore
    tr.policy.reset(tr.t)
    rt.attach(run.job)
    decisions = []

    def on_step(info):
        d = rt.step()
        if d is not None:
            decisions.append(d)
            run.lags[f"at_decision_{len(decisions)}"] = info["lag"]
            log(f"  decision at t={d.t:.3f}: {d.kind}, latency "
                f"{d.latency:.4f}, predicted recovery "
                f"{d.predicted_recovery:.4f}")
            if d.new_plan is not None:
                raise _StopRun
    try:
        # ends before the job's first trigger under its CI
        tr.run(duration_s=cis[0] - 1.0, on_second=on_step)
    except _StopRun:
        pass
    switch = next((d for d in decisions if d.new_plan is not None), None)
    if switch is None or switch.kind != "reconfigure" or \
            switch.new_plan.delta_codec != "int8":
        ctl = rt.controller
        res = optimize_plan(ctl.m_l, ctl.m_r, tr_now, l_const,
                            rt.cfg.recovery_constraint, ctl.rescaler.p,
                            cis[0], cis[-1], cost, variants=[plan, int8])
        for c in res.candidates:
            log(f"  candidate {c.plan.name}: feasible {c.feasible}, ci "
                f"{c.ci}, q_l {c.q_l}, q_r {c.q_r}, objective "
                f"{c.objective}, overhead {c.overhead}")
        raise SmokeFailure(f"Khaos did not switch the trainer to int8: "
                           f"{decisions}")
    check(rt.phase_sequence() == ["steady_state", "profiled", "optimizing"],
          f"phase order {rt.phase_sequence()}")
    check(tr.ckpt.plan.name == switch.new_plan.name,
          f"trainer runs {tr.ckpt.plan.name}, the Decision said "
          f"{switch.new_plan.name}")
    return {"decision": {"t": switch.t, "kind": switch.kind,
                         "latency": switch.latency,
                         "tr_avg": switch.tr_avg,
                         "predicted_recovery": switch.predicted_recovery,
                         "new_ci": switch.new_ci,
                         "new_plan": switch.new_plan.name,
                         "p": rt.controller.rescaler.p},
            "constraints": {"latency": l_const,
                            "recovery": rt.cfg.recovery_constraint},
            "ci_grid": cis, "phases": rt.phase_sequence(),
            "decisions": [d.kind for d in decisions],
            "capacity_eps": capacity, "step_s": step_s, "lag": run.lags,
            "m_l_pct_error": info["m_l_pct_error"],
            "m_r_pct_error": info["m_r_pct_error"]}


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not BENCH.is_file():
        print("chip_smoke.py needs the repro_torch package under src/ and "
              "benchmarks/torch_bench_ckpt.py beside it", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.monotonic()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), {kind}")
    hbm, flops = card_rates(kind)
    dev = torch.device("cuda", 0)

    import repro_torch  # noqa: F401  (sets the TF32 switches off)
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels.ckpt_delta import kernel as K
    from repro_torch.kernels.ckpt_delta import ops

    t0 = time.monotonic()
    lib = K.build()
    log(f"build: {lib.name} in {time.monotonic() - t0:.2f} s")

    cfg = replace(get_config("yi-6b"), num_layers=2)
    t0 = time.monotonic()
    results = kernel_phase(dev, hbm, flops)
    results.update(per_leaf_phase(dev, hbm, flops, _state_leaves(cfg)))
    log(f"kernel phase: {time.monotonic() - t0:.1f} s")

    # -- calibration path: #5/#6 per leaf against the fused #1/#2 --------
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    device_section = calibration_phase(cfg, dev)
    calib_launches = ops.launch_counts()
    log(f"calibration phase: {time.monotonic() - t0:.1f} s, device memory "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{calib_launches}")
    print(json.dumps({"calibration_device": device_section}))
    for name in CALIBRATION_KERNELS:
        check(calib_launches[name] > 0,
              f"{name} was not launched on the calibration path")

    # -- trainer path: lossless half, Khaos, int8 half --------------------
    log(f"trainer: {cfg.name} widths, num_layers {cfg.num_layers}, "
        f"{cfg.param_count():,} params, dtype {cfg.dtype}, params "
        f"{cfg.param_dtype}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        # the counts are set to 0 before each trainer segment and read
        # after it; the bench run between them (its own states) is not
        # the trainer path
        ops.reset_launch_counts()
        run = TrainerRun(cfg, dev, CKPT_DIR / "trainer", batch=2,
                         seq_len=1024)
        run.lossless_half()
        launches = ops.launch_counts()
        log(f"lossless half: {time.monotonic() - t0:.1f} s")
        t1 = time.monotonic()
        cal, sources = calibration_artifact(run, device_section,
                                            CKPT_DIR / "bench", dev)
        log(f"calibration artifact ({time.monotonic() - t1:.1f} s): "
            f"{json.dumps({k: v for k, v in cal.items() if k != 'plans'})}")
        log(f"calibration sources (reduced): {json.dumps(sources)}")
        n_before = len(run.ckpt_events())
        ops.reset_launch_counts()
        t1 = time.monotonic()
        khaos = khaos_phases(run, cal)
        log(f"khaos: {time.monotonic() - t1:.1f} s")
        print(json.dumps({"khaos": khaos}))
        run.int8_half(n_before)
        launches = {k: v + ops.launch_counts()[k]
                    for k, v in launches.items()}
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"trainer path: {time.monotonic() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated()
    summary = run.tr.summary()
    for e in run.ckpt_events():
        log("  " + json.dumps({k: e.get(k) for k in (
            "event", "kind", "step", "blocking_s", "bytes_on_link",
            "bytes_written", "level", "duration_s")}))
    check(all(math.isfinite(x) for x in run.tr.losses), "non-finite loss")
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"trainer: {len(run.tr.losses)} steps, median step "
        f"{run.step_s():.3f} s, device memory peak {peak / 1e9:.2f} GB, "
        f"host memory peak (whole run) {host_peak / 1e9:.2f} GB, "
        f"bytes written {summary['ckpt_stats']['bytes_written']}, "
        f"bytes on link {summary['ckpt_stats']['bytes_on_link']}")
    log(f"kernel launches on the trainer path: {launches}")
    for name in KERNELS:
        if name not in CALIBRATION_KERNELS:
            check(launches[name] > 0,
                  f"{name} was not launched on the trainer path")

    rows = []
    for name, (replaces, _, _) in KERNELS.items():
        r = results[name]
        n = (calib_launches if name in CALIBRATION_KERNELS
             else launches)[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "mismatches": r["mismatches"],
                     "elements": r["elements"],
                     "path": ("calibration" if name in CALIBRATION_KERNELS
                              else "trainer")})
    log(f"total {time.monotonic() - t_start:.1f} s; library_ms is null: no "
        f"single PyTorch call computes any of these six functions")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
