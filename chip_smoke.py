#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

  build    compile the ckpt_delta CUDA kernels from the sources in this
           checkout (nvcc, sm_90a) and print the build seconds;
  kernels  hold each of the four kernels against its plain PyTorch
           version on the card, at small awkward sizes and at the packed
           size of the 2-layer yi-6b-width train state (2,611,015,680
           float32 elements, past 2^31): every output bit for bit.  Time
           plain and kernel in turns (plain, kernel, kernel, plain) and
           compute each kernel's bound from the bytes it must move and the
           card's memory rate;
  trainer  run ``repro_torch``'s ResilientTrainer at yi-6b width with
           num_layers 32 -> 2 (bf16 compute, f32 params and AdamW state,
           batch 2 x 1024 tokens, random weights from a seed) under a
           device-placed incremental plan: a full and a lossless delta
           trigger, an injected task failure restored through the decode
           kernel and checked BIT-EQUAL to the saved state; then
           ``reconfigure_plan`` to the int8 codec, a delta trigger, a
           second failure and a restore checked within the per-group
           max|delta|/254 bound.  The kernel launch counts are reset just
           before this phase and read just after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
``src/repro_torch`` package beside this file, it exits non-zero and prints
no result.  Checkpoints go to ``.chip_smoke_ckpt/`` in the checkout and
are removed at the end.
"""
from __future__ import annotations

import os

# set before torch initialises CUDA: the trainer phase holds ~60 GB of
# large, differently sized buffers and must not fragment
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CKPT_DIR = ROOT / ".chip_smoke_ckpt"

GROUP = 1024
FLAT_ELEMENTS = 2_611_015_680      # packed 2-layer yi-6b-width train state
CHECK_CHUNK = GROUP << 18          # elements per plain-version comparison
RUN_S = 5e3                        # virtual seconds per trainer run() call
INT8_SLACK = 1 + 2 ** -16 + 1e-6   # f32 rounding on top of amax/254

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
}
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
            bytes_per, ops_per = KERNELS[name][1], KERNELS[name][2]
            b_ms = n * bytes_per / hbm * 1e3
            o_ms = n * ops_per / flops * 1e3
            r.update(ms=timing[0], plain_ms=timing[1],
                     bound_ms=max(b_ms, o_ms),
                     bound_by="bytes" if b_ms >= o_ms else "operations",
                     elements=n)

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


def trainer_phase(model_cfg, device, ckpt_dir: Path, batch: int,
                  seq_len: int) -> dict:
    """The port's main path: a live trainer, a full and a delta trigger,
    a failure restored through the decode kernel, a plan switch to int8
    and a second failure.  Returns what it measured."""
    import numpy as np
    import torch
    from repro_torch.config import CheckpointPlan, OptimizerConfig, replace
    from repro_torch.data.stream import EventStream, constant_rate
    from repro_torch.models.zoo import state_to_numpy
    from repro_torch.runtime import (ResilientTrainer, TrainerConfig,
                                     TrainerJobHandle)

    # replication_factor 0: the card's machine takes at most 45 GiB of
    # disk writes per run, and the run writes three full snapshots (10.44 GB
    # each) and two deltas; one ring replica per shard would double every
    # full (the replicated store is exercised by the CPU tests).  keep 1:
    # every newest()/gc CRC-reads each kept full, 10.44 GB apiece
    plan = CheckpointPlan(interval_s=1e9, mode="incremental", full_every=2,
                          encode_placement="device", delta_codec="lossless",
                          levels=("local",), sync=True, codec="zlib",
                          replication_factor=0, keep=1)
    # each run() below ends with an injected failure whose detection time
    # (2 * RUN_S virtual seconds) carries the clock past the run's end, so
    # the run returns right after the restore, before another step
    tcfg = TrainerConfig(batch=batch, seq_len=seq_len, ckpt_dir=str(ckpt_dir),
                         time_scale=1.0, detect_s=2 * RUN_S, restart_s=1.0,
                         plan=plan)
    stream = EventStream(schedule=constant_rate(1000.0))
    tr = ResilientTrainer(model_cfg, tcfg, stream,
                          OptimizerConfig(total_steps=1000, lr=1e-4,
                                          warmup_steps=1),
                          seed=0, device=device)
    job = TrainerJobHandle(tr)
    saved: dict = {}

    def scripted(script: dict):
        """on-step callback: at step k run ``script[k]`` (the actions a
        controller takes through the JobHandle protocol)."""
        k0 = len(tr.losses)

        def on_step(info):
            k = len(tr.losses) - k0
            log(f"  step {int(tr.state['step'].item())}: loss "
                f"{info['loss']:.6f}")
            for action in script.get(k, ()):
                action()
        return on_step

    trigger = lambda: job.reconfigure(1e-6)       # next loop: checkpoint
    quiet = lambda: job.reconfigure(1e9)
    copy = lambda key: lambda: saved.__setitem__(
        key, _flat(state_to_numpy(tr.state)))
    fail = lambda: tr.inject_failure_at(tr.t, "task")

    # -- lossless: full at step 2, delta at step 4, task failure --------
    tr.run(duration_s=RUN_S, on_second=scripted({
        2: [trigger], 3: [quiet], 4: [copy("lossless"), trigger],
        5: [quiet, fail]}))
    ev = [e for e in tr.events if e["event"] in ("checkpoint", "restore")]
    check([e["kind"] for e in ev] == ["full", "delta", "full+delta"],
          f"lossless phase events {ev}")
    _check_bit_equal(_flat(tr.state), saved.pop("lossless"),
                     "lossless full+delta restore")
    log("lossless full+delta restore is bit-equal to the saved state")

    # -- int8: plan switch (drain savepoint), full, delta, failure ------
    job.reconfigure_plan(replace(plan, delta_codec="int8"))
    tr.run(duration_s=RUN_S, on_second=scripted({
        1: [copy("base"), trigger], 2: [quiet],
        3: [copy("int8"), trigger], 4: [quiet, fail]}))
    ev2 = [e for e in tr.events if e["event"] in ("checkpoint", "restore")]
    check([e["kind"] for e in ev2[len(ev):]] ==
          ["savepoint", "full", "delta", "full+delta"],
          f"int8 phase events {ev2[len(ev):]}")
    margin = _check_int8_bound(_flat(tr.state), saved["int8"],
                               saved["base"])
    log(f"int8 full+delta restore within max|delta|/254 (worst margin "
        f"{margin:.3e})")
    summary = tr.summary()
    check(all(np.isfinite(tr.losses)), "non-finite loss")
    return {"losses": list(tr.losses), "events": ev2,
            "ckpt_stats": summary["ckpt_stats"],
            "step_s": summary["measured_step_s"]}


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py needs the repro_torch package under src/ "
              "beside it", file=sys.stderr)
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

    t0 = time.monotonic()
    results = kernel_phase(dev, hbm, flops)
    log(f"kernel phase: {time.monotonic() - t0:.1f} s")

    cfg = replace(get_config("yi-6b"), num_layers=2)
    log(f"trainer: {cfg.name} widths, num_layers {cfg.num_layers}, "
        f"{cfg.param_count():,} params, dtype {cfg.dtype}, params "
        f"{cfg.param_dtype}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    try:
        info = trainer_phase(cfg, dev, CKPT_DIR, batch=2, seq_len=1024)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"trainer phase: {time.monotonic() - t0:.1f} s")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for e in info["events"]:
        log("  " + json.dumps({k: e.get(k) for k in (
            "event", "kind", "step", "blocking_s", "bytes_on_link",
            "bytes_written", "level", "duration_s")}))
    log(f"trainer: {len(info['losses'])} steps, last step "
        f"{info['step_s']:.3f} s, device memory peak {peak / 1e9:.2f} GB, "
        f"bytes written {info['ckpt_stats']['bytes_written']}, "
        f"bytes on link {info['ckpt_stats']['bytes_on_link']}")
    log(f"kernel launches on the trainer path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the trainer path")

    rows = []
    for name, (replaces, _, _) in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "mismatches": r["mismatches"],
                     "elements": r["elements"]})
    log(f"total {time.monotonic() - t_start:.1f} s; library_ms is null: no "
        f"single PyTorch call computes any of these four functions")
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
