#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero, before the result line):

  build        compile the four kernel libraries (ckpt_delta,
               flash_attention, rglru, rwkv6) from the sources in this
               checkout, one nvcc (sm_90a) each, all started together, and
               print each build's seconds;
  kernels      hold each of the six kernels against its plain PyTorch
               version on the card, every output bit for bit: the four
               flat kernels (#1-#4) at small awkward sizes and at the packed
               size of the 2-layer yi-6b-width train state (2,611,015,680
               float32 elements, past 2^31), the two per-leaf encodes
               (#5/#6) at awkward leaf sizes and at every leaf shape of that
               state.  Time plain and kernel in turns (plain, kernel,
               kernel, plain) and compute each kernel's bound from the
               bytes it must move and the card's memory rate;
  seqmix       the kernel-bench path (``benchmarks/torch_bench_kernels.py``,
               the E6 twin): its four reference rows on the card, then its
               card table at published widths and contexts (yi-6b, grok-1
               and recurrentgemma-2b attention, recurrentgemma-2b's
               RG-LRU, rwkv6-3b's WKV-6): flash attention (#7) within 2e-4
               (float32) / 1e-2 + 1e-2 |ref| and 1e-2 of each row's norm
               (bfloat16), the RG-LRU scan (#8) bit for bit and WKV-6 (#9)
               within 2e-4 of their plain versions, timed in turns beside
               their bounds and, for attention,
               ``scaled_dot_product_attention``; the table is printed as
               one ``{"seqmix": [...]}`` line.  Then each of the three at
               every shape of the reference's kernel sweeps
               (``tests/test_kernels.py``) at its tolerances: #7 within
               2e-4 (float32) / 5e-2 (bfloat16), also with fewer keys than
               queries (Skv < S, window 64, where some rows see no key)
               and in float32 at its own tile edges, #8 bit for bit, also
               at its ragged edges, #9 within 2e-4, including the
               two-call state carry.  Its tensors are freed before the
               calibration;
  campaign     the chaos-campaign path on the torch lane engine
               (``sim.DeviceCampaign``, float64 tensors on the card):
               ``benchmarks/torch_bench_campaign.py`` —
               the parity matrix (plan x crash kind x degradation x CI,
               60 lanes x 900 ticks) bit for bit against the NumPy lane
               engine (no divergent lane), lane-ticks/s of both engines at
               1e3 and 1e4 lanes x 500 ticks (the bench's 1e5 lanes x
               2000 ticks cut to make room for the drills and the paper
               phase), a profiler trace of the torch engine's ticks
               (device busy share, launches a tick) at 1e3 and 1e4 lanes,
               and the exhaustive plan sweep on the card against the
               top-3 NumPy replay (its measured objective no worse).  Printed as one
               ``{"campaign": {...}}`` line;
  drills       the seven drill twins of ``run.py --smoke`` on the card
               (``benchmarks/torch_run.py``: the checkpoint bench on tiny
               states, the proactive drill, the recovery drill's
               ``bench_sim/3`` artifact embedding the campaign phase's
               full-size device section, the replication drills, the
               runtime drill and the 3-job fleet drill), each once; E11
               in full (``benchmarks/torch_bench_fleet.py``: 8 jobs and a
               rejected firehose under one ``FleetSupervisor``) on the
               torch lane engine with its whole validator, wall-clock gate
               included (each wall-clock from one build, the bench's
               minimum over three cut for the paper phase), and once more
               on the NumPy lanes as the oracle
               (every key but ``wallclock`` equal, floats bit for bit; the
               NumPy wall-clock ratio printed, not gated); then
               ``card_drill`` (``benchmarks/torch_bench_replication.py``):
               the trainer's device-encode lossless plan with one ring
               replica per shard over one yi-6b block's
               ``params/layers/*`` leaves (173,023,232 float32 elements),
               a full, a seeded 1e-3 randn perturbation saved as a delta
               (#1), host 2 killed, the degraded partial restore (#3)
               checked BIT-EQUAL with fewer bytes pulled than the full
               holds.  Printed as one ``{"drills": {...}}`` line;
  paper        the paper's experiments, each on the torch lane engine
               and held to the NumPy lanes bit for bit: E1 and E2
               (Tables II/III, ``benchmarks/torch_bench_tables.py``) at the
               reference's ``--quick`` setting (one repeat, a full
               simulated day) — Phase 2 (``make_khaos``) on both engines,
               the (C, TR, L, R) grids and both fitted QoS models equal,
               then the day with the device engine's controller; E9
               (``torch_bench_khaos_training.py``) over its full day on
               both engines (goodput, recoveries, checkpoints,
               reconfigurations and decisions equal), one Phase-3 chunk
               under ``torch.profiler`` (the device's busy share); E10's
               head-to-head (``torch_bench_proactive.head_to_head``, period
               14,400 s) on both engines, every key but the wall time
               equal and the strict proactive win validated; the full E4
               (``torch_bench_recovery.bench_recovery_vs_ci``: the scalar
               sweep, its lanes, the 432-lane grid) with its
               ``bench_sim/3`` artifact embedding this E10 and the
               campaign phase's full-size section, validated, and the
               grid per lane on both engines; the Phase-2 launcher
               (``repro_torch.launch.profile_run``) on the card against
               its ``--sequential`` path.  E9 runs in this process; the
               other three parts run meanwhile in spawned worker
               processes (each with its own CUDA context and launch
               counts, summed here): every part is host-bound, and E9
               alone outlasts them.  The nine kernels must launch 0 times
               (these are simulations).  Printed as one
               ``{"paper": {...}}`` line;
  serve        the serving path (``benchmarks/torch_bench_serve.py``)
               at published widths and full depth, one row per family:
               yi-6b, olmoe-1b-7b, recurrentgemma-2b (a 2048 prompt that
               fills its ring, then wraps), rwkv6-3b and qwen2-vl-7b
               (stub vision embeddings, M-RoPE), random weights from a
               seed.  Each row's float32 prefill + 32 teacher-forced
               decode steps within 1e-3 of the row norm of
               ``forward_logits`` over prompt + continuation (an MoE at
               the capacity where no token drops); bf16 served through
               ``StreamServer`` (qwen2-vl through the prefill and decode
               steps), timed: prefill ms, decode ms a step, tokens/s,
               device memory peak, top-1 agreement with float32 (not
               gated); yi and recurrentgemma with the int8 KV cache from
               ``cache_specs`` zeros over 64 steps, greedy agreement with
               bf16 reported (the reference's bound, > 0.85, is held at
               their SMOKE configs below).  whisper-small (1500 frames,
               decoder 416 ->
               32) is held to the same float32 prefill + decode on the
               host CPU (its decode does not reproduce its prefill, ROADMAP
               Q2).  Then all ten SMOKE configs in float32 on the card
               against the CPU, same weights: prefill + 4 greedy decode
               steps, tokens equal, logits within 1e-4; yi's and
               recurrentgemma's SMOKE int8 KV agreement with bf16 > 0.85
               on the card (the reference's test).  The nine
               kernels' launches are counted around it and printed (0:
               the reference model calls none).  Everything it allocated
               is freed before the calibration.  Printed as one
               ``{"serve": {...}}`` line;
  prodstep     the train step as the reference's production launcher
               builds it, on a (1, 1) ("data", "model") ``DeviceMesh`` of
               the card (a world-size-1 nccl group over an in-process
               ``HashStore``): ``ShardingRules`` and their annotator,
               ``accum`` = the global batch over the data-parallel size,
               capped at 2, ``state_specs`` and their placements; yi-6b
               widths, 2 layers, float32, batch 4 x 1024, ``sgd``, under
               ``torch.use_deterministic_algorithms(True)``.  Remat
               "full" and "minimal" give params after one step bit-equal
               to "none" (each policy's memory kept for the backward
               pass and step peak logged); 2 microbatches against the
               one batch: loss and grad_norm within rtol 1e-5, params
               within 1e-4 x lr x max|g| plus one f32 ulp of the param;
               one real leaf of each placement kind round-trips
               ``distribute_tensor`` bit-equal; the step's median seconds;
               its roofline (``repro_torch.roofline.count_step`` on
               ``meta``): TF32 off, the counted flops over the card's f32
               peak at most the measured step, the dry run's argument
               bytes equal to the real state and batch, its temp beside
               the timed step's measured peak.  The nine kernels must
               launch 0 times.  Freed after.  One ``{"prodstep": {...}}``
               line;
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
               and profiles the JAX package's default grid (5 failure
               points x 6 CIs) as lanes of one campaign on the card's lane
               engine, priced by that cost model, fitting M_L and M_R; the
               job's priced recovery must be > 0 (ROADMAP fault 7);
  khaos 3      the runtime attaches to the live trainer; the backlog that
               the lossless delta's stall and the failure left (read on
               each side of both) violates the latency constraint and the
               controller's Decision switches the plan to int8;
  int8         under the switched plan: a full, an int8 delta trigger, a
               second failure and a restore checked within the per-group
               max|delta|/254 bound.

Kernel launch counts are set to 0 just before the kernel-bench path and
read just after it (#7-#9), likewise around the drills path (#1 and #3
must launch there; each row reports this path's count as
``drills_launches``), around the paper path (each row's
``paper_launches``, all 0), around the serve path (reported, not gated),
around the prodstep path (``prodstep_launches``, all 0), around the
calibration path (#5/#6) and around the
trainer path, from the lossless half to the int8 half (#1-#4).  The line
before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
With no CUDA device, or without the ``src/repro_torch`` package beside
this file, it exits non-zero and prints no result.  Checkpoints go to
``.chip_smoke_ckpt/`` in the checkout and are removed at the end.
"""
from __future__ import annotations

import os

# set before torch initialises CUDA: the trainer phase holds ~60 GB of
# large, differently sized buffers and must not fragment
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# set before cuBLAS starts: the prodstep phase runs under
# torch.use_deterministic_algorithms(True), which needs a fixed workspace
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import dataclasses
import gc
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
KBENCH = ROOT / "benchmarks" / "torch_bench_kernels.py"
#: the E12 engine bench of the campaign phase, and the ticks of its
#: throughput lanes (the bench's THR_TICKS is 2000; halved to keep the
#: script's time with the drills phase, halved again with the paper phase)
CBENCH = ROOT / "benchmarks" / "torch_bench_campaign.py"
THR_HORIZON = 500
#: the throughput and trace lane counts: the 1e5-lane point (~25 s of the
#: phase with its lane building) and the 1e5-lane trace (a 2000 x 1e5
#: float64 rate matrix) were cut for the paper phase
THR_LANE_COUNTS = (1_000, 10_000)
#: fresh builds behind each E11 wall-clock of the drills phase (the
#: bench's min over 3, ~60 s of the phase, cut for the paper phase)
E11_REPS = 1
#: the drills phase: the run.py --smoke twin, E11 and the card drill (the
#: runner loads the other drill benches beside it)
DRILL_BENCHES = (ROOT / "benchmarks" / "torch_run.py",
                 *(ROOT / "benchmarks" / f"torch_bench_{n}.py"
                   for n in ("fleet", "replication", "runtime", "proactive",
                             "recovery")))
#: the kernels the drills path must launch: the card drill's delta save
#: and its degraded restore
DRILL_KERNELS = ("flat_lossless_encode", "lossless_decode")
#: the serve phase: prefill, decode and StreamServer for every family
SBENCH = ROOT / "benchmarks" / "torch_bench_serve.py"
#: the paper phase: E1/E2 (with their shared harness), E9, E10 and E4
PAPER_BENCHES = tuple(ROOT / "benchmarks" / f"torch_{n}.py" for n in (
    "bench_tables", "bench_khaos_training", "bench_proactive",
    "bench_recovery", "common"))
#: the chunk of E9's Phase 3 (one optimization period, 300 ticks) that the
#: profiler reads: the 216th of the day's 288 (18:00), when the paper
#: phase's worker processes have ended and E9 has the card to itself
E9_TRACE_CHUNK = 216
#: the prodstep phase: yi-6b widths, 2 layers, float32, batch x seq, the
#: accum cap, sgd's learning rate, the accum gate on the params (a share
#: of lr x max|g|, the largest update) and the timed steps
PROD_BATCH, PROD_SEQ = 4, 1024
PROD_ACCUM_CAP = 2
PROD_LR = 1.0
PROD_PARAM_TOL = 1e-4
PROD_TIMED = 3

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
#: the profiled (failure points, CIs): the JAX package's KhaosConfig
#: defaults (num_failure_points 5, num_configs 6), over CI_GRID's window
KHAOS_GRID = (5, 6)

_CKPT = ("src/repro/kernels/ckpt_delta/kernel.py",
         "src/repro_torch/kernels/ckpt_delta/csrc/ckpt_delta.cu")
KERNELS = {
    # name: (TPU kernel replaced, CUDA source, bytes per element, ops per
    # element); #7-#9 count their work per shape in the bench's ``work``
    "flat_lossless_encode": (f"{_CKPT[0]}:198", _CKPT[1], 16 + 8 / GROUP, 5),
    "flat_int8_encode": (f"{_CKPT[0]}:240", _CKPT[1], 9 + 8 / GROUP, 9),
    "lossless_decode": (f"{_CKPT[0]}:152", _CKPT[1], 16, 2),
    "delta_decode": (f"{_CKPT[0]}:267", _CKPT[1], 5 + 4 / GROUP, 2),
    "lossless_encode": (f"{_CKPT[0]}:128", _CKPT[1], 16, 3),
    "delta_encode": (f"{_CKPT[0]}:82", _CKPT[1], 9 + 4 / GROUP, 7),
    "flash_attention": (
        "src/repro/kernels/flash_attention/kernel.py:88",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        None, None),
    "rglru_scan": ("src/repro/kernels/rglru/kernel.py:53",
                   "src/repro_torch/kernels/rglru/csrc/rglru.cu", None, None),
    "wkv6": ("src/repro/kernels/rwkv6/kernel.py:57",
             "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu", None, None),
}
#: the path whose launch counts each kernel's row reports
CALIBRATION_KERNELS = ("lossless_encode", "delta_encode")
SEQMIX_KERNELS = ("flash_attention", "rglru_scan", "wkv6")
TRAINER_KERNELS = tuple(k for k in KERNELS if k not in CALIBRATION_KERNELS
                        + SEQMIX_KERNELS)
#: the card-table row (name, dtype) each of #7-#9 reports in its line
HEADLINE = {"flash_attention": ("attn-yi", "bfloat16"),
            "rglru_scan": ("rglru-rg", "float32"),
            "wkv6": ("wkv6-rwkv", "float32")}
# shapes of the reference's kernel sweeps (tests/test_kernels.py), plus
# attention at sequence lengths that leave a partial tile
ATTN_SWEEP = ((1, 128, 4, 4, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
              (1, 512, 2, 2, 256), (1, 200, 4, 2, 128), (1, 77, 2, 1, 64))
ATTN_MASKS = ((True, 0), (True, 64), (False, 0))
# (B, S, Skv, H, K, hd) with fewer keys than queries: under window 64 the
# rows q >= Skv + 63 see no key and return the mean of v
ATTN_SKV_SWEEP = ((1, 256, 128, 4, 2, 64), (1, 200, 77, 2, 1, 128))
ATTN_SKV_MASKS = ((True, 64), (False, 64))
# float32 attention at the f32 kernel's edges (2e-4): S one past its 128-row
# tile and, at hd 256, not a multiple of its 64-row tile; Skv not a
# multiple of its 64-key tile, below and above S; the softcap with and
# without a window, at hd 128 and 256.  ((B, S, Skv, H, K, hd), causal,
# window, softcap)
ATTN_F32_EDGES = (((2, 129, 129, 2, 2, 128), True, 0, 0.0),
                  ((1, 300, 300, 2, 1, 256), True, 0, 0.0),
                  ((1, 200, 100, 2, 2, 128), False, 0, 0.0),
                  ((1, 130, 190, 2, 1, 256), False, 0, 30.0),
                  ((1, 300, 300, 2, 1, 256), True, 100, 30.0),
                  ((1, 333, 333, 4, 2, 128), True, 0, 30.0))
# the reference's RG-LRU shapes, then the kernel's ragged edges: S 8193
# at rglru-rg's width (not a multiple of the time tile), D 37 (rows not
# whole 16-byte chunks), B.D 8 (fewer chains than one full-width block),
# D 2568 (the last channel block narrow) and bf16 D 2561 (element loads)
RGLRU_SWEEP = ((1, 128, 128), (2, 512, 256), (1, 256, 512), (2, 8193, 2560),
               (2, 300, 37), (1, 257, 8), (2, 1000, 2568), (1, 777, 2561))
WKV6_SWEEP = ((1, 128, 2, 16), (2, 256, 2, 32), (1, 128, 4, 64))


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


def card_rates(name: str):
    """(HBM bytes/s, fp32 CUDA-core FLOP/s, bf16 dense tensor FLOP/s) of
    the SKU NVIDIA's data sheets name (``repro_torch.kernels.rates``); an
    unknown card fails the run rather than guess."""
    from repro_torch.kernels.rates import card_rates as rates
    try:
        return rates(name)
    except ValueError as e:
        raise SmokeFailure(str(e)) from None


def build_all() -> dict:
    """Build the four kernel libraries, one nvcc each, all started
    together: {family: (library path, seconds of its own build)}."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.ckpt_delta import kernel as ck
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rglru import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk

    def one(lib):
        t0 = time.monotonic()
        path = lib.build()
        return path, time.monotonic() - t0
    libs = {"ckpt_delta": ck.LIBRARY, "flash_attention": fk.LIBRARY,
            "rglru": rk.LIBRARY, "rwkv6": wk.LIBRARY}
    with ThreadPoolExecutor(len(libs)) as ex:
        futures = {name: ex.submit(one, lib) for name, lib in libs.items()}
        return {name: f.result() for name, f in futures.items()}


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


def _turns(kernel_fn, plain_fn) -> tuple[float, float]:
    """plain, kernel, kernel, plain, each the mean ms of 2 calls with CUDA
    events around each (``torch_bench_kernels.turns``): (kernel ms, plain
    ms).  Outputs are freed between calls."""
    ms, plain_ms, _ = _module(KBENCH).turns(kernel_fn, plain_fn)
    return ms, plain_ms


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
    bytes_per, ops_per = KERNELS[name][2], KERNELS[name][3]
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


def sweep_checks(dev) -> dict:
    """Kernels #7-#9 against their plain versions at every shape of the
    reference's sweeps: #7 within 2e-4 (float32) / 5e-2 (bfloat16) with
    each mask and with softcap 30, at Skv < S under window 64, where some
    rows see no key, and in float32 at the f32 kernel's tile edges
    (``ATTN_F32_EDGES``); the softcap quotient both kernels take against
    IEEE division (``div_cap_divisors``); #8 bit for bit in both dtypes
    at the reference's shapes and the kernel's ragged edges, #9
    within 2e-4, and the two-call state carry of #9 (one call over 256
    steps against two of 128, the second from the first's state) within
    the reference's 1e-4.  Returns each kernel's worst error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, rwkv6
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    max_err = _module(KBENCH).max_err
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = dict.fromkeys(SEQMIX_KERNELS, 0.0)

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def hold(name, out, ref, dtype, what):
        err, ok = max_err(out, ref, dtype)
        check(ok, f"{name} differs from plain beyond the tolerance at "
                  f"{what}: max_abs_err {err}")
        worst[name] = max(worst[name], err)

    cases = [((B, S, S, H, K, hd), dtype, causal, window, 0.0)
             for B, S, H, K, hd in ATTN_SWEEP
             for dtype in (f32, bf16) for causal, window in ATTN_MASKS]
    cases.append(((1, 128, 128, 4, 2, 64), f32, True, 0, 30.0))
    cases += [(shape, dtype, causal, window, 0.0) for shape in ATTN_SKV_SWEEP
              for dtype in (f32, bf16) for causal, window in ATTN_SKV_MASKS]
    cases += [(shape, f32, causal, window, cap)
              for shape, causal, window, cap in ATTN_F32_EDGES]
    for (B, S, Skv, H, K, hd), dtype, causal, window, cap in cases:
        q = rn(B, S, H, hd).to(dtype)
        k, v = (rn(B, Skv, K, hd).to(dtype) for _ in range(2))
        opts = dict(causal=causal, window=window, softcap=cap)
        hold("flash_attention", fa.flash_attention(q, k, v, **opts),
             fa.attention_ref(q, k, v, **opts), dtype,
             f"B{B} S{S} Skv{Skv} H{H} K{K} hd{hd} {dtype} {opts}")
    for B, S, D in RGLRU_SWEEP:
        for dtype in (f32, bf16):
            a = (torch.sigmoid(rn(B, S, D)) * 0.2 + 0.79).to(dtype)
            b = (rn(B, S, D) * 0.1).to(dtype)
            h0 = rn(B, D) * 0.5
            h, ph = rglru.rglru_scan(a, b, h0), rglru.rglru_ref(a, b, h0)
            m, e = _diff(h, ph)
            check(m == 0, f"rglru_scan differs from plain at B{B} S{S} "
                          f"D{D} {dtype}: {m} mismatches")
            worst["rglru_scan"] = max(worst["rglru_scan"], e)

    def wkv6_inputs(B, S, H, hs):
        r, k, v = (rn(B, S, H, hs) * 0.5 for _ in range(3))
        w = torch.sigmoid(rn(B, S, H, hs)) * 0.3 + 0.65
        return r, k, v, w, rn(H, hs) * 0.3, torch.zeros(B, H, hs, hs,
                                                        device=dev)
    for shape in WKV6_SWEEP:
        x = wkv6_inputs(*shape)
        (y, st), (py, ps) = rwkv6.wkv6(*x), rwkv6.wkv6_ref(*x)
        hold("wkv6", y, py, f32, f"{shape} y")
        hold("wkv6", st, ps, f32, f"{shape} final state")
    r, k, v, w, u, s0 = wkv6_inputs(1, 256, 2, 16)
    y_all, s_all = rwkv6.wkv6(r, k, v, w, u, s0)
    first, second = slice(0, 128), slice(128, 256)
    _, s1 = rwkv6.wkv6(r[:, first], k[:, first], v[:, first], w[:, first],
                       u, s0)
    y2, s2 = rwkv6.wkv6(r[:, second], k[:, second], v[:, second],
                        w[:, second], u, s1)
    carry = max(float((y_all[:, second] - y2).abs().max()),
                float((s_all - s2).abs().max()))
    check(carry <= 1e-4, f"wkv6 state carry: two calls differ from one by "
                         f"{carry}")
    py, ps = rwkv6.wkv6_ref(r, k, v, w, u, s0)
    hold("wkv6", y_all, py, f32, "state-carry sequence y")
    hold("wkv6", s2, ps, f32, "state carried over two calls")
    divisors = div_cap_divisors()
    bad = fa_kernel.check_div_cap(torch.tensor(divisors, device=dev))
    check(int(bad.sum()) == 0, f"softcap quotient differs from IEEE "
                               f"division: {dict(zip(divisors, bad.tolist()))}")
    torch.cuda.synchronize()
    log(f"sweeps: {len(cases)} attention cases, {2 * len(RGLRU_SWEEP)} "
        f"RG-LRU, {len(WKV6_SWEEP)} WKV-6 and the state carry "
        f"({carry:.3g}) within tolerance; worst errors {worst}; the "
        f"softcap quotient equals IEEE division for every float in "
        f"[2^-100, 2^100] at {len(divisors)} divisors")
    return worst


def div_cap_divisors() -> list:
    """The softcaps the configs use, the ends of the range the kernels
    take ([2^-20, 2^20]) and 24 log-uniform divisors across it
    from a seed, each rounded to float32."""
    import numpy as np
    from repro_torch.configs import ARCH_IDS, get_config
    caps = {get_config(a).attn_logit_softcap for a in ARCH_IDS} - {0.0}
    rng = np.random.default_rng(11)
    spread = 2.0 ** rng.uniform(-20, 20, 24)
    return sorted(float(np.float32(x)) for x in
                  {*caps, 2.0 ** -20, 2.0 ** 20, 1 / 3, 7.7, *spread})


def seqmix_phase(dev) -> tuple[dict, list]:
    """The kernel-bench path: counts to 0, the E6 twin's four rows and its
    card table at published widths, counts read; then the sweeps.
    Returns, per kernel of #7-#9, its headline row with its launches on
    the path and its worst sweep error; and the whole card table."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, rwkv6

    kbench = _module(KBENCH)
    families = (fa, rglru, rwkv6)
    for f in families:
        f.reset_launch_counts()
    rows = kbench.bench_kernels(device=dev)
    table = kbench.card_table(dev)
    launches = {}
    for f in families:
        launches.update(f.launch_counts())
    log(f"kernel-bench path launches: {launches}")
    check(all("validated=True" in derived for _, _, derived in rows),
          f"bench_kernels rows not validated: {rows}")
    for r in table:
        check(r["validated"], f"{r['kernel']} at {r['row']} {r['dtype']} "
                              f"differs from plain: max_abs_err "
                              f"{r['max_abs_err']}")
    for name in SEQMIX_KERNELS:
        check(launches[name] > 0,
              f"{name} was not launched on the kernel-bench path")
    worst = sweep_checks(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    heads = {}
    for name in SEQMIX_KERNELS:
        head = next(r for r in table if r["kernel"] == name and
                    (r["row"], r["dtype"]) == HEADLINE[name])
        heads[name] = {**{k: head[k] for k in keys},
                       "launches": launches[name],
                       "sweep_max_abs_err": worst[name]}
    return heads, table


def campaign_phase(dev) -> dict:
    """The chaos-campaign path on the card's torch lane engine
    (``benchmarks/torch_bench_campaign.py``, the E12 twin): the parity
    matrix at horizon 900 against the NumPy engine, which must have no
    divergent lane; lane-ticks/s of both engines at ``THR_LANE_COUNTS``
    lanes x ``THR_HORIZON`` ticks; a profiler trace of the torch engine's ticks
    at the same lane counts; the exhaustive plan sweep on the card against
    the top-3 NumPy replay.  The drills phase validates the
    section through the recovery drill's ``bench_sim/3`` artifact."""
    import torch
    cbench = _module(CBENCH)
    out: dict = {}
    t0 = time.monotonic()
    parity = cbench.parity_check(horizon=900, device=dev)
    check(parity["divergent_lanes"] == 0,
          f"the torch lane engine diverged from the NumPy engine on "
          f"{parity['divergent_lanes']} of {parity['lanes']} lanes")
    check(not parity["fma_contraction"] and parity["phase_matches_numpy"],
          f"device arithmetic differs from NumPy's: {parity}")
    check(parity["recoveries"] > 0, "the parity matrix recovered nothing")
    throughput = cbench.bench_throughput(lane_counts=THR_LANE_COUNTS,
                                         horizon=THR_HORIZON, device=dev)
    out["trace"] = [cbench.trace_ticks(n, device=dev)
                    for n in THR_LANE_COUNTS]
    sweep = cbench.bench_sweep(device=dev)
    section = {"throughput": throughput, "parity": parity, "sweep": sweep}
    out["engine_s"] = time.monotonic() - t0
    out["section"] = section
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _canonical(art: dict) -> str:
    """An artifact without its host-clock section, as exact JSON (a float's
    repr round-trips its bits, so equal strings mean bit-equal floats)."""
    return json.dumps({k: v for k, v in art.items() if k != "wallclock"},
                      sort_keys=True)


def drills_phase(dev, section: dict) -> dict:
    """The drills path on the card: the seven ``run.py --smoke`` twins
    (``benchmarks/torch_run.py``; the recovery drill's ``bench_sim/3``
    artifact embeds the campaign phase's full-size ``section`` in place of
    a smoke-sized one), E11 on the torch lane engine under its whole
    validator and on the NumPy lanes as its oracle, and ``card_drill`` at
    one yi-6b block under ``CKPT_DIR`` (removed after)."""
    import tempfile

    import torch
    run, fleet, repl = (_module(p) for p in DRILL_BENCHES[:3])
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        res = run.smoke(tmp, device=dev, device_sec=section)
        out["smoke_s"] = time.monotonic() - t0
        out["smoke_seconds"] = res["seconds"]
        out["replication"] = res["replication"]
        out["fleet_smoke_transfer"] = res["fleet"]["transfer"]
        out["e4"] = res["recovery"]["e4"]
        out["grid"] = res["recovery"]["grid"]
        t0 = time.monotonic()
        art = fleet.bench_fleet(os.path.join(tmp, "BENCH_fleet_torch.json"),
                                engine="device", device=dev, reps=E11_REPS)
        out["e11_device_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        oracle = fleet.bench_fleet(os.path.join(tmp, "BENCH_fleet_np.json"),
                                   engine="numpy", gate_wallclock=False,
                                   reps=E11_REPS)
        out["e11_numpy_s"] = time.monotonic() - t0
    check(_canonical(art) == _canonical(oracle),
          "E11 on the torch lane engine differs from the NumPy lanes")
    out["e11"] = {k: art[k] for k in ("transfer", "twins", "rejected",
                                      "decisions_by_kind", "pooled_phase2",
                                      "shared_campaigns")}
    out["e11"]["n_optimizing"] = sum(
        1 for j in art["jobs"].values() if j["phase"] == "optimizing")
    out["e11_wallclock"] = {"device": art["wallclock"],
                            "numpy": oracle["wallclock"]}
    t0 = time.monotonic()
    out["card_drill"] = repl.card_drill(str(CKPT_DIR / "card_drill"), dev)
    out["card_drill_s"] = time.monotonic() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _same(a, b) -> bool:
    """Exact equality of two JSON-able results (a float's repr round-trips
    its bits; NaN equals NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _same_arrays(a, b) -> bool:
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _traced_chunk(camp, at: int, probe: dict) -> None:
    """Wrap ``camp.run`` so that the ``at``-th advance (one chunk of
    ``drive_campaign``) runs under ``torch.profiler``
    (``torch_bench_campaign.profile_advance``); ``probe`` also gets the
    host clock of the first advance and of the last return (the Phase-3
    seconds)."""
    run = camp.run
    calls = [0]

    def traced(n_ticks=None):
        calls[0] += 1
        probe.setdefault("first_advance", time.monotonic())
        if calls[0] == at:
            probe.update(_module(CBENCH).profile_advance(
                camp, lambda: run(n_ticks)), chunk=at)
        else:
            run(n_ticks)
        probe["last_return"] = time.monotonic()
        return camp
    camp.run = traced


def _paper_tables(dev, out: dict) -> None:
    """E1/E2 at the reference's ``--quick`` setting: the day with Phase 2
    on the card (captured from inside the bench), then Phase 2 again on the
    NumPy lanes; the grids and both fitted QoS models must be equal."""
    tables, _, _, _, common = (_module(p) for p in PAPER_BENCHES)
    secs = out["seconds"]
    real_make_khaos = common.make_khaos
    for key, bench in (("E1", tables.bench_iot_vehicles),
                       ("E2", tables.bench_ysb)):
        calls: list = []

        def make_khaos(*a, **kw):
            calls.append((a, kw, real_make_khaos(*a, **kw)))
            return calls[-1][2]
        common.make_khaos = make_khaos
        try:
            t0 = time.monotonic()
            rows, err = bench(repeats=1, device=dev)
            secs[key] = time.monotonic() - t0
        finally:
            common.make_khaos = real_make_khaos
        check(len(calls) == 1 and calls[0][1]["engine"] == "device",
              f"{key} ran Phase 2 {len(calls)} times, not once on the card")
        (recording, cost, seed), _, (ctl_d, prof_d) = calls[0]
        t0 = time.monotonic()
        ctl_n, prof_n = real_make_khaos(recording, cost, seed,
                                        engine="numpy")
        secs[f"{key}_phase2_numpy"] = time.monotonic() - t0
        for f in ("ci_values", "failure_rates", "latencies", "recoveries"):
            check(_same_arrays(getattr(prof_d, f), getattr(prof_n, f)),
                  f"{key} Phase 2: the {f} grid differs between the torch "
                  f"lane engine and the NumPy lanes")
        for m in ("m_l", "m_r"):
            for f in ("_mu", "_sd", "_beta"):
                check(_same_arrays(getattr(getattr(ctl_d, m), f),
                                   getattr(getattr(ctl_n, m), f)),
                      f"{key} Phase 2: {m}.{f} differs between the engines")
        out[key] = {"rows": [dataclasses.asdict(r) for r in rows],
                    "error_analysis": err,
                    "recoveries_grid": prof_d.recoveries.tolist()}


def _paper_e9(dev, out: dict) -> None:
    """E9's day on both engines, equal; one Phase-3 chunk profiled."""
    e9 = _module(PAPER_BENCHES[1])
    secs = out["seconds"]
    probe: dict = {}
    t0 = time.monotonic()
    e9_dev = e9.bench_khaos_training(
        engine="device", device=dev,
        on_campaign=lambda camp: _traced_chunk(camp, E9_TRACE_CHUNK, probe))
    secs["E9_device"] = time.monotonic() - t0
    secs["E9_phase3_device"] = probe["last_return"] - probe["first_advance"]
    t0 = time.monotonic()
    e9_np = e9.bench_khaos_training(engine="numpy")
    secs["E9_numpy"] = time.monotonic() - t0
    check(_same(e9_dev, e9_np),
          f"E9 on the torch lane engine differs from the NumPy lanes: "
          f"{e9_dev} vs {e9_np}")
    check("device_busy_share" in probe,
          f"E9's Phase 3 never reached chunk {E9_TRACE_CHUNK}")
    out["E9"] = e9_dev
    out["E9_trace"] = probe


def _paper_e10_e4(dev, out: dict, section: dict) -> None:
    """E10's head-to-head on both engines (equal but the wall time, the
    strict proactive win validated), then the full E4 with its
    ``bench_sim/3`` artifact embedding this E10 and ``section``, and the
    grid per lane on both engines."""
    import tempfile

    _, _, pro, rec, _ = (_module(p) for p in PAPER_BENCHES)
    secs = out["seconds"]
    t0 = time.monotonic()
    e10 = pro.head_to_head(device=dev)
    secs["E10_device"] = time.monotonic() - t0
    t0 = time.monotonic()
    e10_np = pro.head_to_head(engine="numpy")
    secs["E10_numpy"] = time.monotonic() - t0
    rec._validate_proactive(e10)
    check(_same({k: v for k, v in e10.items() if k != "wall_s"},
                {k: v for k, v in e10_np.items() if k != "wall_s"}),
          "E10 on the torch lane engine differs from the NumPy lanes")
    out["E10"] = e10

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        path = os.path.join(tmp, "BENCH_sim_torch.json")
        art = rec.bench_recovery_vs_ci(path, proactive=e10,
                                       device_sec=section, device=dev)
        with open(path) as f:
            rec.validate_sim_artifact(json.load(f))
        secs["E4"] = time.monotonic() - t0
    check(art["e4"]["recovery_s"] == art["e4"]["recovery_s_batched"] and
          art["e4"]["latency_ms"] == art["e4"]["latency_ms_batched"],
          f"E4: the lanes differ from the scalar oracle: {art['e4']}")
    cost = rec._e4_cost()
    lanes = rec.grid_lanes(cost)
    t0 = time.monotonic()
    g_dev = rec.grid_campaign(cost, lanes, device=dev)
    grid_dev_s = time.monotonic() - t0
    t0 = time.monotonic()
    g_np = rec.grid_campaign(cost, lanes, engine="numpy")
    grid_np_s = time.monotonic() - t0
    check(g_dev.recoveries == g_np.recoveries and
          g_dev.ticks_run == g_np.ticks_run and
          g_dev.compactions == g_np.compactions,
          "E4's grid on the torch lane engine differs from the NumPy lanes")
    out["E4"] = {"e4": art["e4"], "grid": art["grid"],
                 "speedup": art["speedup"],
                 "scalar_ticks_per_s": art["scalar_ticks_per_s"],
                 "grid_lane_ticks_per_s": {
                     "device": g_dev.ticks_run / grid_dev_s,
                     "numpy": g_np.ticks_run / grid_np_s}}


def _paper_profile_run(dev, out: dict) -> None:
    """The Phase-2 launcher on the card against its ``--sequential`` path
    (the JAX package's batched and sequential paths agree at these
    defaults, so the sequential oracle is the comparison)."""
    import tempfile

    from repro_torch.launch import profile_run
    secs = out["seconds"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        got = profile_run.main(["--device", str(dev), "--out",
                                os.path.join(tmp, "device.json")])
        secs["profile_run_device"] = time.monotonic() - t0
        t0 = time.monotonic()
        want = profile_run.main(["--sequential", "--out",
                                 os.path.join(tmp, "sequential.json")])
        secs["profile_run_sequential"] = time.monotonic() - t0
        with open(os.path.join(tmp, "device.json")) as f:
            on_disk = json.load(f)
    check(_same(got, want) and _same(on_disk, want),
          "launch/profile_run.py on the card differs from --sequential")
    out["profile_run"] = {"compared_with": "sequential",
                          "m_l_pct_error": got["m_l_pct_error"],
                          "m_r_pct_error": got["m_r_pct_error"]}


def _kernel_families() -> tuple:
    from repro_torch.kernels import flash_attention, rglru, rwkv6
    from repro_torch.kernels.ckpt_delta import ops
    return ops, flash_attention, rglru, rwkv6


def _paper_worker(part: str, device: str, section: dict) -> dict:
    """One part of the paper phase in a spawned worker process (its own
    CUDA context): ``{"out": ..., "launches": ...}``, or ``{"error": ...}``
    for the parent to raise (an exception of this script's own classes
    would not unpickle there)."""
    try:
        if str(SRC) not in sys.path:
            sys.path.insert(0, str(SRC))
        import torch
        dev = torch.device(device)
        families = _kernel_families()
        for f in families:
            f.reset_launch_counts()
        out: dict = {"seconds": {}}
        if part == "tables":
            _paper_tables(dev, out)
        elif part == "e10_e4":
            _paper_e10_e4(dev, out, section)
        else:
            _paper_profile_run(dev, out)
        launches: dict = {}
        for f in families:
            launches.update(f.launch_counts())
        return {"out": out, "launches": launches}
    except Exception as e:   # noqa: BLE001 — reported to the parent
        return {"error": f"{part}: {type(e).__name__}: {e}"}


def paper_phase(dev, section: dict) -> dict:
    """The paper's experiments on the card's torch lane engine, each held
    to the NumPy lanes bit for bit: E1/E2 (Tables II/III) at the
    reference's ``--quick`` setting, E9's day, E10's head-to-head, the full
    E4 (its ``bench_sim/3`` artifact embedding this E10 and the campaign
    phase's full-size ``section``) and the Phase-2 launcher
    ``launch/profile_run.py`` against its ``--sequential`` path.  E9 runs
    here; the other three parts (E1/E2, E10 then E4, the launcher) run at
    the same time in spawned worker processes, each with its own CUDA
    context: every part is host-bound, and E9 alone outlasts the others.
    Their kernel launches are returned under ``worker_launches``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    out: dict = {"seconds": {}, "worker_launches": {}}
    parts = ("tables", "e10_e4", "profile_run")
    with ProcessPoolExecutor(
            max_workers=len(parts),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_paper_worker, part, str(dev), section)
                   for part in parts]
        _paper_e9(dev, out)
        results = [f.result() for f in futures]
    for res in results:
        check("error" not in res, res.get("error", ""))
        part_out = res["out"]
        out["seconds"].update(part_out.pop("seconds"))
        out.update(part_out)
        for name, n in res["launches"].items():
            out["worker_launches"][name] = \
                out["worker_launches"].get(name, 0) + n
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def serve_phase(dev) -> dict:
    """The serving path at published widths and full depth
    (``benchmarks/torch_bench_serve.py``): one row per family, each held
    to its float32 oracle, served in bf16 (timed), yi and recurrentgemma
    also with the int8 KV cache; then the ten SMOKE configs on the card
    against the CPU.  Everything it allocated is freed after; the gates
    that failed are listed under ``gate_failures``."""
    import torch
    sbench = _module(SBENCH)
    out = sbench.serve_phase(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["gate_failures"] = sbench.gate_failures(out)
    return out


def prodstep_phase(dev, cfg=None, batch: int = PROD_BATCH,
                   seq: int = PROD_SEQ) -> dict:
    """The train step as the reference's production launcher builds it,
    on a (1, 1) ("data", "model") ``DeviceMesh`` of the card (a
    world-size-1 process group over an in-process ``HashStore``): the
    rules' annotator, ``accum`` from the shape's global batch over the
    data-parallel size (capped at ``PROD_ACCUM_CAP``), ``state_specs``
    and their placements.  yi-6b widths with 2 layers in float32,
    ``sgd``, under ``torch.use_deterministic_algorithms(True)``:

      (a) remat "full" and "minimal" give params after one step
          bit-equal to "none" (logged for each policy: the device memory
          its forward keeps for the backward pass, and its step's peak
          above the memory held before the step);
      (b) ``accum`` microbatches against one batch: loss and grad_norm
          within rtol 1e-5, params within ``PROD_PARAM_TOL`` x lr x
          max|g| plus one float32 ulp of the param (the update's
          rounding);
      (c) every leaf of ``state_specs`` gets placements, and one real
          leaf of each placement kind round-trips ``distribute_tensor``
          -> ``full_tensor`` bit-equal.

    Then the step's seconds (median of ``PROD_TIMED`` steps) and its
    roofline: the step's flops counted by ``roofline.count_step`` on
    ``meta`` tensors over the card's float32 peak (TF32 must be off: the
    products run on the CUDA cores) must not exceed the measured step;
    the dry run's ``arg_gb_per_dev`` on this (1, 1) mesh must equal the
    bytes of the real state and batch; its ``temp_gb_per_dev`` is logged
    beside the measured peak of the timed step.  Everything it allocated
    is freed after.  ``cfg``/``batch``/``seq`` shrink it for a CPU
    rehearsal (gloo in place of nccl; no card, so no rate check)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.config import (OptimizerConfig, ShapeConfig,
                                    ShardingConfig, replace)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import zoo
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import ShardingRules
    from repro_torch.utils.trees import (tree_flatten_with_names,
                                         tree_leaves, tree_structure,
                                         tree_unflatten)

    kind = torch.device(dev).type
    cuda = kind == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cfg is None:
        cfg = replace(get_config("yi-6b"), num_layers=2)
    cfg = replace(cfg, dtype="float32", remat_policy="minimal")
    shape = ShapeConfig("prodstep", "train", seq, batch)
    out: dict = {"arch": cfg.name, "layers": cfg.num_layers,
                 "params": cfg.param_count(), "batch": batch, "seq": seq,
                 "dtype": cfg.dtype}
    t_phase = time.monotonic()
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    was_det = torch.are_deterministic_algorithms_enabled()
    try:
        if cuda:
            index = torch.device(dev).index
            torch.cuda.set_device(torch.cuda.current_device()
                                  if index is None else index)
        mesh = make_test_mesh(1, 1, device_type=kind)
        rules = ShardingRules(cfg, mesh, ShardingConfig())
        ann = rules.annotator()
        accum = min(PROD_ACCUM_CAP,
                    max(1, shape.global_batch // rules.dp_size))
        ocfg = OptimizerConfig(name="sgd", lr=PROD_LR, warmup_steps=1,
                               schedule="constant")
        opt = make_optimizer(ocfg)
        out.update(mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   dp_size=rules.dp_size, accum=accum, lr=PROD_LR)

        # (c) placements of every state leaf
        specs = zoo.state_specs(cfg, opt)
        shard = dict(tree_flatten_with_names(rules.state_shardings(specs)))
        names = [n for n, _ in tree_flatten_with_names(specs)]
        check(sorted(shard) == sorted(names)
              and all(len(s.placements) == 2 for s in shard.values()),
              "prodstep: a state leaf without placements")

        gen = torch.Generator(device=dev).manual_seed(21)
        state = zoo.init_state(cfg, opt, gen, dev)
        # step 1: past the warmup, whose learning rate at step 0 is 0
        state["step"] = torch.ones((), dtype=torch.int32, device=dev)
        held_bytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(state))
        real = dict(tree_flatten_with_names(state))
        kinds: dict = {}
        for n in names:
            kinds.setdefault(tuple(map(str, shard[n].placements)), n)
        for pl, n in kinds.items():
            t = real[n]
            back = distribute_tensor(t, mesh, shard[n].placements) \
                .full_tensor()
            check(back.dtype == t.dtype and torch.equal(back, t),
                  f"prodstep: {n} under {pl} did not round-trip")
        out["placement_kinds"] = {" ".join(k): n for k, n in kinds.items()}
        out["state_leaves"] = len(names)
        del real
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=dev, dtype=torch.int32)
        labels = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=dev, dtype=torch.int32)
        data = {"tokens": tokens, "labels": labels}
        held_bytes += tokens.numel() * 4 + labels.numel() * 4

        torch.use_deterministic_algorithms(True)
        # (a) remat: one step per policy from the same state
        params: dict = {}
        metrics: dict = {}
        out.update(peak_gb={}, kept_gb={}, policy_s={})
        for policy in ("none", "full", "minimal"):
            pcfg = replace(cfg, remat_policy=policy)
            if cuda:    # what the graph keeps for the backward pass
                gc.collect()
                sync()
                before = torch.cuda.memory_allocated()
                leaves = [p.detach().requires_grad_(True)
                          for p in tree_leaves(state["params"])]
                # the loss and its metrics hold the graph: drop both
                loss, parts = zoo.make_loss_fn(pcfg, ann=ann)(
                    tree_unflatten(tree_structure(state["params"]), leaves),
                    data)
                sync()
                out["kept_gb"][policy] = (torch.cuda.memory_allocated()
                                          - before) / 1e9
                del loss, parts, leaves
            step = zoo.make_train_step(pcfg, opt, ocfg, ann=ann)
            gc.collect()
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            t0 = time.monotonic()
            new, m = step(state, data)
            sync()
            out["policy_s"][policy] = time.monotonic() - t0
            if cuda:
                out["peak_gb"][policy] = (torch.cuda.max_memory_allocated()
                                          - before) / 1e9
            params[policy] = new["params"]
            metrics[policy] = {k: float(v) for k, v in m.items()}
            del new, m
        ref = dict(tree_flatten_with_names(params["none"]))
        for policy in ("full", "minimal"):
            bad = [n for n, leaf in tree_flatten_with_names(params[policy])
                   if not torch.equal(leaf, ref[n])]
            check(not bad and metrics[policy]["loss"]
                  == metrics["none"]["loss"],
                  f"prodstep: remat {policy} differs from none at {bad[:4]}")
        del params["full"], params["none"]
        out["metrics"] = metrics["minimal"]

        # (b) accum microbatches against the one batch of (a)
        step = zoo.make_train_step(cfg, opt, ocfg, accum=accum, ann=ann)
        new, m = step(state, data)
        sync()
        m = {k: float(v) for k, v in m.items()}
        out["accum_metrics"] = m
        for key in ("loss", "grad_norm"):
            rel = abs(m[key] - metrics["minimal"][key]) / \
                abs(metrics["minimal"][key])
            out[f"accum_{key}_rel"] = rel
            check(rel <= 1e-5, f"prodstep: accum {key} rel {rel:.3e}")
        one = dict(tree_flatten_with_names(params["minimal"]))
        old = dict(tree_flatten_with_names(state["params"]))
        # lr x max|g|: the largest update of the one-batch step; each
        # param may also round to the other side of one f32 ulp
        upd = max(float((old[n] - one[n]).abs().max()) for n in one)
        diff, worst = 0.0, 0.0
        for n, leaf in tree_flatten_with_names(new["params"]):
            a = one[n].abs()
            ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
            d = (leaf - one[n]).abs()
            diff = max(diff, float(d.max()))
            worst = max(worst, float((d / (PROD_PARAM_TOL * upd + ulp))
                                     .max()))
        out.update(lr_max_g=upd, accum_param_max_diff=diff,
                   accum_param_worst_share=worst)
        check(upd > 0 and worst <= 1.0,
              f"prodstep: accum params differ by up to {diff:.3e}, "
              f"{worst:.3f} x ({PROD_PARAM_TOL} x lr x max|g| = "
              f"{PROD_PARAM_TOL * upd:.3e}, plus one ulp of the param)")
        del new, params, one, old
        torch.use_deterministic_algorithms(was_det)

        # the production step's time: accum microbatches, remat minimal
        times = []
        for i in range(PROD_TIMED):
            gc.collect()
            sync()
            if cuda and i == 0:
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            t0 = time.monotonic()
            state, m = step(state, data)
            sync()
            times.append(time.monotonic() - t0)
            if cuda and i == 0:
                out["timed_peak_gb"] = (torch.cuda.max_memory_allocated()
                                        - before) / 1e9
            check(math.isfinite(float(m["loss"])), "prodstep: loss not finite")
        out["step_s"] = sorted(times)[len(times) // 2]
        out["step_times_s"] = times
        out["roofline"] = prodstep_roofline(
            cfg, shape, mesh, rules, opt, step, accum, held_bytes,
            out["step_s"], torch.cuda.get_device_name(dev) if cuda else None)
        del state, data, step, m
    finally:
        torch.use_deterministic_algorithms(was_det)
        dist.destroy_process_group()
        sync()
        if cuda:
            torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    return out


def prodstep_roofline(cfg, shape, mesh, rules, opt, step, accum: int,
                      held_bytes: int, step_s: float,
                      card: "str | None") -> dict:
    """The roofline of the prodstep phase's timed step, counted on
    ``meta`` tensors (a few seconds of host time): its flops over the
    card's float32 peak must not exceed the measured ``step_s``, and the
    dry run's argument bytes must equal the real state and batch."""
    import torch

    from repro_torch import roofline
    from repro_torch.kernels.rates import card_rates
    from repro_torch.launch import dryrun
    from repro_torch.models import zoo

    check(not torch.backends.cuda.matmul.allow_tf32,
          "prodstep: TF32 is on, so the float32 peak is not the bound")
    t0 = time.monotonic()
    args = (zoo.state_specs(cfg, opt), zoo.input_specs(cfg, shape))
    costs = roofline.count_step(step, *args, n_dev=1)
    cell = dryrun.Cell(cfg, shape, mesh, rules, step, args,
                       {"accum": accum}, None, 0)
    rec = dryrun.cell_record(cell, dryrun.count_full(cell))
    out = {"count_s": time.monotonic() - t0, "flops": costs.flops,
           "hbm_bytes": costs.bytes,
           "arg_gb_per_dev": rec["arg_gb_per_dev"],
           "temp_gb_per_dev": rec["temp_gb_per_dev"],
           "output_gb_per_dev": rec["output_gb_per_dev"],
           "held_gb": held_bytes / 2**30}
    check(rec["hlo_flops_per_dev"] == costs.flops,
          "prodstep: the dry run's flops differ from count_step's")
    check(rec["arg_gb_per_dev"] * 2**30 == held_bytes,
          f"prodstep: dry-run arg bytes {rec['arg_gb_per_dev'] * 2**30:.0f}"
          f" != the real state and batch {held_bytes}")
    if card is not None:
        rates = card_rates(card)
        bound = max(costs.flops / rates.fp32, costs.bytes / rates.hbm)
        out.update(fp32_peak=rates.fp32, hbm_rate=rates.hbm,
                   flops_bound_s=costs.flops / rates.fp32,
                   bytes_bound_s=costs.bytes / rates.hbm, bound_s=bound,
                   bound_fraction=costs.flops / rates.fp32 / step_s)
        check(costs.flops / rates.fp32 <= step_s,
              f"prodstep: counted flops over the f32 peak "
              f"{costs.flops / rates.fp32:.3f} s exceed the measured step "
              f"{step_s:.3f} s")
    return out


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


def _module(path: Path):
    """A benchmark module, loaded by path once."""
    if path.stem not in sys.modules:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        # registered before it runs: a dataclass looks its module up
        sys.modules[path.stem] = mod
        spec.loader.exec_module(mod)
    return sys.modules[path.stem]


def _bench():
    """``benchmarks/torch_bench_ckpt.py``."""
    return _module(BENCH)


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


def khaos_cost(cal: dict, step_s: float, batch: int):
    """The cost model of the job from the calibration artifact: capacity
    ``batch / step_s`` events/s, base latency one step."""
    from repro_torch.sim import SimCostModel
    return SimCostModel.from_calibration(
        cal, capacity_eps=batch / step_s, base_latency_s=step_s,
        detect_s=DETECT_S, restart_s=RESTART_S)


def khaos_profile(cost, recording, plans: list, l_const: float,
                  grid: tuple = KHAOS_GRID, engine: str = "device",
                  device=None):
    """Phases 1 and 2 of the job: a ``KhaosRuntime`` over ``plans`` records
    the steady state of ``recording`` and profiles ``grid`` = (failure
    points, CIs) in a CI window of 1.5x-6x the calibrated full write —
    ``engine`` "device"/"numpy" as lanes of one campaign
    (``BatchedDeployment``), "sequential" one ``SimDeployment`` per CI.
    At 3 CIs the grid is ``CI_GRID``; otherwise the runtime's own grid
    (evenly spaced over the window).  Returns (runtime, CIs,
    deployment)."""
    from repro_torch.config import KhaosConfig
    from repro_torch.core import KhaosRuntime
    from repro_torch.sim import BatchedDeployment, SimDeployment

    m, z = grid
    fw = cost.ckpt_duration_s
    rt = KhaosRuntime(KhaosConfig(latency_constraint=l_const,
                                  optimization_period=KHAOS_PERIOD_S,
                                  ci_min=CI_GRID[0] * fw,
                                  ci_max=CI_GRID[-1] * fw,
                                  num_failure_points=m, num_configs=z),
                      cost=cost, plan_variants=plans)
    rt.record_steady_state(recording)
    cis = [f * fw for f in CI_GRID] if z == len(CI_GRID) \
        else list(rt.default_ci_grid())
    if engine == "sequential":
        def deployment(ci):
            return SimDeployment(ci, recording, cost)
    else:
        deployment = BatchedDeployment(cost, recording, engine=engine,
                                       device=device)
    rt.run_profiling(deployment, ci_values=cis)
    return rt, cis, deployment


def priced_recovery(rt, cost, plan, cis: list, tr_now: float) -> float:
    """The job's recovery at ``cis[0]`` as the optimizer re-prices it from
    the fitted models (on the optimizer's CI grid)."""
    import numpy as np
    from repro_torch.config import CheckpointPlan
    from repro_torch.core.ci_optimizer import _variant_predictions
    _, recs, _ = _variant_predictions(rt.m_l, rt.m_r, cost, [plan],
                                      np.linspace(cis[0], cis[-1], 128),
                                      tr_now, CheckpointPlan())
    return float(recs[0][0])


def khaos_phases(run: TrainerRun, cal: dict, dev) -> dict:
    """Phases 1 and 2 (the grid as lanes of one campaign on the card's
    lane engine), then Phase 3 over the live trainer.

    The constraints, as a user would set them from the calibrated costs:
    the job may lag by the backlog that ONE lossless device delta, as the
    calibrated model prices its write, leaves behind (rate x priced write
    / capacity); recovery may take up to twice what the calibrated models
    predict for the job at its current CI.  The job runs at 1.5x the
    calibrated full write: the profiled grid spans 1.5x-6x of it."""
    from repro_torch.config import replace
    from repro_torch.core import optimize_plan
    from repro_torch.data.stream import record_workload

    tr, plan = run.tr, run.tr.ckpt.plan
    int8 = replace(plan, delta_codec="int8")
    step_s = run.step_s()
    capacity = run.tcfg.batch / step_s
    cost = khaos_cost(cal, step_s, run.tcfg.batch)
    recording = record_workload(run.schedule, duration=STREAM_PERIOD_S,
                                seed=0)
    priced_lossless = cost.write_duration("delta", "local", "lossless",
                                          "device")
    l_const = float(recording.counts.mean()) * priced_lossless / capacity
    t0 = time.monotonic()
    rt, cis, dep = khaos_profile(cost, recording, [plan, int8], l_const,
                                 engine="device", device=dev)
    profile_s = time.monotonic() - t0
    info = rt.phase_log[-1].info
    camp = dep.last_campaign
    check(info["substrate"] == "campaign" and camp.device.type == "cuda",
          f"Phase 2 did not run as a campaign on the card: {info}")
    log(f"khaos phases 1-2: {rt.phase_sequence()}, {info['cells']} cells "
        f"({KHAOS_GRID[0]} failure points x {KHAOS_GRID[1]} CIs) as lanes of "
        f"one campaign on {camp.device} ({camp.chunks} chunks, "
        f"{camp.horizon} ticks), M_L error {info['m_l_pct_error']:.4f}, M_R "
        f"error {info['m_r_pct_error']:.4f} ({profile_s:.1f} s); latencies "
        f"{rt.profile.latencies.tolist()}, recoveries "
        f"{rt.profile.recoveries.tolist()}")

    # Phase 3: the job runs at cis[0]; its recovery priced there by the
    # optimizer's own re-pricing (on the optimizer's CI grid)
    tr_now = float(recording.counts.mean())
    priced = priced_recovery(rt, cost, plan, cis, tr_now)
    check(priced > 0, f"the fitted models price the job's recovery at "
                      f"{priced} s")
    rt.cfg = replace(rt.cfg, recovery_constraint=2.0 * priced)
    log(f"khaos constraints: latency {l_const:.4f} s (rate "
        f"{tr_now:.3f}/s x priced lossless delta {priced_lossless:.3f} s / "
        f"capacity {capacity:.3f}/s), recovery {rt.cfg.recovery_constraint:.3f}"
        f" s (2 x {priced:.3f} s priced at CI {cis[0]:.3f} s)")
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
            "ci_grid": cis, "grid": list(KHAOS_GRID),
            "profile_s": profile_s, "phases": rt.phase_sequence(),
            "decisions": [d.kind for d in decisions],
            "capacity_eps": capacity, "step_s": step_s, "lag": run.lags,
            "m_l_pct_error": info["m_l_pct_error"],
            "m_r_pct_error": info["m_r_pct_error"]}


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not all(
            p.is_file() for p in (BENCH, KBENCH, CBENCH, SBENCH,
                                  *DRILL_BENCHES, *PAPER_BENCHES)):
        print("chip_smoke.py needs the repro_torch package under src/ and "
              "benchmarks/torch_run.py, torch_common.py and torch_bench_"
              "{ckpt,kernels,campaign,fleet,replication,runtime,proactive,"
              "recovery,serve,tables,khaos_training}.py beside it",
              file=sys.stderr)
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
    rates = card_rates(kind)      # an unknown card fails here
    hbm, flops = rates.hbm, rates.fp32
    dev = torch.device("cuda", 0)

    import repro_torch  # noqa: F401  (sets the TF32 switches off)
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    families = _kernel_families()
    ops = families[0]

    t0 = time.monotonic()
    for name, (path, secs) in build_all().items():
        log(f"build {name}: {path.name} in {secs:.2f} s")
    log(f"build: {time.monotonic() - t0:.2f} s for the four libraries")

    cfg = replace(get_config("yi-6b"), num_layers=2)
    t0 = time.monotonic()
    results = kernel_phase(dev, hbm, flops)
    results.update(per_leaf_phase(dev, hbm, flops, _state_leaves(cfg)))
    log(f"kernel phase: {time.monotonic() - t0:.1f} s")

    # -- kernel-bench path: #7-#9 -----------------------------------------
    t0 = time.monotonic()
    seqmix, table = seqmix_phase(dev)
    log(f"seqmix phase: {time.monotonic() - t0:.1f} s, device memory in "
        f"use after it {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    print(json.dumps({"seqmix": table}))

    # -- chaos-campaign path: the torch lane engine ----------------------
    t0 = time.monotonic()
    campaign = campaign_phase(dev)
    log(f"campaign phase: {time.monotonic() - t0:.1f} s, card {smi}")
    print(json.dumps({"campaign": campaign}))

    # -- drills path: run.py --smoke's twins, E11, the card drill (#1/#3) --
    for f in families:
        f.reset_launch_counts()
    t0 = time.monotonic()
    drills = drills_phase(dev, campaign["section"])
    drill_launches: dict = {}
    for f in families:
        drill_launches.update(f.launch_counts())
    drills["phase_s"] = time.monotonic() - t0
    drills["launches"] = drill_launches
    wc = drills["e11_wallclock"]
    cd = drills["card_drill"]
    log(f"drills phase: {drills['phase_s']:.1f} s (smoke "
        f"{drills['smoke_s']:.1f} s, E11 device {drills['e11_device_s']:.1f}"
        f" s, numpy {drills['e11_numpy_s']:.1f} s, card drill "
        f"{drills['card_drill_s']:.1f} s); E11 controller wall-clock "
        f"device {wc['device']['fleet_s']:.4f} s vs one job "
        f"{wc['device']['one_job_s']:.4f} s ({wc['device']['ratio']:.3f}x), "
        f"numpy {wc['numpy']['fleet_s']:.4f} vs "
        f"{wc['numpy']['one_job_s']:.4f} s ({wc['numpy']['ratio']:.3f}x, "
        f"not gated), pooled Phase 2 on the device engine "
        f"{wc['device']['pooled_phase2_s']:.3f} s; card drill "
        f"{cd['bytes_written']} bytes written, saves "
        f"{cd['full_save_s']:.2f} + {cd['delta_save_s']:.2f} s, restore "
        f"{cd['restore_s']:.2f} s, pulled fraction "
        f"{cd['measured_fraction']:.4f}; launches {drill_launches}; card "
        f"{smi}")
    print(json.dumps({"drills": drills}))
    for name in DRILL_KERNELS:
        check(drill_launches[name] > 0,
              f"{name} was not launched on the drills path")

    # -- paper path: E1/E2, E9, E10, E4 and the Phase-2 launcher ---------
    for f in families:
        f.reset_launch_counts()
    t0 = time.monotonic()
    paper = paper_phase(dev, campaign["section"])
    paper_launches: dict = {}
    for f in families:
        paper_launches.update(f.launch_counts())
    for name, n in paper["worker_launches"].items():
        paper_launches[name] += n
    paper["phase_s"] = time.monotonic() - t0
    paper["launches"] = paper_launches
    tr = paper["E9_trace"]
    for key in ("E1", "E2"):
        log(f"{key}: " + "; ".join(
            f"{r['name']} latency {r['avg_latency_ms']:.0f} ms, violations "
            f"{100 * r['lat_violation_frac']:.2f} %, recovery "
            f"{r['total_recovery_s']:.0f} s (violation "
            f"{r['recovery_violation_s']:.0f} s), reconfigs "
            f"{r['reconfigurations']}" for r in paper[key]["rows"])
            + f"; error analysis {paper[key]['error_analysis']} "
            f"(simulated seconds)")
    log(f"E9: {paper['E9']['results']} (goodput, recovery violation s); "
        f"ckpts {paper['E9']['ckpts']}; decisions "
        f"{paper['E9']['decisions_by_kind']}; Phase 3 chunk "
        f"{tr['chunk']} ({tr['ticks']} ticks, {tr['lanes']} lanes): "
        f"{tr['wall_ms_per_tick']:.3f} ms a tick on the host clock, "
        f"device {tr['device_ms_per_tick']:.4f} ms a tick, busy share "
        f"{tr['device_busy_share']:.4f}, {tr['launches_per_tick']:.1f} "
        f"launches a tick")
    log(f"E10: qos violation s {paper['E10']['qos_violation_s']}, lead "
        f"{paper['E10']['lead_s']:.0f} s; E4 grid lane-ticks/s "
        f"{paper['E4']['grid_lane_ticks_per_s']} (not gated)")
    log(f"paper phase: {paper['phase_s']:.1f} s, parts "
        f"{ {k: round(v, 2) for k, v in paper['seconds'].items()} }; "
        f"launches of the nine kernels {paper_launches}; card {smi}")
    print(json.dumps({"paper": paper}))
    check(not any(paper_launches.values()),
          f"kernels launched on the paper path: {paper_launches}")

    # -- serving path: prefill, decode, StreamServer, every family --------
    for f in families:
        f.reset_launch_counts()
    t0 = time.monotonic()
    serve = serve_phase(dev)
    serve_launches: dict = {}
    for f in families:
        serve_launches.update(f.launch_counts())
    serve["phase_s"] = time.monotonic() - t0
    serve["launches"] = serve_launches
    for r in serve["rows"]:
        log(f"{r['row']}: {r['arch']} {r['layers']}"
            f"{'+' + str(r['decoder_layers']) if r['decoder_layers'] else ''}"
            f" layers, {r['params']:,} params, B {r['batch']}, prompt "
            f"{r['prompt']} -> {r['new']}; oracle ({r['oracle']}) max rel "
            f"{r['oracle_max_rel']:.3e}; bf16 prefill {r['prefill_ms']:.1f} "
            f"ms, decode {r['decode_ms']:.2f} ms/step (device busy "
            f"{r['decode_trace']['device_busy_share']:.1%}, "
            f"{r['decode_trace']['launches_per_step']:.0f} launches a step),"
            f" {r['served_by']} "
            f"{r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gb']:.2f} GB "
            f"(oracle {r['oracle_peak_gb']:.2f}), top-1 vs f32 "
            f"{r['top1_vs_f32']:.3f}, int8 agreement with bf16 "
            f"{r.get('int8_agree', 'n/a')} (bf16 with f32 "
            f"{r.get('int8_bf16_vs_f32', 'n/a')}, not gated); row "
            f"{r['row_s']:.1f} s")
    smoke_int8 = {x["arch"]: x["int8_agree"] for x in serve["smoke"]
                  if "int8_agree" in x}
    log(f"serve phase: {serve['phase_s']:.1f} s (SMOKE sweep "
        f"{serve['smoke_s']:.1f} s, worst rel "
        f"{max(x['max_rel'] for x in serve['smoke']):.3e}, int8 agreement "
        f"{smoke_int8}); launches of the "
        f"nine kernels {serve_launches} (the reference model calls none); "
        f"device memory in use after it "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB; card {smi}")
    print(json.dumps({"serve": serve}))
    check(not serve["gate_failures"], "; ".join(serve["gate_failures"]))

    # -- production-style train step: mesh, rules, remat, accumulation ---
    for f in families:
        f.reset_launch_counts()
    prod = prodstep_phase(dev)
    prod_launches: dict = {}
    for f in families:
        prod_launches.update(f.launch_counts())
    prod["launches"] = prod_launches
    roof = prod["roofline"]
    log(f"prodstep: {prod['arch']} widths, {prod['layers']} layers, "
        f"{prod['params']:,} params, {prod['dtype']}, batch "
        f"{prod['batch']} x {prod['seq']}, mesh {prod['mesh']}, accum "
        f"{prod['accum']}; remat none/full/minimal bit-equal, kept for "
        f"backward { {k: round(v, 3) for k, v in prod['kept_gb'].items()} }"
        f" GB, step peak over held "
        f"{ {k: round(v, 3) for k, v in prod['peak_gb'].items()} } GB, "
        f"step s { {k: round(v, 3) for k, v in prod['policy_s'].items()} };"
        f" accum loss rel {prod['accum_loss_rel']:.3e}, grad_norm rel "
        f"{prod['accum_grad_norm_rel']:.3e}, params max diff "
        f"{prod['accum_param_max_diff']:.3e} (lr x max|g| "
        f"{prod['lr_max_g']:.3e}, {prod['accum_param_worst_share']:.3f} of "
        f"the gate); {len(prod['placement_kinds'])} placement "
        f"kinds round-tripped over {prod['state_leaves']} leaves; step "
        f"{prod['step_s']:.3f} s (median of {len(prod['step_times_s'])}); "
        f"roofline: {roof['flops']:.4e} flops counted on meta in "
        f"{roof['count_s']:.1f} s, over the f32 peak "
        f"{roof.get('flops_bound_s', math.nan):.3f} s = "
        f"{roof.get('bound_fraction', math.nan):.3f} of the step; dry-run "
        f"arg {roof['arg_gb_per_dev']:.3f} GB = the state and batch held, "
        f"temp {roof['temp_gb_per_dev']:.3f} GB + output "
        f"{roof['output_gb_per_dev']:.3f} GB against the timed step's "
        f"measured peak over held {prod.get('timed_peak_gb', math.nan):.3f}"
        f" GB; phase {prod['phase_s']:.1f} s; launches of the nine kernels "
        f"{prod_launches}; card {smi}")
    print(json.dumps({"prodstep": prod}))
    check(not any(prod_launches.values()),
          f"kernels launched on the prodstep path: {prod_launches}")

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
        khaos = khaos_phases(run, cal, dev)
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
    for name in TRAINER_KERNELS:
        check(launches[name] > 0,
              f"{name} was not launched on the trainer path")

    rows = []
    for name, (replaces, source, _, _) in KERNELS.items():
        if name in SEQMIX_KERNELS:
            r = seqmix[name]
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, **r, "path": "kernel bench",
                         "drills_launches": drill_launches[name],
                         "paper_launches": paper_launches[name],
                         "serve_launches": serve_launches[name],
                         "prodstep_launches": prod_launches[name]})
            continue
        r = results[name]
        n = (calib_launches if name in CALIBRATION_KERNELS
             else launches)[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "mismatches": r["mismatches"],
                     "elements": r["elements"],
                     "drills_launches": drill_launches[name],
                     "paper_launches": paper_launches[name],
                     "serve_launches": serve_launches[name],
                     "prodstep_launches": prod_launches[name],
                     "path": ("calibration" if name in CALIBRATION_KERNELS
                              else "trainer")})
    log(f"total {time.monotonic() - t_start:.1f} s; library_ms is null for "
        f"#1-#6 (no single PyTorch call computes them), for #8 and #9, and "
        f"for softcapped attention; #7's is scaled_dot_product_attention "
        f"at its headline row")
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
