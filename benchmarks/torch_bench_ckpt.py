"""Checkpoint subsystem benchmark of the PyTorch port and the calibration
artifact the Khaos cost model loads — the twin of ``bench_ckpt.py``.

    PYTHONPATH=src python benchmarks/torch_bench_ckpt.py [--device cpu]

It measures, on the port's checkpoint plane:

  * ``bench_checkpoint``: the monolithic D2H copy of a train state, a full
    sync write, the blocking part of an async write, a restore, and the
    written fractions of a lossless and an int8 host-encoded delta;
  * ``bench_plans``: whole-plan accounting over a drifting state (bytes
    written and on the link, write and blocking seconds, encode CPU);
  * ``bench_device_delta``: the ``device`` section — per codec, the pack of
    the f32 subtree (``pack_s``), ONE fused flat encode with every output
    plane pulled to the host (``encode_s``: kernels #1/#2 on a card), the
    per-leaf baseline — one ``*_encode_leaf`` per packed leaf with its
    outputs pulled (``per_leaf_encode_s``: kernels #5/#6 on a card) — and
    one ``DeltaLeafSource`` trigger's bytes on the link.

``build_calibration`` assembles the ``bench_ckpt/3`` artifact (the schema
the JAX package's ``bench_ckpt.py`` writes, so either package's
``SimCostModel.from_calibration`` loads it), ``validate_calibration``
checks it and ``emit_calibration`` writes it; ``main`` writes
``BENCH_ckpt_torch.json``.  ``smoke(tmpdir)`` runs the whole flow on tiny
states and checks the artifact loads.  The states live on the CUDA device
unless ``--device`` names another (the CPU runs the kernels' plain
versions).  The JAX package's ``bench_calibrated_optimize`` is not
twinned here: it needs the batched plan verifier.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, CheckpointPlan,
                                    CheckpointStore, DeltaLeafSource,
                                    DeviceDeltaBase)
from repro_torch.checkpoint.pipeline import HostLanding
from repro_torch.config import OptimizerConfig, replace
from repro_torch.configs import get_smoke_config
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.sim import SimCostModel
from repro_torch.sim.costmodel import CALIBRATION_KEYS
from repro_torch.utils.trees import (np_dtype, resolve_device, tree_bytes,
                                     tree_flatten_with_names, tree_leaves,
                                     tree_map)


def _sync(state: Any) -> None:
    """Wait for the device work behind ``state``'s tensors."""
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def _mk_state(scale: int = 4, device: Any = None) -> dict:
    cfg = replace(get_smoke_config("yi-6b"), d_model=64 * scale,
                  d_ff=128 * scale, num_layers=4)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = zoo.init_state(cfg, make_optimizer(OptimizerConfig()), gen, dev)
    _sync(state)
    return state


def _bump(state: dict) -> dict:
    """Every float leaf + 1e-4 (new tensors; the state is not touched)."""
    return tree_map(
        lambda x: x + x.new_tensor(1e-4) if x.is_floating_point() else x,
        state)


def _planes(outputs) -> list:
    return [(t.numel(), np_dtype(t)) for t in outputs]


def _pulled(calls, planes: list, landing: HostLanding, pin: bool) -> float:
    """Seconds to run ``calls`` (each returns one encode's outputs) and
    pull every output to the host: all of them end to end in ``landing``,
    as a device-delta trigger's payload lands (page-locked on a card,
    reused), so both the fused and the per-leaf path write the same host
    bytes.  Each plane goes in one copy, where the trigger copies 4 MiB
    chunks on two threads."""
    t0 = time.monotonic()
    hosts = iter(landing.take(planes, pin))
    for call in calls:
        for t in call():
            torch.from_numpy(next(hosts)).copy_(t.reshape(-1))
    return time.monotonic() - t0


def bench_checkpoint(tmpdir: str, scale: int = 4, device: Any = None):
    """Single-mechanism microbenchmarks; returns (rows, measurements) where
    measurements feed the calibration artifact."""
    shutil.rmtree(tmpdir, ignore_errors=True)
    dev = resolve_device(device)
    state = _mk_state(scale, dev)
    nbytes = tree_bytes(state)
    print(f"\n=== Checkpoint subsystem (state = {nbytes/2**20:.1f} MiB, "
          f"{dev}) ===")
    rows = []
    meas = {"state_bytes": nbytes}

    t0 = time.monotonic()
    zoo.state_to_numpy(state)
    meas["snapshot_full_copy_s"] = time.monotonic() - t0
    rows.append(("ckpt_snapshot_full_copy", meas["snapshot_full_copy_s"] * 1e6,
                 "monolithic D2H deep copy (pre-pipeline blocking cost)"))

    store = CheckpointStore(tmpdir + "/sync", num_shards=4)
    t0 = time.monotonic()
    store.save(1, state)
    sync_s = time.monotonic() - t0
    meas["full_write_s"] = sync_s
    rows.append(("ckpt_sync_save", sync_s * 1e6,
                 f"{nbytes/sync_s/2**20:.0f} MiB/s"))

    amgr = CheckpointManager(tmpdir + "/async",
                             CheckpointPlan(sync=False, num_shards=4,
                                            replication_factor=0),
                             device=dev)
    block_s = amgr.save(1, state).blocking_s    # the chunked snapshot only
    amgr.wait()
    meas["async_blocking_s"] = block_s
    rows.append(("ckpt_async_block", block_s * 1e6,
                 f"{block_s/sync_s:.3f}x of sync"))

    t0 = time.monotonic()
    store.restore(state)
    restore_s = time.monotonic() - t0
    meas["restore_s"] = restore_s
    rows.append(("ckpt_restore", restore_s * 1e6,
                 f"{nbytes/restore_s/2**20:.0f} MiB/s"))

    for mode in ("lossless", "int8"):
        mgr = CheckpointManager(
            tmpdir + f"/inc_{mode}",
            CheckpointPlan(mode="incremental", full_every=8, delta_codec=mode,
                           num_shards=2, replication_factor=0),
            device=dev)
        mgr.save(0, state)
        bumped = _bump(state)
        t0 = time.monotonic()
        mgr.save(1, bumped)
        dt = time.monotonic() - t0
        by_kind = mgr.stats()["bytes_by_kind"]
        ratio = by_kind["delta"] / max(by_kind["full"], 1)
        meas[f"delta_fraction_{mode}"] = ratio
        rows.append((f"ckpt_incr_{mode}", dt * 1e6,
                     f"delta/full bytes = {ratio:.4f}"))

    for name, us, derived in rows:
        print(f"{name},{us:.0f},{derived}")
    return rows, meas


PLANS = {
    "full-sync": CheckpointPlan(),
    "full-async": CheckpointPlan(sync=False),
    "incr8-sync": CheckpointPlan(mode="incremental", full_every=8),
    "incr8-async": CheckpointPlan(mode="incremental", full_every=8,
                                  sync=False, busy_policy="block"),
    "dev-lossless": CheckpointPlan(mode="incremental", full_every=8,
                                   encode_placement="device"),
    "dev-int8": CheckpointPlan(mode="incremental", full_every=8,
                               encode_placement="device",
                               delta_codec="int8"),
    "multilevel": CheckpointPlan(levels=("memory", "local", "remote"),
                                 local_every=2, remote_every=8),
    "ml+delta": CheckpointPlan(mode="incremental", full_every=8,
                               levels=("memory", "local", "remote"),
                               local_every=1, remote_every=8),
}


def bench_plans(tmpdir: str, triggers: int = 16, scale: int = 4,
                device: Any = None):
    """Whole-plan accounting: run ``triggers`` checkpoint triggers of a
    drifting train state through each plan and report total bytes written,
    mean blocking/write durations and delta-encode CPU seconds — the
    overhead the optimizer trades against QoS.  Returns (rows, per-plan
    stats dict for the calibration artifact)."""
    dev = resolve_device(device)
    state = _mk_state(scale, dev)
    nbytes = tree_bytes(state)
    print(f"\n=== Checkpoint plans ({triggers} triggers, "
          f"state = {nbytes/2**20:.1f} MiB, {dev}) ===")
    print(f"{'plan':12s} {'bytes_written':>14s} {'vs_full':>8s} "
          f"{'write_ms':>9s} {'block_ms':>9s} {'encode_ms':>9s} "
          f"{'link_frac':>9s}")
    rows = []
    plan_stats: dict[str, dict] = {}
    baseline_bytes = None
    for name, plan in PLANS.items():
        shutil.rmtree(f"{tmpdir}/{name}", ignore_errors=True)
        mgr = CheckpointManager(f"{tmpdir}/{name}", plan, device=dev)
        cur = state
        block, writes, encode, deltas = [], [], [], 0
        link, delta_link = [], []
        for i in range(triggers):
            cur = _bump(cur)
            rep = mgr.save(i, cur, float(i))
            block.append(rep.blocking_s)
            mgr.wait()
            writes.append(rep.duration_s)
            encode.append(rep.encode_s)
            link.append(rep.bytes_on_link)
            if rep.kind == "delta":
                deltas += 1
                delta_link.append(rep.bytes_on_link)
        st = mgr.stats()
        total = st["bytes_written"]
        if baseline_bytes is None:
            baseline_bytes = total
        plan_stats[name] = {
            "bytes_per_trigger": total / triggers,
            "write_s": float(np.mean(writes)),
            "blocking_s": float(np.mean(block)),
            "encode_cpu_s": float(np.sum(encode)),
            "delta_triggers": deltas,
            "bytes_by_kind": st["bytes_by_kind"],
            # pre-compression post-encode D2H traffic: host encodes move
            # the raw state, device encodes only the payload
            "bytes_on_link_per_trigger": float(np.mean(link)),
            "delta_bytes_on_link": (float(np.mean(delta_link))
                                    if delta_link else 0.0),
            "encode_placement": plan.encode_placement,
            "delta_codec": plan.delta_codec,
        }
        rows.append((name, total, total / baseline_bytes,
                     1e3 * float(np.mean(writes)),
                     1e3 * float(np.mean(block))))
        print(f"{name:12s} {total:>14d} {total/baseline_bytes:>8.3f} "
              f"{1e3*np.mean(writes):>9.1f} {1e3*np.mean(block):>9.1f} "
              f"{1e3*np.sum(encode):>9.1f} {np.mean(link)/nbytes:>9.3f}")
    return rows, plan_stats


# ---------------------------------------------------------------------------
# device-placement encode (DeltaLeafSource: kernels in front of D2H)
# ---------------------------------------------------------------------------

def bench_device_delta(scale: int = 4, device: Any = None,
                       state: Optional[dict] = None, reps: int = 3) -> dict:
    """Measure the on-device delta encode per codec — the ``device``
    section of the bench_ckpt/3 artifact:

      * ``pack_s``: the per-trigger ``pack_flat`` of the new state's f32
        subtree into one GROUP-aligned buffer;
      * ``encode_s``: ONE fused flat encode + pulling every output plane to
        the host (``SimCostModel.device_encode_s*``), into a reused
        page-locked ``HostLanding`` as a trigger's payload, as every pull
        here (``_pulled``);
      * ``per_leaf_encode_s``: the pre-flat baseline — one
        ``*_encode_leaf`` per packed leaf with all its outputs pulled —
        that the validate gate regresses ``encode_s`` against;
      * ``bytes_on_link``/``link_fraction``: one ``DeltaLeafSource``
        trigger's payload D2H vs the full state.

    ``state`` (a train state on the device) replaces the bench's own
    ``_mk_state(scale)``; each timing is the best of ``reps``.
    """
    from repro_torch.kernels.ckpt_delta.ops import (flat_int8_encode,
                                                    flat_lossless_encode,
                                                    int8_encode_leaf,
                                                    lossless_encode_leaf,
                                                    pack_flat)

    if state is None:
        state = _mk_state(scale, device)
    bumped = _bump(state)
    _sync(bumped)
    nbytes = tree_bytes(state)
    base = DeviceDeltaBase(state)
    layout = base.layout
    assert layout is not None, "bench state has no packable f32 subtree"
    new_leaves = dict(tree_flatten_with_names(bumped))
    base_leaves = {n: base.leaves[n].check() for n in layout.names}
    packable = [new_leaves[n] for n in layout.names]
    print(f"\n=== Device-placement delta encode "
          f"(state = {nbytes/2**20:.1f} MiB, {len(layout.names)} packed "
          f"leaves, {base.device}) ===")

    pack_flat(packable)                        # warm the allocator
    _sync(bumped)
    t0 = time.monotonic()
    new_flat = pack_flat(packable)
    _sync(bumped)
    pack_s = time.monotonic() - t0

    gl = layout.group_leaf_device(base.device)
    nl = len(layout.names)
    landing, pin = HostLanding(), base.device.type == "cuda"
    out: dict[str, dict] = {}
    for codec in ("lossless", "int8"):
        fused = flat_lossless_encode if codec == "lossless" \
            else flat_int8_encode
        leaf_op = lossless_encode_leaf if codec == "lossless" \
            else int8_encode_leaf
        fused_calls = [lambda: fused(new_flat, base.flat, gl, nl)]
        leaf_calls = [functools.partial(leaf_op, new_leaves[n],
                                        base_leaves[n])
                      for n in layout.names]
        paths = {"encode_s": (fused_calls, _planes(fused_calls[0]())),
                 "per_leaf_encode_s": (leaf_calls, [
                     p for call in leaf_calls for p in _planes(call())])}
        # warm both paths once (the landing grows and is registered
        # here) before any timing, then take the best of ``reps`` of each
        for calls, planes in paths.values():
            _pulled(calls, planes, landing, pin)
        out[codec] = {"pack_s": pack_s, **{
            key: min(_pulled(calls, planes, landing, pin)
                     for _ in range(reps))
            for key, (calls, planes) in paths.items()}}
    del new_flat                 # the sources below pack their own

    for codec in ("lossless", "int8"):
        src = DeltaLeafSource(bumped, base, codec=codec, landing=landing)
        link = src.bytes_on_link()          # waits for every chunk
        del src
        e = out[codec]
        e.update(bytes_on_link=int(link), link_fraction=link / nbytes)
        print(f"device_{codec}: pack {1e3*pack_s:.1f} ms, fused encode "
              f"{1e3*e['encode_s']:.1f} ms (per-leaf baseline "
              f"{1e3*e['per_leaf_encode_s']:.1f} ms), {link} B on link "
              f"({link/nbytes:.3f}x full state)")
    landing.release()
    return out


# ---------------------------------------------------------------------------
# calibration artifact (BENCH_ckpt_torch.json <-> SimCostModel.from_calibration)
# ---------------------------------------------------------------------------

def build_calibration(meas: dict, plan_stats: dict, device: dict) -> dict:
    """Assemble the "bench_ckpt/3" artifact from the measured tables."""
    incr = plan_stats.get("incr8-sync", {})
    encode_per_byte = 0.0
    if incr.get("delta_triggers"):
        encode_per_byte = incr["encode_cpu_s"] / (
            meas["state_bytes"] * incr["delta_triggers"])
    return {
        "schema": "bench_ckpt/3",
        "state_bytes": meas["state_bytes"],
        "full_write_s": meas["full_write_s"],
        "restore_s": meas["restore_s"],
        "delta_fraction": meas["delta_fraction_lossless"],
        "delta_int8_fraction": meas["delta_fraction_int8"],
        "delta_encode_s_per_byte": encode_per_byte,
        "snapshot_full_copy_s": meas["snapshot_full_copy_s"],
        "async_blocking_s": meas["async_blocking_s"],
        "device": device,
        "plans": plan_stats,
    }


def validate_calibration(cal: dict, timings: bool = True) -> None:
    """Schema check for the artifact.  Key/schema-version checking is the
    consumer's (``SimCostModel.from_calibration``), so the contract lives
    in one place; the numeric, plans-table and device-section checks below
    are bench-side only (the same checks as ``bench_ckpt.py``'s).
    ``timings=False`` leaves out the one check that compares two measured
    times (the fused encode under the per-leaf baseline): it holds the
    kernels to account only where they ran, on the card."""
    SimCostModel.from_calibration(cal)      # raises ValueError on mismatch
    for k in CALIBRATION_KEYS[1:]:
        if not isinstance(cal[k], (int, float)) or cal[k] < 0:
            raise ValueError(f"{k} must be a non-negative number, "
                             f"got {cal[k]!r}")
    if cal["state_bytes"] <= 0:
        raise ValueError("state_bytes must be positive")
    if not isinstance(cal.get("plans"), dict) or not cal["plans"]:
        raise ValueError("plans table missing or empty")
    for name, st in cal["plans"].items():
        for k in ("bytes_per_trigger", "write_s", "blocking_s",
                  "encode_cpu_s", "bytes_on_link_per_trigger",
                  "encode_placement", "delta_codec"):
            if k not in st:
                raise ValueError(f"plan {name!r} missing {k}")
    if cal["schema"] in ("bench_ckpt/2", "bench_ckpt/3"):
        # device-encoded delta triggers must beat the full-state D2H, on
        # the FRACTION (the device section may come from another state
        # scale than the rest of the artifact)
        int8 = cal["device"]["int8"]
        if not int8["link_fraction"] < 1.0:
            raise ValueError(
                f"device int8 delta moved {int8['link_fraction']:.3f}x the "
                f"full state over the link — encode-before-link must shrink "
                f"the payload")
        for pname, st in cal["plans"].items():
            if (st.get("encode_placement") == "device"
                    and st.get("delta_codec") == "int8"
                    and st.get("delta_triggers")
                    and not st["delta_bytes_on_link"] < cal["state_bytes"]):
                raise ValueError(
                    f"plan {pname!r}: delta-trigger bytes_on_link "
                    f"{st['delta_bytes_on_link']} not under the full state")
    if cal["schema"] == "bench_ckpt/3":
        # the flat-path gates: the int8 payload within its analytic bound
        # (q + 1/256 scales + GROUP padding ~= 0.26x the state), and the
        # fused flat encode not above the per-leaf baseline it replaced
        if not cal["device"]["int8"]["link_fraction"] <= 0.26:
            raise ValueError(
                f"device int8 link fraction "
                f"{cal['device']['int8']['link_fraction']:.4f} exceeds the "
                f"0.26 payload bound (q + scales + GROUP padding)")
        for codec in ("lossless", "int8") if timings else ():
            e = cal["device"][codec]
            if not e["encode_s"] < e["per_leaf_encode_s"]:
                raise ValueError(
                    f"fused {codec} encode regressed: {e['encode_s']:.4f}s "
                    f">= per-leaf baseline {e['per_leaf_encode_s']:.4f}s")


def emit_calibration(path: str, meas: dict, plan_stats: dict,
                     device: dict, timings: bool = True) -> dict:
    cal = build_calibration(meas, plan_stats, device)
    validate_calibration(cal, timings)
    with open(path, "w") as f:
        json.dump(cal, f, indent=2)
    print(f"\ncalibration artifact -> {path}")
    speedup = cal["snapshot_full_copy_s"] / max(cal["async_blocking_s"], 1e-9)
    print(f"async blocking {cal['async_blocking_s']*1e3:.1f} ms vs "
          f"monolithic snapshot {cal['snapshot_full_copy_s']*1e3:.1f} ms "
          f"({speedup:.1f}x lower)")
    return cal


def main(out: str = "BENCH_ckpt_torch.json", device: Any = None,
         tmpdir: Optional[str] = None) -> dict:
    """The full bench at scale 4; checkpoints go under ``tmpdir`` (default:
    ``.bench_ckpt_torch/`` beside ``out``) and are removed at the end."""
    tmpdir = tmpdir or os.path.join(os.path.dirname(os.path.abspath(out)),
                                    ".bench_ckpt_torch")
    try:
        _, meas = bench_checkpoint(tmpdir + "/micro", device=device)
        _, plan_stats = bench_plans(tmpdir + "/plans", device=device)
        dev = bench_device_delta(device=device)
        cal = emit_calibration(out, meas, plan_stats, dev)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    # the flat-path acceptance bar: ONE fused device encode must come in
    # under the host full write it lets the plan skip
    for codec in ("lossless", "int8"):
        e = cal["device"][codec]
        assert e["encode_s"] < cal["full_write_s"], \
            f"fused {codec} encode {e['encode_s']:.4f}s not under the " \
            f"host full write {cal['full_write_s']:.4f}s"
    return cal


def _smoke_device_trainer(tmpdir: str, device: Any) -> None:
    """Drive one micro live trainer on an ``encode_placement="device"``
    plan: a device-encoded delta must land and restore through the
    manager's decode path."""
    from repro_torch.data.stream import EventStream, constant_rate
    from repro_torch.runtime import ResilientTrainer, TrainerConfig

    plan = CheckpointPlan(interval_s=2.0, mode="incremental", full_every=2,
                          encode_placement="device", num_shards=2)
    tcfg = TrainerConfig(batch=2, seq_len=16, ckpt_dir=tmpdir,
                         time_scale=40.0, detect_s=1.0, restart_s=1.0,
                         plan=plan)
    trainer = ResilientTrainer(get_smoke_config("yi-6b"), tcfg,
                               EventStream(schedule=constant_rate(400.0)),
                               OptimizerConfig(total_steps=500, lr=1e-3),
                               device=device)
    for _ in range(60):
        if trainer.ckpt.stats()["bytes_by_kind"]["delta"] > 0:
            break
        trainer.run(duration_s=2.0)
    st = trainer.ckpt.stats()
    if st["bytes_by_kind"]["delta"] <= 0:
        raise ValueError(f"no device-encoded delta landed: {st}")
    if not 0 < st["bytes_on_link"] < st["bytes_written"] * 1000:
        raise ValueError(f"implausible bytes_on_link accounting: {st}")
    rep = trainer.ckpt.restore(trainer.state, "node")
    if rep.kind not in ("full", "full+delta"):
        raise ValueError(f"unexpected restore kind {rep.kind!r}")
    print(f"device-plan micro trainer OK: {st['saves']} triggers, "
          f"{st['bytes_by_kind']['delta']} delta bytes, restored "
          f"step {rep.step} ({rep.kind}) via the {plan.encode_placement} "
          f"decode path")


def smoke(tmpdir: str, device: Any = "cpu") -> dict:
    """Tiny-state end-to-end check of the calibration loop: run the plan
    bench (device placements included), emit the artifact into
    ``tmpdir``, validate its bench_ckpt/3 schema, load it back through
    ``SimCostModel.from_calibration`` (plus v1/v2 artifacts for the
    versioned fallbacks), and drive a micro trainer on a device-encode
    plan.  The fused-vs-per-leaf timing gate applies where the kernels
    ran: on a CUDA device, not on the plain versions of a CPU."""
    shutil.rmtree(tmpdir, ignore_errors=True)
    os.makedirs(tmpdir, exist_ok=True)
    timings = resolve_device(device).type == "cuda"
    _, meas = bench_checkpoint(tmpdir + "/micro", scale=1, device=device)
    _, plan_stats = bench_plans(tmpdir + "/plans", triggers=6, scale=1,
                                device=device)
    dev_section = bench_device_delta(scale=3, device=device)
    path = os.path.join(tmpdir, "BENCH_ckpt_torch.json")
    cal = emit_calibration(path, meas, plan_stats, dev_section, timings)
    with open(path) as f:
        validate_calibration(json.load(f), timings)
    cost = SimCostModel.from_calibration(path, capacity_eps=3000.0)
    assert cost.state_bytes > 0 and cost.ckpt_duration_s > 0
    assert cost.write_duration("delta") <= cost.write_duration("full") \
        or cost.delta_encode_s_per_byte > 0
    assert cost.device_link_fraction_int8 < 1.0, \
        "int8 device deltas must shrink the link traffic"
    # placement pricing: device deltas swap the host encode term for the
    # measured device pack + fused encode — exactly that swap
    host_d = cost.write_duration("delta")
    dev_d = cost.write_duration("delta", placement="device")
    swap = cost.device_pack_s + cost.device_encode_s \
        - cost.delta_encode_s_per_byte * cost.state_bytes
    assert abs((dev_d - host_d) - swap) < 1e-12, \
        f"device placement mispriced: {dev_d - host_d} != {swap}"
    incr8 = CheckpointPlan(mode="incremental", full_every=8)
    dev8 = CheckpointPlan(mode="incremental", full_every=8,
                          encode_placement="device", delta_codec="int8")
    assert cost.avg_link_bytes(dev8) < cost.avg_link_bytes(incr8) \
        == cost.state_bytes, "link-bytes model lost the placement dimension"
    # versioned fallbacks: v1 (no device section) keeps the modeled
    # defaults, v2 (no pack_s/per_leaf_encode_s) keeps pack_s at 0
    v1 = {k: v for k, v in cal.items() if k != "device"}
    v1["schema"] = "bench_ckpt/1"
    cost_v1 = SimCostModel.from_calibration(v1)
    assert cost_v1.device_link_fraction_int8 == \
        SimCostModel.device_link_fraction_int8
    v2 = json.loads(json.dumps(cal))
    v2["schema"] = "bench_ckpt/2"
    for entry in v2["device"].values():
        del entry["pack_s"], entry["per_leaf_encode_s"]
    cost_v2 = SimCostModel.from_calibration(v2)
    assert cost_v2.device_pack_s == 0.0 \
        and cost_v2.device_encode_s == cost.device_encode_s
    _smoke_device_trainer(tmpdir + "/trainer", device)
    print(f"smoke OK: {path} validates and loads "
          f"(delta_fraction={cost.delta_fraction:.4f}, "
          f"encode_s_per_byte={cost.delta_encode_s_per_byte:.3e}, "
          f"device int8 link fraction "
          f"{cost.device_link_fraction_int8:.3f})")
    return cal


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the states (default: cuda)")
    ap.add_argument("--out", default="BENCH_ckpt_torch.json")
    args = ap.parse_args()
    main(args.out, device=args.device)
