"""Recovery drill of the PyTorch port: the level-2 survival assumption,
exercised for real — the twin of ``bench_replication.py``.

    PYTHONPATH=src python benchmarks/torch_bench_replication.py [--device cpu]

The drill saves a checkpoint under k=1 ring replication (levels
local+remote), kills ONE host (its primary shards and the replicas it
held die with it), and then proves the three acceptance properties the
peer-replication plane owes:

  1. the node-failure restore recovers BIT-EXACT from peer replicas,
     pulling strictly fewer bytes than a full remote restore (degraded
     PARTIAL restore: only the dead host's shards move);
  2. with replication disabled (rep0) the same failure degrades to the
     remote level — and the cost model prices both paths, deriving
     per-kind survival from placement+k (the modeled degraded fraction is
     asserted against the drill's measured bytes);
  3. the worst case for k=1 — ``peer_loss``, the host AND its replica
     peer dying in one window — still recovers bit-exact through the
     per-shard remote fallback, and ``optimize_plan``'s variant grid
     carries the ``replication_factor`` dimension that trades this
     replica traffic against recovery time.

The drills' states (the reference's seeded NumPy states) live as tensors
on ``device``, the CUDA device unless the caller names another.
``card_drill`` runs the same kill-host drill at one host's shard scale:
the trainer's device-encode incremental plan with k=1 over the
``params/layers/*`` leaves of one yi-6b transformer block (173,023,232
float32 elements), a full, a seeded perturbation saved as one lossless
device delta (the fused encode, kernel #1 on a card), then the node loss
and the degraded partial restore (the decode, kernel #3 on a card),
checked bit for bit.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.replication import PeerReplicatedStore
from repro_torch.config import CheckpointPlan
from repro_torch.ft.failures import FailureInjector
from repro_torch.sim import SimCostModel
from repro_torch.utils.trees import (resolve_device, tree_flatten_with_names,
                                     tree_map)


def _state(seed: int = 0, device: Any = None) -> dict:
    rng = np.random.default_rng(seed)
    state = {
        "w0": rng.standard_normal((128, 64)).astype(np.float32),
        "w1": rng.standard_normal((96, 96)).astype(np.float32),
        "b0": rng.standard_normal((2048,)).astype(np.float32),
        "b1": rng.standard_normal((777,)).astype(np.float32),
        "step": np.asarray(1234, dtype=np.int64),
    }
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in state.items()}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bit_exact(a: Any, b: Any) -> bool:
    la = dict(tree_flatten_with_names(a))
    lb = dict(tree_flatten_with_names(b))
    if la.keys() != lb.keys():
        return False
    for k in la:
        x, y = _host(la[k]), _host(lb[k])
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.tobytes() != y.tobytes():
            return False
    return True


def recovery_drill(root: str, verbose: bool = True,
                   device: Any = None) -> dict:
    """The k=1 drill (properties 1 and 2 above).  Returns the measured
    record; raises AssertionError on any violated gate."""
    state = _state(device=device)
    plan = CheckpointPlan(levels=("local", "remote"), remote_every=1,
                          num_shards=4, replication_factor=1)
    mgr = CheckpointManager(os.path.join(root, "rep1"), plan, device=device)
    mgr.save(100, state, timestamp=1.0)

    # worst-case, host-targeted node failure (paper §III-C timing + the
    # placement-aware kill): host 2's shards and held replicas die
    inj = FailureInjector()
    failure = inj.worst_case_failure(requested_t=100.0, last_ckpt_t=1.0,
                                     interval_s=60.0, ckpt_cost_s=2.5,
                                     kind="node", host=2)
    mgr.on_failure(failure.kind, host=failure.host)
    report = mgr.restore(state, failure.kind)

    full_bytes = mgr.stores["local"].total_bytes(100)
    assert report.level == "local", \
        f"k=1 node restore must stay at level-2, got {report.level!r}"
    assert report.degraded and report.restored_bytes > 0, \
        "the host-targeted kill must force a degraded partial restore"
    assert _bit_exact(report.state, state), \
        "degraded partial restore is not bit-exact"
    # the partial-restore gate: only the failed host's shard bytes moved
    assert report.restored_bytes < full_bytes, (
        f"degraded restore pulled {report.restored_bytes} bytes, not fewer "
        f"than the {full_bytes}-byte full checkpoint")
    # modeled vs measured: the cost model derives node survival from
    # placement+k and prices the degraded pull at ~1/num_hosts of the
    # state; bin-packing skew is bounded by 2x
    cost = SimCostModel(state_bytes=float(full_bytes))
    assert cost.surviving_levels(plan, "node") == ("local", "remote")
    modeled_fraction = 1.0 / mgr.stores["local"].num_hosts
    measured_fraction = report.restored_bytes / full_bytes
    assert measured_fraction <= 2.0 * modeled_fraction, (
        f"measured degraded pull {measured_fraction:.3f} of state vs "
        f"modeled {modeled_fraction:.3f} (tolerance 2x for bin-packing)")
    # replica traffic was actually pushed and accounted
    stats = mgr.stores["local"].replica_stats
    assert stats.acks >= plan.num_shards and stats.replica_bytes > 0

    # rep0: same failure, no replicas -> the restore degrades to remote,
    # and the cost model's derived survival says so before the bytes do
    plan0 = CheckpointPlan(levels=("local", "remote"), remote_every=1,
                           num_shards=4, replication_factor=0)
    mgr0 = CheckpointManager(os.path.join(root, "rep0"), plan0,
                             device=device)
    mgr0.save(100, state, timestamp=1.0)
    assert cost.surviving_levels(plan0, "node") == ("remote",)
    mgr0.on_failure("node", host=2)
    report0 = mgr0.restore(state, "node")
    assert report0.level == "remote", \
        f"rep0 node restore must degrade to remote, got {report0.level!r}"
    assert _bit_exact(report0.state, state)
    # both paths are priced, and the degraded-local path is the cheaper
    # recovery (remote restores pay the remote_restore_factor)
    d_rep1 = cost.plan_downtime_s(plan, "node")
    d_rep0 = cost.plan_downtime_s(plan0, "node")
    assert d_rep1 < d_rep0, (d_rep1, d_rep0)

    rec = {"restored_bytes": int(report.restored_bytes),
           "full_state_bytes": int(full_bytes),
           "measured_fraction": float(measured_fraction),
           "modeled_fraction": float(modeled_fraction),
           "replica_bytes": int(stats.replica_bytes),
           "downtime_rep1_s": float(d_rep1),
           "downtime_rep0_s": float(d_rep0)}
    if verbose:
        print(f"  recovery drill: degraded restore pulled "
              f"{rec['restored_bytes']}/{rec['full_state_bytes']} bytes "
              f"({measured_fraction:.1%}, modeled {modeled_fraction:.1%}); "
              f"rep0 degraded to remote "
              f"({d_rep0:.1f}s vs {d_rep1:.1f}s downtime)")
    return rec


def peer_loss_drill(root: str, verbose: bool = True,
                    device: Any = None) -> dict:
    """Property 3: the k=1 worst case (host + its replica peer die in one
    window) recovers bit-exact through the per-shard remote fallback."""
    state = _state(seed=7, device=device)
    plan = CheckpointPlan(levels=("local", "remote"), remote_every=1,
                          num_shards=4, replication_factor=1)
    mgr = CheckpointManager(os.path.join(root, "peer_loss"), plan,
                            device=device)
    mgr.save(200, state, timestamp=1.0)

    failures = FailureInjector().peer_loss(
        requested_t=100.0, last_ckpt_t=1.0, interval_s=60.0,
        ckpt_cost_s=2.5, host=1, num_hosts=4,
        replication_factor=plan.replication_factor)
    assert len(failures) == 2 and failures[0].t < failures[1].t
    for f in failures:
        mgr.on_failure(f.kind, host=f.host)
    report = mgr.restore(state, "node")
    store = mgr.stores["local"]
    assert isinstance(store, PeerReplicatedStore)
    assert _bit_exact(report.state, state), \
        "peer-loss restore is not bit-exact"
    assert report.degraded
    assert store.last_restore["shards_from_remote"] >= 1, \
        "peer loss must exercise the per-shard remote fallback"
    rec = dict(store.last_restore)
    if verbose:
        print(f"  peer-loss drill: {rec['shards_from_primary']} primary + "
              f"{rec['shards_from_peer']} peer + "
              f"{rec['shards_from_remote']} remote shards, "
              f"{rec['restored_bytes']} bytes pulled")
    return rec


def optimizer_dimension_check(verbose: bool = True) -> None:
    """The replication_factor plan dimension is reachable by
    ``optimize_plan``'s default variant grid, and the model prices its
    traffic/recovery trade."""
    from repro_torch.core.ci_optimizer import default_plan_variants

    cost = SimCostModel(state_bytes=1e9)
    variants = default_plan_variants(cost, ci_ref=60.0)
    reps = sorted({p.replication_factor for p in variants})
    assert 0 in reps and 1 in reps and 2 in reps, (
        f"variant grid lost the replication dimension: {reps}")
    p0 = next(p for p in variants if p.replication_factor == 0)
    p2 = next(p for p in variants if p.replication_factor == 2)
    # traffic ordering: more replicas, more interconnect bytes
    assert cost.avg_replica_bytes(p0) == 0.0
    assert cost.avg_replica_bytes(p2) > 0.0
    # recovery ordering: replicas buy the faster level-2 node restore
    assert cost.plan_downtime_s(p2, "node") < cost.plan_downtime_s(p0, "node")
    if verbose:
        print(f"  optimizer grid: replication factors {reps}, "
              f"rep2 replica traffic "
              f"{cost.avg_replica_bytes(p2) / 1e9:.2f} GB/trigger vs "
              f"rep0 downtime {cost.plan_downtime_s(p0, 'node'):.0f}s")


# ---------------------------------------------------------------------------
# the kill-host drill at one host's shard scale
# ---------------------------------------------------------------------------

#: the trainer's plan shape (device-placed lossless deltas, one disk
#: level, sync commits) with one ring replica per shard
CARD_PLAN = CheckpointPlan(mode="incremental", full_every=2,
                           encode_placement="device",
                           delta_codec="lossless", codec="zlib",
                           levels=("local",), num_shards=4,
                           replication_factor=1, sync=True, keep=1)
CARD_PERTURB = 1e-3          # std of the seeded step-like perturbation


def block_state(model_cfg=None, device: Any = None) -> dict:
    """The ``params/layers/*`` leaves of one transformer block of
    ``model_cfg`` (default yi-6b, one layer) as ``zoo.init_params`` lays
    them out, from seed 0 on ``device``, plus an int64 ``step``."""
    from repro_torch.config import replace
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = replace(model_cfg or get_config("yi-6b"), num_layers=1)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = zoo.init_params(cfg, gen, dev)["layers"]
    return {"params": {"layers": layers},
            "step": torch.tensor(0, dtype=torch.int64, device=dev)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_drill(root: str, device: Any = None, model_cfg=None,
               verbose: bool = True) -> dict:
    """Full, one lossless device delta of a seeded perturbation, a node
    loss of host 2, the degraded partial restore: BIT-equal to the
    perturbed state, fewer bytes pulled than the full holds (within 2x of
    1/num_hosts of it), every shard's replica acknowledged.  Raises
    AssertionError on a violated gate; returns the measured record."""
    dev = resolve_device(device)
    shutil.rmtree(root, ignore_errors=True)
    base = block_state(model_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def perturb(x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():
            return x + 1
        return x + CARD_PERTURB * torch.randn(x.shape, generator=gen,
                                              dtype=x.dtype, device=dev)
    new = tree_map(perturb, base)
    elements = sum(int(x.numel()) for _, x in tree_flatten_with_names(new)
                   if x.is_floating_point())
    plan = CARD_PLAN
    mgr = CheckpointManager(root, plan, device=dev)
    try:
        _sync(dev)
        t0 = time.perf_counter()
        full = mgr.save(0, base, timestamp=0.0)
        t1 = time.perf_counter()
        delta = mgr.save(1, new, timestamp=1.0)
        _sync(dev)
        t2 = time.perf_counter()
        assert (full.kind, delta.kind) == ("full", "delta"), \
            (full.kind, delta.kind)
        store = mgr.stores["local"]
        assert isinstance(store, PeerReplicatedStore)
        full_bytes = store.total_bytes(0)
        del base
        mgr.on_failure("node", host=2)
        t3 = time.perf_counter()
        report = mgr.restore(new, "node")
        _sync(dev)
        restore_s = time.perf_counter() - t3
        assert report.level == "local" and report.kind == "full+delta" \
            and report.step == 1, (report.level, report.kind, report.step)
        assert report.degraded and report.restored_bytes > 0, \
            "the host-targeted kill must force a degraded partial restore"
        assert _bit_exact(report.state, new), \
            "degraded partial restore is not bit-exact"
        assert report.restored_bytes < full_bytes, (
            f"degraded restore pulled {report.restored_bytes} bytes, not "
            f"fewer than the {full_bytes}-byte full checkpoint")
        modeled = 1.0 / store.num_hosts
        measured = report.restored_bytes / full_bytes
        assert measured <= 2.0 * modeled, (
            f"measured degraded pull {measured:.3f} of state vs modeled "
            f"{modeled:.3f} (tolerance 2x for bin-packing)")
        stats = store.replica_stats
        assert stats.acks >= plan.num_shards and stats.replica_bytes > 0
        rec = {"elements": elements,
               "state_bytes": elements * 4 + 8,
               "full_state_bytes": int(full_bytes),
               "delta_bytes": int(delta.bytes_written),
               "replica_bytes": int(stats.replica_bytes),
               # the full's bytes hold its shards and their replicas;
               # a delta is written once (its mirror is priced only)
               "bytes_written": int(full.bytes_written
                                    + delta.bytes_written),
               "restored_bytes": int(report.restored_bytes),
               "measured_fraction": float(measured),
               "modeled_fraction": float(modeled),
               "full_save_s": t1 - t0, "delta_save_s": t2 - t1,
               "restore_s": restore_s,
               "shards_from_peer": int(store.last_restore[
                   "shards_from_peer"]),
               "acks": int(stats.acks)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if verbose:
        print(f"  card drill: {elements:,} f32 elements on {dev}, "
              f"{rec['bytes_written']} bytes written (full and its "
              f"replicas {rec['full_state_bytes']}, delta "
              f"{rec['delta_bytes']}); saves "
              f"{rec['full_save_s']:.2f} + {rec['delta_save_s']:.2f} s, "
              f"degraded restore {restore_s:.2f} s pulled "
              f"{rec['restored_bytes']} bytes ({measured:.1%}, modeled "
              f"{modeled:.1%}), bit-equal")
    return rec


def smoke(root: Optional[str] = None, device: Any = None) -> dict:
    """The --smoke gate: all three drills on a fresh scratch dir (made
    under ``root``, else in the temporary directory; removed after)."""
    root = tempfile.mkdtemp(prefix="bench_replication_", dir=root)
    try:
        out = {"recovery": recovery_drill(root, device=device),
               "peer_loss": peer_loss_drill(root, device=device)}
        optimizer_dimension_check()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def main(device: Any = None) -> dict:
    print("\n== replication recovery drill ==")
    return smoke(device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the states (default: cuda)")
    main(device=ap.parse_args().device)
