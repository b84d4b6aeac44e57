"""E9 (beyond-paper capstone) on the PyTorch port: Khaos applied to a
training job — the twin of ``bench_khaos_training.py``.

    PYTHONPATH=src python benchmarks/torch_bench_khaos_training.py \\
        [--device cpu]

Takes an architecture's step bound, the checkpoint economics (TrainState
bytes over host disk bandwidth) and a cluster failure model, then runs
the full three-phase pipeline — sequenced by ``KhaosRuntime`` — to pick
the checkpoint interval for a continual-training job ingesting a variable
document stream, against Young/Daly and naive statics.

The step bound is the reference's assumed 2.0 s (its default when no
dry-run record exists), not a measurement: this twin reads no dry-run
record.  Phase 2, the simulate-to-verify plan replay and the day-scale
Phase 3 all run as lanes on the torch lane engine (on the CUDA device
unless ``device`` names another; ``engine="numpy"`` takes the NumPy
lanes, which give the same bits): Khaos AND every static baseline are
lanes of ONE campaign, the Khaos lane supervised controller-in-the-loop
(``KhaosRuntime.drive_campaign``).  Goodput, recoveries and checkpoint
counts are simulated quantities, the same on any device.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.configs import get_config
from repro_torch.core import KhaosRuntime, optimize_plan, young_daly_interval
from repro_torch.data.stream import dense_rates, diurnal_rate, record_workload
from repro_torch.ft.failures import FailureModel
from repro_torch.sim import (BatchedDeployment, LaneSpec, costmodel_from_arch,
                             make_campaign, make_plan_verifier)

DAY = 86_400.0
#: the reference's step bound when it finds no dry-run record (seconds)
ASSUMED_BOUND_S = 2.0


def _arch_costmodel(arch: str = "yi-6b"):
    cfg = get_config(arch)
    bound = ASSUMED_BOUND_S
    cm = costmodel_from_arch(
        param_count=cfg.param_count(), bound_step_s=bound,
        tokens_per_step=256 * 4096, seq_len=4096,
        n_hosts=64, disk_bw_per_host=1.0e9,
        opt_state_bytes_per_param=12.0)
    return cfg, cm, bound


def bench_khaos_training(arch: str = "yi-6b", day: float = DAY,
                         engine: str = "device", device: Any = None,
                         on_campaign: Optional[Callable] = None) -> dict:
    """The E9 day.  Returns ``results`` (per config, the reference's
    ``(goodput, rec-viol)``) and, per config, ``ckpts``, ``recoveries``
    and ``reconfigurations``, plus ``decisions_by_kind``, ``phases``,
    ``plan`` and ``initial_ci``.  ``on_campaign`` is called with the
    Phase-3 campaign before it runs (a probe's hook)."""
    dev = device if engine == "device" else None
    cfg, cm, bound = _arch_costmodel(arch)
    print(f"\n=== Khaos for training: {arch} (assumed step bound "
          f"{bound:.2f}s, the reference's default, not a measurement; "
          f"ckpt {cm.ckpt_duration_s:.1f}s for "
          f"{cfg.param_count()*12/2**30:.0f} GiB TrainState) ===")

    # ingestion stream: diurnal document arrivals at ~75% of capacity
    sched = diurnal_rate(base=0.62 * cm.capacity_eps, amplitude=0.45,
                         period=day, seed=7)
    fm = FailureModel(mtbf_node_s=30 * day, num_nodes=64, seed=3)
    mtbf = fm.cluster_mtbf_s
    yd = young_daly_interval(cm.ckpt_duration_s, mtbf)
    print(f"cluster MTBF {mtbf/3600:.1f}h -> Young/Daly CI = {yd:.0f}s")

    # the one phase machine drives Phase 1 -> 2 -> 3
    recording = record_workload(sched, duration=14_400.0, seed=7)
    ci_grid = np.geomspace(max(10.0, yd / 8), yd * 2.5, 6)
    kcfg = KhaosConfig(latency_constraint=4.0 * bound,
                       recovery_constraint=450.0,
                       optimization_period=300.0,
                       ci_min=float(ci_grid[0]), ci_max=float(ci_grid[-1]),
                       reconfig_cooldown=1800.0,
                       num_failure_points=4, smoothing_window=60)
    rt = KhaosRuntime(kcfg)
    rt.record_steady_state(recording)
    rt.run_profiling(
        BatchedDeployment(cm, recording, warmup_s=600,
                          max_recovery_s=3600.0, engine=engine, device=dev),
        ci_grid, margin=120)
    m_l, m_r = rt.m_l, rt.m_r

    # Phase 3 mechanism search with the simulate-to-verify pass: top plan
    # candidates are replayed through a campaign before committing
    plan_opt = optimize_plan(
        m_l, m_r, tr_avg=float(np.mean(recording.counts)),
        l_const=4.0 * bound, r_const=450.0, p=1.0,
        ci_min=float(ci_grid[0]), ci_max=float(ci_grid[-1]), cost=cm,
        mtbf_s=mtbf,
        verifier=make_plan_verifier(cm, recording=recording, warmup_s=600,
                                    margin_s=120, max_recovery_s=3600.0,
                                    engine=engine, device=dev))
    if plan_opt.plan is not None:
        n_sim = sum(1 for c in plan_opt.candidates if c.sim is not None)
        print(f"plan search (simulate-to-verify over {n_sim} candidates): "
              f"{plan_opt.plan.name} @ CI={plan_opt.ci:.0f}s "
              f"(verified={plan_opt.verified})")

    ci0 = rt.initial_ci(float(np.mean(recording.counts)))
    print(f"Khaos initial CI (Eq. 8) = {ci0 and round(ci0)}s")

    # one shared failure schedule so every configuration faces the same day
    t, shared_fails = 0.0, []
    while t < day:
        t = fm.next_failure_after(t)
        if t < day:
            shared_fails.append((t, "node"))

    # Khaos + every static baseline as lanes of ONE campaign; only the
    # Khaos lane gets a controller (hot CI swap: no flink restart)
    configs = [("Khaos", ci0 or yd),
               (f"YoungDaly {yd:.0f}s", yd),
               ("static 60s", 60.0),
               ("static 1800s", 1800.0)]
    day_rates = dense_rates(0.0, int(day), schedule=sched)
    lanes = [LaneSpec(rates=day_rates, ci_s=float(ci),
                      failures=tuple(shared_fails), tag={"name": name})
             for name, ci in configs]
    camp = make_campaign(cm, lanes, engine=engine, device=dev,
                         flink_semantics=False)
    if on_campaign is not None:
        on_campaign(camp)
    sup = rt.drive_campaign(camp, lanes=[0])

    results, ckpts, recoveries, reconfigs = {}, {}, {}, {}
    for i, (name, _ci) in enumerate(configs):
        goodput = camp.processed_total[i] / (cm.capacity_eps * day)
        recs = [r["recovery_s"] for r in camp.recoveries[i]]
        viol = sum(max(0.0, r - kcfg.recovery_constraint) for r in recs)
        n_reconf = len(sup.reconfigurations(0)) if i == 0 else 0
        print(f"{name:>16s}: goodput {100*goodput:5.1f}%  "
              f"ckpts {camp.ckpt_count[i]:4d}  failures {len(shared_fails)}  "
              f"recoveries {[round(r) for r in recs]}  "
              f"rec-viol {viol:6.0f}s  reconfigs {n_reconf}")
        results[name] = (goodput, viol)
        ckpts[name] = int(camp.ckpt_count[i])
        recoveries[name] = [float(r) for r in recs]
        reconfigs[name] = n_reconf
    kinds = sup.summary()["decisions_by_kind"]
    print(f"phase machine: {' -> '.join(rt.phase_sequence())}  "
          f"(controller-in-the-loop lane decisions: {kinds})")
    return {"results": results, "ckpts": ckpts, "recoveries": recoveries,
            "reconfigurations": reconfigs, "decisions_by_kind": kinds,
            "failures": len(shared_fails), "phases": rt.phase_sequence(),
            "initial_ci": ci0,
            "plan": plan_opt.plan.name if plan_opt.plan is not None else None,
            "plan_ci": plan_opt.ci}


def main(device: Any = None) -> dict:
    return bench_khaos_training(device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the lane engine (default: cuda)")
    main(device=ap.parse_args().device)
