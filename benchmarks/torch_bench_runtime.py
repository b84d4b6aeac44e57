"""Smoke gate of the port's control-plane API — the twin of
``bench_runtime.py``.

    PYTHONPATH=src python benchmarks/torch_bench_runtime.py [--device cpu]

Drives a tiny end-to-end ``KhaosRuntime``: all three phases against a
4-lane controller-in-the-loop campaign on the torch lane engine (Phase 2
profiles as lanes of one campaign there too), plus a micro live trainer
whose checkpoint plan is switched mid-run through ``TrainerJobHandle`` —
and fails (raises) on phase-order regressions, protocol regressions (a
handle missing a ``JobHandle`` method) or Decision-kind drift.  The lane
engine and the trainer run on the CUDA device unless ``device`` names
another.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Any

from repro_torch.config import CheckpointPlan, KhaosConfig, OptimizerConfig
from repro_torch.core import (Decision, KhaosRuntime, PhaseError,
                              missing_handle_methods)
from repro_torch.data.stream import constant_rate, dense_rates, record_workload
from repro_torch.sim import (BatchedDeployment, LaneSpec, SimCostModel,
                             SimJobHandle, StreamSimulator, make_campaign)


def _assert(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"runtime smoke: {msg}")


def smoke(tmpdir: str, device: Any = None) -> dict:
    """The drill; the micro trainer's checkpoints go under ``tmpdir``."""
    shutil.rmtree(tmpdir, ignore_errors=True)
    cost = SimCostModel(capacity_eps=2600.0, ckpt_duration_s=1.0)
    sched = constant_rate(1800.0)
    recording = record_workload(sched, duration=1200, seed=0)
    kcfg = KhaosConfig(latency_constraint=1.5, recovery_constraint=240.0,
                       optimization_period=30.0, ci_min=10, ci_max=120,
                       num_failure_points=2, num_configs=2,
                       reconfig_cooldown=60.0)

    def deployment(**kw):
        return BatchedDeployment(cost, recording, engine="device",
                                 device=device, **kw)

    # -- phase order is enforced, not advisory ---------------------------
    try:
        KhaosRuntime(kcfg).run_profiling(deployment())
    except PhaseError:
        pass
    else:
        raise ValueError("runtime smoke: Phase 2 ran before Phase 1")

    # -- phases 1 -> 2 -> 3 on a 4-lane campaign -------------------------
    rt = KhaosRuntime(kcfg, cost=cost)
    rt.record_steady_state(recording)
    rt.run_profiling(deployment(warmup_s=120, max_recovery_s=900.0),
                     ci_values=[30, 90], margin=60)
    _assert(rt.phase_log[-1].info["substrate"] == "campaign",
            "Phase 2 did not profile as one campaign")
    T = 600
    lanes = [LaneSpec(rates=dense_rates(0.0, T, schedule=sched),
                      ci_s=float(ci)) for ci in (20, 60, 90, 115)]
    camp = make_campaign(cost, lanes, engine="device", device=device)
    sup = rt.drive_campaign(camp)
    _assert(rt.phase_sequence() == ["steady_state", "profiled", "optimizing"],
            f"phase order regressed: {rt.phase_sequence()}")
    _assert(camp.done, "campaign did not run to completion")
    summary = sup.summary()
    _assert(summary["lanes"] == 4, f"expected 4 supervised lanes: {summary}")
    for ctl in sup.controllers:
        for d in ctl.decisions:
            _assert(d.kind in Decision.KINDS,
                    f"unknown Decision kind {d.kind!r}")

    # -- protocol conformance across every handle ------------------------
    sim = StreamSimulator(cost, ci_s=60.0, schedule=sched)
    for handle in (SimJobHandle(sim), sup.handles[0]):
        missing = missing_handle_methods(handle)
        _assert(not missing,
                f"{type(handle).__name__} missing protocol methods {missing}")

    # -- micro live trainer: plan switch through the same protocol -------
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.stream import EventStream
    from repro_torch.runtime import (ResilientTrainer, TrainerConfig,
                                     TrainerJobHandle)

    stream = EventStream(schedule=constant_rate(500.0))
    tcfg = TrainerConfig(batch=4, seq_len=16, ckpt_dir=tmpdir,
                         ckpt_interval_s=4.0, time_scale=20.0,
                         detect_s=1.0, restart_s=1.0)
    trainer = ResilientTrainer(get_smoke_config("yi-6b"), tcfg, stream,
                               OptimizerConfig(total_steps=1000, lr=1e-3),
                               device=device)
    job = TrainerJobHandle(trainer)
    missing = missing_handle_methods(job)
    _assert(not missing, f"TrainerJobHandle missing {missing}")
    trainer.run(duration_s=10.0)
    step_before = int(trainer.state["step"])
    new_plan = CheckpointPlan(interval_s=3.0, mode="incremental",
                              full_every=2, levels=("memory", "local"),
                              sync=False, num_shards=2)
    job.reconfigure_plan(new_plan)
    _assert(trainer.ckpt.plan.name == new_plan.name,
            "trainer did not rebuild the manager from the new plan")
    # the virtual clock advances by the measured step time: run until a
    # save lands under the new plan (a slow first step can overshoot one
    # 10 s run without a trigger)
    trainer.run(duration_s=10.0)
    for _ in range(30):
        if trainer.ckpt.stats()["saves"] >= 1:
            break
        trainer.run(duration_s=2.0)
    tsum = trainer.summary()
    _assert(tsum["plan_switches"] == 1, "plan switch not recorded")
    _assert(int(trainer.state["step"]) > step_before,
            "trainer made no progress after the plan switch")
    _assert(tsum["ckpt_stats"]["plan"] == new_plan.name,
            "checkpoint stats not under the new plan")
    _assert(tsum["ckpt_stats"]["saves"] >= 1,
            "no checkpoint landed under the new plan")
    shutil.rmtree(tmpdir, ignore_errors=True)
    print(f"runtime smoke OK: phases {' -> '.join(rt.phase_sequence())}, "
          f"{tsum['checkpoints']} trainer checkpoints, plan switched to "
          f"[{new_plan.name}] mid-run, campaign decisions "
          f"{summary['decisions_by_kind']} ({camp.chunks} device chunks on "
          f"{camp.device})")
    return {"phases": rt.phase_sequence(), "campaign": summary,
            "device_chunks": camp.chunks,
            "trainer": {k: tsum[k] for k in ("checkpoints", "plan_switches")}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the lanes and the trainer "
                         "(default: cuda)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        smoke(os.path.join(tmp, "runtime"), device=args.device)
