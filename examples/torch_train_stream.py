"""End-to-end run on the PyTorch port — the twin of
``examples/train_stream.py``: REAL training of an LM on a live token
stream with Khaos-controlled checkpointing, failure injection and
restart, on the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python examples/torch_train_stream.py --arch yi-6b \
        --duration 90 [--device cpu]

The control plane is the SAME ``KhaosRuntime``/``JobHandle`` machinery the
simulator examples use — ``runtime.TrainerJobHandle`` implements the full
protocol over the live trainer, including ``reconfigure_plan`` (drain +
CheckpointManager rebuild), so a controller Decision can switch the
checkpoint *mechanism* mid-run, not just the interval.

The model is the reduced (smoke) config of the chosen architecture so a
few hundred steps run on one device; the production mesh's step is
``launch/train.py`` without ``--local``.
"""
import argparse
import os
import tempfile

from repro_torch.config import CheckpointPlan, KhaosConfig, OptimizerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import KhaosRuntime, demo_prior_models
from repro_torch.data.stream import EventStream, diurnal_rate
from repro_torch.runtime import (ResilientTrainer, TrainerConfig,
                                 TrainerJobHandle)
from repro_torch.sim import SimCostModel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--duration", type=float, default=90.0,
                    help="virtual seconds to run")
    ap.add_argument("--fail-at", type=float, default=35.0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_stream"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer (default: cuda)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    stream = EventStream(schedule=diurnal_rate(base=400.0, period=600.0))
    # a full checkpoint *plan*: async incremental with an in-RAM level for
    # cheap task-restart recovery (deltas land on local disk between fulls)
    plan = CheckpointPlan(interval_s=10.0, mode="incremental", full_every=4,
                          levels=("memory", "local"), sync=False,
                          num_shards=2)
    tcfg = TrainerConfig(batch=8, seq_len=32, ckpt_dir=args.ckpt_dir,
                         time_scale=8.0, detect_s=2.0, restart_s=2.0,
                         plan=plan)
    trainer = ResilientTrainer(cfg, tcfg, stream,
                               OptimizerConfig(total_steps=5000, lr=3e-3),
                               device=args.device)
    trainer.inject_failure_at(args.fail_at)

    # pre-fit models installed into the runtime (in production Phase 1+2
    # fit these on the cluster; here a simple prior keeps the demo short)
    m_l, m_r = demo_prior_models()
    rt = KhaosRuntime(
        KhaosConfig(latency_constraint=1.0, recovery_constraint=20.0,
                    optimization_period=10.0, ci_min=5, ci_max=60,
                    reconfig_cooldown=20.0),
        # a cost model makes Eq. 8 search plan variants too: Decisions can
        # then actuate the trainer's set_plan (drain + manager rebuild)
        cost=SimCostModel(capacity_eps=500.0, ckpt_duration_s=0.5),
        mtbf_s=600.0)
    rt.install_models(m_l, m_r)
    job = TrainerJobHandle(trainer)
    rt.attach(job)

    def on_second(sample):
        rt.step()

    summary = trainer.run(args.duration, on_second=on_second)
    print("\n=== train_stream summary ===")
    print(f"steps: {summary['final_step']}  "
          f"loss: {trainer.losses[0]:.3f} -> {summary['final_loss']:.3f}")
    print(f"checkpoints: {summary['checkpoints']}  failures: {summary['failures']}  "
          f"restores: {summary['restores']}  "
          f"plan switches: {summary['plan_switches']}")
    st = summary["ckpt_stats"]
    print(f"checkpoint plane [{st['plan']}]: {st['bytes_by_kind']} bytes, "
          f"levels {st['saves_by_level']}, restores {st['restores']}")
    print(f"controller reconfigurations: {job.reconfigurations}")
    if job.plan_changes:
        print(f"mechanism switches: {job.plan_changes}")
    print("phase machine:", " -> ".join(rt.phase_sequence()))
    assert summary["failures"] >= 1 and summary["restores"] >= 1
    assert summary["final_loss"] < trainer.losses[0], "model should learn"


if __name__ == "__main__":
    main()
