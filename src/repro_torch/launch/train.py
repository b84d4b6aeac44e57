"""Training launcher of the port: the live resilient trainer, optionally
supervised by a ``KhaosRuntime``.

    # the trainer at the SMOKE config of an arch, on the CUDA device:
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --local \
        --duration 60 [--khaos] [--device cpu]

Only the ``--local`` path of the JAX package's ``launch/train.py`` is
ported.  Its production path (``--shape``, ``--multi-pod``) compiles the
sharded step against the dry run's plans; the sharding rules, meshes and
the accumulated train step it builds on are ported (``sharding.py``,
``launch/mesh.py``), the roofline and the dry run are not yet (ROADMAP
section 1, item 3).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--local", action="store_true",
                    help="the live trainer at the arch's reduced config")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ci", type=float, default=30.0)
    ap.add_argument("--khaos", action="store_true",
                    help="supervise with a KhaosRuntime (prior-fitted QoS "
                         "models) through TrainerJobHandle")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer (default: cuda)")
    args = ap.parse_args(argv)
    if not args.local:
        ap.error("only --local runs are ported: the production path waits "
                 "for the port's roofline and dry run (roofline.py and "
                 "launch/dryrun.py, ROADMAP section 1, item 3)")

    from repro_torch.config import KhaosConfig, OptimizerConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import KhaosRuntime, demo_prior_models
    from repro_torch.data.stream import EventStream, diurnal_rate
    from repro_torch.runtime import (ResilientTrainer, TrainerConfig,
                                     TrainerJobHandle)

    cfg = get_smoke_config(args.arch)
    stream = EventStream(schedule=diurnal_rate(base=400.0, period=600.0))
    tcfg = TrainerConfig(batch=8, seq_len=32, ckpt_dir=args.ckpt_dir,
                         ckpt_interval_s=args.ci, ckpt_async=True,
                         time_scale=8.0)
    trainer = ResilientTrainer(cfg, tcfg, stream,
                               OptimizerConfig(total_steps=10_000),
                               device=args.device)
    on_second = None
    if args.khaos:
        rt = KhaosRuntime(KhaosConfig(latency_constraint=1.0,
                                      recovery_constraint=30.0,
                                      optimization_period=10.0,
                                      ci_min=5, ci_max=60))
        rt.install_models(*demo_prior_models())
        rt.attach(TrainerJobHandle(trainer))
        on_second = lambda sample: rt.step()
    summary = trainer.run(args.duration, on_second=on_second)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
