"""Batched streaming inference on the PyTorch port — the twin of
``examples/serve_stream.py``: prefill + greedy decode over request
batches, with per-batch latency metrics — the serving-side data plane the
dry run traces at the assigned decode shapes — on the CUDA device unless
``--device`` names another.

    PYTHONPATH=src python examples/torch_serve_stream.py \
        --arch recurrentgemma-2b [--device cpu]

``--fleet`` additionally serves the CONTROL plane: a ``FleetSupervisor``
admitting three jobs next to the data plane (one cold-profiled, one
transfer-admitted from the registry, one rejected for capacity) and
printing the fleet status — the supervisor a real deployment would run
beside its servers, its campaigns on the torch lane engine of the same
device.  See ``examples/torch_fleet_supervision.py`` for the full fleet
walkthrough.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import zoo
from repro_torch.runtime.server import ServeRequest, StreamServer
from repro_torch.utils.trees import resolve_device


def serve_fleet_supervisor(device) -> dict:
    """The --fleet mode: one supervisor over three admission outcomes."""
    from repro_torch.config import KhaosConfig
    from repro_torch.data.stream import constant_rate
    from repro_torch.fleet import FleetJobSpec, FleetSupervisor
    from repro_torch.sim import SimCostModel

    cost = SimCostModel(capacity_eps=2600.0, ckpt_duration_s=1.0,
                        state_bytes=1e9)
    kcfg = KhaosConfig(latency_constraint=1.5, recovery_constraint=240.0,
                       optimization_period=30.0, ci_min=10, ci_max=120,
                       num_failure_points=2, num_configs=3,
                       record_seconds=600.0, reconfig_cooldown=60.0)
    sup = FleetSupervisor(fleet_capacity_eps=6000.0, engine="device",
                          device=device)

    def spec(name, rate, seed=0):
        return FleetJobSpec(name, cost, kcfg, schedule=constant_rate(rate),
                            seed=seed, horizon_s=300.0,
                            profile_max_recovery_s=900.0)

    print("cold:     ", sup.submit(spec("serve-a", 1500.0)).action)
    sup.run_profiling_pooled()          # fits serve-a, files it in the registry
    print("transfer: ", sup.submit(spec("serve-b", 1500.0, seed=1)).action)
    print("rejected: ", sup.submit(spec("serve-xl", 9000.0)).action)
    sup.run_profiling_pooled()
    sup.start()
    status = sup.run(300.0, chunk_s=30.0)
    print(f"fleet status after {status['t']:.0f}s: "
          f"{ {n: j['status'] for n, j in status['jobs'].items()} } "
          f"decisions {status['decisions_by_kind']}")
    return status


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--fleet", action="store_true",
                    help="also run the fleet-supervisor control plane demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server (default: cuda)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    dev = resolve_device(args.device)
    params = zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    server = StreamServer(cfg, params, max_batch=4)
    rng = np.random.default_rng(0)

    rid = 0
    for b in range(args.batches):
        reqs = []
        for _ in range(4):
            reqs.append(ServeRequest(
                rid=rid,
                prompt=rng.integers(0, cfg.vocab_size, 16, dtype=np.int32),
                max_new_tokens=8))
            rid += 1
        t0 = time.monotonic()
        out = server.serve_batch(reqs)
        dt = time.monotonic() - t0
        print(f"batch {b}: served {len(out)} requests in {dt*1e3:.0f}ms "
              f"({dt*1e3/ (4*8):.1f} ms/token); "
              f"sample completion: {out[reqs[0].rid].tolist()}")

    if args.fleet:
        serve_fleet_supervisor(dev)


if __name__ == "__main__":
    main()
