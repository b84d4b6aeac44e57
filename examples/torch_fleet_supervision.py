"""Fleet supervision quickstart on the PyTorch port — the twin of
``examples/fleet_supervision.py``: one control plane over many Khaos
jobs, every campaign of the supervisor (what-ifs, transfer probes, the
pooled Phase 2, the shared Phase-3 campaign) on the torch lane engine (on
the CUDA device unless ``--device`` names another).

    PYTHONPATH=src python examples/torch_fleet_supervision.py [--device cpu]

Walks the whole fleet story on the simulator substrate:

1. submit a first wave of jobs — Phase 1 records each one, admission
   reserves fleet capacity and runs a what-if chaos campaign at the
   residual, and an oversized job is REJECTED;
2. profile the admitted cold jobs in ONE pooled ``BatchedCampaign`` (all
   jobs' z x m grids as lanes of a single sweep), fit per-job QoS models
   and file them in the ``QoSModelRegistry``;
3. submit a second wave of near-twin jobs — their fingerprints hit the
   registry, a one-lane probe validates the donor models, and they enter
   Phase 3 WITHOUT a profiling campaign (``adopt_models``), at a fraction
   of the cold jobs' profiling lane-time;
4. supervise everything through one multiplexed tick: a shared Phase-3
   campaign for the lane jobs plus a scalar ``StreamSimulator`` job,
   every controller appending to one decision log, the bounded fleet
   metrics plane rolling up per-job and per-fleet series.
"""
import argparse

from repro_torch.config import KhaosConfig
from repro_torch.data.stream import constant_rate, diurnal_rate
from repro_torch.fleet import FleetJobSpec, FleetSupervisor
from repro_torch.sim import SimCostModel


def main(device: str = "cuda"):
    cost = SimCostModel(capacity_eps=2600.0, ckpt_duration_s=1.0,
                        state_bytes=2e9)
    kcfg = KhaosConfig(latency_constraint=1.5, recovery_constraint=240.0,
                       optimization_period=30.0, ci_min=10, ci_max=120,
                       num_failure_points=3, num_configs=3,
                       record_seconds=600.0, reconfig_cooldown=60.0)
    sup = FleetSupervisor(fleet_capacity_eps=16_000.0, engine="device",
                          device=device)

    def spec(name, schedule, seed=0, substrate="lane"):
        return FleetJobSpec(name, cost, kcfg, schedule=schedule, seed=seed,
                            substrate=substrate, horizon_s=900.0,
                            profile_max_recovery_s=900.0,
                            failures=((400.0, "node"),))

    # -- wave 1: cold jobs + one capacity reject ----------------------------
    for name, sched, seed in [
            ("etl-a", constant_rate(1500.0), 0),
            ("etl-b", constant_rate(1500.0), 1),
            ("diurnal-a", diurnal_rate(base=1200.0, amplitude=0.4), 2)]:
        dec = sup.submit(spec(name, sched, seed))
        print(f"submit {name:10s} -> {dec.action:14s} ({dec.reason})")
    dec = sup.submit(spec("firehose", constant_rate(30_000.0)))
    print(f"submit {'firehose':10s} -> {dec.action:14s} ({dec.reason})")

    prof = sup.run_profiling_pooled()
    print(f"\npooled Phase 2: {prof['jobs_profiled']} jobs, "
          f"{prof['pooled_lanes']} lanes in one campaign; "
          f"registry now holds {len(sup.registry)} fingerprints")

    # -- wave 2: near-twins ride the registry -------------------------------
    for name, sched, seed, sub in [
            ("etl-c", constant_rate(1500.0), 3, "lane"),
            ("etl-d", constant_rate(1500.0), 4, "scalar")]:
        dec = sup.submit(spec(name, sched, seed, substrate=sub))
        print(f"submit {name:10s} -> {dec.action}")
    sup.run_profiling_pooled()       # no-op if every wave-2 job transferred

    # -- Phase 3: one multiplexed control tick over the whole fleet ---------
    sup.start()
    status = sup.run(900.0, chunk_s=30.0)

    print("\nfleet after supervision:")
    for name, j in status["jobs"].items():
        print(f"  {name:10s} status={j['status']:9s} "
              f"admission={j['admission']:14s} "
              f"profiling_lane_ticks={j['profiling_lane_ticks']:6d} "
              f"transferred={j['transferred']}")
    print(f"shared campaigns: {status['shared_campaigns']}, "
          f"decisions {status['decisions_by_kind']}")
    cold = status["jobs"]["etl-a"]["profiling_lane_ticks"]
    xfer = status["jobs"]["etl-c"]["profiling_lane_ticks"]
    print(f"profiling lane-time: cold {cold} ticks vs transfer {xfer} ticks "
          f"({cold / max(xfer, 1):.1f}x less for the transfer-admitted job)")
    lat = sup.metrics.series("fleet/latency")
    print(f"fleet latency plane: {len(lat)} raw samples "
          f"(+{len(lat.rollups)} rollups), lifetime mean "
          f"{lat.lifetime_mean():.2f}s")
    for name in ("etl-a", "etl-c"):
        print(f"  {name}: QoS violations {sup.qos_violations(name)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the lane engine (default: cuda)")
    main(ap.parse_args().device)
