"""Quickstart on the PyTorch port: the whole Khaos loop in one minute on
the simulator — the twin of ``examples/quickstart.py``, driven end-to-end
by the ``KhaosRuntime`` phase machine, with the Phase-2 campaign's lanes
on the torch lane engine (on the CUDA device unless ``--device`` names
another; the lanes give the NumPy engine's bits).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.core import KhaosRuntime, young_daly_interval
from repro_torch.data.stream import diurnal_rate, record_workload
from repro_torch.ft.failures import FailureInjector
from repro_torch.sim import (BatchedDeployment, SimCostModel, SimJobHandle,
                             StreamSimulator)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the lane engine (default: cuda)")
args = ap.parse_args()

kcfg = KhaosConfig(latency_constraint=1.0, recovery_constraint=500.0,
                   optimization_period=60.0, ci_min=10, ci_max=120,
                   num_failure_points=4)
cost = SimCostModel(capacity_eps=4200.0, ckpt_duration_s=2.5,
                    ckpt_sync_penalty=0.6)
rt = KhaosRuntime(kcfg)

# ---- Phase 1: record the stream, find failure points over the W(t) range --
sched = diurnal_rate(base=2400, amplitude=0.5, period=7200, seed=5)
recording = record_workload(sched, duration=7200, seed=5)
steady = rt.record_steady_state(recording)
print("Phase 1: failure points at throughputs",
      np.round(steady.failure_rates).astype(int).tolist(), "events/s")

# ---- Phase 2: the whole (CI x failure point) grid as ONE batched campaign -
prof = rt.run_profiling(BatchedDeployment(cost, recording, engine="device",
                                          device=args.device),
                        ci_values=[10, 40, 80, 120], margin=60)
print("Phase 2: recovery grid R (failure-point x CI):")
print(np.round(prof.recoveries).astype(int))

# ---- Phase 3: attach the job handle, monitor, optimize Eq. 8 at runtime ---
ci0 = rt.initial_ci(float(np.mean(recording.counts)))
print(f"Phase 3: initial CI from Eq. 8 = "
      f"{'infeasible' if ci0 is None else f'{ci0:.0f}s'} "
      f"(Young/Daly static would say {young_daly_interval(2.5, 7200):.0f}s)")

sim = StreamSimulator(cost, ci_s=ci0 or 60.0, schedule=sched)
job = SimJobHandle(sim)
ctl = rt.attach(job)
print("phase machine:", " -> ".join(rt.phase_sequence()))
inj = FailureInjector()
for ft in (1800.0, 4200.0):
    sim.inject_failure(inj.worst_case_time(ft, 0.0, sim.policy.interval_s,
                                           cost.ckpt_duration_s))
while sim.t < 7200:
    sim.tick()
    rt.step()

lat = np.array(sim.metrics.series("latency").values)
print(f"run: avg latency {lat.mean()*1e3:.0f}ms, "
      f"violations {np.mean(lat > 1.0)*100:.1f}%, "
      f"recoveries {[round(r['recovery_s']) for r in sim.recoveries]}s, "
      f"reconfigurations {job.reconfigurations}")
print("decisions:", {k: sum(1 for d in ctl.decisions if d.kind == k)
                     for k in {d.kind for d in ctl.decisions}})
