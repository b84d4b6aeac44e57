"""Phase-2 deep dive on the PyTorch port — the twin of
``examples/chaos_profiling.py``: parallel profiling deployments,
worst-case injection, and the (CI x TR) -> latency/recovery surfaces
Khaos learns.  The whole z x m grid runs as lanes of ONE campaign on the
torch lane engine (on the CUDA device unless ``--device`` names another),
sequenced by the ``KhaosRuntime`` phase machine (which also fits the
M_L/M_R models the moment profiling completes).

    PYTHONPATH=src python examples/torch_chaos_profiling.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.config import KhaosConfig
from repro_torch.core import KhaosRuntime
from repro_torch.data.stream import diurnal_rate, record_workload
from repro_torch.sim import BatchedDeployment, SimCostModel

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the lane engine (default: cuda)")
args = ap.parse_args()

sched = diurnal_rate(base=2500, amplitude=0.6, period=10_800, seed=9)
recording = record_workload(sched, duration=10_800, seed=9)
cost = SimCostModel(capacity_eps=4400.0, ckpt_duration_s=3.0,
                    ckpt_sync_penalty=0.6)

rt = KhaosRuntime(KhaosConfig(num_failure_points=5, ci_min=10, ci_max=120))
rt.record_steady_state(recording)

ci_values = [10, 30, 60, 90, 120]
print("profiling 5 parallel deployments x 5 worst-case failure injections "
      "(25 lanes, one sweep)...")
prof = rt.run_profiling(BatchedDeployment(cost, recording, engine="device",
                                          device=args.device),
                        ci_values, margin=90,
                        progress=lambda msg: print("  " + msg))

print("\nLatency surface L (ms)  [rows: failure points by rate; cols: CI]")
hdr = "  TR \\ CI " + " ".join(f"{c:>7d}" for c in ci_values)
print(hdr)
for i, tr in enumerate(prof.failure_rates):
    print(f"{tr:9.0f} " + " ".join(f"{v*1e3:7.0f}" for v in prof.latencies[i]))

print("\nRecovery surface R (s)")
print(hdr)
for i, tr in enumerate(prof.failure_rates):
    print(f"{tr:9.0f} " + " ".join(f"{v:7.0f}" for v in prof.recoveries[i]))

ci_f, tr_f, L_f, R_f = prof.flat()
m_l, m_r = rt.m_l, rt.m_r     # fitted by the runtime at the phase boundary
print(f"\nM_L avg pct error: {m_l.avg_percent_error(ci_f, tr_f, L_f):.3f}  "
      f"M_R: {m_r.avg_percent_error(ci_f, tr_f, R_f):.3f}")
print("M_R predictions at TR=3500:",
      np.round(m_r.predict(np.array(ci_values, float), 3500.0)).astype(int).tolist())
print("phase machine:", " -> ".join(rt.phase_sequence()))
