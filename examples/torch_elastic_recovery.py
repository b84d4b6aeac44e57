"""Elastic recovery on the PyTorch port — the twin of
``examples/elastic_recovery.py``: lose hosts mid-training, plan a smaller
mesh, restore the checkpoint with a different shard count, and keep
training — the manifest-driven reshard path, expressed through the
unified control-plane API: one ``CheckpointManager`` executes the plan on
the big mesh, and the surviving cluster rebuilds the manager from a NEW
``CheckpointPlan`` (different ``num_shards``) — exactly the drain+rebuild
primitive ``ResilientTrainer.set_plan``/``TrainerJobHandle.
reconfigure_plan`` actuate when the Khaos controller switches mechanisms.
The state lives on the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python examples/torch_elastic_recovery.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import CheckpointPlan, MeshConfig, OptimizerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.ft import HeartbeatDetector, plan_rescale
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.utils.trees import (resolve_device, tensor_to_numpy,
                                     tree_leaves)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the state (default: cuda)")
ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                              "repro_torch_elastic"))
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = get_smoke_config("qwen2.5-14b")
opt = make_optimizer(OptimizerConfig())
params = zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
state = {"params": params, "opt": opt.init(params),
         "step": torch.tensor(120, dtype=torch.int32, device=dev)}

# 1. production cluster: 64 hosts, one manager executing the 64-shard plan
plan64 = CheckpointPlan(levels=("local",), num_shards=64)
mgr64 = CheckpointManager(args.dir, plan64, device=dev)
mgr64.save(120, state, extra={"pipeline": {"cursor": {"offset": 960},
                                           "stream": {"consumed": 960}}})
mgr64.wait()
print(f"saved step-120 checkpoint under plan [{plan64.name}] as 64 shards")

# 2. three hosts miss heartbeats
det = HeartbeatDetector(num_hosts=64, timeout_s=50.0)
det.heartbeat_all(0.0)
for h in range(61):
    det.heartbeat(h, 60.0)
dead = det.failed_hosts(61.0)
print(f"heartbeat detector: hosts {dead} failed")

# 3. plan the new mesh (TP pinned, data axis shrinks, batch stays divisible)
mesh = MeshConfig(data=16, model=16)
plan = plan_rescale(mesh, hosts_alive=64 - len(dead), chips_per_host=4,
                    global_batch=256)
print(f"rescale plan: {plan.old.shape} -> {plan.new.shape} "
      f"({plan.hosts_used} hosts used, {plan.standby} standby, "
      f"batch_ok={plan.batch_ok})")

# 4. the surviving cluster REBUILDS the manager from a new plan (shard
#    count follows the smaller mesh) and restores THE SAME checkpoint —
#    the manifest makes shard count a restore-time choice, and the
#    rebuild is the same primitive a controller plan-switch uses
plan61 = CheckpointPlan(levels=("local",), num_shards=plan.hosts_used)
mgr61 = CheckpointManager(args.dir, plan61, device=dev)
report = mgr61.restore(state, failure_kind="node")
restored, extra = report.state, report.extra
same = all(np.array_equal(tensor_to_numpy(a), np.asarray(b))
           for a, b in zip(tree_leaves(state), tree_leaves(restored)))
print(f"restored at step {report.step} from level {report.level!r} with "
      f"cursor {extra['pipeline']['cursor']} — bitwise identical: {same}")
assert same and plan.new.model == 16
print("elastic recovery complete: resume training on the smaller mesh")
