"""Simulation package of the port: the scalar engine and its cost model,
copies of the JAX package's ``repro.sim`` counterparts.

  ``SimCostModel``     prices a ``CheckpointPlan`` (loaded from a
                       ``bench_ckpt/3`` calibration artifact by
                       ``from_calibration``);
  ``StreamSimulator``  the scalar ORACLE: one job, a readable Python tick
                       loop; ``SimDeployment`` profiles one CI for Phase 2
                       and ``SimJobHandle`` puts it under the controller.

The batched NumPy lanes and the device campaign engine are not ported
yet, so nothing of them is exported here.
"""
from repro_torch.sim.costmodel import (SimCostModel, costmodel_from_arch,
                                       levels_due)
from repro_torch.sim.simulator import (SimDeployment, SimJobHandle,
                                       StreamSimulator)

__all__ = ["SimCostModel", "costmodel_from_arch", "levels_due",
           "StreamSimulator", "SimDeployment", "SimJobHandle"]
