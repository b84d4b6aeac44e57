"""Simulation package of the port — a three-engine hierarchy, each bit-exact
against the one above it (copies of the JAX package's ``repro.sim``
counterparts, except the device engine, which is torch):

  ``SimCostModel``     prices a ``CheckpointPlan`` (loaded from a
                       ``bench_ckpt/3`` calibration artifact by
                       ``from_calibration``);
  ``StreamSimulator``  the scalar ORACLE: one job, a readable Python tick
                       loop; authoritative for tick semantics.
                       ``SimDeployment`` profiles one CI for Phase 2 and
                       ``SimJobHandle`` puts it under the controller;
  ``BatchedCampaign``  NumPy LANES: N jobs advanced by one fused array
                       tick; authoritative for the vectorized
                       floating-point order;
  ``DeviceCampaign``   the DEVICE engine (``sim.device``): the same tick
                       on float64 torch tensors on the CUDA device, for
                       10^5+-lane mega-campaigns and exhaustive plan
                       sweeps; must match the NumPy lanes bit for bit.

Pick an engine with ``make_campaign(cost, lanes, engine="numpy"|"device")``.
``DeviceCampaign`` is exported lazily, as the JAX package does.
"""
from repro_torch.sim.costmodel import (SimCostModel, costmodel_from_arch,
                                       levels_due)
from repro_torch.sim.simulator import (SimDeployment, SimJobHandle,
                                       StreamSimulator)
from repro_torch.sim.batched import (BatchedCampaign, BatchedDeployment,
                                     BatchedLaneHandle, LaneSpec,
                                     build_profile_lanes, make_campaign,
                                     make_plan_verifier,
                                     measure_profile_lanes,
                                     scatter_profile_results)

__all__ = ["SimCostModel", "costmodel_from_arch", "levels_due",
           "StreamSimulator", "SimDeployment", "SimJobHandle",
           "BatchedCampaign", "BatchedDeployment", "BatchedLaneHandle",
           "DeviceCampaign", "LaneSpec", "build_profile_lanes",
           "make_campaign", "make_plan_verifier", "measure_profile_lanes",
           "scatter_profile_results"]


def __getattr__(name):
    if name == "DeviceCampaign":
        from repro_torch.sim.device import DeviceCampaign
        return DeviceCampaign
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
