"""Fleet supervision: one control plane over many Khaos jobs.

The paper optimizes checkpointing for ONE stream processing job; a real
cluster runs dozens.  This package multiplexes N jobs — each with its own
``KhaosRuntime`` phase machine and QoS constraints — onto one scheduler
tick, one pooled ``BatchedCampaign`` chaos substrate, and one bounded
metrics plane, and adds the two things a fleet enables that a single job
cannot have:

* QoS-model TRANSFER (``registry``): fitted M_L / M_R surfaces are filed
  under coarse profile fingerprints; a new job matching a fitted neighbor
  adopts its models and skips the Phase-2 campaign, guarded by a
  divergence watchdog whose trip wire is a real ``reprofile()``;
* ADMISSION CONTROL (``admission``): jobs reserve fleet capacity, and a
  what-if chaos campaign at the residual capacity rejects (or queues)
  jobs the fleet could run at steady state but not recover.

See ``supervisor`` for the architecture (supervisor/monitor split) and
the admission flow in prose.  A copy of the JAX package's ``repro.fleet``;
``FleetSupervisor(engine="device", device=...)`` runs every campaign it
needs on the torch lane engine (``sim.DeviceCampaign``), bit for bit the
NumPy engine's.
"""
from repro_torch.fleet.admission import (AdmissionDecision, decide_admission,
                                         reservation_eps, whatif_campaign)
from repro_torch.fleet.registry import (DivergenceWatchdog, JobFingerprint,
                                        QoSModelRegistry, RegistryEntry,
                                        fingerprint)
from repro_torch.fleet.supervisor import (FleetJob, FleetJobSpec,
                                          FleetSupervisor,
                                          lane_violation_seconds)

__all__ = [
    "AdmissionDecision", "decide_admission", "reservation_eps",
    "whatif_campaign",
    "DivergenceWatchdog", "JobFingerprint", "QoSModelRegistry",
    "RegistryEntry", "fingerprint",
    "FleetJob", "FleetJobSpec", "FleetSupervisor",
    "lane_violation_seconds",
]
