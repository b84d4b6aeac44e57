from repro_torch.kernels.rglru.ops import (launch_counts, reset_launch_counts,
                                           rglru_scan)
from repro_torch.kernels.rglru.ref import rglru_ref

__all__ = ["rglru_scan", "rglru_ref", "launch_counts", "reset_launch_counts"]
