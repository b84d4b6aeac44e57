from repro_torch.kernels.rwkv6.ops import (launch_counts, reset_launch_counts,
                                           wkv6)
from repro_torch.kernels.rwkv6.ref import wkv6_ref

__all__ = ["wkv6", "wkv6_ref", "launch_counts", "reset_launch_counts"]
