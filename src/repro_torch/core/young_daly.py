"""Young/Daly optimal checkpoint interval — the classic HPC baseline the
paper cites as related work [8–10]; implemented both as a baseline and as
a prior for seeding the profiling grid."""
from __future__ import annotations

import math


def young_daly_interval(checkpoint_cost_s: float, mtbf_s: float,
                        higher_order: bool = True) -> float:
    """W = sqrt(2 * delta * MTBF)  (Young); Daly's higher-order correction
    when delta is not << MTBF."""
    if checkpoint_cost_s <= 0 or mtbf_s <= 0:
        raise ValueError("costs must be positive")
    w = math.sqrt(2.0 * checkpoint_cost_s * mtbf_s)
    if higher_order and checkpoint_cost_s < 2.0 * mtbf_s:
        # Daly 2006: W = sqrt(2 d M) [1 + 1/3 sqrt(d/(2M)) + (1/9)(d/(2M))] - d
        r = math.sqrt(checkpoint_cost_s / (2.0 * mtbf_s))
        w = w * (1.0 + r / 3.0 + (r * r) / 9.0) - checkpoint_cost_s
    return max(w, checkpoint_cost_s)
