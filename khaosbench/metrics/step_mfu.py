"""Model flops of one step (counted from the configuration's widths,
``khaosbench/flops.py``) over the mean step time times the card's bf16
tensor peak, in %."""
import numpy as np


def read(rec):
    if not rec.step_walls:
        return None
    return rec.flops_per_step / (float(np.mean(rec.step_walls))
                                 * rec.rates().bf16) * 100.0
