"""Mean blocking seconds of the window's checkpoint triggers, in ms."""
import numpy as np


def mean_blocking_ms(rec):
    if not rec.triggers:
        return None
    return float(np.mean([t["blocking_s"] for t in rec.triggers])) * 1e3
