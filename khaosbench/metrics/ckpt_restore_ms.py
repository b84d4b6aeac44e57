"""Mean ``RestoreReport.duration_s`` of the window's restores (the
manager's own span: the snapshot's device-to-host copy and the host deep
copy; the trainer's copy back to the device is not in it), in ms."""
import numpy as np


def read(rec):
    if not rec.restores:
        return None
    return float(np.mean([r["duration_s"] for r in rec.restores])) * 1e3
