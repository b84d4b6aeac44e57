"""Mean of the job's own ``step_time`` (host clock around the step, ended
by the loss's read, which waits for the device) over the window's steps."""
import numpy as np


def read(rec):
    if not rec.step_walls:
        return None
    return float(np.mean(rec.step_walls)) * 1e3
