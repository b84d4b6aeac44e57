"""Mean over the window's failures of the seconds from the failure until
the backlog is first back at its level just before it (the window's end
for a failure that never catches up)."""
import numpy as np

from khaosbench.timeline import recovery_times


def read(rec):
    if rec.arrivals is None or not rec.failures:
        return None
    return float(np.mean(recovery_times(rec.log, rec.failures, rec.arrivals,
                                        rec.cursor0, rec.window_s)))
