"""Mean over the window's failures of the seconds from the failure until
the job's restore has ended (the state back on the device, the stream
rolled back to the restored cursor): the time the job can process
nothing.  A failure with no restore after it counts until the window's
end."""
import numpy as np

from khaosbench.timeline import downtimes


def read(rec):
    if not rec.failures:
        return None
    return float(np.mean(downtimes(rec.log, rec.failures, rec.window_s)))
