"""95th percentile over every event created in the window of the time
from its creation to the end of the step that last processed it (an
event still pending at the window's end counts until the end), in ms."""
import numpy as np

from khaosbench.timeline import event_latencies


def read(rec):
    if rec.arrivals is None or not len(rec.arrivals):
        return None
    lat = event_latencies(rec.log, rec.arrivals, rec.cursor0, rec.window_s)
    return float(np.percentile(lat, 95)) * 1e3
