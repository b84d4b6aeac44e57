"""Share of the traced window in which no kernel, copy or set ran on the
card, in %."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return (1.0 - rec.trace.busy_s / rec.trace.window_s) * 100.0
