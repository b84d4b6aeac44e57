"""Seconds from the start of the benchmark's process to the window's
start: imports, the codec's kernel built or loaded, weights made from the
seed, the checked steps, the warm-up triggers."""


def read(rec):
    return rec.setup_s
