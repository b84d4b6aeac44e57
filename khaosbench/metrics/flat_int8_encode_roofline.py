"""The fused int8 delta encode's least time on the card (its bytes,
counted from the configuration's widths, over the HBM peak) over its mean
device time per launch in the traced window, in %."""


def read(rec):
    if rec.trace is None:
        return None
    mean_s = rec.trace.op_mean_s("int8_encode_kernel")
    if mean_s is None:
        return None
    return rec.int8_encode_bytes / rec.rates().hbm / mean_s * 100.0
