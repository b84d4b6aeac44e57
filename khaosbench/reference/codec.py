"""Plain decoder of the checkpoint plane's int8 delta payload and the
codec's documented error bound.

The payload of one device-encoded delta covers the float32 leaves of the
state packed one after another, each zero-padded to whole groups of
``GROUP`` elements.  Per group it holds one float32 scale and, per
element, an int8 ``q``; the decoded value is ``base + q * scale``.  The
codec promises ``|new - base - q * scale| <= max(max|new - base|,
1e-12) / 254`` per element: half a quantisation step, the scale being
the group's largest change (floored at 1e-12) over 127.  The encoder
forms ``new - base``, the scale and the quotient in float32, so the bound
here allows two float32 roundings of each (a relative 2^-21 of the half
step and of the element's change).
"""
from __future__ import annotations

import numpy as np
import torch

GROUP = 1024
SCALE_FLOOR = 1e-12
ROUNDING = 2.0 ** -21


def layout(named_shapes: list) -> list:
    """[(name, offset, size, shape)] of the packed buffer: each leaf at a
    GROUP-aligned offset, padded to whole groups."""
    out, off = [], 0
    for name, shape in named_shapes:
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out.append((name, off, size, tuple(shape)))
        off += -(-size // GROUP) * GROUP
    return out


def worst_error_over_bound(new: torch.Tensor, base: torch.Tensor,
                           q: torch.Tensor, scales: torch.Tensor) -> float:
    """max over the elements of one leaf of |new - (base + q * s)| over
    the codec's bound, in float64; ``q`` and ``scales`` are this leaf's
    padded extent of the payload.  <= 1 where the codec kept its
    promise."""
    n = new.numel()
    pad = q.numel() - n
    d = (new.reshape(-1).to(torch.float32)
         - base.reshape(-1).to(torch.float32)).to(torch.float64)
    if pad:
        d = torch.cat([d, d.new_zeros(pad)])
    d = d.reshape(-1, GROUP)
    qs = q.reshape(-1, GROUP).to(torch.float64) \
        * scales.to(torch.float64)[:, None]
    amax = d.abs().amax(dim=1, keepdim=True).clamp_min(SCALE_FLOOR)
    bound = amax / 254.0 * (1 + ROUNDING) + d.abs() * ROUNDING
    return float(((d - qs).abs() / bound).amax())
