"""Bytes counted from a configuration's widths alone, for the roofline
metrics (never read from the program).  What depends on the architecture
(a step's flops, which leaves the state holds) is its model module's."""
from __future__ import annotations

from khaosbench.reference.codec import GROUP
from khaosbench.reference.tree import flatten


def packed_elements(shapes: dict) -> int:
    """Elements of a tree of (shape, std) leaves, each padded to whole
    GROUPs, as the delta codec packs it."""
    return sum(-(-_numel(shape) // GROUP) * GROUP
               for _, (shape, _) in flatten(shapes))


def int8_encode_bytes(elements: int) -> int:
    """Bytes the fused int8 delta encode must move over ``elements``
    packed float32 state elements: the new and the base state read (4 B
    each), q written (1 B), and per group a float32 scale and an int32
    count of changed elements."""
    return 9 * elements + 8 * (elements // GROUP)


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out
