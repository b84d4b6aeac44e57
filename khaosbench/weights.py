"""The benchmark's weights: made on the device from the seed, in one draw
of a ``torch.Generator`` on that device, in the parameter tree of the
model module's ``param_shapes``.  The same seed on the same device gives
the same weights, so the reference makes them again after the window."""
from __future__ import annotations

import torch

from khaosbench.reference.tree import flatten, unflatten


def make_params(shapes: dict, seed: int, device) -> dict:
    """float32 params of the tree ``shapes`` of (shape, std) leaves:
    normal(0, std), or ones where the std is None (the norm scales)."""
    leaves = flatten(shapes)
    sizes = [torch.Size(shape).numel() for _, (shape, std) in leaves
             if std is not None]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    parts = iter(draw.split(sizes))
    out = []
    for name, (shape, std) in leaves:
        if std is None:
            out.append((name, torch.ones(shape, device=device)))
        else:
            out.append((name, next(parts).view(shape).mul(std)))
    del draw, parts
    return unflatten(out)
