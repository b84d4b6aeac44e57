"""Plain PyTorch versions of the delta-codec kernels.

Each function here computes exactly what one CUDA kernel of
``kernel.py`` computes, on the same tensors, with the same IEEE float32
arithmetic: subtraction, addition, true division and round-half-to-even.
They serve three callers: the CPU (a wrapper in ``ops.py`` takes them for
a CPU tensor), the tests, which hold them against the JAX package, and
``chip_smoke.py``, which holds each kernel against them on the card.

uint32 words are carried as int32 tensors (torch supports uint32 only
partly); XOR and ``!=`` give the same bits on either view, and the host
hands numpy a ``.view(np.uint32)`` for the on-disk format.
"""
from __future__ import annotations

from typing import Sequence

import torch

GROUP = 1024
SCALE_FLOOR = 1e-12          # scale = max(amax, 1e-12) / 127
_COUNT_CHUNK = GROUP << 16   # elements per slice of the per-group counts


def _groups(x: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    if n % GROUP:
        raise ValueError(f"length {n} is not a multiple of GROUP={GROUP}")
    return x.reshape(-1, GROUP)


def _group_count(mask: torch.Tensor) -> torch.Tensor:
    """Per-group count of True, summed slice by slice so no int32 copy of
    a multi-gigabyte mask is ever made."""
    return torch.cat([m.reshape(-1, GROUP).sum(dim=1, dtype=torch.int32)
                      for m in _groups(mask).reshape(-1).split(_COUNT_CHUNK)])


def pad_to_groups(x: torch.Tensor) -> torch.Tensor:
    """Flatten and zero-pad to a whole number of GROUPs."""
    x = x.reshape(-1)
    pad = (-x.numel()) % GROUP
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x


def pack_flat(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate f32 leaves, each zero-padded to a whole number of
    GROUPs so every leaf starts at a GROUP-aligned offset (the layout
    ``checkpoint.pipeline.FlatLayout`` records).  A plain concat in the
    reference too, so it has no kernel."""
    return torch.cat([pad_to_groups(leaf.to(torch.float32))
                      for leaf in leaves])


def lossless_encode(new: torch.Tensor, base: torch.Tensor):
    """(d f32, r int32) over a GROUP-aligned f32 pair: d = new - base,
    r = bits(new) ^ bits(base + d) (kernel #5)."""
    new = new.reshape(-1)
    base = base.reshape(-1)
    _groups(new)
    d = new - base
    r = (base + d).view(torch.int32)   # what decode reconstructs ...
    r ^= new.view(torch.int32)         # ... XOR the true bits, in place
    return d, r


def lossless_encode_groups(new: torch.Tensor, base: torch.Tensor):
    """(d f32, r int32, group_changed i32, group_rnnz i32): the lossless
    encode plus, per group, the count of elements whose bits changed and
    the count of nonzero residual words (kernel #1)."""
    d, r = lossless_encode(new, base)
    gc = _group_count(new.reshape(-1).view(torch.int32)
                      != base.reshape(-1).view(torch.int32))
    gz = _group_count(r != 0)
    return d, r, gc, gz


def int8_encode(new: torch.Tensor, base: torch.Tensor):
    """(q int8, scale f32 per group): d = new - base, scale = max(max|d|,
    1e-12) / 127 per group, q = clip(round_half_even(d / scale), -127,
    127) (kernel #6)."""
    d = _groups(new.reshape(-1) - base.reshape(-1))
    amax = d.abs().amax(dim=1)
    # divide by a 0-d tensor ON THE SAME DEVICE: with a Python-scalar
    # divisor PyTorch's CUDA division multiplies by the reciprocal, which
    # is not the IEEE quotient the reference (and the kernel) computes
    scale = torch.clamp_min(amax, SCALE_FLOOR) / amax.new_tensor(127.0)
    q = torch.round(d / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(-1), scale


def int8_encode_groups(new: torch.Tensor, base: torch.Tensor):
    """(q int8, scale f32 per group, group_changed i32): the int8 encode
    plus the per-group changed count (kernel #2)."""
    q, scale = int8_encode(new, base)
    gc = _group_count(new.reshape(-1).view(torch.int32)
                      != base.reshape(-1).view(torch.int32))
    return q, scale, gc


def lossless_decode(base: torch.Tensor, d: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """out = f32(bits(base + d) ^ r): the exact inverse of the lossless
    encode."""
    pred = base.reshape(-1) + d.reshape(-1)
    pred.view(torch.int32).bitwise_xor_(r.reshape(-1))
    return pred


def delta_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """d = q * scale[group] (the caller adds the base)."""
    return _groups(q).to(torch.float32).mul_(scales[:, None]).reshape(-1)


def leaf_reduce(per_group: torch.Tensor, group_leaf: torch.Tensor,
                num_leaves: int) -> torch.Tensor:
    """Per-group counts -> per-leaf counts over the layout's group->leaf
    map (``index_add_``; the reference's scatter-add, outside its kernel
    as well)."""
    out = torch.zeros(num_leaves, dtype=torch.int32, device=per_group.device)
    return out.index_add_(0, group_leaf, per_group)
