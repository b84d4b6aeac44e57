"""Dispatching wrappers of the delta codec: the entry points the checkpoint
plane calls.

Each wrapper takes the plain PyTorch version (``ref.py``) for a tensor
that lies on the CPU, and launches its CUDA kernel (``kernel.py``) for a
CUDA tensor — with no fallback: a kernel that cannot build or launch
raises.  Each wrapper counts its kernel launches in a plain integer
attribute (``flat_lossless_encode.launches`` …), incremented only where
the kernel is launched, so a run can show that its main path went
through the kernels (``launch_counts``/``reset_launch_counts``).

  * ``pack_flat`` concatenates the f32 subtree into one GROUP-aligned
    buffer (a plain concat, as in the reference: no kernel);
  * ``flat_lossless_encode``/``flat_int8_encode`` run ONE encode over the
    packed buffer and reduce the per-group change statistics to per-leaf
    counts with ``index_add_`` over the layout's group->leaf map;
  * ``lossless_decode``/``delta_decode`` invert them (any length: inputs
    are zero-padded to whole groups and the output sliced back).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.ckpt_delta import kernel as _k
from repro_torch.kernels.ckpt_delta import ref as _ref
from repro_torch.kernels.ckpt_delta.ref import GROUP, pad_to_groups


def _impl(t: torch.Tensor):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if t.device.type == "cpu":
        return _ref
    if t.device.type == "cuda":
        return _k
    raise ValueError(f"no ckpt_delta implementation for device {t.device}")


def pack_flat(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pack f32 leaves into ONE flat buffer, each zero-padded to a whole
    number of GROUPs (``pipeline.FlatLayout`` records the offsets)."""
    return _ref.pack_flat(leaves)


def flat_lossless_encode(new_flat: torch.Tensor, base_flat: torch.Tensor,
                         group_leaf: torch.Tensor, num_leaves: int):
    """Fused lossless encode of the packed buffer: returns (d f32, r int32
    — the u32 residual's bits —, leaf_changed i32[num_leaves], leaf_rnnz
    i32[num_leaves]).  ``leaf_changed == 0`` marks a leaf bit-identical to
    its base; ``leaf_rnnz.sum() == 0`` an all-zero residual plane."""
    impl = _impl(new_flat)
    d, r, gc, gz = impl.lossless_encode_groups(new_flat, base_flat)
    if impl is _k:
        flat_lossless_encode.launches += 1
    return (d, r, _ref.leaf_reduce(gc, group_leaf, num_leaves),
            _ref.leaf_reduce(gz, group_leaf, num_leaves))


def flat_int8_encode(new_flat: torch.Tensor, base_flat: torch.Tensor,
                     group_leaf: torch.Tensor, num_leaves: int):
    """Fused int8 encode of the packed buffer: returns (q int8, per-group
    f32 scales, leaf_changed i32[num_leaves]).  Worst-case error per
    element is half a step: |err| <= max|delta_group| / 254."""
    impl = _impl(new_flat)
    q, s, gc = impl.int8_encode_groups(new_flat, base_flat)
    if impl is _k:
        flat_int8_encode.launches += 1
    return q, s, _ref.leaf_reduce(gc, group_leaf, num_leaves)


def lossless_decode(base: torch.Tensor, d: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Bit-exact inverse of the lossless encode; ``r`` carries the u32
    residual as int32.  Returns f32 of ``base``'s length."""
    n = base.numel()
    args = [pad_to_groups(x) for x in (base.to(torch.float32),
                                       d.to(torch.float32), r)]
    impl = _impl(args[0])
    out = impl.lossless_decode(*args)
    if impl is _k:
        lossless_decode.launches += 1
    return out[:n]


def delta_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 payload -> f32 delta (the caller adds the base).  Returns the
    GROUP-padded length, like the reference; callers slice."""
    qp = pad_to_groups(q)
    impl = _impl(qp)
    d = impl.delta_decode(qp, scales.to(torch.float32))
    if impl is _k:
        delta_decode.launches += 1
    return d


KERNEL_WRAPPERS = (flat_lossless_encode, flat_int8_encode, lossless_decode,
                   delta_decode)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = ["GROUP", "pack_flat", "flat_lossless_encode", "flat_int8_encode",
           "lossless_decode", "delta_decode", "launch_counts",
           "reset_launch_counts"]
