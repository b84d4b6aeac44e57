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
    are zero-padded to whole groups and the output sliced back);
  * ``lossless_encode``/``delta_encode`` are the PER-LEAF encodes: one
    launch per tensor of any shape, flattened and zero-padded to whole
    groups, without statistics.  ``lossless_encode_leaf``/
    ``int8_encode_leaf`` add the leaf's ``changed`` flag (and the
    residual's nonzero count) as plain torch reductions outside the
    kernel, as the reference computes them outside its ``pallas_call``.
    The checkpoint calibration times them as the pre-flat baseline
    (``per_leaf_encode_s``).
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


def lossless_encode(new: torch.Tensor, base: torch.Tensor):
    """Per-leaf lossless encode of one tensor pair of any shape: (d f32,
    r int32 — the u32 residual's bits), both GROUP-padded (zero padding
    encodes to zero delta and zero residual)."""
    nf = pad_to_groups(new.to(torch.float32))
    bf = pad_to_groups(base.to(torch.float32))
    impl = _impl(nf)
    d, r = impl.lossless_encode(nf, bf)
    if impl is _k:
        lossless_encode.launches += 1
    return d, r


def delta_encode(new: torch.Tensor, base: torch.Tensor):
    """Per-leaf int8 encode of one tensor pair of any shape: (q int8
    GROUP-padded, per-group f32 scales)."""
    nf = pad_to_groups(new.to(torch.float32))
    bf = pad_to_groups(base.to(torch.float32))
    impl = _impl(nf)
    q, s = impl.int8_encode(nf, bf)
    if impl is _k:
        delta_encode.launches += 1
    return q, s


def _bits_changed(new: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """True iff any f32 bit pattern differs (0-d bool, on the device)."""
    nf = new.reshape(-1).to(torch.float32)
    bf = base.reshape(-1).to(torch.float32)
    return (nf.view(torch.int32) != bf.view(torch.int32)).any()


def lossless_encode_leaf(new: torch.Tensor, base: torch.Tensor):
    """One leaf's lossless encode: (d, r — GROUP-padded —, changed, resid_nnz)
    where ``changed`` says any bit differs and ``resid_nnz`` counts the
    nonzero residual words (both 0-d tensors on the input's device)."""
    d, r = lossless_encode(new, base)
    return d, r, _bits_changed(new, base), torch.count_nonzero(r)


def int8_encode_leaf(new: torch.Tensor, base: torch.Tensor):
    """One leaf's int8 encode: (q GROUP-padded, scales, changed).  The
    worst-case error per element is half a step: max|delta_group| / 254."""
    q, s = delta_encode(new, base)
    return q, s, _bits_changed(new, base)


KERNEL_WRAPPERS = (flat_lossless_encode, flat_int8_encode, lossless_decode,
                   delta_decode, lossless_encode, delta_encode)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = ["GROUP", "pack_flat", "flat_lossless_encode", "flat_int8_encode",
           "lossless_decode", "delta_decode", "lossless_encode",
           "delta_encode", "lossless_encode_leaf", "int8_encode_leaf",
           "launch_counts", "reset_launch_counts"]
