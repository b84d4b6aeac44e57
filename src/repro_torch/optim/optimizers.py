"""Functional AdamW and global-norm clipping over dict pytrees.

Every update builds NEW tensors (never ``p.add_()``): the checkpoint plane
holds references to the previous state's tensors — the delta base and the
deferred snapshot — and relies on them not changing, as the JAX reference
relies on array immutability (``pipeline.HeldTensor`` raises if one does).
Optimizer state lives in ``state_dtype`` (float32 by default) whatever the
parameter dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.optim.schedule import make_schedule
from repro_torch.utils.trees import (tree_leaves, tree_map, tree_structure,
                                     tree_unflatten)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

Params = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params, torch.Tensor], tuple[Params, Any]]


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(tree: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), gn


def adamw(cfg: OptimizerConfig) -> Optimizer:
    sched = make_schedule(cfg)
    sdt = _DTYPES[cfg.state_dtype]

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        lr = sched(step)
        b1, b2 = cfg.b1, cfg.b2
        t = step.to(torch.float32) + 1.0
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
            v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            # decoupled weight decay on matrices only (ndim >= 2)
            wd = cfg.weight_decay if p.ndim >= 2 else 0.0
            pf = p.to(torch.float32)
            p_new = pf - lr * (delta + wd * pf)
            return p_new.to(p.dtype), m_new.to(sdt), v_new.to(sdt)

        treedef = tree_structure(params)
        out = [upd(g, m, v, p) for g, m, v, p in
               zip(tree_leaves(grads), tree_leaves(state["m"]),
                   tree_leaves(state["v"]), tree_leaves(params))]
        new_p = tree_unflatten(treedef, [o[0] for o in out])
        new_m = tree_unflatten(treedef, [o[1] for o in out])
        new_v = tree_unflatten(treedef, [o[2] for o in out])
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return adamw(cfg)
    raise ValueError(f"optimizer {cfg.name!r} is not ported yet")
