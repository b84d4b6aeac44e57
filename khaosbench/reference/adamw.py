"""Plain AdamW steps over any model's loss: the training half of every
model's reference (a model's reference module brings the loss)."""
from __future__ import annotations

import math

import torch

from .tree import flatten, unflatten


def learning_rate(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then (``schedule``
    "cosine") cosine to a tenth of it at ``total_steps``."""
    warmup = max(1, opt["warmup_steps"])
    total = max(opt["total_steps"], warmup + 1)
    if step < warmup or opt["schedule"] == "constant":
        return opt["lr"] * min(step / warmup, 1.0)
    prog = min(max((step - warmup) / (total - warmup), 0.0), 1.0)
    return opt["lr"] * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def adamw_step(params: list, grads: list, m: list, v: list, step: int,
               opt: dict):
    """One AdamW step over parallel lists of leaves, after clipping the
    gradients to a global norm of ``grad_clip``; returns the new
    (params, m, v) and the clipped gradients."""
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = min(opt["grad_clip"] / max(float(gn), 1e-9), 1.0)
    grads = [g * scale for g in grads]
    lr = learning_rate(opt, step)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    bc1, bc2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    out_p, out_m, out_v = [], [], []
    for p, g, mi, vi in zip(params, grads, m, v):
        mn = b1 * mi + (1 - b1) * g
        vn = b2 * vi + (1 - b2) * g * g
        delta = (mn / bc1) / (torch.sqrt(vn / bc2) + eps)
        wd = opt["weight_decay"] if p.ndim >= 2 else 0.0
        out_p.append(p - lr * (delta + wd * p))
        out_m.append(mn)
        out_v.append(vn)
    return out_p, out_m, out_v, grads


def train_steps(loss_fn, params: dict, opt: dict, batches: list) -> dict:
    """Run ``len(batches)`` steps of ``loss_fn(params, tokens, labels)``
    from ``params`` (consumed); returns the losses, the per-leaf norms of
    the first (clipped) gradient and of the change of each parameter over
    all the steps."""
    names = [n for n, _ in flatten(params)]
    p = [leaf.detach() for _, leaf in flatten(params)]
    start = [x.clone() for x in p]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    losses, first_grad = [], None
    for step, (tokens, labels) in enumerate(batches):
        leaves = [x.requires_grad_(True) for x in p]
        loss = loss_fn(unflatten(list(zip(names, leaves))), tokens, labels)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            p, m, v, clipped = adamw_step([x.detach() for x in leaves],
                                          list(grads), m, v, step, opt)
        if first_grad is None:
            first_grad = {n: float(torch.linalg.vector_norm(g))
                          for n, g in zip(names, clipped)}
        del grads, clipped, leaves, loss
    change = {n: float(torch.linalg.vector_norm(a - b))
              for n, a, b in zip(names, p, start)}
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change}
