"""Model zoo of the port, dense family: parameter init, the sequence
forward, the loss, the functional train step, and the weight carry-over
to and from the JAX package's numpy trees.

Params are nested dicts carrying the reference's leaf names and layouts,
per-layer weights stacked on a leading ``num_layers`` axis
(``layers/attn/wq`` is (L, d, H, hd)), so a state flattens to the same
names in the same order in both frameworks and the carry-over is a
rename-free copy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig, OptimizerConfig
from repro_torch.models import layers as L
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.utils.trees import (tensor_to_numpy, to_tensor, tree_map,
                                     tree_structure, tree_unflatten,
                                     tree_leaves)

Params = Any


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


def _stack(trees: list) -> Params:
    """Stack per-layer param dicts on a new leading axis."""
    treedef = tree_structure(trees[0])
    cols = zip(*[tree_leaves(t) for t in trees])
    return tree_unflatten(treedef, [torch.stack(c) for c in cols])


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: Any) -> Params:
    """Random params from ``gen`` (a ``torch.Generator`` on ``device``):
    the reference's names, shapes, stds and truncated-normal init, not its
    numbers (``jax.random`` and torch's generators differ; carry weights
    over with ``state_from_numpy`` where numbers must match)."""
    _check_family(cfg)
    p: dict = {"emb": L.init_embeddings(gen, cfg, device),
               "final_norm": L.init_norm(cfg, device)}
    p["layers"] = _stack([
        {"ln1": L.init_norm(cfg, device),
         "attn": L.init_attention(gen, cfg, device),
         "ln2": L.init_norm(cfg, device),
         "ffn": L.init_ffn(gen, cfg, device)}
        for _ in range(cfg.num_layers)])
    return p


def _layer(params: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], params["layers"])


def forward_logits(params: Params, cfg: ModelConfig,
                   batch: dict) -> torch.Tensor:
    """Sequence forward for training: tokens (B, S) -> logits (B, S, V)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_tokens(params["emb"], tokens, cfg)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = L.apply_norm(lp["ln1"], x, cfg)
        x = x + L.attention_sequence(lp["attn"], h, cfg, positions=positions)
        h = L.apply_norm(lp["ln2"], x, cfg)
        x = x + L.apply_ffn(lp["ffn"], h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.logits_from_hidden(params["emb"], x, cfg)


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        logits = forward_logits(params, cfg, batch)
        ce = L.cross_entropy(logits, batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    opt_cfg: OptimizerConfig):
    """One functional training step (gradient accumulation 1): returns
    ``train_step(state, batch) -> (new_state, metrics)``.  The new state is
    built of NEW tensors; nothing in ``state`` is modified, which the
    checkpoint plane's deferred snapshot and device delta base rely on."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        treedef = tree_structure(params)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten(treedef, list(grads))
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        with torch.no_grad():
            new_params, new_opt = optimizer.update(
                grads, state["opt"], params, state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        out_metrics = {"loss": loss.detach(), "grad_norm": gnorm.detach(),
                       **{k: v.detach() for k, v in metrics.items()}}
        return new_state, out_metrics

    return train_step


def init_state(cfg: ModelConfig, optimizer: Optimizer, gen: torch.Generator,
               device: Any) -> dict:
    params = init_params(cfg, gen, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Weight carry-over from / to the JAX package (numpy trees, same names)
# ---------------------------------------------------------------------------

def state_from_numpy(tree: Any, device: Any) -> Any:
    """A numpy tree (the JAX package's params or train state, through
    ``np.asarray``) -> the same tree of tensors on ``device``, leaf for
    leaf: the layouts are shared, so nothing is renamed or transposed."""
    return tree_map(lambda x: to_tensor(x, device), tree)


def state_to_numpy(state: Any) -> Any:
    """The port's tree of tensors -> a numpy tree the JAX package takes."""
    return tree_map(lambda x: tensor_to_numpy(x)
                    if isinstance(x, torch.Tensor) else np.asarray(x), state)
