"""Model zoo of the port: the six families (dense / moe / hybrid / ssm /
vlm / audio), parameter init, the sequence forward (train / prefill), the
one-token decode forward, the loss, the functional train step, the
prefill and decode step factories, input and cache specs, and the weight
carry-over to and from the JAX package's numpy trees.

Params are nested dicts carrying the reference's leaf names and layouts,
per-layer weights stacked on a leading axis (``layers/attn/wq`` is (L, d,
H, hd); the hybrid family's ``groups/rec`` is (G, n_rec, ...),
``groups/attn`` (G, ...) and ``tail`` (n_tail, ...)), so a state flattens
to the same names in the same order in both frameworks and the carry-over
is a rename-free copy.  The layer stacks are plain loops over that axis
(the reference scans them); each layer body (each group of the hybrid
stack) runs under ``cfg.remat_policy`` when autograd records, as the
reference's scan bodies run under ``jax.checkpoint``.

Decode consumes its caches: each step writes the new token's K/V and the
recurrent states into the cache tensors it is given and returns them
(PyTorch's form of the reference's donated caches); nothing copies a
whole (L, B, S, K, hd) cache per step.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig, OptimizerConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.utils.trees import (tensor_to_numpy, to_tensor, tree_map,
                                     tree_structure, tree_unflatten,
                                     tree_leaves)

_aten = torch.ops.aten

Params = Any

VLM_VISION_TOKENS = 1024   # stub frontend: fixed number of patch embeddings


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

def _dots_with_no_batch_dims(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the products that
    have no batch dimension (``x @ W`` lowers to ``mm``/``addmm``, an
    einsum that contracts with a weight to ``bmm`` over a batch of one);
    recompute everything else, batched attention products included."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat_policy``: "none" keeps every activation,
    "minimal" keeps only the no-batch-dim products and "full" (any other
    value, as in the reference) keeps nothing but the body's inputs; the
    rest is recomputed in the backward pass.  Without autograd recording
    (prefill, decode, ``torch.no_grad``) ``fn`` runs as it is."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "minimal":
        kw = {"context_fn": partial(create_selective_checkpoint_contexts,
                                    _dots_with_no_batch_dims)}
    else:
        kw = {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _stack_init(init_fn: Callable[[], Params], n: int) -> Params:
    """``n`` calls of ``init_fn`` stacked on a new leading axis, each
    layer written into the preallocated stack as it is made (the peak is
    the stack plus one layer, not two copies of the model)."""
    first = init_fn()
    treedef = tree_structure(first)
    stacks = [torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                          device=a.device) for a in tree_leaves(first)]
    for i in range(n):
        layer = first if i == 0 else init_fn()
        for s, a in zip(stacks, tree_leaves(layer)):
            s[i].copy_(a)
        del layer
    return tree_unflatten(treedef, stacks)


def _index_tree(tree: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], tree)


def _unstack(tree: Params) -> list:
    """The per-index trees of a stacked tree, one ``unbind`` per leaf.  Its
    backward stacks the layers' gradients once; indexing the stack per
    layer would make each layer's backward fill a zero gradient of the
    whole stack, a cost that grows with the square of the depth."""
    cols = [torch.unbind(a) for a in tree_leaves(tree)]
    treedef = tree_structure(tree)
    return [tree_unflatten(treedef, list(c)) for c in zip(*cols)]


def _n_stacked(tree: Params) -> int:
    return tree_leaves(tree)[0].shape[0]


def _hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_rec per group, n_groups, n_tail) of a hybrid block pattern."""
    pat = tuple(cfg.recurrent.block_pattern)
    n_rec = sum(1 for b in pat if b == "recurrent")
    n_groups = cfg.num_layers // len(pat)
    n_tail = cfg.num_layers - n_groups * len(pat)
    return n_rec, n_groups, n_tail


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: Any) -> Params:
    """Random params from ``gen`` (a ``torch.Generator`` on ``device``):
    the reference's names, shapes, stds and truncated-normal init, not its
    numbers (``jax.random`` and torch's generators differ; carry weights
    over with ``state_from_numpy`` where numbers must match)."""
    norm = partial(L.init_norm, cfg, device)
    p: dict = {"emb": L.init_embeddings(gen, cfg, device),
               "final_norm": norm()}

    if cfg.family in ("dense", "vlm"):
        p["layers"] = _stack_init(lambda: {
            "ln1": norm(), "attn": L.init_attention(gen, cfg, device),
            "ln2": norm(), "ffn": L.init_ffn(gen, cfg, device)},
            cfg.num_layers)
    elif cfg.family == "moe":
        p["layers"] = _stack_init(lambda: {
            "ln1": norm(), "attn": L.init_attention(gen, cfg, device),
            "ln2": norm(), "moe": L.init_moe(gen, cfg, device)},
            cfg.num_layers)
    elif cfg.family == "ssm":
        p["layers"] = _stack_init(lambda: {
            "ln1": norm(), "ln2": norm(),
            "mix": L.init_rwkv_block(gen, cfg, device)}, cfg.num_layers)
    elif cfg.family == "hybrid":
        n_rec, n_groups, n_tail = _hybrid_layout(cfg)
        if any(b != "recurrent" for b in cfg.recurrent.block_pattern[:n_tail]):
            raise ValueError("the hybrid tail must be recurrent-only")

        def rec_one():
            return {"ln": norm(), "mix": L.init_rglru_block(gen, cfg, device),
                    "ffn_ln": norm(), "ffn": L.init_ffn(gen, cfg, device)}

        def attn_one():
            return {"ln": norm(), "attn": L.init_attention(gen, cfg, device),
                    "ffn_ln": norm(), "ffn": L.init_ffn(gen, cfg, device)}

        p["groups"] = _stack_init(lambda: {
            "rec": _stack_init(rec_one, n_rec), "attn": attn_one()},
            n_groups)
        if n_tail:
            p["tail"] = _stack_init(rec_one, n_tail)
    elif cfg.family == "audio":
        p["enc_layers"] = _stack_init(lambda: {
            "ln1": norm(), "attn": L.init_attention(gen, cfg, device),
            "ln2": norm(), "ffn": L.init_ffn(gen, cfg, device)},
            cfg.num_layers)
        p["enc_norm"] = norm()
        p["dec_layers"] = _stack_init(lambda: {
            "ln1": norm(), "self_attn": L.init_attention(gen, cfg, device),
            "ln2": norm(), "cross_attn": L.init_attention(gen, cfg, device),
            "ln3": norm(), "ffn": L.init_ffn(gen, cfg, device)},
            cfg.num_decoder_layers)
    else:
        raise ValueError(cfg.family)
    return p


# ---------------------------------------------------------------------------
# Sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _stack_caches(per_layer: list) -> Params:
    treedef = tree_structure(per_layer[0])
    cols = zip(*[tree_leaves(t) for t in per_layer])
    return tree_unflatten(treedef, [torch.stack(c) for c in cols])


def _uniform_layer(lp, x, aux, *, cfg: ModelConfig, positions,
                   collect_kv: bool, causal: bool, window: int, ann):
    """One layer of the dense/moe/vlm/ssm stacks: (x, aux) -> (x, aux,
    this layer's cache or None)."""
    x = ann.constrain(x, "hidden")
    ys = None
    if cfg.family == "ssm":
        h = L.apply_norm(lp["ln1"], x, cfg)
        y, (tm_x, tm_s) = L.rwkv_time_mix(lp["mix"], h, cfg)
        x = x + y
        h = L.apply_norm(lp["ln2"], x, cfg)
        y, cm_x = L.rwkv_channel_mix(lp["mix"], h, cfg)
        x = x + y
        if collect_kv:
            ys = {"tm_x": tm_x, "tm_s": tm_s, "cm_x": cm_x}
    else:
        h = L.apply_norm(lp["ln1"], x, cfg)
        if collect_kv:
            a, (k, v) = L.attention_sequence(
                lp["attn"], h, cfg, positions=positions, causal=causal,
                window=window, return_kv=True, ann=ann)
            ys = {"k": k, "v": v}
        else:
            a = L.attention_sequence(lp["attn"], h, cfg, positions=positions,
                                     causal=causal, window=window, ann=ann)
        x = ann.constrain(x + a, "hidden")
        h = L.apply_norm(lp["ln2"], x, cfg)
        if cfg.family == "moe":
            y, aux_l = L.apply_moe(lp["moe"], h, cfg, ann=ann)
            aux = aux + aux_l
        else:
            y = L.apply_ffn(lp["ffn"], h, cfg, ann=ann)
        x = x + y
    return ann.constrain(x, "hidden"), aux, ys


def _run_uniform_stack(params, cfg: ModelConfig, x, positions, *,
                       collect_kv: bool, causal: bool = True,
                       window: int = 0, ann=L.NULL_ANN):
    """dense/moe/vlm/ssm stacks (uniform per-layer structure)."""
    body = _remat(partial(_uniform_layer, cfg=cfg, positions=positions,
                          collect_kv=collect_kv, causal=causal,
                          window=window, ann=ann), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for lp in _unstack(params["layers"]):
        x, aux, ys = body(lp, x, aux)
        caches.append(ys)
    return x, aux, (_stack_caches(caches) if collect_kv else None)


def _hybrid_sublayer(lp, x, cfg, positions, kind: str, collect: bool,
                     ann=L.NULL_ANN):
    h = L.apply_norm(lp["ln"], x, cfg)
    st = None
    if kind == "recurrent":
        y, (h_last, conv_tail) = L.rglru_sequence(lp["mix"], h, cfg, ann=ann)
        if collect:
            st = {"h": h_last, "conv": conv_tail}
    else:
        W = cfg.recurrent.window_size
        if collect:
            y, (k, v) = L.attention_sequence(
                lp["attn"], h, cfg, positions=positions, causal=True,
                window=W, return_kv=True, ann=ann)
            S = k.shape[1]
            if S < W:
                pad = (0, 0, 0, 0, 0, W - S)
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
            else:
                if S % W != 0:
                    raise ValueError("hybrid prefill needs seq % window == 0")
                k, v = k[:, -W:], v[:, -W:]
            st = {"k": k, "v": v}
        else:
            y = L.attention_sequence(lp["attn"], h, cfg, positions=positions,
                                     causal=True, window=W, ann=ann)
    x = ann.constrain(x + y, "hidden")
    h = L.apply_norm(lp["ffn_ln"], x, cfg)
    x = ann.constrain(x + L.apply_ffn(lp["ffn"], h, cfg, ann=ann), "hidden")
    return x, st


def _hybrid_group(gp, x, *, cfg: ModelConfig, positions, collect_kv: bool,
                  ann):
    """One (recurrent x n_rec, attention) group of the hybrid stack."""
    x = ann.constrain(x, "hidden")
    recs = []
    for lp in _unstack(gp["rec"]):
        x, st = _hybrid_sublayer(lp, x, cfg, positions, "recurrent",
                                 collect_kv, ann)
        recs.append(st)
    x, attn_st = _hybrid_sublayer(gp["attn"], x, cfg, positions,
                                  "attention", collect_kv, ann)
    ys = {"rec": _stack_caches(recs), "attn": attn_st} if collect_kv \
        else None
    return x, ys


def _run_hybrid_stack(params, cfg: ModelConfig, x, positions, *,
                      collect_kv: bool, ann=L.NULL_ANN):
    body = _remat(partial(_hybrid_group, cfg=cfg, positions=positions,
                          collect_kv=collect_kv, ann=ann), cfg)
    group_caches = []
    for gp in _unstack(params["groups"]):
        x, ys = body(gp, x)
        group_caches.append(ys)
    tail_caches = []
    if "tail" in params:
        for lp in _unstack(params["tail"]):
            x, st = _hybrid_sublayer(lp, x, cfg, positions, "recurrent",
                                     collect_kv, ann)
            tail_caches.append(st)
    caches = None
    if collect_kv:
        caches = {"groups": _stack_caches(group_caches)}
        if tail_caches:
            caches["tail"] = _stack_caches(tail_caches)
    return x, caches


def _audio_enc_layer(lp, x, *, cfg: ModelConfig, positions, ann):
    x = ann.constrain(x, "hidden")
    h = L.apply_norm(lp["ln1"], x, cfg)
    x = x + L.attention_sequence(lp["attn"], h, cfg, positions=positions,
                                 causal=False, ann=ann)
    h = L.apply_norm(lp["ln2"], x, cfg)
    x = x + L.apply_ffn(lp["ffn"], h, cfg, ann=ann)
    return ann.constrain(x, "hidden")


def _audio_dec_layer(lp, x, enc_out, *, cfg: ModelConfig, positions,
                     collect_kv: bool, ann):
    dt = x.dtype
    x = ann.constrain(x, "hidden")
    h = L.apply_norm(lp["ln1"], x, cfg)
    ys = None
    if collect_kv:
        a, (k, v) = L.attention_sequence(
            lp["self_attn"], h, cfg, positions=positions, causal=True,
            return_kv=True, ann=ann)
    else:
        a = L.attention_sequence(lp["self_attn"], h, cfg,
                                 positions=positions, causal=True, ann=ann)
    x = x + a
    h = L.apply_norm(lp["ln2"], x, cfg)
    ck = torch.einsum("bsd,dnh->bsnh", enc_out,
                      lp["cross_attn"]["wk"].to(dt))
    cv = torch.einsum("bsd,dnh->bsnh", enc_out,
                      lp["cross_attn"]["wv"].to(dt))
    x = x + L.attention_sequence(lp["cross_attn"], h, cfg,
                                 positions=positions, causal=False,
                                 kv_override=(ck, cv, None), ann=ann)
    h = L.apply_norm(lp["ln3"], x, cfg)
    x = ann.constrain(x + L.apply_ffn(lp["ffn"], h, cfg, ann=ann), "hidden")
    if collect_kv:
        ys = {"k": k, "v": v, "ck": ck, "cv": cv}
    return x, ys


def _run_audio_stack(params, cfg: ModelConfig, frames, dec_x, dec_positions,
                     *, collect_kv: bool, ann=L.NULL_ANN):
    B, Se = frames.shape[:2]
    enc_positions = torch.arange(Se, device=frames.device)[None].expand(B, Se)
    enc_body = _remat(partial(_audio_enc_layer, cfg=cfg,
                              positions=enc_positions, ann=ann), cfg)
    x = frames
    for lp in _unstack(params["enc_layers"]):
        x = enc_body(lp, x)
    enc_out = L.apply_norm(params["enc_norm"], x, cfg)

    dec_body = _remat(partial(_audio_dec_layer, cfg=cfg,
                              positions=dec_positions,
                              collect_kv=collect_kv, ann=ann), cfg)
    x = dec_x
    caches = []
    for lp in _unstack(params["dec_layers"]):
        x, ys = dec_body(lp, x, enc_out)
        caches.append(ys)
    return x, (_stack_caches(caches) if collect_kv else None)


def forward_logits(params, cfg: ModelConfig, batch: dict, *,
                   collect_kv: bool = False, last_token_only: bool = False,
                   ann=L.NULL_ANN):
    """Sequence forward for train/prefill.  Returns (logits, aux, caches).

    ``last_token_only`` (prefill) computes logits for the final position
    only; ``collect_kv`` returns each layer's K/V or recurrent state,
    stacked per layer, as prefill hands them to decode.  ``ann`` pins
    activation layouts (``repro_torch.sharding.ActivationAnnotator``) and
    sets the MoE group count."""
    if cfg.family == "audio":
        frames = batch["frames"].to(L._dtype(cfg))
        dec_tokens = batch["dec_tokens"]
        dec_x = L.embed_tokens(params["emb"], dec_tokens, cfg)
        B, Sd = dec_tokens.shape
        dec_pos = torch.arange(Sd, device=dec_x.device)[None].expand(B, Sd)
        x, caches = _run_audio_stack(params, cfg, frames, dec_x, dec_pos,
                                     collect_kv=collect_kv, ann=ann)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed_tokens(params["emb"], tokens, cfg)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype)
            nv = ve.shape[1]
            x = torch.cat([x[:, :nv] + ve, x[:, nv:]], dim=1)
        x = ann.constrain(x, "hidden")
        if cfg.mrope_sections and "positions" in batch:
            positions = batch["positions"]
        else:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
            if cfg.mrope_sections:
                positions = positions[None].expand(3, B, S)
        if cfg.family == "hybrid":
            pos2d = positions if positions.ndim == 2 else positions[0]
            x, caches = _run_hybrid_stack(params, cfg, x, pos2d,
                                          collect_kv=collect_kv, ann=ann)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, aux, caches = _run_uniform_stack(params, cfg, x, positions,
                                                collect_kv=collect_kv,
                                                ann=ann)
    if last_token_only:
        x = x[:, -1:]
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = ann.constrain(L.logits_from_hidden(params["emb"], x, cfg),
                           "logits")
    return logits, aux, caches


# ---------------------------------------------------------------------------
# Decode forward
# ---------------------------------------------------------------------------

def forward_decode(params, cfg: ModelConfig, caches, tokens, pos,
                   ann=L.NULL_ANN):
    """One decode step.  tokens (B, 1) int; pos (B,) int.

    Returns (logits (B, vocab_pad), caches).  The caches given are
    CONSUMED: the new token's K/V (at ``pos``, or ``pos % window`` in the
    hybrid ring) and the new recurrent states are written into them in
    place, and the returned dict holds the same tensors."""
    x = L.embed_tokens(params["emb"], tokens, cfg)

    if cfg.family in ("dense", "vlm", "moe"):
        for i in range(_n_stacked(params["layers"])):
            lp = _index_tree(params["layers"], i)
            h = L.apply_norm(lp["ln1"], x, cfg)
            a, _ = L.attention_decode_step(lp["attn"], h, cfg, pos=pos,
                                           k_cache=caches["k"][i],
                                           v_cache=caches["v"][i])
            x = x + a
            h = L.apply_norm(lp["ln2"], x, cfg)
            if cfg.family == "moe":
                y, _ = L.apply_moe(lp["moe"], h, cfg, ann=ann)
            else:
                y = L.apply_ffn(lp["ffn"], h, cfg)
            x = x + y
        new_caches = {"k": caches["k"], "v": caches["v"]}

    elif cfg.family == "ssm":
        for i in range(_n_stacked(params["layers"])):
            lp = _index_tree(params["layers"], i)
            h = L.apply_norm(lp["ln1"], x, cfg)
            y, (tm_x, tm_s) = L.rwkv_time_mix(
                lp["mix"], h, cfg, x_prev=caches["tm_x"][i],
                state=caches["tm_s"][i])
            x = x + y
            h = L.apply_norm(lp["ln2"], x, cfg)
            y, cm_x = L.rwkv_channel_mix(lp["mix"], h, cfg,
                                         x_prev=caches["cm_x"][i])
            x = x + y
            caches["tm_x"][i].copy_(tm_x)
            caches["tm_s"][i].copy_(tm_s)
            caches["cm_x"][i].copy_(cm_x)
        new_caches = {k: caches[k] for k in ("tm_x", "tm_s", "cm_x")}

    elif cfg.family == "hybrid":
        n_rec = _hybrid_layout(cfg)[0]
        W = cfg.recurrent.window_size

        def sub_rec(lp, x, st, i):
            h = L.apply_norm(lp["ln"], x, cfg)
            y, (hh, conv) = L.rglru_decode_step(
                lp["mix"], h, cfg, h=st["h"][i], conv_state=st["conv"][i])
            st["h"][i].copy_(hh)
            st["conv"][i].copy_(conv)
            x = x + y
            h = L.apply_norm(lp["ffn_ln"], x, cfg)
            return x + L.apply_ffn(lp["ffn"], h, cfg)

        groups = caches["groups"]
        for g in range(_n_stacked(params["groups"])):
            gp = _index_tree(params["groups"], g)
            rec_st = _index_tree(groups["rec"], g)
            for i in range(n_rec):
                x = sub_rec(_index_tree(gp["rec"], i), x, rec_st, i)
            lp = gp["attn"]
            h = L.apply_norm(lp["ln"], x, cfg)
            a, _ = L.attention_decode_step(
                lp["attn"], h, cfg, pos=pos,
                k_cache=groups["attn"]["k"][g],
                v_cache=groups["attn"]["v"][g], window=W)
            x = x + a
            h = L.apply_norm(lp["ffn_ln"], x, cfg)
            x = x + L.apply_ffn(lp["ffn"], h, cfg)
        new_caches = {"groups": groups}
        if "tail" in params:
            for i in range(_n_stacked(params["tail"])):
                x = sub_rec(_index_tree(params["tail"], i), x,
                            caches["tail"], i)
            new_caches["tail"] = caches["tail"]

    elif cfg.family == "audio":
        for i in range(_n_stacked(params["dec_layers"])):
            lp = _index_tree(params["dec_layers"], i)
            h = L.apply_norm(lp["ln1"], x, cfg)
            a, _ = L.attention_decode_step(lp["self_attn"], h, cfg, pos=pos,
                                           k_cache=caches["k"][i],
                                           v_cache=caches["v"][i])
            x = x + a
            h = L.apply_norm(lp["ln2"], x, cfg)
            a, _ = L.attention_decode_step(
                lp["cross_attn"], h, cfg, pos=pos, k_cache=None,
                v_cache=None, cross_kv=(caches["ck"][i], caches["cv"][i]))
            x = x + a
            h = L.apply_norm(lp["ln3"], x, cfg)
            x = x + L.apply_ffn(lp["ffn"], h, cfg)
        new_caches = {k: caches[k] for k in ("k", "v", "ck", "cv")}
    else:
        raise ValueError(cfg.family)

    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.logits_from_hidden(params["emb"], x, cfg)[:, 0]
    return logits, new_caches


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------

def make_loss_fn(cfg: ModelConfig, ann=L.NULL_ANN):
    def loss_fn(params, batch):
        logits, aux, _ = forward_logits(params, cfg, batch, ann=ann)
        ce = L.cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def _split_micro(x: torch.Tensor, accum: int, bsz: int) -> torch.Tensor:
    """Split the global-batch dim into (accum, B/accum): leading-batch
    leaves and (3, B, S) position ids (the accum axis moved to the
    front)."""
    if x.shape[0] == bsz:
        return x.reshape((accum, bsz // accum) + tuple(x.shape[1:]))
    if x.ndim >= 2 and x.shape[1] == bsz:
        y = x.reshape((x.shape[0], accum, bsz // accum)
                      + tuple(x.shape[2:]))
        return torch.movedim(y, 1, 0)
    raise ValueError(f"cannot microbatch leaf of shape {tuple(x.shape)}")


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    opt_cfg: OptimizerConfig, accum: int = 1,
                    ann=L.NULL_ANN, accum_dtype: str = "float32"):
    """One functional training step: returns ``train_step(state, batch) ->
    (new_state, metrics)``.  With ``accum > 1`` the batch is split into
    ``accum`` microbatches whose gradients are summed in ``accum_dtype``
    (bf16 adds bf16 to bf16), then divided by ``accum`` and cast to
    float32; the loss is the microbatches' mean and the metrics ``ce`` =
    that mean (ce + aux) and ``aux`` = 0, as in the reference.  The new
    state is built of NEW tensors; nothing in ``state`` is modified,
    which the checkpoint plane's deferred snapshot and device delta base
    rely on.

    ``train_step.parts`` is ``(begin, micro, finish)``, the accumulated
    step in pieces, so that the dry run (``roofline.trace_accumulated``)
    can count one microbatch in place of ``accum``.  Their contract:
    ``begin(params, batch) -> (mbs, gsum, loss)`` splits the batch and
    makes the zero sums; ``micro(params, mb, gsum, loss) -> (gsum,
    loss)`` adds one microbatch, holding nothing of it after it returns;
    ``finish(state, gsum, loss) -> (new_state, metrics)`` empties
    ``gsum`` and clips before the update, so neither the sums nor the
    unclipped gradients live through it.  ``begin``, ``accum`` times
    ``micro``, then ``finish`` IS ``train_step`` for ``accum > 1``;
    ``tests/test_torch_dryrun.py`` holds its peak to the one-body step's."""
    loss_fn = make_loss_fn(cfg, ann=ann)
    adt = L.dtype_of(accum_dtype)

    def grad_fn(params, batch):
        treedef = tree_structure(params)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    def begin(params, batch):
        """The microbatches, the zero gradient sums and the loss sum."""
        lead = batch.get("tokens", batch.get("frames"))
        bsz = lead.shape[0]
        mbs = {k: _split_micro(v, accum, bsz) for k, v in batch.items()}
        gsum = [torch.zeros(p.shape, dtype=adt, device=p.device)
                for p in tree_leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=lead.device)
        return mbs, gsum, loss

    def micro(params, mb, gsum, loss):
        """One microbatch's loss and gradient, added to the sums."""
        l, _, g = grad_fn(params, mb)
        return [a + b.to(adt) for a, b in zip(gsum, tree_leaves(g))], \
            loss + l

    def update(state, grads, gnorm, loss, metrics):
        """The optimizer update with the clipped gradients, and the step's
        metrics.  The callers clip: rebinding their ``grads`` frees the
        unclipped ones before the update."""
        params = state["params"]
        with torch.no_grad():
            new_params, new_opt = optimizer.update(
                grads, state["opt"], params, state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        out_metrics = {"loss": loss, "grad_norm": gnorm.detach(), **metrics}
        return new_state, out_metrics

    def finish(state, gsum, loss):
        """The sums' mean in float32, then the update; ``gsum`` is emptied
        so the sums are freed before the update."""
        grads = tree_unflatten(tree_structure(state["params"]),
                               [(g / accum).to(torch.float32) for g in gsum])
        gsum.clear()
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        loss = loss / accum
        return update(state, grads, gnorm, loss,
                      {"ce": loss, "aux": torch.zeros(
                          (), dtype=torch.float32, device=loss.device)})

    def train_step(state, batch):
        params = state["params"]
        if accum <= 1:
            loss, metrics, grads = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            return update(state, grads, gnorm, loss, metrics)
        mbs, gsum, loss = begin(params, batch)
        for i in range(accum):
            gsum, loss = micro(params, {k: v[i] for k, v in mbs.items()},
                               gsum, loss)
        return finish(state, gsum, loss)

    train_step.parts = (begin, micro, finish)
    return train_step


def make_prefill_step(cfg: ModelConfig, ann=L.NULL_ANN):
    """``prefill(params, inputs) -> (next_token (B,) int32, caches)``."""
    @torch.no_grad()
    def prefill(params, inputs):
        logits, _, caches = forward_logits(params, cfg, inputs,
                                           collect_kv=True,
                                           last_token_only=True, ann=ann)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, caches
    return prefill


def make_decode_step(cfg: ModelConfig, ann=L.NULL_ANN):
    """``decode(params, caches, {"tokens", "pos"}) -> (next_token (B, 1)
    int32, caches)``; the caches given are consumed (written in place)."""
    @torch.no_grad()
    def decode(params, caches, inputs):
        logits, new_caches = forward_decode(params, cfg, caches,
                                            inputs["tokens"], inputs["pos"],
                                            ann=ann)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token[:, None], new_caches
    return decode


def init_state(cfg: ModelConfig, optimizer: Optimizer, gen: torch.Generator,
               device: Any) -> dict:
    params = init_params(cfg, gen, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Input / cache specs: shapes and dtypes as ``meta`` tensors, no allocation
# ---------------------------------------------------------------------------

def _spec(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=L.dtype_of(dtype), device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors standing in for every model input of this (arch,
    shape)."""
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.dtype
    if shape.mode in ("train", "prefill"):
        labels = shape.mode == "train"
        if cfg.family == "audio":
            Sd = S // cfg.dec_ratio
            spec = {"frames": _spec((B, S, cfg.d_model), dt),
                    "dec_tokens": _spec((B, Sd), "int32")}
            if labels:
                spec["labels"] = _spec((B, Sd), "int32")
            return spec
        spec = {"tokens": _spec((B, S), "int32")}
        if labels:
            spec["labels"] = _spec((B, S), "int32")
        if cfg.family == "vlm":
            spec["vision_embeds"] = _spec((B, VLM_VISION_TOKENS, cfg.d_model),
                                          dt)
            spec["positions"] = _spec((3, B, S), "int32")
        return spec
    # decode
    return {"tokens": _spec((B, 1), "int32"), "pos": _spec((B,), "int32")}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """KV-cache / state ``meta`` tensors for decode shapes, as the
    reference lays them out (its audio entry gives ``k``/``v`` the
    encoder-side length and ``ck``/``cv`` the decoder-side one, the
    other way round from what prefill returns; kept as the reference
    has it)."""
    if shape.mode != "decode":
        raise ValueError("cache_specs takes a decode shape")
    B, S = shape.global_batch, shape.seq_len
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kvdt = cfg.kv_cache_dtype
    if cfg.family in ("dense", "vlm", "moe"):
        LN = cfg.num_layers
        return {"k": _spec((LN, B, S, K, hd), kvdt),
                "v": _spec((LN, B, S, K, hd), kvdt)}
    if cfg.family == "ssm":
        hs = cfg.rwkv.head_size
        H = cfg.d_model // hs
        Lx = cfg.num_layers
        return {"tm_x": _spec((Lx, B, cfg.d_model), cfg.dtype),
                "tm_s": _spec((Lx, B, H, hs, hs), "float32"),
                "cm_x": _spec((Lx, B, cfg.d_model), cfg.dtype)}
    if cfg.family == "hybrid":
        n_rec, G, n_tail = _hybrid_layout(cfg)
        lru = cfg.recurrent.lru_width or cfg.d_model
        cw = cfg.recurrent.conv1d_width
        W = cfg.recurrent.window_size
        rec = {"h": _spec((G, n_rec, B, lru), "float32"),
               "conv": _spec((G, n_rec, B, cw - 1, lru), cfg.dtype)}
        attn = {"k": _spec((G, B, W, K, hd), kvdt),
                "v": _spec((G, B, W, K, hd), kvdt)}
        caches = {"groups": {"rec": rec, "attn": attn}}
        if n_tail:
            caches["tail"] = {"h": _spec((n_tail, B, lru), "float32"),
                              "conv": _spec((n_tail, B, cw - 1, lru),
                                            cfg.dtype)}
        return caches
    if cfg.family == "audio":
        Ld = cfg.num_decoder_layers
        Se = S // cfg.dec_ratio
        return {"k": _spec((Ld, B, S, K, hd), kvdt),
                "v": _spec((Ld, B, S, K, hd), kvdt),
                "ck": _spec((Ld, B, Se, K, hd), kvdt),
                "cv": _spec((Ld, B, Se, K, hd), kvdt)}
    raise ValueError(cfg.family)


def state_specs(cfg: ModelConfig, optimizer: Optimizer) -> dict:
    """The train state ``{"params", "opt", "step"}`` as ``meta`` tensors:
    the names, shapes and dtypes ``init_state`` builds, nothing
    allocated."""
    return init_state(cfg, optimizer, torch.Generator(), "meta")


def zeros_like_specs(specs: Any, device: Any) -> Any:
    """Zero tensors of the specs' shapes and dtypes on ``device`` (decode
    from empty caches)."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)


def build_model(cfg: ModelConfig) -> dict:
    """Convenience bundle for examples/tests."""
    return {
        "init": partial(init_params, cfg),
        "loss_fn": make_loss_fn(cfg),
        "prefill": make_prefill_step(cfg),
        "decode": make_decode_step(cfg),
        "input_specs": partial(input_specs, cfg),
        "cache_specs": partial(cache_specs, cfg),
    }


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
