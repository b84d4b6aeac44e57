"""Plain float32 reference of the ``decoder`` model module's two
architectures: a llama-style dense decoder (Yi-6B) and a top-k
mixture-of-experts decoder (OLMoE-1B-7B), their parameter tree and their
loss (the AdamW steps over it are ``adamw.py``'s).

Written from the published descriptions and the configuration files in
``khaosbench/configs``; it imports nothing of the program.  The parameter
tree has the program's names and layouts (layer weights stacked on a
leading axis), because the benchmark hands the same weights to both
sides.  Where the program departs from the published model, this
reference follows the program and the configuration file lists the
departure under ``assumed``:

* the MoE dispatch is capacity-bounded (GShard): each expert takes at
  most ``C = max(4, ceil(top_k * T / E * capacity_factor))`` of the
  (token, rank) pairs, in token-major order, and the rest are dropped;
* the top-k gate values are renormalised to sum to one;
* a Switch-style load-balancing loss (E * sum_e f_e * p_e, f_e from the
  top-1 choice) times ``router_aux_loss_coef`` is added to the loss;
* no query/key norm (OLMoE has one);
* the vocabulary is padded to a multiple of ``vocab_pad_multiple`` and
  the padded logits are masked.

Every contraction goes through ``Precision.einsum``, so the control can
put the same model in a lower precision (``FP8``) in the program's place.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import adamw
from .precision import Precision


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def is_moe(cfg: dict) -> bool:
    return "num_experts" in cfg


def param_shapes(cfg: dict) -> dict:
    """The parameter tree as nested dicts of (shape, init std); a std of
    None marks a norm scale (initialised to ones)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        head_dim(cfg)
    f, V = cfg["intermediate_size"], padded_vocab(cfg)
    out_std = 0.02 / math.sqrt(2 * L)
    layer = {
        "ln1": {"scale": ((L, d), None)},
        "ln2": {"scale": ((L, d), None)},
        "attn": {"wq": ((L, d, H, hd), 0.02), "wk": ((L, d, K, hd), 0.02),
                 "wv": ((L, d, K, hd), 0.02), "wo": ((L, H, hd, d), out_std)},
    }
    if is_moe(cfg):
        E = cfg["num_experts"]
        layer["moe"] = {"router": ((L, d, E), 0.02),
                        "w_up": ((L, E, d, f), 0.02),
                        "w_gate": ((L, E, d, f), 0.02),
                        "w_down": ((L, E, f, d), out_std)}
    else:
        layer["ffn"] = {"w_up": ((L, d, f), 0.02), "w_gate": ((L, d, f), 0.02),
                        "w_down": ((L, f, d), out_std)}
    return {"emb": {"embed": ((V, d), 0.02), "unembed": ((d, V), 0.02)},
            "final_norm": {"scale": ((d,), None)},
            "layers": layer}


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """Half-split rotary embedding of x (B, S, N, hd)."""
    hd = x.shape[-1]
    half = hd // 2
    inv = torch.tensor(1.0 / (theta ** (np.arange(half, dtype=np.float64)
                                        / half)),
                       dtype=torch.float32, device=x.device)
    ang = positions.to(torch.float32)[:, :, None] * inv
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, cfg, pr: Precision):
    B, S, _ = x.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = head_dim(cfg)
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    q = rope(pr.einsum("bsd,dnh->bsnh", x, p["wq"]), pos, cfg["rope_theta"])
    k = rope(pr.einsum("bsd,dnh->bsnh", x, p["wk"]), pos, cfg["rope_theta"])
    v = pr.einsum("bsd,dnh->bsnh", x, p["wv"])
    if H // K > 1:
        k = torch.repeat_interleave(k, H // K, dim=2)
        v = torch.repeat_interleave(v, H // K, dim=2)
    logits = pr.einsum("bqnh,bsnh->bnqs", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    o = pr.act(pr.einsum("bnqs,bsnh->bqnh", torch.softmax(logits, dim=-1),
                         v))
    return pr.act(pr.einsum("bsnh,nhd->bsd", o, p["wo"]))


def ffn(p, x, pr: Precision):
    g = pr.einsum("td,df->tf", x, p["w_gate"])
    u = pr.einsum("td,df->tf", x, p["w_up"])
    return pr.act(pr.einsum("tf,fd->td",
                            pr.act(torch.nn.functional.silu(g) * u),
                            p["w_down"]))


def moe(p, x, cfg, pr: Precision):
    """(y, aux) of the capacity-bounded top-k MoE over tokens x (T, d)."""
    T, _ = x.shape
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(pr.einsum("td,de->te", x, p["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = min(max(4, math.ceil(k * T / E * cfg["capacity_factor"])), k * T)
    flat = idx.reshape(-1)                              # token-major order
    onehot = torch.nn.functional.one_hot(flat, E)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    keep = (pos < cap).reshape(T, k)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, rank = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        we = {n: w[e] for n, w in p.items() if n != "router"}
        out = ffn(we, x[tok], pr) * gates[tok, rank][:, None]
        y = y.index_add(0, tok, out)
    f_e = torch.nn.functional.one_hot(idx[:, 0], E).to(torch.float32).mean(0)
    aux = E * torch.sum(f_e * probs.mean(0)) * cfg["router_aux_loss_coef"]
    return y, aux


def loss_fn(params: dict, cfg: dict, tokens: torch.Tensor,
            labels: torch.Tensor, pr: Optional[Precision] = None):
    """Mean next-token cross entropy (plus the MoE balancing loss)."""
    pr = pr or Precision()
    B, S = tokens.shape
    eps = cfg["rms_norm_eps"]
    x = pr.act(params["emb"]["embed"][tokens.long()])
    aux = torch.zeros((), device=x.device)
    lay = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        li = {g: {n: w[i] for n, w in leaves.items()}
              for g, leaves in lay.items()}
        h = pr.act(rms_norm(x, li["ln1"]["scale"], eps))
        x = pr.act(x + attention(li["attn"], h, cfg, pr))
        h = pr.act(rms_norm(x, li["ln2"]["scale"], eps)).reshape(B * S, -1)
        if is_moe(cfg):
            y, a = moe(li["moe"], h, cfg, pr)
            aux = aux + a
        else:
            y = ffn(li["ffn"], h, pr)
        x = pr.act(x + y.reshape(B, S, -1))
    x = pr.act(rms_norm(x, params["final_norm"]["scale"], eps))
    logits = pr.einsum("bsd,dv->bsv", x, params["emb"]["unembed"])
    V = cfg["vocab_size"]
    if logits.shape[-1] > V:
        logits = logits[..., :V]        # the padded rows are masked out
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(B * S, V), labels.reshape(-1).long())
    return ce + aux


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_steps(params: dict, cfg: dict, opt: dict, batches: list,
                pr: Optional[Precision] = None) -> dict:
    """``adamw.train_steps`` over this model's loss."""
    return adamw.train_steps(
        lambda p, tokens, labels: loss_fn(p, cfg, tokens, labels, pr),
        params, opt, batches)
