"""Plain float32 reference of the two trained models: a llama-style dense
decoder (Yi-6B) and a top-k mixture-of-experts decoder (OLMoE-1B-7B),
their loss, and one AdamW step.

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


def flatten(tree: dict, prefix: str = "") -> list:
    """(slash/name, leaf) pairs with dict keys in sorted order."""
    out = []
    for k in sorted(tree):
        name = f"{prefix}{k}"
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flatten(v, name + "/"))
        else:
            out.append((name, v))
    return out


def unflatten(pairs: list) -> dict:
    root: dict = {}
    for name, leaf in pairs:
        node = root
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root


# ---------------------------------------------------------------------------
# Precision of the contractions
# ---------------------------------------------------------------------------

class Precision:
    """float32 throughout (the reference)."""

    name = "float32"

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, a, b)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation where the program holds it in its compute dtype
        (the residual stream, norm outputs, the attention and FFN
        hidden states)."""
        return x


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale per tensor (amax to
    448, the largest e4m3 value), back in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _FP8Einsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        qa, qb = fake_fp8(a), fake_fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a = qa.detach().requires_grad_(True)
            b = qb.detach().requires_grad_(True)
            out = torch.einsum(ctx.eq, a, b)
        ga, gb = torch.autograd.grad(out, (a, b), fake_fp8(g))
        return None, ga, gb


class FP8(Precision):
    """The precision below bfloat16, for the control: every contraction's
    operands, forward and backward, in float8 e4m3 with a per-tensor
    scale (products accumulated in float32), and every activation the
    program holds in bfloat16 rounded to float8 e4m3 (its gradient passed
    straight through)."""

    name = "fp8_e4m3"

    def einsum(self, eq, a, b):
        return _FP8Einsum.apply(eq, a, b)

    def act(self, x):
        return x + (fake_fp8(x) - x).detach()


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
# AdamW
# ---------------------------------------------------------------------------

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


def train_steps(params: dict, cfg: dict, opt: dict, batches: list,
                pr: Optional[Precision] = None) -> dict:
    """Run ``len(batches)`` steps from ``params`` (consumed); returns the
    losses, the per-leaf norms of the first (clipped) gradient and of
    the change of each parameter over all the steps."""
    names = [n for n, _ in flatten(params)]
    p = [leaf.detach() for _, leaf in flatten(params)]
    start = [x.clone() for x in p]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    losses, first_grad = [], None
    for step, (tokens, labels) in enumerate(batches):
        leaves = [x.requires_grad_(True) for x in p]
        loss = loss_fn(unflatten(list(zip(names, leaves))), cfg, tokens,
                       labels, pr)
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
