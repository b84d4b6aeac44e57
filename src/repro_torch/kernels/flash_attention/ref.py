"""Plain PyTorch version of the flash attention kernel: attention with the
softmax fully materialised, in float32.

GQA (kv head = h // (H / K)), scale 1/sqrt(hd), optional logit softcap
``cap * tanh(s / cap)``, causal (k <= q) and sliding-window (q - k <
window, applied whenever window > 0) masks; masked logits are -1e30.  It
is ``repro/kernels/flash_attention/ref.py`` in PyTorch.  The score tensor
is (B, H, S, Skv) float32 and is updated in place to bound the memory.
"""
from __future__ import annotations

import math

import torch


def attention_mask(S: int, Skv: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(S, Skv) bool, True where query position q may see key position k."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    allow = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        allow &= k_pos <= q_pos
    if window > 0:
        allow &= (q_pos - k_pos) < window
    return allow


def first_keyless_row(S: int, Skv: int, *, window: int) -> int:
    """The first query row that the mask allows no key, or S if every row
    sees one.  Row q may see keys [max(0, q - window + 1), min(Skv - 1,
    causal ? q : Skv - 1)] (window <= 0: no lower bound), which is empty
    exactly when window > 0 and q >= Skv + window - 1, causal or not.
    Such a row softmaxes its -1e30 scores to a uniform row: the mean of v
    over all Skv keys."""
    if window <= 0:
        return S
    return min(S, Skv + window - 1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, Skv, K, hd) with K | H -> (B, S, H, hd)
    in q's dtype."""
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if G > 1:
        kf = kf.repeat_interleave(G, dim=2)
        vf = vf.repeat_interleave(G, dim=2)
    s = torch.einsum("bqnh,bsnh->bnqs", q.to(torch.float32), kf)
    s /= math.sqrt(hd)
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap).mul_(softcap)
    allow = attention_mask(S, Skv, causal=causal, window=window,
                           device=q.device)
    s.masked_fill_(~allow, -1e30)
    s -= s.amax(-1, keepdim=True)
    s.exp_()
    s /= s.sum(-1, keepdim=True)
    o = torch.einsum("bnqs,bsnh->bqnh", s, vf)
    return o.to(q.dtype)
