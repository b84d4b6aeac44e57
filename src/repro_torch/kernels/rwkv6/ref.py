"""Plain PyTorch version of the WKV-6 kernel: the sequential recurrence.

    y_t[j]  = sum_i r_t[i] * (S_t[i, j] + u[i] * k_t[i] * v_t[j])
    S_{t+1} = diag(w_t) S_t + k_t^T v_t

per (batch, head), in float32, as ``repro/kernels/rwkv6/ref.py`` (a
``lax.scan``) computes it, written as a Python loop over time.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0):
    """r, k, v, w (B, S, H, hs); u (H, hs); s0 (B, H, hs, hs) ->
    (y (B, S, H, hs) f32, S_final (B, H, hs, hs) f32)."""
    r, k, v, w = (x.to(torch.float32) for x in (r, k, v, w))
    uu = u.to(torch.float32)[None, :, :, None]
    s = s0.to(torch.float32)
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B, H, hs, hs)
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s
