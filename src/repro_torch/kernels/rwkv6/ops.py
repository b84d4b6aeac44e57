"""Dispatching wrapper of the WKV-6 recurrence: ``wkv6(r, k, v, w, u, s0)``.

A CPU tensor takes the plain PyTorch version (``ref.py``) right after the
shape checks, at any head size, as the JAX op takes it.  Any other tensor
is held to what the CUDA kernel is built for, hs in ``HEAD_SIZES`` (so a
``meta`` tensor shows the rule without a card), and then a CUDA tensor
launches the kernel (``kernel.py``), with no fallback: a kernel that
cannot build or launch raises; any other device raises.  Inputs are cast
to float32, as the reference casts them.  Each launch of the kernel adds
one to ``wkv6.launches`` (``launch_counts``/``reset_launch_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel as _k
from repro_torch.kernels.rwkv6.ref import wkv6_ref

HEAD_SIZES = _k.HEAD_SIZES


def wkv6(r, k, v, w, u, s0):
    """r, k, v, w (B, S, H, hs); u (H, hs); s0 (B, H, hs, hs) ->
    (y (B, S, H, hs) f32, S_final (B, H, hs, hs) f32)."""
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError("r, k, v, w must share one (B, S, H, hs) shape")
    B, S, H, hs = r.shape
    if tuple(u.shape) != (H, hs) or tuple(s0.shape) != (B, H, hs, hs):
        raise ValueError(f"u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not "
                         f"match r {tuple(r.shape)}")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} not in {HEAD_SIZES}")
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 implementation for device {r.device}")
    out = _k.wkv6(*(x.to(torch.float32).contiguous()
                    for x in (r, k, v, w, u, s0)))
    wkv6.launches += 1
    return out


wkv6.launches = 0


def launch_counts() -> dict:
    return {"wkv6": wkv6.launches}


def reset_launch_counts() -> None:
    wkv6.launches = 0


__all__ = ["wkv6", "wkv6_ref", "launch_counts", "reset_launch_counts"]
