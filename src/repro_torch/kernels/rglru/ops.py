"""Dispatching wrapper of the RG-LRU scan: ``rglru_scan(a, b, h0)``.

A CPU tensor takes the plain PyTorch version (``ref.py``) right after the
shape checks, in any float dtypes, as the JAX op takes them.  Any other
tensor is held to what the CUDA kernel is built for, a and b of one dtype
of ``DTYPES`` (so a ``meta`` tensor shows the rule without a card), and
then a CUDA tensor launches the kernel (``kernel.py``), with no fallback:
a kernel that cannot build or launch raises; any other device raises.
Each launch of the kernel adds one to ``rglru_scan.launches``
(``launch_counts``/``reset_launch_counts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru import kernel as _k
from repro_torch.kernels.rglru.ref import rglru_ref

DTYPES = tuple(_k.DTYPES)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t: a, b (B, S, D) (on a CUDA device
    float32 or bfloat16 of one dtype), h0 (B, D) -> h (B, S, D)
    float32."""
    if a.dim() != 3 or b.shape != a.shape or \
            tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}: want (B,S,D), (B,S,D), "
                         f"(B,D)")
    if a.device.type == "cpu":
        return rglru_ref(a, b, h0)
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one of {list(DTYPES)}, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"no rglru implementation for device {a.device}")
    h = _k.rglru_scan(a.contiguous(), b.contiguous(),
                      h0.to(torch.float32).contiguous())
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0


def launch_counts() -> dict:
    return {"rglru_scan": rglru_scan.launches}


def reset_launch_counts() -> None:
    rglru_scan.launches = 0


__all__ = ["rglru_scan", "rglru_ref", "launch_counts", "reset_launch_counts"]
