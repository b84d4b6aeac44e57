"""Bind and launch the CUDA RG-LRU scan (``csrc/rglru.cu``, kernel #8).

Built with ``nvcc`` at first use into ``build/`` beside this file and
bound through ``ctypes`` (``kernels/_build.py``); nothing is compiled or
loaded when the module is imported.  The launcher takes the inputs as
``ops.rglru_scan`` checked them (a/b of one shape and one dtype of
``DTYPES``, h0 (B, D) float32) and refuses only what is not a contiguous
CUDA tensor; it runs the kernel on PyTorch's current stream into an
output it allocates, and raises if the launch was refused.  The kernel
picks its own geometry: blocks of a few dozen channels of one batch row,
about one block an SM, each streaming its (time tile x channels) panels
of a and b through a shared-memory ring by cp.async (element loads where
a row is not whole 16-byte chunks) and running one serial chain a
channel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (NvccLibrary, ptr, raise_on,
                                        require_cuda, stream)

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = NvccLibrary(
    Path(__file__).resolve().parent / "csrc" / "rglru.cu",
    {"rglru_scan": [_vp] * 4 + [_i64] * 3 + [ctypes.c_int, _vp]})

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """Kernel #8: h (B, S, D) float32 with h_t = a_t * h_{t-1} + b_t."""
    require_cuda(a=a, b=b, h0=h0)
    B, S, D = a.shape
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        code = LIBRARY.load().rglru_scan(ptr(a), ptr(b), ptr(h0), ptr(h),
                                         B, S, D, DTYPES[a.dtype], stream(a))
    raise_on("rglru_scan", code)
    return h
