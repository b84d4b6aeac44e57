"""Bind and launch the CUDA WKV-6 recurrence (``csrc/wkv6.cu``, kernel #9).

Built with ``nvcc`` at first use into ``build/`` beside this file and
bound through ``ctypes`` (``kernels/_build.py``); nothing is compiled or
loaded when the module is imported.  The launcher takes the inputs as
``ops.wkv6`` checked and cast them (float32, the shapes below, hs in
``HEAD_SIZES``) and refuses only what is not a contiguous CUDA tensor;
it runs the kernel on PyTorch's current stream into outputs it
allocates, and raises if the launch was refused (as it is for S = 0).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (NvccLibrary, ptr, raise_on,
                                        require_cuda, stream)

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = NvccLibrary(
    Path(__file__).resolve().parent / "csrc" / "wkv6.cu",
    {"wkv6_fwd": [_vp] * 8 + [_i64] * 4 + [_vp]})

#: head sizes the kernel is instantiated for (every config and test)
HEAD_SIZES = (16, 32, 64)


def wkv6(r, k, v, w, u, s0):
    """Kernel #9: (y (B, S, H, hs) f32, S_final (B, H, hs, hs) f32)."""
    require_cuda(r=r, k=k, v=v, w=w, u=u, s0=s0)
    B, S, H, hs = r.shape
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s = torch.empty(s0.shape, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = LIBRARY.load().wkv6_fwd(
            ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(s0), ptr(y), ptr(s),
            B, S, H, hs, stream(r))
    raise_on("wkv6", code)
    return y, s
