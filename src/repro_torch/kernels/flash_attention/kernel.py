"""Bind and launch the CUDA flash attention forward
(``csrc/flash_attention.cu``, kernel #7).

Built with ``nvcc`` at first use into ``build/`` beside this file and
bound through ``ctypes`` (``kernels/_build.py``); nothing is compiled or
loaded when the module is imported.  The launcher takes the inputs as
``ops.flash_attention`` checked them (GQA shapes, one dtype of
``DTYPES``, hd in ``HEAD_DIMS``) and refuses only what is not a
contiguous CUDA tensor; it runs the kernel on PyTorch's current stream
into an output it allocates, and raises if the launch was refused.  The
kernel chooses its own tiles and takes any sequence length.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import (NvccLibrary, ptr, raise_on,
                                        require_cuda, stream)

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = NvccLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"flash_attention_fwd": [_vp] * 4 + [_i64] * 6 + [_int, _i64,
                                                      ctypes.c_float,
                                                      ctypes.c_float, _int,
                                                      _vp]})

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the kernel is instantiated for (every config and test)
HEAD_DIMS = (64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, softcap: float) -> torch.Tensor:
    """Kernel #7: (B, S, H, hd) in q's dtype."""
    require_cuda(q=q, k=k, v=v)
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        code = LIBRARY.load().flash_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(o), B, S, Skv, H, K, hd,
            int(bool(causal)), int(window), float(softcap or 0.0),
            1.0 / math.sqrt(hd), DTYPES[q.dtype], stream(q))
    raise_on("flash_attention", code)
    return o
