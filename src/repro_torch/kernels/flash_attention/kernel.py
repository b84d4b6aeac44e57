"""Bind and launch the CUDA flash attention forward
(``csrc/flash_attention.cu``, kernel #7).

Built with ``nvcc`` at first use into ``build/`` beside this file and
bound through ``ctypes`` (``kernels/_build.py``); nothing is compiled or
loaded when the module is imported.  The launcher takes the inputs as
``ops.flash_attention`` checked them (GQA shapes, one dtype of
``DTYPES``, hd in ``HEAD_DIMS``) and refuses only what is not a
contiguous CUDA tensor; it runs the kernel on PyTorch's current stream
into an output it allocates, and raises if the launch was refused.  The
kernels read 16-byte chunks (TMA, cp.async), so an input whose storage
does not start on 16 bytes is copied first.  The kernel chooses its own
tiles and takes any sequence length; float32 runs on the CUDA cores
(register-blocked tiles of 128 query rows, 64 at hd 256, against 64-key
tiles fed by cp.async), bfloat16 on the tensor cores (wgmma on TMA-fed
tiles).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import (NvccLibrary, ptr, raise_on,
                                        require_cuda, stream)
from repro_torch.kernels.flash_attention.ref import first_keyless_row

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = NvccLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"flash_attention_fwd": [_vp] * 5 + [_i64] * 6 + [_int, _i64,
                                                      ctypes.c_float,
                                                      ctypes.c_float, _int,
                                                      _vp],
     "flash_attention_mean_v": [_vp, _vp] + [_i64] * 4 + [_int, _vp],
     "flash_attention_check_div_cap": [_vp, _int, _vp, _vp]})

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the kernel is instantiated for (every config and test)
HEAD_DIMS = (64, 128, 256)
#: softcaps (as float32) whose quotient ``div_cap`` is checked to equal
#: IEEE division; the launcher refuses a cap outside this range
SOFTCAP_RANGE = (2.0 ** -20, 2.0 ** 20)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, softcap: float) -> torch.Tensor:
    """Kernel #7: (B, S, H, hd) in q's dtype.  Where some query row sees
    no key (``first_keyless_row``), the mean of v over its positions is
    taken first by the kernel ``flash_attention_mean_v``: such rows return
    it, as the plain version's uniform softmax does."""
    require_cuda(q=q, k=k, v=v)
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    dtype = DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        lib = LIBRARY.load()
        vmean = None
        if first_keyless_row(S, Skv, window=window) < S:
            vmean = torch.empty((B, K, hd), dtype=torch.float32,
                                device=q.device)
            raise_on("flash_attention_mean_v", lib.flash_attention_mean_v(
                ptr(v), ptr(vmean), B, Skv, K, hd, dtype, stream(q)))
        code = lib.flash_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(o),
            None if vmean is None else ptr(vmean), B, S, Skv, H, K, hd,
            int(bool(causal)), int(window), float(softcap or 0.0),
            1.0 / math.sqrt(hd), dtype, stream(q))
    raise_on("flash_attention", code)
    return o


def check_div_cap(divisors: torch.Tensor) -> torch.Tensor:
    """For each float32 divisor (a CUDA tensor), how many float x with |x|
    in [2^-100, 2^100] have a softcap quotient (``div_cap``, which both
    kernels take) that differs from the IEEE quotient (``__fdiv_rn``):
    int64 counts, 0 where the kernels divide exactly."""
    require_cuda(divisors=divisors)
    out = torch.zeros(divisors.shape, dtype=torch.int64,
                      device=divisors.device)
    with torch.cuda.device(divisors.device):
        code = LIBRARY.load().flash_attention_check_div_cap(
            ptr(divisors), divisors.numel(), ptr(out), stream(divisors))
    raise_on("flash_attention_check_div_cap", code)
    return out
