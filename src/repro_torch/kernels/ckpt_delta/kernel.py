"""Bind and launch the CUDA delta-codec kernels (``csrc/ckpt_delta.cu``).

The source is built with ``nvcc`` at first use into ``build/`` beside
this file and bound through ``ctypes`` (``kernels/_build.py``).  Nothing
is compiled or loaded when the module is imported.

Each launcher here runs one kernel on PyTorch's current stream into
outputs the function allocates, checks the launch (the C entry point
returns ``cudaGetLastError()``) and does not synchronise.  The inputs are
validated first: CUDA float32/int8/int32 tensors, contiguous, 16-byte
aligned, a whole number of 1024-element groups.

The TPU kernels these replace are named in ``csrc/ckpt_delta.cu``; what
bounds them on the card (bytes) and what the design does about it is
written there too.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import NvccLibrary, ptr, raise_on, stream
from repro_torch.kernels.ckpt_delta.ref import GROUP

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
LIBRARY = NvccLibrary(
    Path(__file__).resolve().parent / "csrc" / "ckpt_delta.cu",
    {"ckpt_flat_lossless_encode": [_vp] * 6 + [_i64, _vp],
     "ckpt_flat_int8_encode": [_vp] * 5 + [_i64, _vp],
     "ckpt_lossless_decode": [_vp] * 4 + [_i64, _vp],
     "ckpt_delta_decode": [_vp] * 3 + [_i64, _vp],
     "ckpt_lossless_encode": [_vp] * 4 + [_i64, _vp],
     "ckpt_int8_encode": [_vp] * 4 + [_i64, _vp]})


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           numel: Optional[int] = None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _groups_of(t: torch.Tensor) -> int:
    n = t.numel()
    if n % GROUP:
        raise ValueError(f"length {n} is not a multiple of GROUP={GROUP}")
    ng = n // GROUP
    if ng >= 2 ** 31:
        raise ValueError(f"{ng} groups exceed one launch's grid")
    return ng


def lossless_encode_groups(new: torch.Tensor, base: torch.Tensor):
    """Kernel #1: (d f32, r int32, group_changed i32, group_rnnz i32)."""
    ng = _groups_of(new)
    _check("new", new, torch.float32)
    _check("base", base, torch.float32, new.numel())
    d = torch.empty_like(new)
    r = torch.empty(new.numel(), dtype=torch.int32, device=new.device)
    gc = torch.empty(ng, dtype=torch.int32, device=new.device)
    gz = torch.empty(ng, dtype=torch.int32, device=new.device)
    with torch.cuda.device(new.device):
        code = LIBRARY.load().ckpt_flat_lossless_encode(
            ptr(new), ptr(base), ptr(d), ptr(r), ptr(gc), ptr(gz),
            ng, stream(new))
    raise_on("flat_lossless_encode", code)
    return d.reshape(-1), r, gc, gz


def int8_encode_groups(new: torch.Tensor, base: torch.Tensor):
    """Kernel #2: (q int8, scale f32 per group, group_changed i32)."""
    ng = _groups_of(new)
    _check("new", new, torch.float32)
    _check("base", base, torch.float32, new.numel())
    q = torch.empty(new.numel(), dtype=torch.int8, device=new.device)
    s = torch.empty(ng, dtype=torch.float32, device=new.device)
    gc = torch.empty(ng, dtype=torch.int32, device=new.device)
    with torch.cuda.device(new.device):
        code = LIBRARY.load().ckpt_flat_int8_encode(
            ptr(new), ptr(base), ptr(q), ptr(s), ptr(gc), ng,
            stream(new))
    raise_on("flat_int8_encode", code)
    return q, s, gc


def lossless_decode(base: torch.Tensor, d: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Kernel #3: out = f32(bits(base + d) ^ r)."""
    ng = _groups_of(base)
    _check("base", base, torch.float32)
    _check("d", d, torch.float32, base.numel())
    _check("r", r, torch.int32, base.numel())
    out = torch.empty(base.numel(), dtype=torch.float32, device=base.device)
    with torch.cuda.device(base.device):
        code = LIBRARY.load().ckpt_lossless_decode(
            ptr(base), ptr(d), ptr(r), ptr(out), ng, stream(base))
    raise_on("lossless_decode", code)
    return out


def delta_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel #4: d = q * scale[group]."""
    ng = _groups_of(q)
    _check("q", q, torch.int8)
    _check("scales", scales, torch.float32, ng)
    d = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = LIBRARY.load().ckpt_delta_decode(ptr(q), ptr(scales), ptr(d), ng,
                                         stream(q))
    raise_on("delta_decode", code)
    return d


def lossless_encode(new: torch.Tensor, base: torch.Tensor):
    """Kernel #5, the per-leaf lossless encode: (d f32, r int32), no
    statistics."""
    ng = _groups_of(new)
    _check("new", new, torch.float32)
    _check("base", base, torch.float32, new.numel())
    d = torch.empty_like(new)
    r = torch.empty(new.numel(), dtype=torch.int32, device=new.device)
    with torch.cuda.device(new.device):
        code = LIBRARY.load().ckpt_lossless_encode(
            ptr(new), ptr(base), ptr(d), ptr(r), ng, stream(new))
    raise_on("lossless_encode", code)
    return d.reshape(-1), r


def int8_encode(new: torch.Tensor, base: torch.Tensor):
    """Kernel #6, the per-leaf int8 encode: (q int8, scale f32 per group),
    no statistics."""
    ng = _groups_of(new)
    _check("new", new, torch.float32)
    _check("base", base, torch.float32, new.numel())
    q = torch.empty(new.numel(), dtype=torch.int8, device=new.device)
    s = torch.empty(ng, dtype=torch.float32, device=new.device)
    with torch.cuda.device(new.device):
        code = LIBRARY.load().ckpt_int8_encode(ptr(new), ptr(base), ptr(q),
                                        ptr(s), ng, stream(new))
    raise_on("delta_encode", code)
    return q, s
