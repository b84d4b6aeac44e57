"""Build, bind and launch the CUDA delta-codec kernels (``csrc/ckpt_delta.cu``).

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and bound through ``ctypes`` (a build of seconds,
where ``torch.utils.cpp_extension.load`` takes minutes).  The library
lands in ``build/`` beside this file, named by the source's hash, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
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
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.ckpt_delta.ref import GROUP

SOURCE = Path(__file__).resolve().parent / "csrc" / "ckpt_delta.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the ckpt_delta kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libckpt_delta-{digest[:12]}.so"


def build() -> Path:
    """Compile the source unless a library of this exact source exists.
    Returns the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            sigs = {
                "ckpt_flat_lossless_encode": [vp] * 6 + [i64, vp],
                "ckpt_flat_int8_encode": [vp] * 5 + [i64, vp],
                "ckpt_lossless_decode": [vp] * 4 + [i64, vp],
                "ckpt_delta_decode": [vp] * 3 + [i64, vp],
                "ckpt_lossless_encode": [vp] * 4 + [i64, vp],
                "ckpt_int8_encode": [vp] * 4 + [i64, vp],
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


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


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


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
        code = _load().ckpt_flat_lossless_encode(
            _ptr(new), _ptr(base), _ptr(d), _ptr(r), _ptr(gc), _ptr(gz),
            ng, _stream(new))
    _raise_on("flat_lossless_encode", code)
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
        code = _load().ckpt_flat_int8_encode(
            _ptr(new), _ptr(base), _ptr(q), _ptr(s), _ptr(gc), ng,
            _stream(new))
    _raise_on("flat_int8_encode", code)
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
        code = _load().ckpt_lossless_decode(
            _ptr(base), _ptr(d), _ptr(r), _ptr(out), ng, _stream(base))
    _raise_on("lossless_decode", code)
    return out


def delta_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel #4: d = q * scale[group]."""
    ng = _groups_of(q)
    _check("q", q, torch.int8)
    _check("scales", scales, torch.float32, ng)
    d = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _load().ckpt_delta_decode(_ptr(q), _ptr(scales), _ptr(d), ng,
                                         _stream(q))
    _raise_on("delta_decode", code)
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
        code = _load().ckpt_lossless_encode(
            _ptr(new), _ptr(base), _ptr(d), _ptr(r), ng, _stream(new))
    _raise_on("lossless_encode", code)
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
        code = _load().ckpt_int8_encode(_ptr(new), _ptr(base), _ptr(q),
                                        _ptr(s), ng, _stream(new))
    _raise_on("delta_encode", code)
    return q, s
