"""Build one CUDA source into a shared library with ``nvcc`` and bind it
with ``ctypes``.

Each kernel family (``ckpt_delta``, ``flash_attention``, ``rglru``,
``rwkv6``) keeps its source under ``csrc/`` and its own ``build/`` beside
it.  The source is compiled at first use into a library with a plain C
interface (a build of seconds, where ``torch.utils.cpp_extension.load``
takes minutes), named by the hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is compiled or loaded when a module is imported.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``raise_on`` turns a nonzero code into an exception, so a refused launch
never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

# never --use_fast_math: the kernels rely on IEEE division and on the
# _rn intrinsics not being contracted or approximated
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


class NvccLibrary:
    """One ``.cu`` source, its build directory and the ctypes signatures
    (argument types; every entry point returns an int) of its C entry
    points."""

    def __init__(self, source: Path, signatures: dict[str, Sequence]):
        self.source = Path(source)
        self.build_dir = self.source.parent.parent / "build"
        self.signatures = dict(signatures)
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return self.build_dir / f"lib{self.source.stem}-{digest[:12]}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source
        exists.  Returns the library path."""
        out = self.path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


def require_cuda(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor is a contiguous CUDA tensor: the launchers
    pass raw pointers.  Shapes, dtypes and widths are the ``ops.py``
    wrappers' to check, on every device."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
