"""Architecture config registry of the port.

Each module exposes ``CONFIG`` (the published config) and ``SMOKE`` (a
reduced same-family config for CPU tests), as in the JAX package.  The
model zoo runs only the dense family so far (yi-6b); recurrentgemma-2b,
rwkv6-3b and grok-1-314b are registered as data: the kernel bench
(``benchmarks/torch_bench_kernels.py``) reads its attention, RG-LRU and
WKV-6 widths from them.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("yi-6b", "recurrentgemma-2b", "rwkv6-3b", "grok-1-314b")


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE

