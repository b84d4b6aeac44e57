"""Architecture config registry of the port.

Only the dense family the port runs so far is registered; each module
exposes ``CONFIG`` (the published config) and ``SMOKE`` (a reduced
same-family config for CPU tests), as in the JAX package.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("yi-6b",)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE

