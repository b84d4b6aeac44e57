"""Architecture config registry of the port.

Each module exposes ``CONFIG`` (the published config) and ``SMOKE`` (a
reduced same-family config for CPU tests), as in the JAX package, and the
registry lists the same ten architectures in the same order.  The model
zoo (``repro_torch.models.zoo``) runs all six families: dense, moe,
hybrid, ssm, vlm and audio.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "internlm2-20b",
    "yi-6b",
    "codeqwen1.5-7b",
    "qwen2.5-14b",
    "recurrentgemma-2b",
    "olmoe-1b-7b",
    "grok-1-314b",
    "rwkv6-3b",
    "qwen2-vl-7b",
    "whisper-small",
)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
