"""Architecture config registry of the port: ``get_config(arch)``.

Only the arches whose serving path is ported are listed; the others join
as their families are ported.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


# Serving arches that are not token LMs (the JAX package's diffusion-style
# job tiers).  Their engine, ``serving/diffusion.py``, is not ported yet, so
# the port names them only to refuse them with a clear message.
JOB_ARCHES: Tuple[str, ...] = ("sd21",)


def resolve_serving_arch(arch: str) -> ModelConfig:
    """name -> the ``ModelConfig`` that serves it: the fleet's fail-fast
    check of ``TierSpec.arch`` at construction.  An unknown arch raises
    ``KeyError`` with the known names, as in JAX; a job arch raises
    ``ValueError``: the port has no job engine yet."""
    if arch in JOB_ARCHES:
        raise ValueError(
            f"serving arch {arch!r} is a diffusion job tier; the port has no "
            "job engine yet (serving/diffusion.py is not ported)")
    try:
        return get_config(arch)
    except KeyError:
        known = sorted(_ARCH_MODULES) + sorted(JOB_ARCHES)
        raise KeyError(f"unknown serving arch {arch!r}; known: {known}") from None


__all__ = ["ARCH_IDS", "JOB_ARCHES", "ModelConfig", "get_config", "resolve_serving_arch"]
