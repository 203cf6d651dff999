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
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
