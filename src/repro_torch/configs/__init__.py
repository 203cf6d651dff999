"""Architecture config registry of the port: ``get_config(arch)``, and
``resolve_serving_arch``, the fleet's lookup of a ``TierSpec.arch``.

Every arch of the JAX package is listed: the dense, vlm and encoder
transformers (hubert-xlarge prefills only), the MoE transformers
(mixtral-8x22b with its sliding window, arctic-480b with its dense
residual), rwkv6 and zamba2.  The job arch ``sd21`` (the
paper's Stable Diffusion 2.1 deployment units) is served by
``serving/diffusion.py``.
"""
from __future__ import annotations

import importlib
from typing import Tuple, Union

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


# Serving arches that are NOT token LMs: they resolve to a job-engine
# descriptor (the paper's Table-1 deployment units) instead of a
# ``ModelConfig``, and the fleet serves them with ``DiffusionEngine``.
JOB_ARCHES: Tuple[str, ...] = ("sd21",)


def resolve_serving_arch(arch: str) -> Union[ModelConfig, tuple]:
    """name -> what serves it: a ``ModelConfig`` for token-LM arches, or
    the DU-profile tuple for diffusion-style job arches (``sd21``).

    The fleet's fail-fast check of ``TierSpec.arch`` at construction: an
    unknown arch raises ``KeyError`` with the known names, as in JAX."""
    if arch in JOB_ARCHES:
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        return mod.paper_deployment_units()
    try:
        return get_config(arch)
    except KeyError:
        known = sorted(_ARCH_MODULES) + sorted(JOB_ARCHES)
        raise KeyError(f"unknown serving arch {arch!r}; known: {known}") from None


def serving_family(arch: str) -> str:
    """Model family string for a serving arch (``"job"`` for job-engine
    arches like sd21): what model-compatibility routing keys on."""
    if arch in JOB_ARCHES:
        return "job"
    return get_config(arch).family


__all__ = ["ARCH_IDS", "JOB_ARCHES", "ModelConfig", "get_config", "resolve_serving_arch",
           "serving_family"]
