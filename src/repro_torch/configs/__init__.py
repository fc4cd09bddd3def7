"""Published architecture configs used by the port, by the reference's
names: the dense ``tinyllama-1.1b``, ``gemma3-1b``, ``llama3-8b`` and
``yi-34b``, the MoE ``granite-moe-1b-a400m`` and ``dbrx-132b``, the VLM
``qwen2-vl-72b``, the ssm ``rwkv6-3b``, the hybrid ``recurrentgemma-9b``
and the encdec ``whisper-medium`` (``get_config(name)``): every config of
the reference.
``CONFIG.reduced()`` is the smoke-test variant, as in the reference."""

from __future__ import annotations

import importlib
from typing import List

from ..models.config import ArchConfig

__all__ = ["get_config", "arch_names"]

_ARCH_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma3-1b": "gemma3_1b",
    "llama3-8b": "llama3_8b",
    "yi-34b": "yi_34b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "dbrx-132b": "dbrx_132b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
}


def arch_names() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"{__name__}.{_ARCH_MODULES[name]}").CONFIG
