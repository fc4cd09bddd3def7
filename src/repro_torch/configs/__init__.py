"""Published architecture configs used by the port, by the reference's
names: the dense ``tinyllama-1.1b``, ``gemma3-1b``, ``llama3-8b`` and
``yi-34b``, the MoE ``granite-moe-1b-a400m`` and ``dbrx-132b``, the VLM
``qwen2-vl-72b``, the ssm ``rwkv6-3b``, the hybrid ``recurrentgemma-9b``
and the encdec ``whisper-medium`` (``get_config(name)``): every config of
the reference, and its four input shapes (``get_shape``) with the (arch,
shape) pairs it skips and why (``is_skipped``, ``SKIPS``).
``CONFIG.reduced()`` is the smoke-test variant, as in the reference."""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import SHAPES, ArchConfig, InputShape

__all__ = ["arch_names", "get_config", "get_shape", "is_skipped", "SHAPES", "SKIPS"]

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

#: (arch, shape) pairs skipped, with the reference's reasons word for word:
#: long_500k requires a sub-quadratic decode path; pure full-attention
#: architectures have none.
SKIPS: Dict[tuple, str] = {
    ("llama3-8b", "long_500k"): "pure full attention; no sub-quadratic path",
    ("granite-moe-1b-a400m", "long_500k"): "pure full attention; no sub-quadratic path",
    ("tinyllama-1.1b", "long_500k"): "pure full attention; no sub-quadratic path",
    ("dbrx-132b", "long_500k"): "pure full attention; no sub-quadratic path",
    ("whisper-medium", "long_500k"): "full attention enc-dec; 500k ctx out of family scope",
    ("qwen2-vl-72b", "long_500k"): "pure full attention; no sub-quadratic path",
    ("yi-34b", "long_500k"): "pure full attention; no sub-quadratic path",
}


def arch_names() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"{__name__}.{_ARCH_MODULES[name]}").CONFIG


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def is_skipped(arch: str, shape: str) -> str | None:
    return SKIPS.get((arch, shape))
