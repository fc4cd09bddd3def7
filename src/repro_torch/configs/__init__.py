"""Published architecture configs used by the port, by the reference's
names: ``get_config("tinyllama-1.1b")``, ``get_config("gemma3-1b")``,
``get_config("llama3-8b")``, ``get_config("yi-34b")`` (the reference's
dense configs).
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
}


def arch_names() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"{__name__}.{_ARCH_MODULES[name]}").CONFIG
