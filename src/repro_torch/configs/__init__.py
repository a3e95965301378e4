"""Architecture registry of the port.

One module per architecture, each exporting ``CONFIG: ModelConfig`` and
``smoke()`` exactly as the reference's `repro.configs.<id>`.  Ported:
all ten of the reference's architectures, windowed ones (gemma3-4b,
mixtral-8x22b), the int8 KV cache (``kv_quant``) and zamba2-7b's shared
attention block included.  An unknown id raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = (
    "musicgen-large",
    "stablelm-3b",
    "llama3-8b",
    "minitron-8b",
    "gemma3-4b",
    "mamba2-1.3b",
    "zamba2-7b",
    "internvl2-1b",
    "qwen3-moe-235b-a22b",
    "mixtral-8x22b",
)
PORTED = ARCH_IDS               # every architecture of the reference


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).smoke()
