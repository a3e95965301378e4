"""Architecture registry of the port.

One module per architecture, each exporting ``CONFIG: ModelConfig`` and
``smoke()`` exactly as the reference's `repro.configs.<id>`.  Ported:
every architecture but zamba2-7b (its `shared_attn` block), windowed
ones (gemma3-4b, mixtral-8x22b) and the int8 KV cache (``kv_quant``)
included; zamba2-7b raises ``KeyError`` with "not ported yet".
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
PORTED = ("llama3-8b", "internvl2-1b", "stablelm-3b", "mamba2-1.3b",
          "qwen3-moe-235b-a22b", "minitron-8b", "musicgen-large",
          "gemma3-4b", "mixtral-8x22b")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet; "
                       f"ported: {PORTED}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).smoke()
