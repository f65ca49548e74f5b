"""Architecture registry: the 10 assigned configs (+ reduced smoke variants).

``get_config(arch)`` returns the full config; ``get_smoke_config(arch)`` the
reduced same-family config used by CPU smoke tests. Exact geometry per the
assignment table; [source; tier] recorded in each module.
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHS: List[str] = [
    "smollm-135m",
    "deepseek-67b",
    "starcoder2-15b",
    "qwen3-8b",
    "llava-next-34b",
    "jamba-1.5-large-398b",
    "whisper-small",
    "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b",
    "xlstm-1.3b",
]


def _module(arch: str):
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
