"""Config registry: one module per assigned architecture (+ SAE configs).

``get_config(name)`` returns the exact assigned ArchConfig;
``get_reduced(name)`` the same-family CPU smoke config.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.transformer import ArchConfig
from ..models.zoo import reduce_config

ARCH_IDS = [
    "gemma_7b",
    "qwen25_32b",
    "gemma3_4b",
    "stablelm_3b",
    "hymba_15b",
    "llama32_vision_90b",
    "whisper_small",
    "mamba2_370m",
    "mixtral_8x7b",
    "deepseek_v2_236b",
]

# assignment-id <-> module-name mapping
ALIASES = {
    "gemma-7b": "gemma_7b",
    "qwen2.5-32b": "qwen25_32b",
    "gemma3-4b": "gemma3_4b",
    "stablelm-3b": "stablelm_3b",
    "hymba-1.5b": "hymba_15b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "whisper-small": "whisper_small",
    "mamba2-370m": "mamba2_370m",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    return reduce_config(get_config(name))


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
