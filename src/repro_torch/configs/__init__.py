"""Architecture registry: --arch <id> selects one of the ten assigned configs.

A copy of the reference package's configs, so the port imports nothing of it;
``tests/test_torch_models.py`` pins every field of every config, and of its
``reduced()``, to the reference."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = (
    "rwkv6-7b",
    "mistral-large-123b",
    "granite-3-2b",
    "smollm-360m",
    "phi4-mini-3.8b",
    "whisper-large-v3",
    "deepseek-v2-236b",
    "grok-1-314b",
    "llava-next-mistral-7b",
    "jamba-1.5-large-398b",
)

_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "mistral-large-123b": "mistral_large_123b",
    "granite-3-2b": "granite_3_2b",
    "smollm-360m": "smollm_360m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "whisper-large-v3": "whisper_large_v3",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "grok-1-314b": "grok_1_314b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config", "get_shape"]
