"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

import importlib

from ..models import ModelConfig

_MODULES = {
    "smollm-360m": "smollm_360m",
    "granite-34b": "granite_34b",
    "chatglm3-6b": "chatglm3_6b",
    "stablelm-1.6b": "stablelm_1_6b",
    "whisper-small": "whisper_small",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "rwkv6-7b": "rwkv6_7b",
    "internvl2-2b": "internvl2_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "deepseek-v3-671b": "deepseek_v3",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    """The full published configuration (dry-run / AOT only)."""
    return _mod(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    """Reduced same-family configuration (CPU-runnable smoke tests)."""
    return _mod(arch_id).SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
