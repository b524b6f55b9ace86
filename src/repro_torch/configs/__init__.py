"""Architecture config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeSpec, SHAPES, TrainConfig, reduced, shape_applicable,
)

ARCHS: dict[str, str] = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "granite-8b": "repro_torch.configs.granite_8b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG


def all_arch_names() -> list[str]:
    return list(ARCHS)
