"""Config registry of the port: ``get_config(arch_id)`` for the archs it serves."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import olmo_1b
from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    smoke_variant,
)

_CONFIGS: Dict[str, ModelConfig] = {c.name: c for c in (olmo_1b.CONFIG,)}

ARCH_IDS: Tuple[str, ...] = tuple(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "SHAPES_BY_NAME",
    "ARCH_IDS",
    "get_config",
    "smoke_variant",
]
