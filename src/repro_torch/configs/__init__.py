"""Config registry of the port: ``get_config(arch_id)``.

It holds the archs the port serves (olmo-1b) and those whose decode rounds
the planner's tests plan (``runtime.serving.plan_model_streaming``):
mixtral-8x7b, mamba2-780m and internvl2-26b, copied from
``repro.configs``.  Serving one of those fails at once in
``models.api.get_api``, naming the ROADMAP step that ports its family.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import internvl2_26b, mamba2_780m, mixtral_8x7b, olmo_1b
from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    smoke_variant,
)

_CONFIGS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (olmo_1b.CONFIG, mixtral_8x7b.CONFIG, mamba2_780m.CONFIG, internvl2_26b.CONFIG)
}

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
