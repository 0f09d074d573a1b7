"""Config registry of the port: ``get_config(arch_id)``.

Each config is a copy of ``repro.configs``' of the same name.  The port
serves the dense decoders olmo-1b, starcoder2-15b, nemotron-4-15b and
gemma3-12b (local:global attention windows, head_dim 256).  It also
holds mixtral-8x7b, mamba2-780m and internvl2-26b, whose decode rounds
the planner's tests plan (``runtime.serving.plan_model_streaming``);
serving one of those fails at once in ``models.api.get_api``, naming the
ROADMAP step that ports its family.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (
    gemma3_12b,
    internvl2_26b,
    mamba2_780m,
    mixtral_8x7b,
    nemotron_4_15b,
    olmo_1b,
    starcoder2_15b,
)
from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    ShapeConfig,
    smoke_variant,
)

_CONFIGS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (olmo_1b.CONFIG, starcoder2_15b.CONFIG, nemotron_4_15b.CONFIG, gemma3_12b.CONFIG,
              mixtral_8x7b.CONFIG, mamba2_780m.CONFIG, internvl2_26b.CONFIG)
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
