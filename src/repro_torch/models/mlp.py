"""Dense MLP (counterpart of ``repro.models.mlp.mlp_apply``).

Mixture-of-experts waits for ROADMAP queue 1 step 12.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import mlp_act


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ (p["w_gate"] if "w_gate" in p else p["w_up"]).to(dt)
    up = x @ p["w_up"].to(dt) if "w_gate" in p else None
    if cfg.mlp_bias:
        g = g + p["b_up"].to(dt)
    y = mlp_act(cfg.mlp, g, up) @ p["w_down"].to(dt)
    if cfg.mlp_bias:
        y = y + p["b_down"].to(dt)
    return y
