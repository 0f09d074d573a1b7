"""Shared model building blocks: norms, RoPE, activations.

Parameters are plain dicts of tensors; functions are pure apart from the
KV-cache write in ``transformer``.  Compute dtype is the config's (bf16 on
the main path) with float32 for norms and softmax.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import mlp_act, rope_angles, rotate_half_split

__all__ = [
    "rms_norm", "layer_norm", "apply_norm", "rope_freqs", "apply_rope",
    "mlp_act", "mlp_is_gated",
]


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(torch.float32))
    return y.to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm; with scale=bias=None this is OLMo's non-parametric LN.
    The variance is the population variance, as ``jnp.var``."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, params: Optional[dict]) -> torch.Tensor:
    kind = cfg.norm
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"] if params else None)
    if kind == "layernorm":
        return layer_norm(
            x,
            params["scale"] if params else None,
            params.get("bias") if params else None,
        )
    if kind == "nonparam_ln":      # OLMo: no learnable affine
        return layer_norm(x, None, None)
    raise ValueError(kind)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(
    x: torch.Tensor,              # (B, S, H, hd)
    positions: torch.Tensor,      # (B, S) int
    theta: float,
) -> torch.Tensor:
    angles = rope_angles(positions, x.shape[-1], theta)      # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return rotate_half_split(x, cos, sin)


def mlp_is_gated(kind: str) -> bool:
    return kind == "swiglu"
