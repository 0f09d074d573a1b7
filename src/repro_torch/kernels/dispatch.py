"""Model -> kernel dispatch for the decode path (counterpart of
``repro.kernels.dispatch``).

The models call these wrappers instead of :mod:`decode` directly.  The
kernels are active when ``cfg.decode_kernels`` is set (threaded from
``ServeConfig.decode_kernels``) and the step is a single-token decode;
``REPRO_DECODE_KERNELS=0`` switches them off without replumbing configs.
That selects the composed path, a mode the user chose, not a fallback.

The reference's ``kernel_blocks``/``_slab`` are not carried over: they
size blocks against a 4 MiB TPU VMEM budget, and the CUDA kernels choose
their own tiles.

Kept out of the kernels, as the reference keeps them out: the KV-cache
write between QKV and attention, norms and residuals, and MoE MLPs.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.kernels import decode

_ENV_KILL = "REPRO_DECODE_KERNELS"


def enabled(cfg) -> bool:
    """True when the decode kernels are switched on for this model."""
    if os.environ.get(_ENV_KILL, "1") in ("0", "false", "False", "no"):
        return False
    return bool(getattr(cfg, "decode_kernels", False))


def _single_token(x: torch.Tensor) -> bool:
    return x.dim() == 3 and x.shape[1] == 1


def attention_active(cfg, x: torch.Tensor) -> bool:
    """Fused QKV/attention applies: flag on + single-token decode step."""
    return enabled(cfg) and _single_token(x)


def mlp_active(cfg, x: torch.Tensor) -> bool:
    """Fused MLP applies: flag on + single token + dense (non-MoE) MLP."""
    return enabled(cfg) and _single_token(x) and not getattr(cfg, "is_moe", False)


def decode_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *, rope: bool):
    """(B, 1, d) -> q (B, 1, Hq, hd), k/v (B, 1, Hkv, hd) via fused_qkv."""
    b = x.shape[0]
    q, k, v = decode.fused_qkv(
        x[:, 0],
        p["wq"], p["wk"], p["wv"],
        p.get("bq"), p.get("bk"), p.get("bv"),
        positions.reshape(b).contiguous() if positions is not None else None,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope=rope,
        theta=cfg.rope_theta,
    )
    return q[:, None], k[:, None], v[:, None]


def decode_attention(
    cfg,
    p: dict,
    q: torch.Tensor,                       # (B, 1, Hq, hd)
    k: torch.Tensor,                       # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,             # (B,) or (B, 1)
    kv_valid_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    window_arr: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    k_exp: Optional[torch.Tensor] = None,  # (B, Sk, Hkv) int8: k, v are an int8 cache
    v_exp: Optional[torch.Tensor] = None,
    plan_lanes: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention + output projection -> (B, 1, d), over the bf16
    cache or the int8 one (``kv_quant``) with its exponents; ``plan_lanes``
    as in :func:`decode.fused_decode_attention`."""
    b = q.shape[0]
    y = decode.fused_decode_attention(
        q[:, 0],
        k, v,
        p["wo"], p.get("bo"),
        q_positions=q_positions.reshape(b).contiguous(),
        kv_valid_len=kv_valid_len,
        window=window,
        window_arr=window_arr,
        kv_positions=kv_positions,
        causal=causal,
        k_exp=k_exp,
        v_exp=v_exp,
        plan_lanes=plan_lanes,
    )
    return y[:, None]


def decode_mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) -> (B, 1, d) via fused_mlp (dense MLPs only)."""
    y = decode.fused_mlp(
        x[:, 0],
        p["w_up"], p.get("w_gate"), p.get("b_up"),
        p["w_down"], p.get("b_down"),
        act=cfg.mlp,
    )
    return y[:, None]
