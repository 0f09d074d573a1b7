"""Grouped-query attention with streaming-softmax kv-chunking.

Counterpart of ``repro.models.attention`` for the port's dense decoder:
``gqa_attention`` (the prefill path, a kv-chunk loop with the running
(max, denom, acc) softmax -- not SDPA, so the numbers follow the
reference), ``_decode_attention`` (single-token attention over the whole
cache) and the QKV/output projections.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG, BIG_WINDOW, decode_mask, dtype_scalar


def gqa_attention(
    q: torch.Tensor,                      # (B, Sq, H, hd)
    k: torch.Tensor,                      # (B, Sk, KV, hd)
    v: torch.Tensor,                      # (B, Sk, KV, hd)
    *,
    q_positions: Optional[torch.Tensor] = None,   # (B, Sq) absolute positions
    kv_valid_len=None,                            # () or (B,) valid cache slots
    causal: bool = True,
    window: Optional[int] = None,                 # static sliding window
    window_arr: Optional[torch.Tensor] = None,    # dynamic () window
    kv_positions: Optional[torch.Tensor] = None,  # (Sk,) or (B, Sk) ring slots
    chunk: int = 512,
) -> torch.Tensor:
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    groups = h // kv
    dev = q.device

    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32, device=dev)[None].expand(b, sq)

    if sq == 1:
        return _decode_attention(
            q, k, v,
            q_positions=q_positions, kv_valid_len=kv_valid_len,
            causal=causal, window=window, window_arr=window_arr,
            kv_positions=kv_positions,
        )
    if kv_positions is not None:
        raise ValueError("ring-buffer caches are decode-only")

    chunk = min(chunk, sk)
    if kv_valid_len is None:
        limit = torch.full((b, 1, 1, 1), sk, dtype=torch.int64, device=dev)
    else:
        limit = torch.as_tensor(kv_valid_len, device=dev).to(torch.int64).reshape(-1, 1, 1, 1)
    if window_arr is not None:
        win = torch.as_tensor(window_arr, device=dev).to(torch.int64)
    else:
        win = BIG_WINDOW if window is None else int(window)

    qf = (q * dtype_scalar(1.0 / (hd ** 0.5), q.dtype)).float()
    row = q_positions.to(torch.int64)[:, :, None, None]            # (B, Sq, 1, 1)
    m = torch.full((b, sq, h), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, sk, chunk):
        # the reference pads the last chunk with zero K/V, whose columns
        # sit past the valid length and are masked; slicing is the same
        kci = k[:, c0:c0 + chunk].repeat_interleave(groups, dim=2)   # (B, C, H, hd)
        vci = v[:, c0:c0 + chunk].repeat_interleave(groups, dim=2)
        s = torch.einsum("bqhd,bchd->bqhc", qf, kci.float())       # (B, Sq, H, C)
        col = torch.arange(c0, c0 + kci.shape[1], dtype=torch.int64, device=dev)
        colb = col[None, None, None, :]
        valid = colb < limit
        if causal:
            valid = valid & (colb <= row) & (colb > row - win)
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhc,bchd->bqhd", p.to(vci.dtype).float(), vci.float()
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _decode_attention(
    q, k, v, *, q_positions, kv_valid_len, causal, window, window_arr,
    kv_positions=None,
):
    """Single-query attention over the whole cache, grouped GQA einsums
    without materialising repeated K/V."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    groups = h // kv
    qg = (q * dtype_scalar(1.0 / (hd ** 0.5), q.dtype)).reshape(b, sq, kv, groups, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    valid = decode_mask(
        b, sk, q.device, q_positions=q_positions.reshape(b), kv_valid_len=kv_valid_len,
        window=window, window_arr=window_arr, kv_positions=kv_positions,
        causal=causal,
    )
    s = torch.where(valid[:, None, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum(
        "bqkgs,bskd->bqkgd", (p / torch.clamp(l, min=1e-30)).to(v.dtype).float(), v.float()
    )
    return ctx.reshape(b, sq, h, hd).to(q.dtype)


# ------------------------------------------------------------ projections --


def project_qkv(cfg, p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.attn_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (
        q.reshape(b, s, cfg.n_heads, hd),
        k.reshape(b, s, cfg.n_kv_heads, hd),
        v.reshape(b, s, cfg.n_kv_heads, hd),
    )


def project_out(cfg, p: dict, ctx: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = ctx.shape
    y = ctx.reshape(b, s, h * hd) @ p["wo"].to(ctx.dtype)
    if cfg.attn_bias:
        y = y + p["bo"].to(ctx.dtype)
    return y
