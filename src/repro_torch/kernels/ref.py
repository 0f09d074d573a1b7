"""Plain PyTorch versions of the kernels (the oracles).

The PU kernels (``int8_gemm``, ``im2col``, conv-as-GEMM) are integer
arithmetic and equal the JAX oracles bit for bit.  PyTorch has no integer
matrix product on CUDA, so the products run in float64: exact, since every
partial sum of int8 x int8 products over fewer than 2**38 terms stays
below 2**53.  The int32 accumulator then wraps as XLA's does
(``core.quant.wrap_i32``).

The decode oracles mirror ``repro.kernels.ref`` op for op, rounding points
included:
one rounding to the compute dtype per matrix product, then the bias, then
RoPE in float32 on the rounded value; ``(q * scale)`` rounded to the
compute dtype before the score product; the ``-1e30`` mask sentinel and
``max(l, 1e-30)``.  A Python float multiplying a low-precision tensor in
JAX is first rounded to that tensor's dtype (weak typing); torch keeps it
in float32, so :func:`dtype_scalar` rounds it first.

These run on the CPU path and, on the card, only as the comparison in
``chip_smoke.py`` and the tests.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import INT8_MAX, INT8_MIN, IntLike, shift_round, wrap_i32

NEG = -1e30
BIG_WINDOW = 2 ** 31 - 1      # int32 max: "no window"


# ------------------------------------------------------ PU datapath oracles --
# int8 weights x int8 activations -> int32 accumulate (+ int32 bias) ->
# power-of-two scale/shift -> saturate to int8 -> optional fused residual
# addition (saturating) -> optional ReLU (paper Fig. 2).


def _epilogue(acc: torch.Tensor, shift: IntLike, relu: bool,
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    y = torch.clamp(shift_round(acc, shift), INT8_MIN, INT8_MAX)
    if residual is not None:
        y = torch.clamp(y + residual.to(torch.int32), INT8_MIN, INT8_MAX)
    if relu:
        y = torch.clamp(y, min=0)
    return y.to(torch.int8)


def int8_gemm_ref(
    w: torch.Tensor,                       # (N, M) int8 weights
    x: torch.Tensor,                       # (M, P) int8 activations
    bias: Optional[torch.Tensor] = None,   # (N,) int32
    shift: IntLike = 0,                    # power-of-two rescale (right shift)
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,   # (N, P) int8, same output grid
) -> torch.Tensor:
    """Oracle for the systolic-array GEMM + post-processing chain -> (N, P) int8."""
    acc = (w.to(torch.float64) @ x.to(torch.float64)).to(torch.int64)
    if bias is not None:
        acc = acc + bias.to(torch.int64)[:, None]
    return _epilogue(wrap_i32(acc), shift, relu, residual)


def im2col_ref(img: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """Oracle for the IM2COL transform: ``img`` (H, W, C) in the paper's HWC
    order -> (OH*OW, k*k*C) patch rows, [(ki, kj) outer, C inner]; zero
    padding."""
    h, w, c = img.shape
    imgp = F.pad(img, (0, 0, pad, pad, pad, pad))
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    rows = []
    for ki in range(k):
        for kj in range(k):
            sl = imgp[ki: ki + (oh - 1) * stride + 1: stride,
                      kj: kj + (ow - 1) * stride + 1: stride]      # (OH, OW, C)
            rows.append(sl.reshape(oh * ow, c))
    return torch.cat(rows, dim=-1)


def conv2d_int8_ref(
    img: torch.Tensor,                     # (H, W, Cin) int8
    w4d: torch.Tensor,                     # (k, k, Cin, Cout) int8
    bias: Optional[torch.Tensor] = None,   # (Cout,) int32
    stride: int = 1,
    pad: int = 0,
    shift: IntLike = 0,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,   # (OH, OW, Cout) int8
) -> torch.Tensor:
    """End-to-end conv oracle through ``F.conv2d`` in float64 (exact): a
    layout-independent cross-check of the im2col + GEMM composition."""
    lhs = img.to(torch.float64).permute(2, 0, 1)[None]             # NCHW
    rhs = w4d.to(torch.float64).permute(3, 2, 0, 1)                # OIHW
    acc = F.conv2d(lhs, rhs, stride=stride, padding=pad)[0].permute(1, 2, 0)
    acc = acc.to(torch.int64)                                      # (OH, OW, Cout)
    if bias is not None:
        acc = acc + bias.to(torch.int64)
    return _epilogue(wrap_i32(acc), shift, relu, residual)


def dtype_scalar(x: float, dt: torch.dtype) -> float:
    """``x`` rounded to ``dt``, as JAX rounds a weak-typed Python scalar."""
    return torch.tensor(x, dtype=dt).item()


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(...,) int positions -> (..., hd/2) float32 angles ``pos * freq``."""
    freqs = 1.0 / (
        theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
            / head_dim
        )
    )
    return positions[..., None].to(torch.float32) * freqs


def rotate_half_split(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE of ``t`` in float32, rounded back to ``t.dtype``."""
    tf = t.to(torch.float32)
    half = t.shape[-1] // 2
    t1, t2 = tf[..., :half], tf[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)


def mlp_act(kind: str, gate: torch.Tensor, up: Optional[torch.Tensor]) -> torch.Tensor:
    """swiglu: silu(gate) * up;  gelu (tanh form, as ``jax.nn.gelu``);
    sq_relu: relu(gate) ** 2."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "sq_relu":
        r = F.relu(gate)
        return r * r
    raise ValueError(kind)


def fused_qkv_ref(
    x: torch.Tensor,                       # (B, d)
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    bq: Optional[torch.Tensor] = None,
    bk: Optional[torch.Tensor] = None,
    bv: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope: bool = True,
    theta: float = 1e4,
):
    """Oracle for :func:`decode.fused_qkv` (projection + bias + RoPE)."""
    b = x.shape[0]
    dt = x.dtype

    def proj(w, bias, h):
        y = x @ w.to(dt)
        if bias is not None:
            y = y + bias.to(dt)
        return y.reshape(b, h, head_dim)

    q = proj(wq, bq, n_heads)
    k = proj(wk, bk, n_kv_heads)
    v = proj(wv, bv, n_kv_heads)
    if rope:
        ang = rope_angles(positions, head_dim, theta)      # (B, hd/2)
        cos = torch.cos(ang)[:, None, :]
        sin = torch.sin(ang)[:, None, :]
        q = rotate_half_split(q, cos, sin)
        k = rotate_half_split(k, cos, sin)
    return q, k, v


def pow2_exact(e: torch.Tensor) -> torch.Tensor:
    """float32 ``2**e`` of integer exponents ``e`` in [-126, 127], built
    from the bits: exact on every device (XLA's float32 ``exp2`` is not at
    |e| >= 13)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def kv_quantize(x: torch.Tensor):
    """(..., hd) float -> (int8 payload, int8 exponent over the last dim):
    the int8 KV cache's power-of-two quantization
    (``repro.models.transformer.kv_quantize``), op for op: ``e =
    ceil(log2(max(amax, 1e-30) / 127))`` clipped to [-126, 126], ``q =
    clip(round(x / 2**e), -128, 127)`` (half to even, as ``jnp.round``).
    The contract with the reference: equal bits, except where ``amax /
    127`` lies within a few float32 ulps of a power of two, where the two
    ``log2`` may round apart and ``ceil`` then flips the exponent; and
    where |e| >= 13, where the reference divides by XLA's inexact
    ``exp2`` and this uses the exact power of two."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    e = torch.ceil(torch.log2(torch.clamp(amax, min=1e-30) / 127.0)).clamp(-126, 126)
    q = torch.clamp(torch.round(xf / pow2_exact(e)[..., None]), INT8_MIN, INT8_MAX)
    return q.to(torch.int8), e.to(torch.int8)


def kv_dequantize(q: torch.Tensor, e: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """int8 payload (..., hd) and exponent (...) -> ``q * 2**e`` in ``dt``
    (exact in bfloat16 and float32: |q| <= 128 takes 8 bits)."""
    return (q.float() * pow2_exact(e)[..., None]).to(dt)


def decode_mask(
    b: int,
    sk: int,
    device: torch.device,
    *,
    q_positions: Optional[torch.Tensor],
    kv_valid_len=None,
    window: Optional[int] = None,
    window_arr: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """(B, Sk) bool: which cache slots a single-token query may attend.

    Ring ``kv_positions`` (negative = never written), else
    ``col < kv_valid_len``; causal ``col <= row`` and ``col > row - win``
    on top.  Comparisons run in int64, so the int32-max default window
    cannot overflow."""
    if kv_positions is not None:
        col = kv_positions.to(torch.int64).reshape(-1, sk).expand(b, sk)
        valid = col >= 0
    else:
        col = torch.arange(sk, device=device, dtype=torch.int64)[None].expand(b, sk)
        if kv_valid_len is None:
            valid = torch.ones((b, sk), dtype=torch.bool, device=device)
        else:
            limit = torch.as_tensor(kv_valid_len, device=device).to(torch.int64)
            valid = col < limit.reshape(-1, 1)
    if causal:
        row = q_positions.to(torch.int64).reshape(b, 1)
        if window_arr is not None:
            win = torch.as_tensor(window_arr, device=device).to(torch.int64)
        else:
            win = BIG_WINDOW if window is None else int(window)
        valid = valid & (col <= row) & (col > row - win)
    return valid


def decode_attention_ref(
    q: torch.Tensor,                       # (B, Hq, hd) post-rope, unscaled
    k: torch.Tensor,                       # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    wo: torch.Tensor,                      # (Hq*hd, d)
    bo: Optional[torch.Tensor] = None,
    *,
    k_exp: Optional[torch.Tensor] = None,  # (B, Sk, Hkv) int8: k, v are an int8 cache
    v_exp: Optional[torch.Tensor] = None,
    q_positions: torch.Tensor,
    kv_valid_len=None,
    window: Optional[int] = None,
    window_arr: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Oracle for :func:`decode.fused_decode_attention` (attention + wo).
    An int8 cache is first dequantized (:func:`kv_dequantize`) to
    ``q.dtype``, as the reference's decode does before its attention."""
    if (k_exp is None) != (v_exp is None):
        raise ValueError("k_exp and v_exp come together or not at all")
    if k_exp is not None:
        k, v = kv_dequantize(k, k_exp, q.dtype), kv_dequantize(v, v_exp, q.dtype)
    b, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dt = q.dtype
    scale = dtype_scalar(1.0 / (hd ** 0.5), dt)
    qg = (q * scale).reshape(b, hkv, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    valid = decode_mask(
        b, sk, q.device, q_positions=q_positions, kv_valid_len=kv_valid_len,
        window=window, window_arr=window_arr, kv_positions=kv_positions,
        causal=causal,
    )
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    ctx = torch.einsum(
        "bkgs,bskd->bkgd", (p / denom).to(v.dtype).float(), v.float()
    ).to(dt)
    y = ctx.reshape(b, hq * hd) @ wo.to(dt)
    if bo is not None:
        y = y + bo.to(dt)
    return y


def fused_mlp_ref(
    x: torch.Tensor,                       # (B, d)
    w_up: torch.Tensor,
    w_gate: Optional[torch.Tensor] = None,
    b_up: Optional[torch.Tensor] = None,
    w_down: Optional[torch.Tensor] = None,
    b_down: Optional[torch.Tensor] = None,
    *,
    act: str = "swiglu",
) -> torch.Tensor:
    """Oracle for :func:`decode.fused_mlp` (mirrors ``models.mlp.mlp_apply``)."""
    dt = x.dtype
    g = x @ (w_gate if w_gate is not None else w_up).to(dt)
    if b_up is not None:
        g = g + b_up.to(dt)
    up = x @ w_up.to(dt) if act == "swiglu" else None
    y = mlp_act(act, g, up) @ w_down.to(dt)
    if b_down is not None:
        y = y + b_down.to(dt)
    return y
