"""Decoder-only transformer LM, dense (counterpart of
``repro.models.transformer``).

Parameters keep the JAX package's layout: ``(in, out)`` weight matrices
and the layers stacked on axis 0 of each leaf, so converted reference
parameters and the port's own seeded init are interchangeable.

Attention windows follow the reference's schedules (sliding window, and
gemma3's local:global layers): :func:`layer_windows` gives each layer
its window, and every path, prefill and decode, composed and kernels,
masks with it.

A pure sliding-window model with ``kv_ring`` keeps a ring KV cache of
``min(max_len, window)`` slots (:func:`ring_applies`, the reference's
rule): decode writes position ``p`` to slot ``p % slots`` and attends the
slots through their absolute positions (:func:`ring_positions`); prefill
lays its last ``window`` positions out the same way.

With ``kv_quant`` the cache is int8 with power-of-two exponents, four
leaves ``(k, v, k_exp, v_exp)``: payloads ``(L, B, S, KV, hd)`` and one
exponent per (slot, kv head), ``(L, B, S, KV)``, starting at -126
(:func:`kv_quantize`, :func:`kv_dequantize`, the reference's arithmetic).
Decode quantizes each new k, v and writes payload and exponent; the
composed path dequantizes the cache as the reference does, the kernel
path hands the int8 cache and its exponents to the attention kernel,
which dequantizes as it loads.  Prefill attends the unquantized k, v and
returns the quantized cache.

A vlm (internvl2-26b) is this decoder with its vision tower's patch
embeddings written over the first ``vision_patches`` token slots in
prefill (:func:`_embed`); the tower is a stub, as in the reference, so
callers pass the embeddings (the serving engine passes zeros).

Unlike the reference, the decode path updates the KV cache *in place*:
the cache tensors given to :func:`decode_step` / :func:`decode_stage` are
written and returned, so the serving engine's preallocated buffers are
never copied.  Callers that need the old cache clone it first.

The config flags this slice does not cover raise ``NotImplementedError``
naming the ROADMAP step that ports them (:func:`check_supported`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ref import BIG_WINDOW, kv_dequantize, kv_quantize
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import apply_norm, apply_rope, mlp_is_gated

# (condition, what, ROADMAP queue 1 step that ports it)
_LATER = (
    (lambda c: c.family in ("ssm", "hybrid", "encdec"), "the {family} family", 12),
    (lambda c: c.is_moe, "mixture-of-experts MLPs", 12),
    (lambda c: c.pos_embed != "rope", "{pos_embed} positions", 9),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config flags that later slices of the port cover."""
    for cond, what, step in _LATER:
        if cond(cfg):
            raise NotImplementedError(
                f"{what.format(family=cfg.family, pos_embed=cfg.pos_embed)} "
                f"is not ported yet (ROADMAP queue 1, step {step})"
            )


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ------------------------------------------------------------- params -----


def _norm_params(cfg, shape, device):
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        return {
            "scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device),
        }
    if cfg.norm == "nonparam_ln":
        return None
    raise ValueError(cfg.norm)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded init: normal(0.02) weights from a ``torch.Generator`` on the
    device, stored in ``cfg.dtype``; zero biases, also in ``cfg.dtype``
    (the reference keeps them in float32 and rounds them to the compute
    dtype before adding them; the decode kernels take them rounded);
    reference norm params.  Shapes are the reference's
    (``transformer.init_params``).  The numbers differ from
    ``jax.random``'s: tests convert reference parameters with
    ``repro_torch.interop`` instead."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg)
    L, d, f, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.head_dim
    dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def normal(*shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, 0.02, generator=gen).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    a = {"wq": normal(L, d, dq), "wk": normal(L, d, dkv),
         "wv": normal(L, d, dkv), "wo": normal(L, dq, d)}
    if cfg.attn_bias:
        a.update(bq=zeros(L, dq), bk=zeros(L, dkv), bv=zeros(L, dkv), bo=zeros(L, d))
    m = {"w_up": normal(L, d, f), "w_down": normal(L, f, d)}
    if mlp_is_gated(cfg.mlp):
        m["w_gate"] = normal(L, d, f)
    if cfg.mlp_bias:
        m.update(b_up=zeros(L, f), b_down=zeros(L, d))
    layers = {
        "attn_norm": _norm_params(cfg, (L, d), device),
        "attn": a,
        "mlp_norm": _norm_params(cfg, (L, d), device),
        "mlp": m,
    }
    params = {
        "embed": normal(cfg.vocab, d),
        "final_norm": _norm_params(cfg, (d,), device),
        "layers": {k: v for k, v in layers.items() if v is not None},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal(d, cfg.vocab)
    return {k: v for k, v in params.items() if v is not None}


def _params_device(params: dict) -> torch.device:
    return params["embed"].device


def window_list(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per-layer effective attention window, as the reference's
    ``layer_windows``: with ``global_every``, layer ``i`` is global
    (``BIG_WINDOW``) when ``(i + 1) % global_every == 0`` and local
    (``window``) otherwise; a pure ``window`` config gives every layer
    ``window``; no window, ``BIG_WINDOW`` everywhere."""
    if cfg.global_every:
        local = cfg.window or BIG_WINDOW
        return tuple(BIG_WINDOW if (i + 1) % cfg.global_every == 0 else local
                     for i in range(cfg.n_layers))
    return (cfg.window or BIG_WINDOW,) * cfg.n_layers


# The windows as int32 device tensors, one per (windows, device), made once.
_WINDOWS: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def layer_windows(cfg: ModelConfig, device=None) -> torch.Tensor:
    """:func:`window_list` as an int32 tensor on ``device``, made once
    (before any capture: a CUDA graph then reads it as a static tensor),
    so no decode step copies it from the host."""
    device = torch.device("cpu") if device is None else resolve_device(device)
    key = (window_list(cfg), device)
    t = _WINDOWS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the layer windows are first needed while a CUDA graph is "
                               "captured; run the step once before capturing it")
        t = torch.tensor(key[0], dtype=torch.int32, device=device)
        if device.type == "cuda":
            # made on this thread's stream, read from any stream
            torch.cuda.current_stream(device).synchronize()
        _WINDOWS[key] = t
    return t


def ring_applies(cfg: ModelConfig) -> bool:
    """The cache is a ring: ``kv_ring`` on a pure sliding-window model (a
    model with global layers keeps its full cache), as the reference
    decides it."""
    return bool(cfg.kv_ring and cfg.window and not cfg.global_every)


def ring_positions(pos: torch.Tensor, slots: int) -> torch.Tensor:
    """The absolute position each ring slot holds once position ``pos``
    is written: ``pos - ((pos - s) mod slots)``, the modulo a floor-mod
    (``torch.fmod`` would differ on slots past ``pos``), so a slot not yet
    written comes out negative.  ``pos`` () int32 -> (slots,); (B,) ->
    (B, slots).  Computed on the device, so a captured block replays it."""
    s = torch.arange(slots, dtype=torch.int32, device=pos.device)
    if pos.dim() > 0:
        pos = pos[:, None]
    return pos - (pos - s) % slots


def _norm(cfg, x: torch.Tensor, p, plan_lanes: Optional[int]) -> torch.Tensor:
    """``apply_norm`` over a lane group's rows padded with zero rows to
    ``plan_lanes``: torch's CUDA reductions pick their split of a row from
    the row count, so a group's norm reduced at its own count could round
    other than the whole batch's, while at the batch's count each row
    reduces as it does there."""
    b = x.shape[0]
    if plan_lanes is None or plan_lanes == b:
        return apply_norm(cfg, x, p)
    pad = x.new_zeros((plan_lanes - b,) + tuple(x.shape[1:]))
    return apply_norm(cfg, torch.cat([x, pad]), p)[:b]


def _layer_slice(tree, i):
    """Layer ``i`` of a stacked params/cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------- forward ----


def _layer_fn(
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, S, D)
    lp: dict,
    window: torch.Tensor,            # () int32
    positions: torch.Tensor,         # (B, S)
    cache_kv: Optional[tuple],       # (B, Smax, KV, hd) x2 (+ (B, Smax, KV) x2 exponents)
    decode_pos: Optional[torch.Tensor],                     # () or (B,) int32
    return_kv: bool,
    write_pos: Optional[torch.Tensor] = None,     # a ring's slot of decode_pos
    kv_positions: Optional[torch.Tensor] = None,  # a ring's (Smax,) or (B, Smax) positions
    plan_lanes: Optional[int] = None,             # the batch a lane group belongs to
):
    dt = x.dtype
    # the decode kernels take the single-token hot path when
    # cfg.decode_kernels is set; the cache write stays plain torch
    use_kernels = kdispatch.attention_active(cfg, x) and cache_kv is not None
    h = _norm(cfg, x, lp.get("attn_norm"), plan_lanes)
    if use_kernels:
        q, k, v = kdispatch.decode_qkv(cfg, lp["attn"], h, positions, rope=True)
    else:
        q, k, v = attn.project_qkv(cfg, lp["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    exps = {}
    if cache_kv is not None:
        if write_pos is None:
            write_pos = decode_pos
        new = (k, v)
        if cfg.kv_quant:
            # the int8 cache takes each row's payload and exponent, k and v
            # quantized in one pass (half the launches of two)
            q8, e8 = kv_quantize(torch.stack((k, v)))
            new = (q8[0], q8[1], e8[0], e8[1])
        if decode_pos.dim() > 0:
            # one-token decode: each lane writes its row at its own position
            lanes = torch.arange(x.shape[0], device=x.device)
            for buf, val in zip(cache_kv, new):
                buf[lanes, write_pos] = val[:, 0].to(buf.dtype)
        else:
            idx = write_pos + torch.arange(x.shape[1], device=x.device)
            for buf, val in zip(cache_kv, new):
                buf.index_copy_(1, idx, val.to(buf.dtype))
        new_cache = cache_kv
        k_att, v_att = cache_kv[:2]
        if cfg.kv_quant and use_kernels:
            exps = dict(k_exp=cache_kv[2], v_exp=cache_kv[3])
        elif cfg.kv_quant:
            k_att, v_att = (kv_dequantize(c, e, dt) for c, e in zip(cache_kv[:2], cache_kv[2:]))
        valid = decode_pos + x.shape[1]
    else:
        k_att, v_att = k, v
        valid = None

    if use_kernels:
        if not exps:
            k_att, v_att = k_att.to(dt), v_att.to(dt)
        x = x + kdispatch.decode_attention(
            cfg, lp["attn"], q, k_att, v_att,
            q_positions=positions,
            kv_valid_len=valid,
            window_arr=window,
            kv_positions=kv_positions,
            plan_lanes=plan_lanes,
            **exps,
        )
    else:
        ctx = attn.gqa_attention(
            q, k_att.to(dt), v_att.to(dt),
            q_positions=positions,
            kv_valid_len=valid,
            causal=True,
            window_arr=window,
            kv_positions=kv_positions,
            chunk=cfg.attn_chunk,
        )
        x = x + attn.project_out(cfg, lp["attn"], ctx)

    h2 = _norm(cfg, x, lp.get("mlp_norm"), plan_lanes)
    if kdispatch.mlp_active(cfg, h2):
        y = kdispatch.decode_mlp(cfg, lp["mlp"], h2)
    else:
        y = mlp_mod.mlp_apply(cfg, lp["mlp"], h2)
    x = x + y
    return x, new_cache, ((k, v) if return_kv else None)


def _embed(cfg, params, tokens, patch_embeds=None):
    """Token embeddings; a vlm's ``patch_embeds`` (B, P, D), cast to the
    embedding's dtype, overwrite token slots ``0 .. P-1`` (the reference's
    ``dynamic_update_slice`` at the origin, which refuses a sequence
    shorter than the patches, as this does)."""
    x = params["embed"].to(_dtype(cfg))[tokens]
    if cfg.family == "vlm" and patch_embeds is not None:
        p = patch_embeds.shape[1]
        if p > x.shape[1] or patch_embeds.shape[0] != x.shape[0]:
            raise ValueError(
                f"patch embeddings {tuple(patch_embeds.shape)} do not fit the token "
                f"embeddings {tuple(x.shape)}: a sequence holds its {p} patches in its "
                f"first {p} slots")
        x[:, :p] = patch_embeds.to(x.dtype)
    return x


def forward_hidden(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,            # (B, S)
    patch_embeds: Optional[torch.Tensor] = None,    # (B, P, D), a vlm's
    return_cache: bool = False,
):
    """Full-sequence pass -> (hidden (B,S,D), optional kv cache (L,B,S,KV,hd) x2;
    with ``kv_quant`` the int8 payloads and their (L,B,S,KV) exponents).
    A vlm's ``patch_embeds`` take the first P token slots (:func:`_embed`)."""
    check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    x = _embed(cfg, params, tokens, patch_embeds)
    windows = layer_windows(cfg, dev)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, _, kv = _layer_fn(
            cfg, x, _layer_slice(params["layers"], i), windows[i], positions,
            None, None, return_kv=return_cache,
        )
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    x = apply_norm(cfg, x, params.get("final_norm"))
    cache = None
    if return_cache:
        cache = (torch.stack(ks), torch.stack(vs))
        if cfg.kv_quant:
            (kq, ke), (vq, ve) = kv_quantize(cache[0]), kv_quantize(cache[1])
            cache = (kq, vq, ke, ve)
    return x, cache


def _unembed_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def logits_last(cfg: ModelConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> logits of the final position (B, V), float32."""
    h_last = hidden[:, -1]
    return (h_last @ _unembed_matrix(cfg, params).to(hidden.dtype)).float()


def prefill(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    patch_embeds: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
):
    """Full-context pass -> (last-token logits (B,V), kv cache (L,B,S,KV,hd) x2,
    or with ``kv_quant`` the four leaves of the int8 cache; the attention
    inside runs on the unquantized k, v, as the reference's does).  A
    vlm's ``patch_embeds`` (B, P, D) overwrite the first P token slots.

    ``lengths`` (B,) enables bucketed batched prefill: rows are prompts
    right-padded to a shared bucket length, and logits are gathered at
    each row's last real token.  The cache keeps the padded tail; causal
    masking hides it and decode overwrites it before it becomes visible.

    A ring config (:func:`ring_applies`) returns the ring layout: past the
    window, the last ``window`` positions at slots ``position % window``;
    a prompt of at most ``window`` tokens keeps its ``s`` slots as they
    are.  The layout shifts the whole sequence, so it takes no
    ``lengths`` (the engine admits ring prompts at their exact length)."""
    if ring_applies(cfg) and lengths is not None:
        raise ValueError("bucketed prefill (lengths) is unsupported for kv_ring configs: "
                         "the ring re-layout is a whole-sequence shift")
    hidden, cache = forward_hidden(cfg, params, tokens, patch_embeds, return_cache=True)
    s = tokens.shape[1]
    if ring_applies(cfg) and s > cfg.window:
        n = cfg.window
        slots = torch.arange(s - n, s, device=tokens.device) % n

        def relayout(c):
            out = torch.empty_like(c[:, :, :n])
            out[:, :, slots] = c[:, :, s - n:]
            return out

        cache = tuple(relayout(c) for c in cache)
    if lengths is not None:
        b = tokens.shape[0]
        lanes = torch.arange(b, device=tokens.device)
        h_last = hidden[lanes, lengths.to(torch.int64) - 1]
        logits = (h_last @ _unembed_matrix(cfg, params).to(hidden.dtype)).float()
        return logits, cache
    return logits_last(cfg, params, hidden), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A zero KV cache of ``max_len`` slots a lane; a ring's holds
    ``min(max_len, window)``.  ``kv_quant``: int8 payloads and (L, B, S,
    KV) int8 exponents filled with -126, ``(k, v, k_exp, v_exp)``."""
    check_supported(cfg)
    device = resolve_device(device)
    slots = min(max_len, cfg.window) if ring_applies(cfg) else max_len
    shape = (cfg.n_layers, batch, slots, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return (
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.full(shape[:-1], -126, dtype=torch.int8, device=device),
            torch.full(shape[:-1], -126, dtype=torch.int8, device=device),
        )
    return (
        torch.zeros(shape, dtype=_dtype(cfg), device=device),
        torch.zeros(shape, dtype=_dtype(cfg), device=device),
    )


# -------------------------------------------------- layer-sliced decode ---


def _decode_positions(pos: torch.Tensor, b: int):
    """Normalise pos to (int32 pos, (B, 1) positions) for one-token decode."""
    pos = pos.to(torch.int32)
    positions = pos.expand(b)[:, None] if pos.dim() == 0 else pos[:, None]
    return pos, positions


def decode_slice_points(cfg: ModelConfig) -> Tuple[int, ...]:
    """Layer indices where a stage boundary may fall (every layer)."""
    return tuple(range(cfg.n_layers + 1))


def slice_params(cfg: ModelConfig, params: dict, layer_range) -> dict:
    """Stage-local decode params for layers [start, stop) (views)."""
    start, stop = layer_range

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[start:stop]

    return {
        "layers": cut(params["layers"]),
        "windows": layer_windows(cfg, _params_device(params))[start:stop],
    }


def slice_cache(cfg: ModelConfig, cache, layer_range):
    """Stage-local KV cache lanes for layers [start, stop) (views)."""
    start, stop = layer_range
    return tuple(a[start:stop] for a in cache)


def decode_embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, pos: torch.Tensor):
    """Token -> hidden (B, 1, D)."""
    return _embed(cfg, params, tokens)


def decode_stage(
    cfg: ModelConfig,
    stage_params: dict,
    hidden: torch.Tensor,            # (B, 1, D)
    stage_cache,
    pos: torch.Tensor,               # () or (B,) int32 -- write position
    plan_lanes: Optional[int] = None,
):
    """One token step through a contiguous layer slice -> (hidden, cache).
    The cache is updated in place and returned.  A ring's write slot and
    slot positions are computed once for the slice.  ``plan_lanes``: when
    ``hidden`` is a lane group of a larger batch, that batch's size: the
    attention kernel splits the cache as for the whole batch, and the
    norms reduce at the batch's row count (:func:`_norm`), so the group's
    lanes get the whole batch's bits (default: B)."""
    n = stage_params["windows"].shape[0]
    pos, positions = _decode_positions(pos, hidden.shape[0])
    write_pos = kv_positions = None
    if ring_applies(cfg):
        slots = stage_cache[0].shape[2]
        write_pos, kv_positions = pos % slots, ring_positions(pos, slots)
    x = hidden
    for i in range(n):
        x, _, _ = _layer_fn(
            cfg, x, _layer_slice(stage_params["layers"], i),
            stage_params["windows"][i], positions,
            tuple(c[i] for c in stage_cache), pos, return_kv=False,
            write_pos=write_pos, kv_positions=kv_positions, plan_lanes=plan_lanes,
        )
    return x, stage_cache


def decode_unembed(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                   plan_lanes: Optional[int] = None) -> torch.Tensor:
    """hidden (B, 1, D) -> logits (B, V); ``plan_lanes`` as in
    :func:`decode_stage`."""
    x = _norm(cfg, hidden, params.get("final_norm"), plan_lanes)
    return logits_last(cfg, params, x)


def decode_step(cfg: ModelConfig, params: dict, cache, tokens: torch.Tensor, pos: torch.Tensor):
    """One token step against a KV cache -> (logits (B,V), cache).

    The one-stage composition of the sliced entry points; the cache is
    updated in place."""
    check_supported(cfg)
    x = decode_embed(cfg, params, tokens, pos)
    x, cache = decode_stage(
        cfg, slice_params(cfg, params, (0, cfg.n_layers)), x, cache, pos
    )
    return decode_unembed(cfg, params, x), cache
