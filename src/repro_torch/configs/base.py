"""Model and shape configuration dataclasses (a copy of ``repro.configs.base``).

The port keeps its own copy so it imports nothing of the JAX package; the
fields, defaults and ``smoke_variant`` are the reference's, so a config
built here describes the same model as the reference's config of the same
name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # 'lm' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention flavour
    rope_theta: float = 1e4
    window: Optional[int] = None        # sliding-window size (tokens)
    global_every: Optional[int] = None  # gemma3: every Nth layer is global
    attn_bias: bool = False
    mlp_bias: bool = False
    norm: str = "rmsnorm"       # 'rmsnorm' | 'layernorm' | 'nonparam_ln'
    mlp: str = "swiglu"         # 'swiglu' | 'gelu' | 'sq_relu'
    tie_embeddings: bool = False
    pos_embed: str = "rope"     # 'rope' | 'learned' | 'sinusoidal'
    max_position: int = 524288  # size of learned position tables if used
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "auto"
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba2): shared attention block applied every N ssm layers
    hybrid_attn_every: int = 0
    # encoder-decoder (Whisper): encoder depth + stub frame count
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # VLM stub front-end: number of precomputed patch embeddings
    vision_patches: int = 0
    dtype: str = "bfloat16"
    # attention kv-chunk for the streaming-softmax prefill loop
    attn_chunk: int = 512
    # int8 KV cache with power-of-two scales
    kv_quant: bool = False
    # ring-buffer KV cache for pure sliding-window models
    kv_ring: bool = False
    # hand-written decode kernels (kernels/decode.py) on the single-token
    # serving hot path; threaded from ServeConfig.decode_kernels
    decode_kernels: bool = False
    # remat: 'none' | 'layer' (training only; kept for config parity)
    remat: str = "layer"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (analytic; used for roofline MODEL_FLOPS)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family in ("ssm",):
            attn = 0
        mlp_mats = 3 if self.mlp == "swiglu" else 2
        if self.is_moe:
            mlp = self.n_experts * mlp_mats * d * f + d * self.n_experts
        else:
            mlp = mlp_mats * d * f
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            din, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            g = 1  # single B/C group
            ssm = (
                d * (2 * din + 2 * g * ns + nh)   # in_proj (z,x,B,C,dt)
                + self.ssm_conv * (din + 2 * g * ns)
                + din * d                          # out_proj
                + 2 * nh + din                     # A, D, norm
            )
        if self.family == "ssm":
            return emb + l * (ssm + 2 * d) + d
        if self.family == "hybrid":
            shared = attn + mlp_mats * d * self.d_ff + 2 * d
            n_attn = l // max(self.hybrid_attn_every, 1)
            return emb + l * (ssm + 2 * d) + shared + d
        core = l * (attn + mlp + 2 * d) + d
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + mlp + 2 * d) + d
            cross = self.n_layers * (attn + d)
            return emb + core + enc + cross
        return emb + core

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_mats = 3 if self.mlp == "swiglu" else 2
        dense_like = self.param_count() - self.n_layers * self.n_experts * mlp_mats * d * f
        return dense_like + self.n_layers * self.top_k * mlp_mats * d * f


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if not cfg.is_moe else 64,
        vocab=512,
        max_position=1024,
    )
    if cfg.is_moe:
        changes.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2))
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        changes.update(n_layers=5, hybrid_attn_every=2)
    if cfg.family == "encdec":
        changes.update(encoder_layers=2, encoder_frames=16)
    if cfg.family == "vlm":
        changes.update(vision_patches=8)
    if cfg.window:
        changes.update(window=64)
    return dataclasses.replace(cfg, **changes)
