"""Mixtral-8x7B [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,

vocab=32000, 8 experts top-2, sliding-window attention [arXiv:2401.04088].
SWA makes long_500k decode sub-quadratic (window 4096) -> cell runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    window=4096,
    norm="rmsnorm",
    mlp="swiglu",
    n_experts=8,
    top_k=2,
)
