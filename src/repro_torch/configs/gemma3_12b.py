"""Gemma3-12B [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360

vocab=262144, head_dim 256, 5 local : 1 global attention (window 1024),
RMSNorm, SwiGLU, tied embeddings, RoPE base 1e6 [hf:google/gemma-3-1b-pt].
The reference's model, not Hugging Face's Gemma: no embedding scale, one
RoPE base, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="lm",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    rope_theta=1e6,
    window=1024,
    global_every=6,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
)
