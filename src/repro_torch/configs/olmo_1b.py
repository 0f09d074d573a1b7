"""OLMo-1B [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304,

non-parametric LayerNorm [arXiv:2402.00838].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="lm",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    rope_theta=1e4,
    norm="nonparam_ln",
    mlp="swiglu",
    tie_embeddings=True,
)
