"""StarCoder2-15B [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576

vocab=49152, RoPE, attention biases, plain-GELU MLP [arXiv:2402.19173].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="lm",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e5,
    norm="layernorm",
    mlp="gelu",
    attn_bias=True,
    mlp_bias=True,
)
