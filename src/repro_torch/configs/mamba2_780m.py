"""Mamba2-780M [ssm]: 48L d_model=1536, attention-free, ssm_state=128,

SSD (state-space duality) [arXiv:2405.21060].  long_500k RUNS
(sub-quadratic by construction).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,     # unused by the ssm family (kept >0 for head_dim init)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    norm="rmsnorm",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)
