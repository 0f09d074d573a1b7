"""InternVL2-26B [vlm]: InternViT front-end (STUB) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821].
The vision tower provides precomputed patch embeddings (256 patches) that
overwrite the leading token slots.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    rope_theta=1e6,
    norm="rmsnorm",
    mlp="swiglu",
    vision_patches=256,
)
