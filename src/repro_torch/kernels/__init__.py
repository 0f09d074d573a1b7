"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from repro_torch.kernels.decode import (
    fused_decode_attention,
    fused_mlp,
    fused_qkv,
    reset_launches,
)
from repro_torch.kernels.ref import decode_attention_ref, fused_mlp_ref, fused_qkv_ref

__all__ = [
    "fused_qkv",
    "fused_decode_attention",
    "fused_mlp",
    "reset_launches",
    "fused_qkv_ref",
    "decode_attention_ref",
    "fused_mlp_ref",
]
