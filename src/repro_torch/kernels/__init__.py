"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from repro_torch.kernels.common import reset_launches
from repro_torch.kernels.decode import (
    fused_decode_attention,
    fused_mlp,
    fused_qkv,
)
from repro_torch.kernels.ops import (
    conv2d_int8,
    conv2d_int8_ref,
    im2col,
    im2col_ref,
    int8_gemm,
    int8_gemm_ref,
    niu_refresh,
    niu_refresh_ref,
)
from repro_torch.kernels.ref import decode_attention_ref, fused_mlp_ref, fused_qkv_ref

__all__ = [
    "fused_qkv",
    "fused_decode_attention",
    "fused_mlp",
    "int8_gemm",
    "im2col",
    "conv2d_int8",
    "niu_refresh",
    "reset_launches",
    "fused_qkv_ref",
    "decode_attention_ref",
    "fused_mlp_ref",
    "int8_gemm_ref",
    "im2col_ref",
    "conv2d_int8_ref",
    "niu_refresh_ref",
]
