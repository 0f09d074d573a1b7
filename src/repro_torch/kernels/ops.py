"""Public wrappers over the PU kernels (counterpart of ``repro.kernels.ops``).

The tensor decides, as everywhere in the port: a CUDA tensor goes to the
hand-written kernels, a CPU tensor to their plain versions.  The glue the
JAX package left to XLA outside its Pallas kernels stays plain torch here
on both paths: the k=1/pad=0 strided shortcut of :func:`im2col` (on the
card the strided 1x1 convs skip it: the GEMM's conv mode gathers them).  The
weight re-layout XLA ran around the Pallas GEMM is gone: the GEMM reads a
conv's weights as the ``(k*k*Cin, Cout)`` view they already are.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import IntLike
from repro_torch.kernels import im2col as _im2col
from repro_torch.kernels import int8_gemm as _gemm
from repro_torch.kernels import niu as _niu
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.common import use_kernel

# The JAX wrappers of these two only resolve ``interpret``; here they are
# the kernel wrappers themselves (each with its ``launches`` count).
int8_gemm = _gemm.int8_gemm          # systolic-array GEMM, fused post-processing
niu_refresh = _niu.niu_refresh       # NIU round (paper SS VI)


def im2col(img: torch.Tensor, k: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """IM2COL patch matrix (OH*OW, k*k*C) from an HWC feature map."""
    if k == 1 and pad == 0:
        # The PU's common input datapath handles k=1, p=0, s in {1,2}
        # as plain (strided) linear transfers without IM2COL (SS II-B).
        img = img[::stride, ::stride]
        h, w, c = img.shape
        return img.reshape(h * w, c)
    return _im2col.im2col(img, k, stride, pad)


def takes_conv_mode(img: torch.Tensor, w4d: torch.Tensor, k: int, stride: int, pad: int) -> bool:
    """Whether :func:`conv2d_int8` sends this convolution to the GEMM's
    conv mode: a map on the card, a geometry ``int8_gemm.conv_mode``
    admits, and both operands contiguous and 16-byte aligned."""
    return (use_kernel(img) and _gemm.conv_mode(img.shape[-1], w4d.shape[-1], k, stride, pad)
            and img.is_contiguous() and w4d.is_contiguous()
            and img.data_ptr() % 16 == 0 and w4d.data_ptr() % 16 == 0)


def conv2d_int8(
    img: torch.Tensor,                     # (H, W, Cin) int8
    w4d: torch.Tensor,                     # (k, k, Cin, Cout) int8
    bias: Optional[torch.Tensor] = None,   # (Cout,) int32
    *,
    k: int,
    stride: int = 1,
    pad: int = 0,
    shift: IntLike = 0,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,   # (OH, OW, Cout) int8
) -> torch.Tensor:
    """Convolution as GEMM: IM2COL + systolic int8 GEMM (paper Fig. 3).

    Returns (OH, OW, Cout) int8.  On the card, a convolution that
    ``int8_gemm.conv_mode`` admits, on a map and weights aligned to 16
    bytes, runs as one implicit GEMM that gathers its patches from the map
    (``int8_gemm.int8_conv_gemm``).  Any other reads the patch matrix as
    :func:`im2col` writes it, the weights as their ``(k*k*Cin, Cout)``
    view, and writes the HWC map directly (``int8_gemm.int8_gemm_pn``):
    nothing is re-laid out."""
    h, w, cin = img.shape
    cout = w4d.shape[-1]
    if takes_conv_mode(img, w4d, k, stride, pad):
        return _gemm.int8_conv_gemm(img, w4d, bias, shift, residual, k=k, stride=stride,
                                    pad=pad, relu=relu)
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    patches = im2col(img, k, stride, pad)                          # (OH*OW, kkC)
    wmat = w4d.reshape(k * k * cin, cout)                          # a view: (ki, kj, cin) outer
    res = None if residual is None else residual.reshape(oh * ow, cout)
    y = _gemm.int8_gemm_pn(patches, wmat, bias, shift, res, relu=relu, w_layout="mn")
    return y.reshape(oh, ow, cout)


# Re-export the oracles so tests and chip_smoke.py can sweep the kernels
# against them from one import site.
int8_gemm_ref = _ref.int8_gemm_ref
im2col_ref = _ref.im2col_ref
conv2d_int8_ref = _ref.conv2d_int8_ref
niu_refresh_ref = _niu.niu_refresh_ref
