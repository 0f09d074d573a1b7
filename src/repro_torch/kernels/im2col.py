"""IM2COL patch extraction (paper SS II-B, Fig. 3): wrapper over
``csrc/pu.cu`` (counterpart of ``repro.kernels.im2col``).

The paper forms the patch matrix on the fly with address/length command
bundles to its DMA engine; the kernel's index arithmetic plays the
command generator.  ``(H, W, C)`` HWC map -> ``(OH*OW, k*k*C)``, columns
``(ki, kj)`` outer and C inner, zero outside the map.  Any 1-, 2- or
4-byte element type (int8, bf16, f32, ...).

A CUDA tensor launches the kernel, a CPU tensor takes the plain version
(``ref.im2col_ref``); a CUDA call the kernel cannot take raises.
``launches`` on :func:`im2col` counts the calls that went to the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.common import count_launches, cuda_stream, raise_on, use_kernel


def im2col(img: torch.Tensor, k: int, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Patch matrix (OH*OW, k*k*C) from an HWC feature map."""
    if not use_kernel(img):
        return ref.im2col_ref(img, k, stride, pad)
    if img.dim() != 3 or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous (H, W, C) tensor, got {tuple(img.shape)}")
    if img.element_size() not in (1, 2, 4):
        raise TypeError(f"the kernel copies 1-, 2- or 4-byte elements, not {img.dtype}")
    h, w, c = img.shape
    if k < 1 or stride < 1 or pad < 0 or h + 2 * pad < k or w + 2 * pad < k or c < 1:
        raise ValueError(f"bad im2col geometry: {tuple(img.shape)}, k={k}, s={stride}, p={pad}")
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    out = torch.empty((oh * ow, k * k * c), dtype=img.dtype, device=img.device)
    from repro_torch.kernels import build

    err = build.load("pu").repro_im2col(
        img.data_ptr(), out.data_ptr(), h, w, c, img.element_size(), k, stride, pad,
        cuda_stream(),
    )
    raise_on(err, "im2col")
    im2col.launches += 1
    return out


count_launches(im2col)
