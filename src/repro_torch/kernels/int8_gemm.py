"""The systolic-array INT8 GEMM with fused post-processing: wrapper over
``csrc/pu.cu`` (counterpart of ``repro.kernels.int8_gemm``).

``y = post(shift_round(w @ x + bias))`` -> int8: int8 x int8 products
summed in int32 (wrapping, as XLA's), then the power-of-two scale/shift
(round half away from zero; a negative shift is a left shift), clip to
int8, optionally ``+ residual`` and clip again, optionally ReLU.

The kernel computes ``out[p, n] = post(sum_k a[p, k] * w[n, k])``, both
operands contiguous in k: :func:`int8_gemm_pn` takes the patch matrix
``a (P, M)`` as ``im2col`` writes it and returns the HWC feature map
``(P, N)``, which is what conv-as-GEMM wants.  The public
:func:`int8_gemm` keeps the JAX package's ``(N, M) @ (M, P) -> (N, P)``
contract by transposing its activation operand, residual and output.

A CUDA tensor launches the kernel, a CPU tensor takes the plain version
(``ref.int8_gemm_ref``); a CUDA call the kernel cannot take raises.
``launches`` on :func:`int8_gemm` counts the calls of either function
that went to the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import IntLike
from repro_torch.kernels import ref
from repro_torch.kernels.common import count_launches, cuda_stream, device_int, raise_on, use_kernel


def _check(name: str, t: Optional[torch.Tensor], shape, dev, dtype):
    if t is None:
        return None
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def int8_gemm_pn(
    a: torch.Tensor,                       # (P, M) int8 patch matrix
    w: torch.Tensor,                       # (N, M) int8 weights
    bias: Optional[torch.Tensor] = None,   # (N,) int32
    shift: IntLike = 0,
    residual: Optional[torch.Tensor] = None,   # (P, N) int8
    *,
    relu: bool = False,
) -> torch.Tensor:
    """``post(a @ w.T + bias)`` -> (P, N) int8, in the kernel's own layout."""
    if not use_kernel(a):
        res = None if residual is None else residual.T
        return ref.int8_gemm_ref(w, a.T, bias, shift, relu, res).T
    p, m = a.shape
    n = w.shape[0]
    dev = a.device
    _check("a", a, (p, m), dev, torch.int8)
    _check("w", w, (n, m), dev, torch.int8)
    shift_t = device_int(shift, "shift", dev)
    out = torch.empty((p, n), dtype=torch.int8, device=dev)
    from repro_torch.kernels import build

    err = build.load("pu").repro_int8_gemm(
        a.data_ptr(), w.data_ptr(), _check("bias", bias, (n,), dev, torch.int32),
        shift_t.data_ptr(), _check("residual", residual, (p, n), dev, torch.int8),
        out.data_ptr(), p, n, m, int(relu), cuda_stream(),
    )
    raise_on(err, "int8_gemm")
    int8_gemm.launches += 1
    return out


def int8_gemm(
    w: torch.Tensor,                       # (N, M) int8
    x: torch.Tensor,                       # (M, P) int8
    bias: Optional[torch.Tensor] = None,   # (N,) int32
    shift: IntLike = 0,
    residual: Optional[torch.Tensor] = None,   # (N, P) int8
    *,
    relu: bool = False,
) -> torch.Tensor:
    """Quantized GEMM ``y = post(shift_round(w @ x + bias))`` -> (N, P) int8."""
    if not use_kernel(x):
        return ref.int8_gemm_ref(w, x, bias, shift, relu, residual)
    res = None if residual is None else residual.T.contiguous()
    return int8_gemm_pn(x.T.contiguous(), w, bias, shift, res, relu=relu).T.contiguous()


count_launches(int8_gemm)
