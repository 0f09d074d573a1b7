"""INT8 quantization with power-of-two scaling factors (counterpart of
``repro.core.quant``).

The paper (SS V) evaluates ResNet models with 8-bit weights, activations
and biases on power-of-two scales, so dequantization is a bit shift:

    q = clip(round(x / 2**e), -128, 127)        with integer exponent e
    x_hat = q * 2**e

and a GEMM ``Y = W X + b`` runs as ``acc_i32 = W_q X_q + b_q`` followed by
``Y_q = shift_round(acc_i32, s)`` -- the systolic array and the scale/shift
module of the PU (Fig. 2(b)).

The int32 arithmetic follows XLA's, which the JAX package relies on:
additions and left shifts wrap modulo 2**32, a left shift by 32 or more
gives 0, an arithmetic right shift by 32 or more fills with the sign bit.
:func:`shift_round` computes in int64 and wraps explicitly, so the result
is the same on every device and for every shift, whatever torch's own
out-of-range shift behaviour is.  ``shift`` may be a device tensor: no
function here reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

INT8_MIN = -128
INT8_MAX = 127

IntLike = Union[int, torch.Tensor]


@dataclasses.dataclass
class QTensor:
    """An int8 tensor with a power-of-two scale: value = q * 2**exp.

    ``exp`` is a 0-d int32 tensor (one exponent per tensor, as the paper's
    scale/shift module applies one shift per layer output)."""

    q: torch.Tensor       # int8 payload
    exp: torch.Tensor     # () int32 exponent

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * torch.exp2(self.exp.to(torch.float32))

    def to(self, device) -> "QTensor":
        return QTensor(q=self.q.to(device), exp=self.exp.to(device))

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype


def pow2_exponent(x: torch.Tensor) -> torch.Tensor:
    """Smallest integer e such that max|x| / 2**e fits the int8 range."""
    amax = torch.clamp(x.abs().amax(), min=1e-30)
    # amax / 2**e <= 127  =>  e >= log2(amax / 127)
    return torch.ceil(torch.log2(amax / float(INT8_MAX))).to(torch.int32)


def quantize(x: torch.Tensor, exp: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize a float tensor to int8 with a power-of-two scale
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    if exp is None:
        exp = pow2_exponent(x)
    scale = torch.exp2(exp.to(torch.float32))
    q = torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX).to(torch.int8)
    return QTensor(q=q, exp=exp)


def dequantize(t: QTensor) -> torch.Tensor:
    return t.dequantize()


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's range modulo 2**32 (two's complement)."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def shift_round(acc: torch.Tensor, shift: IntLike) -> torch.Tensor:
    """Arithmetic right shift with round-half-away-from-zero, as the
    power-of-two rescale of an int32 accumulator; a negative ``shift``
    shifts left (multiplies).  Returns int32."""
    a = acc.to(torch.int64)
    s = torch.as_tensor(shift, device=a.device).to(torch.int64)
    # half = int32(1 << (s - 1)) for s > 0: 1 << 31 wraps to INT32_MIN,
    # and XLA's left shift by 32 or more gives 0
    hs = (s - 1).clamp(min=0)
    half = torch.where((s > 0) & (hs < 32), wrap_i32(torch.ones_like(hs) << hs.clamp(max=31)), 0)
    # an int32 value shifted right by >= 31 is already its sign fill
    sh = s.clamp(min=0, max=63)
    pos = wrap_i32(a + half) >> sh
    neg = wrap_i32(-(wrap_i32(wrap_i32(-a) + half) >> sh))
    right = torch.where(a >= 0, pos, neg)
    ls = (-s).clamp(min=0)
    left = torch.where(ls < 32, wrap_i32(a << ls.clamp(max=31)), 0)
    return torch.where(s >= 0, right, left).to(torch.int32)


def requantize_i32(acc: torch.Tensor, acc_exp: IntLike, out_exp: IntLike) -> torch.Tensor:
    """Rescale an int32 accumulator with exponent ``acc_exp`` onto the
    output grid ``out_exp`` and saturate to int8: the scale/shift module."""
    shift = torch.as_tensor(out_exp, device=acc.device) - torch.as_tensor(acc_exp, device=acc.device)
    y = shift_round(acc, shift.to(torch.int32))
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def quantized_linear_exponents(w_exp: torch.Tensor, x_exp: torch.Tensor) -> torch.Tensor:
    """Exponent of the int32 accumulator of W_q @ X_q."""
    return (w_exp + x_exp).to(torch.int32)


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize round trip (accuracy studies, AIMC baselines)."""
    return quantize(x).dequantize()
