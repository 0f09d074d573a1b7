"""The systolic-array INT8 GEMM with fused post-processing: wrapper over
``csrc/pu.cu`` (counterpart of ``repro.kernels.int8_gemm``).

``y = post(shift_round(w @ x + bias))`` -> int8: int8 x int8 products
summed in int32 (wrapping, as XLA's), then the power-of-two scale/shift
(round half away from zero; a negative shift is a left shift), clip to
int8, optionally ``+ residual`` and clip again, optionally ReLU.

The kernel computes ``out[p, n] = post(sum_k a[p, k] * w[n, k])`` with the
patch matrix ``a (P, M)`` as ``im2col`` writes it, and returns the HWC
feature map ``(P, N)``, which is what conv-as-GEMM wants.  The weights
come as ``(N, M)`` (``w_layout="nm"``, the public contract) or as
``(M, N)`` (``w_layout="mn"``): a conv's ``(k, k, Cin, Cout)`` weights
viewed as ``(k*k*Cin, Cout)``, which the kernel transposes while staging
them, so no weight is copied.  The public :func:`int8_gemm` keeps the
JAX package's ``(N, M) @ (M, P) -> (N, P)`` contract by transposing its
activation operand, residual and output.

:func:`gemm_plan` picks the kernel's split of the reduction from the
shape alone; the split sums and tile counters live in
``common.split_k_scratch``, zero between calls.

:func:`int8_conv_gemm` is the same kernel in its conv mode: it reads the
HWC map in place of the patch matrix and gathers each patch row's 16-byte
chunks itself (im2col folded into the operand loads, an implicit GEMM),
for the convolutions :func:`conv_mode` admits.

A CUDA tensor launches the kernel, a CPU tensor takes the plain version
(``ref.int8_gemm_ref``); a CUDA call the kernel cannot take raises.
``launches`` on :func:`int8_gemm` counts the calls of any of these
functions that went to the kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import IntLike
from repro_torch.kernels import ref
from repro_torch.kernels.common import (count_launches, cuda_stream, device_int, raise_on,
                                        split_k_scratch, use_kernel)

GEMM_BK = 64            # bytes of k per pipeline stage (csrc/pu.cu kBK)
GEMM_TILE = 64          # rows (p) and columns (n) of a block's output tile
GEMM_MIN_KT = 4         # k-tiles a split gets at the least
LAYOUTS = ("nm", "mn")


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Split of the k-tiles, and the scratch the kernel needs."""
    split: int          # blocks along k per output tile
    kt_per: int         # k-tiles (GEMM_BK bytes of k each) per split
    tiles: int          # output tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    @property
    def ws_ints(self) -> int:
        """int32 sums in the workspace, one per output of a tile (0 without
        a split)."""
        return self.tiles * GEMM_TILE ** 2 if self.split > 1 else 0

    @property
    def counters(self) -> int:
        return self.tiles if self.split > 1 else 0


@functools.lru_cache(maxsize=None)
def gemm_plan(p: int, n: int, m: int, sms: int) -> GemmPlan:
    """Split for a (P, N, M) product on a card with ``sms`` SMs.

    The k-tiles are split into as few pieces as bring the grid of
    ``GEMM_TILE`` x ``GEMM_TILE`` output tiles to two blocks per SM, each
    piece at least ``GEMM_MIN_KT`` k-tiles (fewer blocks only where M is
    too short for that; no split where the tiles alone fill the card)."""
    kt = -(-m // GEMM_BK)
    tiles = -(-p // GEMM_TILE) * -(-n // GEMM_TILE)
    per = kt
    while per > GEMM_MIN_KT and tiles * -(-kt // per) < 2 * sms:
        per -= 1
    split = -(-kt // per)
    return GemmPlan(split, -(-kt // split), tiles)   # pieces as even as the split allows


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace(dev: torch.device, stream: int, plan: GemmPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int32 sums and tile counters ``plan`` needs on ``dev`` and
    ``stream``, both zero between calls."""
    return split_k_scratch("int8_gemm", dev, stream, plan.ws_ints, torch.int32, plan.counters)


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
    w: torch.Tensor,                       # (N, M) int8 weights, or (M, N) with w_layout="mn"
    bias: Optional[torch.Tensor] = None,   # (N,) int32
    shift: IntLike = 0,
    residual: Optional[torch.Tensor] = None,   # (P, N) int8
    *,
    relu: bool = False,
    w_layout: str = "nm",
) -> torch.Tensor:
    """``post(a @ w.T + bias)`` -> (P, N) int8, in the kernel's own layout."""
    if w_layout not in LAYOUTS:
        raise ValueError(f"w_layout must be one of {LAYOUTS}, got {w_layout!r}")
    kn = w_layout == "mn"
    if not use_kernel(a):
        res = None if residual is None else residual.T
        return ref.int8_gemm_ref(w.T if kn else w, a.T, bias, shift, relu, res).T
    p, m = a.shape
    n = w.shape[1] if kn else w.shape[0]
    dev = a.device
    _check("a", a, (p, m), dev, torch.int8)
    _check("w", w, (m, n) if kn else (n, m), dev, torch.int8)
    shift_t = device_int(shift, "shift", dev)
    out = torch.empty((p, n), dtype=torch.int8, device=dev)
    plan = gemm_plan(p, n, m, _sm_count(dev))
    stream = cuda_stream()
    ws, cnt = workspace(dev, stream, plan)
    from repro_torch.kernels import build

    err = build.load("pu").repro_int8_gemm(
        a.data_ptr(), w.data_ptr(), _check("bias", bias, (n,), dev, torch.int32),
        shift_t.data_ptr(), _check("residual", residual, (p, n), dev, torch.int8),
        out.data_ptr(), p, n, m, int(relu), int(kn), plan.split, plan.kt_per,
        ws.data_ptr(), cnt.data_ptr(), stream,
    )
    raise_on(err, "int8_gemm")
    int8_gemm.launches += 1
    return out


def conv_mode(c: int, cout: int, k: int, stride: int, pad: int) -> bool:
    """Whether a convolution's GEMM gathers its own patches from the map
    (the kernel's conv mode) instead of reading a patch matrix: each
    16-byte chunk of a patch row lies in one pixel (``C % 16 == 0``) and
    the weights' rows are 16-byte aligned (``Cout % 16 == 0``).  A 1x1
    stride-1 unpadded conv reads the map as it lies and needs no gather."""
    return c % 16 == 0 and cout % 16 == 0 and not (k == 1 and stride == 1 and pad == 0)


def int8_conv_gemm(
    img: torch.Tensor,                     # (H, W, Cin) int8 map
    w4d: torch.Tensor,                     # (k, k, Cin, Cout) int8
    bias: Optional[torch.Tensor] = None,   # (Cout,) int32
    shift: IntLike = 0,
    residual: Optional[torch.Tensor] = None,   # (OH, OW, Cout) int8
    *,
    k: int,
    stride: int = 1,
    pad: int = 0,
    relu: bool = False,
) -> torch.Tensor:
    """Convolution as one implicit GEMM -> (OH, OW, Cout) int8: the
    kernel's A loads gather the patches from the map (:func:`conv_mode`
    must hold, and both operands be 16-byte aligned), so no patch matrix
    is formed.  The same function as ``ref.conv2d_int8_ref``, bit for
    bit."""
    if not use_kernel(img):
        return ref.conv2d_int8_ref(img, w4d, bias, stride, pad, shift, relu, residual)
    h, w, c = img.shape
    cout = w4d.shape[-1]
    if not conv_mode(c, cout, k, stride, pad) or h + 2 * pad < k or w + 2 * pad < k:
        raise ValueError(f"the conv mode does not take a {tuple(img.shape)} map, k={k}, "
                         f"s={stride}, p={pad}, Cout={cout}")
    dev = img.device
    _check("img", img, (h, w, c), dev, torch.int8)
    _check("w4d", w4d, (k, k, c, cout), dev, torch.int8)
    if img.data_ptr() % 16 or w4d.data_ptr() % 16:
        raise ValueError("the conv mode needs a map and weights aligned to 16 bytes")
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    shift_t = device_int(shift, "shift", dev)
    out = torch.empty((oh, ow, cout), dtype=torch.int8, device=dev)
    plan = gemm_plan(oh * ow, cout, k * k * c, _sm_count(dev))
    stream = cuda_stream()
    ws, cnt = workspace(dev, stream, plan)
    from repro_torch.kernels import build

    err = build.load("pu").repro_int8_conv_gemm(
        img.data_ptr(), w4d.data_ptr(), _check("bias", bias, (cout,), dev, torch.int32),
        shift_t.data_ptr(), _check("residual", residual, (oh, ow, cout), dev, torch.int8),
        out.data_ptr(), h, w, c, k, stride, pad, cout, int(relu), plan.split, plan.kt_per,
        ws.data_ptr(), cnt.data_ptr(), stream,
    )
    raise_on(err, "int8_conv_gemm")
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
