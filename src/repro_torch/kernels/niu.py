"""The Noise Injection Unit (paper SS VI): wrapper over ``csrc/niu.cu``.

Counterpart of ``repro.kernels.niu``.  Each NIU round reads the pristine
int8 weights of a tile, injects a fresh device-noise instance and writes
the int8 payload the PU consumes:

    sigma = prog_noise_scale * (0.25*|w| + 0.05*w_max)
    w'    = clip(round((drift*(w + sigma*N) + read*w_max*N') / 2^e), -128, 127)

with ``w = q * 2^e`` and ``w_max`` the tile's programmed range.  The noise
comes from a stateless counter hash (lowbias32) of (seed, element index)
and a Box-Muller transform, so the kernel and the plain version below draw
the same numbers.

The plain version runs the hash in int64 with explicit ``& 0xFFFFFFFF``:
torch on the CPU cannot shift a ``uint32`` tensor.  Every float step is
float32 and rounds where XLA's does; Python float constants are rounded to
float32 first, as XLA rounds a weak-typed scalar.  The CUDA kernel's
``logf`` / ``cosf`` may differ from the CPU's by an ulp, which can flip a
rounding, so the kernel is held to this version by a mismatch rate, not
bit for bit (``chip_smoke.py``).

``launches`` on :func:`niu_refresh` counts its calls that went to the
kernel.
"""
from __future__ import annotations

import math
import torch

from repro_torch.core.quant import IntLike
from repro_torch.kernels.common import count_launches, cuda_stream, device_int, raise_on, use_kernel

_M32 = 0xFFFFFFFF
_SALT_PROG = 0x1234567
_SALT_READ = 0x7654321
_SALT_STEP = 0x9E3779B9


def _f32(x: float) -> float:
    """``x`` rounded to float32 (XLA's weak-typed Python scalar)."""
    return torch.tensor(x, dtype=torch.float32).item()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), with no int64
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply integer mixer (lowbias32) on uint32 values held
    in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(counter: torch.Tensor, salt: int) -> torch.Tensor:
    """(0,1) float32 from the counter hash (uint32 bits / 2**32)."""
    bits = _mix(counter ^ (salt & _M32))
    u = bits.to(torch.float32) / 2.0 ** 32
    return torch.clamp(u, _f32(1e-7), _f32(1.0 - 1e-7))


def _gaussian(counter: torch.Tensor, salt: int) -> torch.Tensor:
    u1 = _uniform(counter, salt)
    u2 = _uniform(counter, salt + _SALT_STEP)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_f32(2.0 * math.pi) * u2)


def _counter(r: int, c: int, seed: IntLike, device) -> torch.Tensor:
    """Per-element counter ``(row*C + col) ^ lowbias32(seed)``; the int32
    seed is reinterpreted as uint32, so a negative seed wraps."""
    idx = torch.arange(r * c, dtype=torch.int64, device=device).reshape(r, c) & _M32
    s = torch.as_tensor(seed, device=device).to(torch.int64) & _M32
    return idx ^ _mix(s)


def niu_refresh_ref(
    q: torch.Tensor,
    exp: IntLike,
    seed: IntLike,
    *,
    prog_noise_scale: float = 0.1,
    read_noise_scale: float = 0.02,
    drift: float = 1.0,
) -> torch.Tensor:
    """Plain version: the same counter-based RNG, no tiling."""
    r, c = q.shape
    scale = torch.exp2(torch.as_tensor(exp, device=q.device).to(torch.float32))
    w = q.to(torch.float32) * scale
    w_max = w.abs().amax()
    counter = _counter(r, c, seed, q.device)
    g = _gaussian(counter, _SALT_PROG)
    sigma = _f32(prog_noise_scale) * (0.25 * w.abs() + _f32(0.05) * w_max)
    w_noisy = w + sigma * g
    if drift != 1.0:
        w_noisy = w_noisy * _f32(drift)
    if read_noise_scale > 0.0:
        g2 = _gaussian(counter, _SALT_READ)
        w_noisy = w_noisy + (_f32(read_noise_scale) * w_max) * g2
    return torch.clamp(torch.round(w_noisy / scale), -128, 127).to(torch.int8)


def niu_refresh(
    q: torch.Tensor,                       # (R, C) int8 pristine payload
    exp: IntLike,                          # () pow2 exponent
    seed: IntLike,                         # () int32
    *,
    prog_noise_scale: float = 0.1,
    read_noise_scale: float = 0.02,
    drift: float = 1.0,
) -> torch.Tensor:
    """One NIU round: a fresh noise instance on an int8 weight tile -> int8."""
    kw = dict(prog_noise_scale=prog_noise_scale, read_noise_scale=read_noise_scale, drift=drift)
    if not use_kernel(q):
        return niu_refresh_ref(q, exp, seed, **kw)
    dev = q.device
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (R, C) int8 tensor, got {q.dtype} {tuple(q.shape)}")
    r, c = q.shape
    if not 0 < r * c < 2 ** 31:
        raise ValueError(f"the kernel takes 1 to 2**31 - 1 elements, got ({r}, {c})")
    seed_t = device_int(seed, "seed", dev)
    # the scale as the plain version takes it, so both use the same value
    scale = torch.exp2(device_int(exp, "exp", dev).to(torch.float32))
    # w_max over the whole (unpadded) tile, before the kernel, as niu.py:129
    # takes it; aminmax in int8, since |-128| does not fit int8
    lo, hi = torch.aminmax(q)
    w_max = torch.maximum(-lo.to(torch.float32), hi.to(torch.float32)) * scale
    out = torch.empty_like(q)
    launch(q, out, scale, seed_t, w_max, **kw)
    niu_refresh.launches += 1
    return out


def launch(q, out, scale, seed, w_max, *, prog_noise_scale, read_noise_scale, drift):
    """The kernel alone, on arguments :func:`niu_refresh` has checked and
    prepared (``scale``, ``w_max`` () float32 and ``seed`` () int32 on the
    card); ``chip_smoke.py`` times it apart from that preparation."""
    from repro_torch.kernels import build

    r, c = q.shape
    err = build.load("niu").repro_niu_refresh(
        q.data_ptr(), out.data_ptr(), scale.data_ptr(), seed.data_ptr(), w_max.data_ptr(),
        r, c, prog_noise_scale, read_noise_scale, drift,
        int(drift != 1.0), int(read_noise_scale > 0.0), cuda_stream(),
    )
    raise_on(err, "niu_refresh")


count_launches(niu_refresh)
