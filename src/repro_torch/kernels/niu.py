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
float32 at the same places as XLA's; Python float constants are rounded to
float32 first, as XLA rounds a weak-typed scalar.  The steps are not the
same to the ulp: ``torch.log`` and ``torch.cos`` differ from XLA's by an
ulp on some inputs (which, depends on the host), and the Gaussians by up
to 3 ulps (``tests/test_torch_pu_redesign.py``).  So the contract with
the reference is: the int8 result equals the JAX NIU's at every element
except those whose float32 value before rounding
(:func:`niu_prerounding_ref`) lies within 2 ulps of a half-integer
(:func:`near_half`), where it may differ by exactly 1.  The CUDA kernel
is held to this plain version on the card (``chip_smoke.py``): on an
H100 its plan's rounds have matched it bit for bit.

A round goes over every weight matrix of a model in one launch:
:func:`niu_plan` takes the pristine matrices once (their table, one output
buffer, each matrix's max |q| by one launch) and :meth:`NiuPlan.refresh`
draws a round.  :func:`niu_refresh` is a one-matrix plan.

``launches`` on :func:`niu_refresh` counts the rounds that went to the
refresh kernel, and on :func:`niu_plan` the plans whose max |q| the card
computed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

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


def niu_prerounding_ref(
    q: torch.Tensor,
    exp: IntLike,
    seed: IntLike,
    *,
    prog_noise_scale: float = 0.1,
    read_noise_scale: float = 0.02,
    drift: float = 1.0,
) -> torch.Tensor:
    """The plain version's float32 ``w' / 2^e``: the noisy weight on the
    int8 grid before it is rounded and clipped."""
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
    return w_noisy / scale


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
    pre = niu_prerounding_ref(q, exp, seed, prog_noise_scale=prog_noise_scale,
                              read_noise_scale=read_noise_scale, drift=drift)
    return torch.clamp(torch.round(pre), -128, 127).to(torch.int8)


def near_half(x: torch.Tensor, ulps: int = 2) -> torch.Tensor:
    """Where float32 ``x`` lies within ``ulps`` float32 ulps of a
    half-integer: the elements whose rounding an ulp of difference
    upstream may flip (the NIU's contract with the reference)."""
    half = torch.floor(x) + 0.5                 # the half-integer nearest x
    ulp = torch.nextafter(x.abs(), torch.tensor(math.inf)) - x.abs()
    return (x.double() - half.double()).abs() <= ulps * ulp.double()


NIU_THREADS = 256        # threads per block (csrc/niu.cu kThreads)
NIU_PER_THREAD = 16      # consecutive elements per thread (kPer)
NIU_BLOCK = NIU_THREADS * NIU_PER_THREAD
NIU_MAX_MATS = 8192      # matrices per plan (kMaxMats: their first blocks fill shared memory)
NIU_ALIGN = 16           # bytes: each output starts 16-byte aligned in the plan's buffer


def niu_first_blocks(ns: Sequence[int]) -> List[int]:
    """The kernel's grid over matrices of ``ns`` elements: matrix ``m``
    owns blocks ``[first[m], first[m + 1])``, each of ``NIU_BLOCK``
    elements; the last entry is the grid's size."""
    first = [0]
    for n in ns:
        first.append(first[-1] + -(-n // NIU_BLOCK))
    return first


def niu_block_matrix(first: Sequence[int], b: int) -> int:
    """The matrix that owns block ``b``: the kernel's binary search for the
    last ``m`` with ``first[m] <= b`` (``first`` without its last entry)."""
    lo, hi = 0, len(first) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


@dataclasses.dataclass(eq=False)
class NiuPlan:
    """One NIU round's launch over a fixed set of pristine weight matrices
    (:func:`niu_plan`).  ``outs`` are views of one int8 buffer that every
    :meth:`refresh` overwrites; the pristine matrices are only read."""
    mats: List[Tuple[torch.Tensor, IntLike]]     # (q, exp) as given
    outs: List[torch.Tensor]                     # noisy payloads, one per matrix
    table: Optional[torch.Tensor] = None         # (n_mats, 4) int64: q, out, n, first block
    exps: Optional[torch.Tensor] = None          # (n_mats,) int32
    amax: Optional[torch.Tensor] = None          # (n_mats,) int32: max |q| of each matrix
    blocks: int = 0                              # the grid

    def refresh(
        self,
        seed: IntLike,                           # one int, or (n_mats,) integers
        *,
        prog_noise_scale: float = 0.1,
        read_noise_scale: float = 0.02,
        drift: float = 1.0,
    ) -> List[torch.Tensor]:
        """One NIU round over every matrix, in one launch on the card: a
        fresh noise instance in ``outs``, which it returns.  A seed tensor
        gives each matrix its own seed."""
        kw = dict(prog_noise_scale=prog_noise_scale, read_noise_scale=read_noise_scale,
                  drift=drift)
        n = len(self.mats)
        if isinstance(seed, torch.Tensor) and (seed.numel() != n or seed.is_floating_point()):
            raise ValueError(f"seed must hold {n} integers, got {seed.dtype} {tuple(seed.shape)}")
        if self.table is None:
            for m, ((q, e), out) in enumerate(zip(self.mats, self.outs)):
                s = seed.reshape(-1)[m] if isinstance(seed, torch.Tensor) else seed
                out.copy_(niu_refresh_ref(q, e, s, **kw))
            return self.outs
        seeds = None
        if isinstance(seed, torch.Tensor):
            if seed.device != self.table.device:
                raise ValueError(f"seed must be on {self.table.device}, got {seed.device}")
            seeds = seed.reshape(-1).to(torch.int32)
        from repro_torch.kernels import build

        err = build.load("niu").repro_niu_refresh(
            self.table.data_ptr(), self.exps.data_ptr(), self.amax.data_ptr(),
            None if seeds is None else seeds.data_ptr(), 0 if seeds is not None else int(seed) & _M32,
            n, self.blocks, prog_noise_scale, read_noise_scale, drift,
            int(drift != 1.0), int(read_noise_scale > 0.0), cuda_stream(),
        )
        raise_on(err, "niu_refresh")
        niu_refresh.launches += 1
        return self.outs


def niu_plan(mats: Sequence[Tuple[torch.Tensor, IntLike]]) -> NiuPlan:
    """A plan over pristine ``(q, exp)`` weight matrices, each a contiguous
    (R, C) int8 tensor: the outputs in one buffer and, on the card, the
    table of matrices and each matrix's max |q|, computed here once by one
    launch (the NIU's range is programmed once, not per round)."""
    mats = [(q, e) for q, e in mats]
    if not mats:
        raise ValueError("a plan needs at least one matrix")
    dev = mats[0][0].device
    for q, _ in mats:
        if q.device != dev or q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
            raise ValueError(f"each q must be a contiguous (R, C) int8 tensor on {dev}, got "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
        if not 0 < q.numel() < 2 ** 31:
            raise ValueError(f"the kernel takes 1 to 2**31 - 1 elements, got {tuple(q.shape)}")
    ns = [q.numel() for q, _ in mats]
    offs = [0]
    for n in ns:
        offs.append(offs[-1] + -(-n // NIU_ALIGN) * NIU_ALIGN)
    buf = torch.empty(offs[-1], dtype=torch.int8, device=dev)
    outs = [buf[o: o + q.numel()].view(q.shape) for o, (q, _) in zip(offs, mats)]
    if not use_kernel(mats[0][0]):
        return NiuPlan(mats, outs)
    if len(mats) > NIU_MAX_MATS:
        raise ValueError(f"a plan takes at most {NIU_MAX_MATS} matrices, got {len(mats)}")
    first = niu_first_blocks(ns)
    table = torch.tensor([[q.data_ptr(), o.data_ptr(), n, f]
                          for (q, _), o, n, f in zip(mats, outs, ns, first)], dtype=torch.int64)
    exps = torch.stack([device_int(e, "exp", dev) for _, e in mats])
    plan = NiuPlan(mats, outs, table.to(dev), exps,
                   torch.zeros(len(mats), dtype=torch.int32, device=dev), first[-1])
    from repro_torch.kernels import build

    err = build.load("niu").repro_niu_absmax(
        plan.table.data_ptr(), plan.amax.data_ptr(), len(mats), plan.blocks, cuda_stream())
    raise_on(err, "niu_plan")
    niu_plan.launches += 1
    return plan


def niu_refresh(
    q: torch.Tensor,                       # (R, C) int8 pristine payload
    exp: IntLike,                          # () pow2 exponent
    seed: IntLike,                         # () int32
    *,
    prog_noise_scale: float = 0.1,
    read_noise_scale: float = 0.02,
    drift: float = 1.0,
) -> torch.Tensor:
    """One NIU round: a fresh noise instance on an int8 weight tile -> int8
    (through a one-matrix :func:`niu_plan` on the card)."""
    kw = dict(prog_noise_scale=prog_noise_scale, read_noise_scale=read_noise_scale, drift=drift)
    if not use_kernel(q):
        return niu_refresh_ref(q, exp, seed, **kw)
    return niu_plan([(q, exp)]).refresh(seed, **kw)[0]


count_launches(niu_refresh, niu_plan)
