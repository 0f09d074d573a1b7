"""The decode-path kernels: wrappers over ``csrc/decode.cu``.

Counterparts of ``repro.kernels.decode``'s three Pallas kernels, with the
same signatures and return shapes minus the TPU block sizes and
``interpret``:

- :func:`fused_qkv` -- QKV projections + bias + RoPE of one decode token.
- :func:`fused_decode_attention` -- single-token GQA attention over the
  whole KV cache, then ``ctx @ wo + bo``.
- :func:`fused_mlp` -- the (gated) MLP.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
in :mod:`repro_torch.kernels.ref`.  A CUDA call that the kernel cannot
take (dtype, shape, layout) raises: it never falls back.

Each wrapper carries ``launches``, a plain integer that counts its calls
that went to the kernel (one per call, though attention and MLP make two
launches each); :func:`reset_launches` sets them, and every other kernel
wrapper's count (``kernels.common``), to 0.

The MLP's two products, the attention's output projection and (as its
own kernel, ``qkv_gemv_kernel``) the QKV projections run on one split-K
tensor-core GEMV (``csrc/decode.cu``).  :func:`gemv_plan` picks its split
of the reduction from the shape alone; :func:`qkv_columns` maps the QKV
grid's column tiles onto the three weights.  The attention splits the
cache into chunks across blocks (flash-decoding), sized by
:func:`attn_plan`.  The split partials and tile counters live in
``common.split_k_scratch``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.common import count_launches, reset_launches, use_kernel  # noqa: F401
from repro_torch.kernels.common import split_k_scratch
from repro_torch.kernels.common import cuda_stream as _stream
from repro_torch.kernels.common import raise_on as _raise_on

_MAX_B = 8
_ACT = {"swiglu": 0, "gelu": 1, "sq_relu": 2}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape: Sequence[int], device, dtype=torch.bfloat16,
           align: int = 16):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_opt(name, t, shape, device, dtype=torch.bfloat16):
    if t is not None:
        _check(name, t, shape, device, dtype)


def _lib():
    from repro_torch.kernels import build

    return build.load("decode")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gemv_cols(n: int, device: torch.device) -> int:
    """Output columns per block of a CUDA-core GEMV slab: the widest (longer
    contiguous weight reads) that still gives every SM a block, else the
    narrowest.  No launch uses it: the products it sized run on
    :func:`gemv_plan`'s split-K GEMV."""
    fits = [nc for nc in (32, 16, 8) if n % nc == 0]
    if not fits:
        raise ValueError(f"output width {n} is not a multiple of 8")
    sms = _sm_count(device)
    return next((nc for nc in fits if n // nc >= sms), fits[-1])


GEMV_N = 128        # output columns of a GEMV block (csrc/decode.cu kGvN)
GEMV_K = 64         # weight rows of a stage (kGvK)
GEMV_MAX_KT = 32    # k-tiles a split takes at most: the x slice fits in shared memory


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """Column tiles, split of the k-tiles, and the scratch the GEMV needs."""
    tiles: int          # GEMV_N-column tiles
    split: int          # blocks along k per column tile
    kt_per: int         # k-tiles (GEMV_K rows each) per split

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    def ws_floats(self, nmat: int) -> int:
        """float32 partials for ``nmat`` weight matrices (0 without a split)."""
        return self.tiles * self.split * nmat * GEMV_N * _MAX_B if self.split > 1 else 0

    @property
    def counters(self) -> int:
        return self.tiles if self.split > 1 else 0


@functools.lru_cache(maxsize=None)
def gemv_plan(n: int, k: int, sms: int) -> GemvPlan:
    """Split of a (K, N) weight's GEMV on a card with ``sms`` SMs: the
    finest split of k (pieces of at most ``GEMV_MAX_KT`` k-tiles) whose
    grid still runs in one wave of one block per SM, so every SM streams
    an equal share; pieces as even as the split allows.  (On an H100 that
    outran grids of two or more blocks per SM, and grids of 1.1-1.5 waves:
    PERF.md.)"""
    tiles = -(-n // GEMV_N)
    kt = -(-k // GEMV_K)
    split = max(1, min(kt, sms // tiles))
    per = -(-kt // max(split, -(-kt // GEMV_MAX_KT)))
    return GemvPlan(tiles, -(-kt // per), per)


def qkv_tiles(n_heads: int, n_kv_heads: int, head_dim: int) -> tuple:
    """Column tiles of wq, wk and wv in the QKV grid (tiles ``[0, tq)`` are
    wq's, then wk's, then wv's; none straddles two matrices)."""
    return tuple(-(-h * head_dim // GEMV_N) for h in (n_heads, n_kv_heads, n_kv_heads))


def qkv_columns(tile: int, head_dim: int) -> tuple:
    """The matrix columns of the ``GEMV_N`` columns of QKV tile ``tile``
    (its index within its matrix), as ``csrc/decode.cu::qkv_col`` maps
    them (columns past the matrix's width are never written).  A head of
    at most ``GEMV_N`` lies within one tile; a wider head (256) spans two,
    and tile r of it holds dims ``[64r, 64r + 64)`` of both halves, so
    both columns of every RoPE pair (c, c + hd/2) meet in one tile."""
    if head_dim <= GEMV_N:
        return tuple(range(tile * GEMV_N, (tile + 1) * GEMV_N))
    run = GEMV_N // 2
    head, r = divmod(tile, 2)
    return tuple(head * head_dim + (lc >= run) * (head_dim // 2) + r * run + lc % run
                 for lc in range(GEMV_N))


def qkv_plan(n_heads: int, n_kv_heads: int, head_dim: int, k: int, sms: int) -> GemvPlan:
    """The QKV grid: every column tile of the three weights, split along
    k as :func:`gemv_plan` splits one weight of as many tiles."""
    return gemv_plan(sum(qkv_tiles(n_heads, n_kv_heads, head_dim)) * GEMV_N, k, sms)


ATTN_CHUNK_BYTES = 16384    # K bytes of a chunk in shared memory (csrc/decode.cu kAtChunkBytes)
ATTN_MAX_SLOTS = 256        # slots a chunk may hold (kAtMaxSlots)
ATTN_SLOTS = 16             # a chunk's slots are a multiple of this
ATTN_BLOCKS_PER_SM = 12     # blocks the split aims at for every SM
ATTN_GROUPS = (1, 2, 4, 6, 8, 12)   # query heads per KV head the kernel takes (csrc/decode.cu)
ATTN_HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel takes (csrc/decode.cu)


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """The attention's split of the cache: ``splits`` chunks of ``chunk``
    slots (the last one may be shorter)."""
    chunk: int
    splits: int

    def ws_floats(self, b: int, hkv: int, groups: int, hd: int) -> int:
        """float32 partials (m, l, acc) of every block."""
        return b * hkv * self.splits * groups * (hd + 2)


@functools.lru_cache(maxsize=None)
def attn_plan(b: int, hkv: int, sk: int, hd: int, sms: int) -> AttnPlan:
    """Chunks of the cache for ``b * hkv`` (lane, kv-head) pairs on a card
    with ``sms`` SMs: as many as give every SM about
    ``ATTN_BLOCKS_PER_SM`` blocks, each a multiple of ``ATTN_SLOTS``
    slots whose K rows fit ``ATTN_CHUNK_BYTES`` (in bf16, an int8 cache
    too: its chunk is dequantized into the same shared memory).  Sized
    from the shape alone: which slots a lane may attend is known only on
    the device.  A lane's result depends on the chunks alone, so a call
    over a lane group of a batch, planned with the batch's ``b``
    (``plan_lanes``), gives each lane the batch's bits."""
    cap = min(ATTN_MAX_SLOTS, ATTN_CHUNK_BYTES // (2 * hd)) // ATTN_SLOTS * ATTN_SLOTS
    want = -(-ATTN_BLOCKS_PER_SM * sms // (b * hkv))
    chunk = min(cap, -(-sk // (want * ATTN_SLOTS)) * ATTN_SLOTS)
    return AttnPlan(chunk, -(-sk // chunk))


def workspace(dev: torch.device, stream: int, floats: int, counters: int):
    """The GEMV's float32 partials and tile counters on ``dev`` and
    ``stream`` (the counters zero between calls)."""
    return split_k_scratch("gemv", dev, stream, floats, torch.float32, counters)


def _gemv(x, w0, w1, bias, y, act: int, what: str):
    """y <- epilogue(x @ w0 [, x @ w1]) through ``gemv_kernel`` (act -1:
    bias only; 0..2: the MLP's up pass)."""
    b, k = x.shape
    n = y.shape[1]
    dev = x.device
    plan = gemv_plan(n, k, _sm_count(dev))
    stream = _stream()
    ws, cnt = workspace(dev, stream, plan.ws_floats(1 if w1 is None else 2), plan.counters)
    err = _lib().repro_gemv(
        x.data_ptr(), w0.data_ptr(), _ptr(w1), _ptr(bias), y.data_ptr(), b, k, n,
        plan.kt_per, plan.split, ws.data_ptr(), cnt.data_ptr(), act, stream,
    )
    _raise_on(err, what)


def _check_batch(b: int, k: int):
    if not 1 <= b <= _MAX_B:
        raise ValueError(f"the decode kernels take 1..{_MAX_B} rows, got {b}")
    if k % 8:
        raise ValueError(f"reduction width {k} is not a multiple of 8")


def fused_qkv(
    x: torch.Tensor,                       # (B, d)
    wq: torch.Tensor,                      # (d, Hq*hd)
    wk: torch.Tensor,                      # (d, Hkv*hd)
    wv: torch.Tensor,                      # (d, Hkv*hd)
    bq: Optional[torch.Tensor] = None,     # (Hq*hd,)
    bk: Optional[torch.Tensor] = None,
    bv: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,   # (B,) int32 (rope only)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope: bool = True,
    theta: float = 1e4,
):
    """One decode token's QKV projections + bias + RoPE.

    Returns ``(q (B, Hq, hd), k (B, Hkv, hd), v (B, Hkv, hd))`` in
    ``x.dtype``."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
              rope=rope, theta=theta)
    if not use_kernel(x):
        if positions is None:
            positions = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        return ref.fused_qkv_ref(x, wq, wk, wv, bq, bk, bv, positions, **kw)
    b, d = x.shape
    dq, dkv = n_heads * head_dim, n_kv_heads * head_dim
    dev = x.device
    _check_batch(b, d)
    if head_dim % 16 or head_dim > 256 or 256 % (head_dim // 8):
        raise ValueError(f"head_dim {head_dim} is not supported by the kernel")
    if (bq is None) != (bk is None) or (bq is None) != (bv is None):
        raise ValueError("bq, bk and bv come together or not at all")
    _check("x", x, (b, d), dev)
    _check("wq", wq, (d, dq), dev)
    _check("wk", wk, (d, dkv), dev)
    _check("wv", wv, (d, dkv), dev)
    _check_opt("bq", bq, (dq,), dev)
    _check_opt("bk", bk, (dkv,), dev)
    _check_opt("bv", bv, (dkv,), dev)
    _check_opt("positions", positions, (b,), dev, torch.int32)
    q = torch.empty((b, n_heads, head_dim), dtype=x.dtype, device=dev)
    k = torch.empty((b, n_kv_heads, head_dim), dtype=x.dtype, device=dev)
    v = torch.empty((b, n_kv_heads, head_dim), dtype=x.dtype, device=dev)
    plan = qkv_plan(n_heads, n_kv_heads, head_dim, d, _sm_count(dev))
    stream = _stream()
    ws, cnt = workspace(dev, stream, plan.ws_floats(1), plan.counters)
    err = _lib().repro_fused_qkv(
        x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
        _ptr(bq), _ptr(bk), _ptr(bv), _ptr(positions),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b, d, n_heads, n_kv_heads, head_dim, int(rope), float(theta),
        plan.kt_per, plan.split, ws.data_ptr(), cnt.data_ptr(), stream,
    )
    _raise_on(err, "fused_qkv")
    fused_qkv.launches += 1
    return q, k, v


def _int_vector(name, t, b, dev) -> tuple:
    """(pointer, stride) of a () or (B,) int32 device tensor."""
    if t.device != dev or t.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor on {dev}")
    if t.dim() == 0:
        return t.data_ptr(), 0
    _check(name, t, (b,), dev, torch.int32)
    return t.data_ptr(), 1


def fused_decode_attention(
    q: torch.Tensor,                       # (B, Hq, hd) post-rope, unscaled
    k: torch.Tensor,                       # (B, Sk, Hkv, hd)
    v: torch.Tensor,                       # (B, Sk, Hkv, hd)
    wo: torch.Tensor,                      # (Hq*hd, d)
    bo: Optional[torch.Tensor] = None,     # (d,)
    *,
    q_positions: torch.Tensor,             # (B,) int32 absolute query position
    kv_valid_len: Optional[torch.Tensor] = None,   # () or (B,) int32
    window: Optional[int] = None,                  # static sliding window
    window_arr: Optional[torch.Tensor] = None,     # dynamic () int32 window
    kv_positions: Optional[torch.Tensor] = None,   # (Sk,) or (B, Sk) ring slots
    causal: bool = True,
    k_exp: Optional[torch.Tensor] = None,          # (B, Sk, Hkv) int8 (an int8 cache)
    v_exp: Optional[torch.Tensor] = None,
    plan_lanes: Optional[int] = None,              # lanes the split is sized for (B)
) -> torch.Tensor:
    """Single-token GQA attention + output projection -> (B, d).

    Mask semantics mirror ``models.attention._decode_attention``:
    ``kv_positions`` (ring caches; negative = never written) else
    ``arange < kv_valid_len``; causal row/window bounds on top.

    ``k``, ``v`` are the bf16 cache, or the int8 cache of ``kv_quant``
    with its exponents ``k_exp``, ``v_exp``: slot ``s`` of a lane's head
    is worth ``k[s] * 2**k_exp[s]`` (``ref.kv_dequantize``), and the
    kernel dequantizes each chunk as it loads it, so its result equals
    the bf16 kernel's on the dequantized cache bit for bit and no bf16
    copy of the cache is made.  ``plan_lanes``: the batch a lane group's
    call belongs to, which sizes the cache's split (:func:`attn_plan`),
    so that the group's lanes get the batch's bits."""
    kw = dict(q_positions=q_positions, kv_valid_len=kv_valid_len, window=window,
              window_arr=window_arr, kv_positions=kv_positions, causal=causal,
              k_exp=k_exp, v_exp=v_exp)
    if not use_kernel(q):
        return ref.decode_attention_ref(q, k, v, wo, bo, **kw)
    b, hq, hd = q.shape
    d = wo.shape[1]
    dev = q.device
    if d % 8:
        raise ValueError(f"model width {d} is not a multiple of 8")
    _check("wo", wo, (hq * hd, d), dev)
    _check_opt("bo", bo, (d,), dev)
    ctx = _attention_ctx(q, k, v, plan_lanes=plan_lanes, **kw)
    y = torch.empty((b, d), dtype=q.dtype, device=dev)
    _gemv(ctx, wo, None, bo, y, -1, "fused_decode_attention (output projection)")
    fused_decode_attention.launches += 1
    return y


def _attention_ctx(q, k, v, *, q_positions, kv_valid_len=None, window=None, window_arr=None,
                   kv_positions=None, causal=True, k_exp=None, v_exp=None,
                   plan_lanes=None) -> torch.Tensor:
    """Launch 1 of :func:`fused_decode_attention` on CUDA tensors: the
    attention's context (B, Hq*hd) in ``q.dtype``, the cache split into
    :func:`attn_plan`'s chunks (sized for ``plan_lanes`` lanes, default
    B), over a bf16 cache or an int8 one with its exponents."""
    b, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    _check_batch(b, hq * hd)
    if hkv <= 0 or hq % hkv or hq // hkv not in ATTN_GROUPS or hd not in ATTN_HEAD_DIMS:
        raise ValueError(f"(Hq={hq}, Hkv={hkv}, hd={hd}) is not supported by the kernel")
    _check("q", q, (b, hq, hd), dev)
    if (k_exp is None) != (v_exp is None):
        raise ValueError("k_exp and v_exp come together or not at all")
    quant = k_exp is not None
    kv_dtype = torch.int8 if quant else torch.bfloat16
    _check("k", k, (b, sk, hkv, hd), dev, kv_dtype)
    _check("v", v, (b, sk, hkv, hd), dev, kv_dtype)
    if quant:
        # one exponent a slot and kv-head, read a byte at a time
        _check("k_exp", k_exp, (b, sk, hkv), dev, torch.int8, align=1)
        _check("v_exp", v_exp, (b, sk, hkv), dev, torch.int8, align=1)
    _check("q_positions", q_positions, (b,), dev, torch.int32)
    kvp, kvp_stride = None, 0
    if kv_positions is not None:
        if kv_positions.dim() == 1:
            _check("kv_positions", kv_positions, (sk,), dev, torch.int32)
        else:
            _check("kv_positions", kv_positions, (b, sk), dev, torch.int32)
            kvp_stride = sk
        kvp = kv_positions.data_ptr()
    limit, limit_stride = None, 0
    if kv_valid_len is not None:
        limit, limit_stride = _int_vector("kv_valid_len", kv_valid_len, b, dev)
    win_ptr, win_static = None, ref.BIG_WINDOW
    if window_arr is not None:
        if window_arr.dim() != 0:
            raise ValueError("window_arr must be a () tensor")
        win_ptr, _ = _int_vector("window_arr", window_arr, b, dev)
    elif window is not None:
        win_static = int(window)
    scale = ref.dtype_scalar(1.0 / (hd ** 0.5), q.dtype)
    if plan_lanes is None:
        plan_lanes = b
    elif plan_lanes < b:
        raise ValueError(f"plan_lanes {plan_lanes} is fewer than the call's {b} lanes")
    plan = attn_plan(plan_lanes, hkv, sk, hd, _sm_count(dev))
    stream = _stream()
    ws, cnt = split_k_scratch("attn", dev, stream, plan.ws_floats(b, hkv, hq // hkv, hd),
                              torch.float32, b * hkv)
    ctx = torch.empty((b, hq * hd), dtype=q.dtype, device=dev)
    tail = (kvp, kvp_stride, limit, limit_stride, q_positions.data_ptr(), win_ptr, win_static,
            int(causal), scale, ctx.data_ptr(), b, sk, hq, hkv, hd,
            plan.chunk, plan.splits, ws.data_ptr(), cnt.data_ptr(), stream)
    if quant:
        err = _lib().repro_decode_attention_q8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_exp.data_ptr(), v_exp.data_ptr(), *tail)
    else:
        err = _lib().repro_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), *tail)
    _raise_on(err, "fused_decode_attention (attention)")
    return ctx


def fused_mlp(
    x: torch.Tensor,                       # (B, d)
    w_up: torch.Tensor,                    # (d, f)
    w_gate: Optional[torch.Tensor] = None, # (d, f) -- presence selects gating
    b_up: Optional[torch.Tensor] = None,   # (f,)
    w_down: Optional[torch.Tensor] = None, # (f, d)
    b_down: Optional[torch.Tensor] = None, # (d,)
    *,
    act: str = "swiglu",
) -> torch.Tensor:
    """up-proj -> activation -> down-proj, matching ``models.mlp.mlp_apply``."""
    gated = w_gate is not None
    if act == "swiglu" and not gated:
        raise ValueError("swiglu requires w_gate")
    if act not in _ACT:
        raise ValueError(act)
    if not use_kernel(x):
        return ref.fused_mlp_ref(x, w_up, w_gate, b_up, w_down, b_down, act=act)
    b, d = x.shape
    f = w_up.shape[1]
    dev = x.device
    _check_batch(b, d)
    if f % 8:
        raise ValueError(f"d_ff {f} is not a multiple of 8")
    if (b_up is None) != (b_down is None):
        raise ValueError("b_up and b_down come together or not at all")
    _check("x", x, (b, d), dev)
    _check("w_up", w_up, (d, f), dev)
    _check_opt("w_gate", w_gate, (d, f), dev)
    _check_opt("b_up", b_up, (f,), dev)
    _check("w_down", w_down, (f, d), dev)
    _check_opt("b_down", b_down, (d,), dev)
    h = torch.empty((b, f), dtype=x.dtype, device=dev)
    y = torch.empty((b, d), dtype=x.dtype, device=dev)
    # the gate product (or up's, ungated) takes b_up; swiglu also needs up's
    _gemv(x, w_gate if gated else w_up, w_up if act == "swiglu" else None, b_up, h,
          _ACT[act], "fused_mlp (up)")
    _gemv(h, w_down, None, b_down, y, -1, "fused_mlp (down)")
    fused_mlp.launches += 1
    return y


KERNELS = (fused_qkv, fused_decode_attention, fused_mlp)
count_launches(*KERNELS)
