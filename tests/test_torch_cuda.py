"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  Run on a
machine with an H100 with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They cover what ``chip_smoke.py`` (olmo-1b and ResNet-50 shapes only)
does not.  Decode kernels: other batch sizes, grouped-query heads
(G = Hq/Hkv > 1), head widths 32, 64 and 256, every activation, and the smoke
engine on the card; tolerance atol = rtol = 2e-2 in bf16, as in
``chip_smoke.py``.  PU kernels: ``int8_gemm`` with N, M and P that are
multiples of no tile and shifts -8..31, ``im2col`` with C = 1 and 2 and
odd geometries, conv-as-GEMM, and ResNet-18 on the card against the CPU,
all bit for bit; the split-K paths of both redesigned kernels (split
and unsplit grids, both weight layouts, olmo-1b and smoke widths, two
calls giving equal bits); ``niu_refresh`` at odd shapes, within the gate of
``chip_smoke.py`` (|diff| <= 1 on at most 1e-4 of the elements).  The
split attention at Sk = 1, 77 and 4096 (windows that mask whole chunks,
ring caches, a lane with no slot to attend) and QKV on the split-K GEMV
(head widths 16 to 256, with and without RoPE), each called twice for
equal bits; the int8-K/V attention (``kv_quant``) equal bit for bit to the
bf16 kernel on the dequantized cache at every (G, hd), and a lane group
planned as its batch (``plan_lanes``) given the batch's bits.  The GEMM's conv mode against ``im2col`` + ``int8_gemm_pn``
at every ResNet-18/50 conv geometry it takes and odd ones, and the NIU
plan against ``niu_refresh_ref`` over ResNet-50's 54 weight matrices and
odd ones (a misaligned view, one element), seed per matrix, bit for bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import common, decode, ops, ref  # noqa: E402
from repro_torch.kernels.int8_gemm import int8_gemm_pn  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")
pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)
HEADS = [(4, 2, 32), (8, 2, 64), (8, 8, 128), (16, 2, 128), (16, 8, 256)]   # (Hq, Hkv, hd)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("bias", [True, False])
def test_fused_qkv(gen, b, heads, bias):
    hq, hkv, hd = heads
    d = 256
    x = _rnd(gen, b, d)
    w = [_rnd(gen, d, h * hd, scale=0.05) for h in (hq, hkv, hkv)]
    bs = [_rnd(gen, h * hd, scale=0.05) if bias else None for h in (hq, hkv, hkv)]
    pos = torch.randint(0, 4096, (b,), generator=gen, device="cuda", dtype=torch.int32)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, theta=1e4)
    decode.reset_launches()
    got = decode.fused_qkv(x, *w, *bs, pos, **kw)
    want = ref.fused_qkv_ref(x, *w, *bs, pos, **kw)
    torch.cuda.synchronize()
    assert decode.fused_qkv.launches == 1
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t, **TOL)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("case", ["valid_len", "window", "ring", "ring_shared", "noncausal"])
def test_fused_decode_attention(gen, b, heads, case):
    hq, hkv, hd = heads
    sk, d = 77, 192
    q = _rnd(gen, b, hq, hd)
    k, v = _rnd(gen, b, sk, hkv, hd), _rnd(gen, b, sk, hkv, hd)
    wo, bo = _rnd(gen, hq * hd, d, scale=0.05), _rnd(gen, d, scale=0.05)
    vlen = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    kw = dict(q_positions=vlen - 1)
    if case in ("valid_len", "window", "noncausal"):
        kw["kv_valid_len"] = vlen
    if case == "window":
        kw["window_arr"] = torch.tensor(9, dtype=torch.int32, device="cuda")
    if case.startswith("ring"):
        ring = torch.randint(-3, sk + 20, (b, sk), generator=gen, device="cuda", dtype=torch.int32)
        kw["kv_positions"] = ring[0].contiguous() if case == "ring_shared" else ring
        kw["q_positions"] = vlen + 20
    if case == "noncausal":
        kw["causal"] = False
    got = decode.fused_decode_attention(q, k, v, wo, bo, **kw)
    want = ref.decode_attention_ref(q, k, v, wo, bo, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_mlp(gen, b, act, bias):
    d, f = 256, 1024
    x = _rnd(gen, b, d)
    wu, wd = _rnd(gen, d, f, scale=0.05), _rnd(gen, f, d, scale=0.05)
    wg = _rnd(gen, d, f, scale=0.05) if act == "swiglu" else None
    bu, bd = (_rnd(gen, f, scale=0.05), _rnd(gen, d, scale=0.05)) if bias else (None, None)
    got = decode.fused_mlp(x, wu, wg, bu, wd, bd, act=act)
    want = ref.fused_mlp_ref(x, wu, wg, bu, wd, bd, act=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("b", list(range(1, 9)))
@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("width", ["smoke", "olmo-1b"])
def test_fused_mlp_split_k_gemv(gen, b, act, bias, width):
    """The split-K tensor-core GEMV at the smoke and the full olmo-1b
    widths: within the bf16 tolerance of the plain version, the same bits
    on a second call, and its per-tile counters back at zero."""
    cfg = get_config("olmo-1b")
    if width == "smoke":
        cfg = smoke_variant(cfg)
    d, f = cfg.d_model, cfg.d_ff
    x = _rnd(gen, b, d)
    wu, wd = _rnd(gen, d, f, scale=0.02), _rnd(gen, f, d, scale=0.02)
    wg = _rnd(gen, d, f, scale=0.02) if act == "swiglu" else None
    bu, bd = (_rnd(gen, f, scale=0.02), _rnd(gen, d, scale=0.02)) if bias else (None, None)
    decode.reset_launches()
    got = decode.fused_mlp(x, wu, wg, bu, wd, bd, act=act)
    again = decode.fused_mlp(x, wu, wg, bu, wd, bd, act=act)
    want = ref.fused_mlp_ref(x, wu, wg, bu, wd, bd, act=act)
    torch.cuda.synchronize()
    assert decode.fused_mlp.launches == 2
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    _, cnt = common._SCRATCH["gemv", x.device, torch.cuda.current_stream().cuda_stream]
    assert not cnt.any()


def test_kernel_rejects_what_it_cannot_take(gen):
    x = _rnd(gen, 9, 64)                       # more than 8 decode rows
    w = _rnd(gen, 64, 64)
    with pytest.raises(ValueError):
        decode.fused_mlp(x, w, w, None, w, None)
    with pytest.raises(TypeError):
        decode.fused_mlp(x[:2].float(), w, w, None, w, None)
    with pytest.raises(ValueError):
        decode.fused_mlp(x[:2], w.t(), w, None, w, None)      # not contiguous


def test_smoke_engine_on_card(gen):
    cfg = smoke_variant(get_config("olmo-1b"))
    from repro_torch.models import transformer

    params = transformer.init_params(cfg, 0, "cuda")
    rng = np.random.default_rng(3)
    eng = ServingEngine(
        cfg, params,
        ServeConfig(max_batch=4, max_len=64, max_new_tokens=7, decode_kernels=True),
        "cuda",
    )
    eng.warmup()
    for n in (9, 14, 6, 30, 3):
        eng.submit(rng.integers(0, cfg.vocab, n).astype(np.int32))
    decode.reset_launches()
    done = eng.run_until_drained()
    assert len(done) == 5 and all(len(r.out_tokens) == 7 for r in done)
    for fn in decode.KERNELS:
        assert fn.launches == cfg.n_layers * eng.decode_rounds > 0


# ------------------------------------- the split attention and the QKV GEMV --

QKV_HEADS = HEADS + [(2, 1, 256), (6, 2, 16), (3, 1, 64)]


@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("heads", QKV_HEADS)
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_qkv_split_k_gemv(gen, b, heads, rope, bias):
    """QKV on the split-K tensor-core GEMV: head widths 16 to 256 (a 256-wide
    head spans two column tiles), with and without RoPE and bias; within the
    bf16 tolerance of the plain version, the same bits on a second call, and
    the tile counters back at zero."""
    hq, hkv, hd = heads
    d = 512
    x = _rnd(gen, b, d)
    w = [_rnd(gen, d, h * hd, scale=0.05) for h in (hq, hkv, hkv)]
    bs = [_rnd(gen, h * hd, scale=0.05) if bias else None for h in (hq, hkv, hkv)]
    pos = torch.randint(0, 8192, (b,), generator=gen, device="cuda", dtype=torch.int32)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, rope=rope, theta=1e4)
    decode.reset_launches()
    got = decode.fused_qkv(x, *w, *bs, pos, **kw)
    again = decode.fused_qkv(x, *w, *bs, pos, **kw)
    want = ref.fused_qkv_ref(x, *w, *bs, pos, **kw)
    torch.cuda.synchronize()
    assert decode.fused_qkv.launches == 2
    for g, a, t in zip(got, again, want):
        torch.testing.assert_close(g, t, **TOL)
        assert torch.equal(g, a)
    _, cnt = common._SCRATCH["gemv", x.device, torch.cuda.current_stream().cuda_stream]
    assert not cnt.any()


SPLIT_ATTN_CASES = ["valid_len", "window_chunks", "window_dynamic", "ring", "ring_shared",
                    "noncausal", "no_valid_slot", "ring_no_valid_slot"]


@pytest.mark.parametrize("sk", [1, 77, 4096])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("case", SPLIT_ATTN_CASES)
def test_fused_decode_attention_split_cache(gen, sk, heads, case):
    """The cache split into chunks across blocks: windows that leave whole
    chunks masked, ring caches, and a lane with no slot to attend (lane 0),
    which must get the plain version's uniform mean over all slots; within
    the bf16 tolerance, the same bits on a second call, counters back at
    zero."""
    hq, hkv, hd = heads
    b, d = 8, 256
    q = _rnd(gen, b, hq, hd)
    k, v = _rnd(gen, b, sk, hkv, hd), _rnd(gen, b, sk, hkv, hd)
    wo, bo = _rnd(gen, hq * hd, d, scale=0.05), _rnd(gen, d, scale=0.05)
    vlen = torch.randint(1, sk + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    kw = dict(q_positions=vlen - 1, kv_valid_len=vlen)
    if case == "window_chunks":
        kw["window"] = 37
    elif case == "window_dynamic":
        kw["window_arr"] = torch.tensor(max(1, sk // 5), dtype=torch.int32, device="cuda")
    elif case.startswith("ring"):
        ring = torch.randint(-3, sk + 20, (b, sk), generator=gen, device="cuda", dtype=torch.int32)
        if case == "ring_no_valid_slot":
            ring[0] = -1
        kw = dict(q_positions=vlen + 20,
                  kv_positions=ring[0].contiguous() if case == "ring_shared" else ring)
    elif case == "noncausal":
        kw["causal"] = False
    elif case == "no_valid_slot":
        kw["kv_valid_len"] = torch.cat([vlen[:1] * 0, vlen[1:]])
    decode.reset_launches()
    got = decode.fused_decode_attention(q, k, v, wo, bo, **kw)
    again = decode.fused_decode_attention(q, k, v, wo, bo, **kw)
    want = ref.decode_attention_ref(q, k, v, wo, bo, **kw)
    torch.cuda.synchronize()
    assert decode.fused_decode_attention.launches == 2
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    _, cnt = common._SCRATCH["attn", q.device, torch.cuda.current_stream().cuda_stream]
    assert not cnt.any()


def test_attention_lane_with_no_slot_gets_the_mean_of_v(gen):
    """At olmo-1b widths: a lane with no slot to attend (valid length 0)
    attends uniformly to all Sk slots, as exp(-1e30 - -1e30) = 1 gives the
    plain version; its context is the mean of V."""
    b, hq, hd, sk = 8, 16, 128, 584
    q, k, v = _rnd(gen, b, hq, hd), _rnd(gen, b, sk, hq, hd), _rnd(gen, b, sk, hq, hd)
    vlen = torch.tensor([0] + [500] * (b - 1), dtype=torch.int32, device="cuda")
    kw = dict(q_positions=vlen - 1, kv_valid_len=vlen)
    ctx = decode._attention_ctx(q, k, v, **kw)
    mean = v[0].float().mean(0).to(torch.bfloat16).reshape(-1)
    torch.testing.assert_close(ctx[0], mean, **TOL)
    eye = torch.eye(hq * hd, dtype=torch.bfloat16, device="cuda")
    torch.testing.assert_close(ctx, ref.decode_attention_ref(q, k, v, eye, **kw), **TOL)


def _int8_cache(gen, b, sk, hkv, hd, written):
    """An int8 cache (payloads, exponents) of ``written`` slots a lane, the
    rest as ``init_cache`` leaves them (payload 0, exponent -126)."""
    x = torch.randn(b, sk, hkv, hd, generator=gen, device="cuda")
    x = x * torch.exp2(torch.randint(-4, 1, (b, sk, hkv, 1), generator=gen, device="cuda").float())
    q, e = ref.kv_quantize(x)
    q[:, written:], e[:, written:] = 0, -126
    return q, e


@pytest.mark.parametrize("sk", [77, 1040])
@pytest.mark.parametrize("groups", decode.ATTN_GROUPS)
@pytest.mark.parametrize("hd", decode.ATTN_HEAD_DIMS)
@pytest.mark.parametrize("case", ["valid_len", "ring", "no_valid_slot"])
def test_int8_attention_equals_bf16_kernel_on_the_dequantized_cache(gen, sk, groups, hd, case):
    """The int8-K/V variant (kv_quant) against the bf16 kernel on
    ``kv_dequantize`` of the same cache: equal bits (the chunks are the
    same and q * 2^e is exact in bf16); within the tolerance of the plain
    version; equal bits on a second call."""
    b, hkv, d = 8, 2, 256
    hq = groups * hkv
    q = _rnd(gen, b, hq, hd)
    kq, ke = _int8_cache(gen, b, sk, hkv, hd, 2 * sk // 3)
    vq, ve = _int8_cache(gen, b, sk, hkv, hd, 2 * sk // 3)
    wo, bo = _rnd(gen, hq * hd, d, scale=0.05), _rnd(gen, d, scale=0.05)
    vlen = torch.randint(1, 2 * sk // 3 + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    kw = dict(q_positions=vlen - 1, kv_valid_len=vlen)
    if case == "ring":
        pos = vlen + sk
        kw = dict(q_positions=pos, kv_positions=pos[:, None] - (pos[:, None] - torch.arange(
            sk, device="cuda", dtype=torch.int32)) % sk)
    elif case == "no_valid_slot":
        kw["kv_valid_len"] = torch.cat([vlen[:1] * 0, vlen[1:]])
    k, v = (ref.kv_dequantize(p, e, torch.bfloat16) for p, e in ((kq, ke), (vq, ve)))
    decode.reset_launches()
    got = decode.fused_decode_attention(q, kq, vq, wo, bo, k_exp=ke, v_exp=ve, **kw)
    again = decode.fused_decode_attention(q, kq, vq, wo, bo, k_exp=ke, v_exp=ve, **kw)
    want = decode.fused_decode_attention(q, k, v, wo, bo, **kw)
    plain = ref.decode_attention_ref(q, kq, vq, wo, bo, k_exp=ke, v_exp=ve, **kw)
    torch.cuda.synchronize()
    assert decode.fused_decode_attention.launches == 3
    assert torch.equal(got, want) and torch.equal(got, again)
    torch.testing.assert_close(got, plain, **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_lane_group_planned_as_its_batch_gets_the_batch_bits(gen, quant):
    """olmo-1b's attention over the serve phase's 584 slots: the lanes
    4..7 of an 8-lane batch, called alone with ``plan_lanes=8`` (as staged
    decode's lane groups are), give the batch call's bits; planned from
    their own 4 lanes the cache splits otherwise."""
    b, hq, hd, sk, d = 8, 16, 128, 584, 2048
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert decode.attn_plan(4, hq, sk, hd, sms) != decode.attn_plan(8, hq, sk, hd, sms)
    q = _rnd(gen, b, hq, hd)
    if quant:
        (k, ke), (v, ve) = (_int8_cache(gen, b, sk, hq, hd, sk) for _ in range(2))
        ex = dict(k_exp=ke, v_exp=ve)
    else:
        k, v, ex = _rnd(gen, b, sk, hq, hd), _rnd(gen, b, sk, hq, hd), {}
    wo = _rnd(gen, hq * hd, d, scale=0.02)
    vlen = torch.tensor([520 + 8 * i for i in range(b)], dtype=torch.int32, device="cuda")
    full = decode.fused_decode_attention(q, k, v, wo, q_positions=vlen - 1, kv_valid_len=vlen,
                                         **ex)
    group = decode.fused_decode_attention(
        q[4:], k[4:], v[4:], wo, q_positions=vlen[4:] - 1, kv_valid_len=vlen[4:], plan_lanes=b,
        **{n: t[4:] for n, t in ex.items()})
    assert torch.equal(group, full[4:])
    with pytest.raises(ValueError, match="plan_lanes"):
        decode.fused_decode_attention(q, k, v, wo, q_positions=vlen - 1, plan_lanes=4, **ex)


def test_int8_attention_rejects_what_it_cannot_take(gen):
    q = _rnd(gen, 2, 4, 64)
    kq, ke = _int8_cache(gen, 2, 32, 2, 64, 32)
    wo = _rnd(gen, 256, 128)
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="together"):
        decode.fused_decode_attention(q, kq, kq, wo, k_exp=ke, q_positions=pos)
    with pytest.raises(TypeError):      # int8 payloads without exponents
        decode.fused_decode_attention(q, kq, kq, wo, q_positions=pos)
    with pytest.raises(TypeError):      # exponents that are not int8
        decode.fused_decode_attention(q, kq, kq, wo, k_exp=ke.int(), v_exp=ke.int(),
                                      q_positions=pos)


# ------------------------------------------------------------- PU kernels --


def _i8(gen, *shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int8)


@pytest.mark.parametrize("n,m,p", [(1, 1, 1), (7, 13, 5), (100, 200, 72), (129, 257, 130),
                                   (65, 147, 17), (33, 4608, 49), (2048, 64, 3)])
def test_int8_gemm_shapes(gen, n, m, p):
    w, x = _i8(gen, n, m), _i8(gen, m, p)
    bias = torch.randint(-5000, 5000, (n,), generator=gen, device="cuda", dtype=torch.int32)
    common.reset_launches()
    got = ops.int8_gemm(w, x, bias, shift=7)
    assert common.launch_counts()["int8_gemm"] == 1
    assert torch.equal(got, ref.int8_gemm_ref(w, x, bias, 7))


@pytest.mark.parametrize("shift", list(range(-8, 32)))
def test_int8_gemm_shift_sweep(gen, shift):
    w, x = _i8(gen, 40, 96), _i8(gen, 96, 70)
    bias = torch.randint(-2 ** 20, 2 ** 20, (40,), generator=gen, device="cuda", dtype=torch.int32)
    res = _i8(gen, 40, 70)
    for relu in (False, True):
        got = ops.int8_gemm(w, x, bias, shift=torch.tensor(shift, dtype=torch.int32, device="cuda"),
                            residual=res, relu=relu)
        assert torch.equal(got, ref.int8_gemm_ref(w, x, bias, shift, relu, res)), (shift, relu)


SPLIT_CASES = [   # (P, N, M): P = 1, 7, 49 and conv1's 12544, M = 147, ragged N,
    (1, 8, 4608), (7, 33, 100), (49, 512, 4608), (49, 2048, 512), (49, 72, 1152),   # split-K
    (12544, 64, 147), (196, 100, 2304), (130, 129, 257), (12544, 512, 576),         # no split
    (3, 2048, 64), (100, 48, 64),
]


@pytest.mark.parametrize("p,n,m", SPLIT_CASES)
@pytest.mark.parametrize("layout", ["nm", "mn"])
def test_int8_gemm_split_k_layouts(gen, p, n, m, layout):
    """Split and unsplit grids the planner picks, both weight layouts, a
    bias that wraps the int32 sum, with residual and ReLU: bit for bit with
    the plain version, the same bits on a second call, the workspace left
    at zero."""
    a, wnm = _i8(gen, p, m), _i8(gen, n, m)
    w = wnm if layout == "nm" else wnm.t().contiguous()
    bias = torch.randint(2 ** 31 - 2 ** 22, 2 ** 31 - 1, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    bias[::2] *= -1
    res = _i8(gen, p, n)
    for shift, r, relu in ((-8, None, False), (0, res, True), (7, res, False), (31, None, True)):
        common.reset_launches()
        got = int8_gemm_pn(a, w, bias, shift, r, relu=relu, w_layout=layout)
        again = int8_gemm_pn(a, w, bias, shift, r, relu=relu, w_layout=layout)
        want = ref.int8_gemm_ref(wnm, a.T, bias, shift, relu, None if r is None else r.T).T
        assert common.launch_counts()["int8_gemm"] == 2
        assert torch.equal(got, want), (shift, relu)
        assert torch.equal(got, again)
    ws, cnt = common._SCRATCH["int8_gemm", a.device, torch.cuda.current_stream().cuda_stream]
    assert not ws.any() and not cnt.any()


@pytest.mark.parametrize("shift", list(range(-8, 32)))
def test_int8_gemm_split_k_shift_sweep(gen, shift):
    a, w = _i8(gen, 49, 1152), _i8(gen, 1152, 72)            # split-K, (M, N) weights
    bias = torch.randint(-2 ** 20, 2 ** 20, (72,), generator=gen, device="cuda", dtype=torch.int32)
    res = _i8(gen, 49, 72)
    for relu in (False, True):
        got = int8_gemm_pn(a, w, bias, torch.tensor(shift, dtype=torch.int32, device="cuda"), res,
                           relu=relu, w_layout="mn")
        assert torch.equal(got, ref.int8_gemm_ref(w.t(), a.T, bias, shift, relu, res.T).T)


def test_int8_gemm_overflow_regime(gen):
    w = torch.full((8, 4608), -128, dtype=torch.int8, device="cuda")
    x = torch.full((4608, 24), -128, dtype=torch.int8, device="cuda")
    bias = torch.full((8,), 2 ** 31 - 1, dtype=torch.int32, device="cuda")   # the sum wraps
    for shift in (0, 16, 31):
        assert torch.equal(ops.int8_gemm(w, x, bias, shift=shift), ref.int8_gemm_ref(w, x, bias, shift))


@pytest.mark.parametrize("h,w,c,k,stride,pad", [
    (8, 8, 3, 3, 1, 1), (7, 9, 2, 3, 1, 0), (16, 16, 1, 5, 2, 2), (11, 5, 2, 3, 3, 2),
    (13, 13, 32, 3, 2, 1), (9, 9, 48, 5, 1, 2), (224, 224, 3, 7, 2, 3), (5, 5, 16, 5, 1, 0),
])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_im2col(gen, h, w, c, k, stride, pad, dtype):
    img = torch.randn((h, w, c), generator=gen, device="cuda").mul(50).to(dtype)
    common.reset_launches()
    got = ops.im2col(img, k, stride, pad)
    assert common.launch_counts()["im2col"] == 1
    assert torch.equal(got, ref.im2col_ref(img, k, stride, pad))


@pytest.mark.parametrize("h,cin,cout,k,stride,pad,relu", [
    (8, 3, 16, 3, 1, 1, True), (8, 4, 8, 3, 2, 1, False), (9, 2, 4, 1, 1, 0, True),
    (10, 3, 6, 1, 2, 0, False), (12, 2, 4, 5, 2, 2, True), (15, 16, 70, 3, 2, 1, True),
])
def test_conv2d_int8(gen, h, cin, cout, k, stride, pad, relu):
    img, w4d = _i8(gen, h, h, cin), _i8(gen, k, k, cin, cout)
    bias = torch.randint(-300, 300, (cout,), generator=gen, device="cuda", dtype=torch.int32)
    oh = (h + 2 * pad - k) // stride + 1
    res = _i8(gen, oh, oh, cout)
    kw = dict(stride=stride, pad=pad, shift=7, relu=relu, residual=res)
    got = ops.conv2d_int8(img, w4d, bias, k=k, **kw)
    assert torch.equal(got, ref.conv2d_int8_ref(img, w4d, bias, **kw))


@pytest.mark.parametrize("r,c", [(1, 1), (3, 5), (257, 129), (1000, 3), (7, 4609)])
@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 - 1])
def test_niu_refresh(gen, r, c, seed):
    q = _i8(gen, r, c, lo=-127)
    exp = torch.tensor(-9, dtype=torch.int32, device="cuda")
    for kw in ({}, dict(prog_noise_scale=2.0, read_noise_scale=1.0, drift=0.8)):
        common.reset_launches()
        got = ops.niu_refresh(q, exp, seed, **kw)
        assert common.launch_counts()["niu_refresh"] == 1
        d = (got.int() - ops.niu_refresh_ref(q, exp, seed, **kw).int()).abs()
        assert d.max().item() <= 1
        assert (d > 0).sum().item() <= max(1, int(1e-4 * q.numel()))


def test_pu_kernels_reject_what_they_cannot_take(gen):
    with pytest.raises(ValueError):
        ops.int8_gemm(_i8(gen, 4, 8).float(), _i8(gen, 8, 4))
    with pytest.raises(ValueError):
        int8_gemm_pn(_i8(gen, 8, 4).t(), _i8(gen, 4, 8))             # not contiguous
    with pytest.raises(ValueError):
        ops.int8_gemm(_i8(gen, 4, 8), _i8(gen, 8, 4), shift=torch.tensor(1.0, device="cuda"))
    with pytest.raises(TypeError):
        ops.im2col(torch.zeros((4, 4, 2), dtype=torch.float64, device="cuda"), 3, 1, 1)
    with pytest.raises(ValueError):
        ops.niu_refresh(_i8(gen, 4, 8).t(), 0, 1)


def test_resnet18_on_card_equals_cpu(gen):
    from repro_torch.models import resnet

    params = resnet.init_params(18, 0, "cuda", num_classes=10)
    cpu = {k: {n: (v.to("cpu")) for n, v in layer.items()} for k, layer in params.items()}
    img = _i8(gen, 28, 28, 3, lo=-100, hi=100)
    common.reset_launches()
    got = resnet._trunk_int8(18, params, img)
    assert common.launch_counts()["int8_gemm"] == 20
    assert torch.equal(got.cpu(), resnet._trunk_int8(18, cpu, img.cpu()))
    lg = resnet.forward_int8(18, params, img).cpu()
    lc = resnet.forward_int8(18, cpu, img.cpu())
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-2)


# ------------------------- the NIU plan and the GEMM's conv mode (redesign) --

niu_mod = importlib.import_module("repro_torch.kernels.niu")


def _conv_geometries(variant, image=224):
    """(H, Cin, Cout, k, stride, pad) of each distinct conv of a ResNet."""
    from repro_torch.models import resnet

    specs, seen = resnet.resnet_conv_specs(variant), []

    def conv(spec, hw, res):
        g = (hw, spec.cin, spec.cout, spec.k, spec.stride, spec.pad)
        if g not in seen:
            seen.append(g)
        return (hw + 2 * spec.pad - spec.k) // spec.stride + 1

    hw = conv(specs[0], image, None)
    hw = (hw + 2 - 3) // 2 + 1          # the 3x3 / 2 max-pool
    resnet._walk(specs, hw, hw, conv)
    return seen


CONV_MODE_GEOMS = sorted({g for v in (18, 50) for g in _conv_geometries(v)
                          if kgemm.conv_mode(g[1], g[2], g[3], g[4], g[5])}) + [
    (9, 16, 32, 3, 2, 1), (15, 48, 16, 3, 1, 1), (13, 32, 64, 5, 2, 2), (10, 32, 64, 1, 2, 0),
    (7, 16, 16, 3, 3, 0), (3, 64, 48, 3, 1, 0), (6, 1024, 16, 1, 1, 1), (11, 16, 2064, 3, 1, 1),
]


def test_conv_mode_geometries_split_and_do_not():
    sms = 132
    plans = [kgemm.gemm_plan(((h + 2 * p - k) // s + 1) ** 2, co, k * k * ci, sms)
             for h, ci, co, k, s, p in CONV_MODE_GEOMS]
    assert any(p.split > 1 for p in plans) and any(p.split == 1 for p in plans)


@pytest.mark.parametrize("h,cin,cout,k,stride,pad", CONV_MODE_GEOMS)
def test_conv_mode_equals_im2col_and_gemm(gen, h, cin, cout, k, stride, pad):
    """The conv mode against the patch matrix (``im2col``) through
    ``int8_gemm_pn``, bit for bit, with and without bias, residual and
    ReLU; a second call gives equal bits; the split workspace stays zero."""
    img, w4d = _i8(gen, h, h, cin), _i8(gen, k, k, cin, cout)
    oh = (h + 2 * pad - k) // stride + 1
    bias = torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen, device="cuda", dtype=torch.int32)
    res = _i8(gen, oh, oh, cout)
    patches, wmat = ops.im2col(img, k, stride, pad), w4d.reshape(-1, cout)
    for b, r, relu, shift in ((None, None, False, 0), (bias, None, True, 7), (bias, res, True, 9),
                              (None, res, False, -2)):
        common.reset_launches()
        got = kgemm.int8_conv_gemm(img, w4d, b, shift, r, k=k, stride=stride, pad=pad, relu=relu)
        again = kgemm.int8_conv_gemm(img, w4d, b, shift, r, k=k, stride=stride, pad=pad, relu=relu)
        assert common.launch_counts()["int8_gemm"] == 2
        want = int8_gemm_pn(patches, wmat, b, shift, None if r is None else r.reshape(-1, cout),
                            relu=relu, w_layout="mn").reshape(oh, oh, cout)
        assert torch.equal(got, want), (b is not None, r is not None, relu, shift)
        assert torch.equal(got, again)
        assert torch.equal(ops.conv2d_int8(img, w4d, b, k=k, stride=stride, pad=pad, shift=shift,
                                           relu=relu, residual=r), got)
    ws, cnt = common._SCRATCH["int8_gemm", img.device, torch.cuda.current_stream().cuda_stream]
    assert not ws.any() and not cnt.any()


def test_conv2d_int8_routes_to_the_conv_mode_where_it_applies(gen):
    img = _i8(gen, 16, 16, 64)
    for w4d, im2col_launches in ((_i8(gen, 3, 3, 64, 64), 0), (_i8(gen, 3, 3, 64, 24), 1)):
        common.reset_launches()
        ops.conv2d_int8(img, w4d, k=3, stride=1, pad=1)
        assert common.launch_counts()["im2col"] == im2col_launches
        assert common.launch_counts()["int8_gemm"] == 1
    # a map that is not 16-byte aligned takes the patch matrix
    buf = _i8(gen, 16 * 16 * 64 + 1)
    odd = buf[1:].view(16, 16, 64)
    w4d = _i8(gen, 3, 3, 64, 64)
    common.reset_launches()
    got = ops.conv2d_int8(odd, w4d, k=3, stride=1, pad=1, shift=8)
    assert common.launch_counts()["im2col"] == 1
    assert torch.equal(got, ref.conv2d_int8_ref(odd, w4d, None, 1, 1, 8))
    with pytest.raises(ValueError):
        kgemm.int8_conv_gemm(odd, w4d, k=3, stride=1, pad=1)
    with pytest.raises(ValueError):
        kgemm.int8_conv_gemm(img, _i8(gen, 3, 3, 64, 24), k=3, stride=1, pad=1)


def _niu_mats(gen):
    """The 54 weight matrices of the seeded ResNet-50, a misaligned view,
    one element, and odd shapes."""
    from repro_torch.models import resnet

    params = resnet.init_params(50, 0, "cuda")
    mats = [(p["w"].q.reshape(-1, p["w"].q.shape[-1]), p["w"].exp) for p in params.values()]
    buf = _i8(gen, 5000, lo=-127)
    e = torch.tensor(-6, dtype=torch.int32, device="cuda")
    mats += [(buf[3: 3 + 37 * 41].view(37, 41), e), (_i8(gen, 1, 1, lo=-127), e),
             (_i8(gen, 7, 4609, lo=-127), torch.tensor(2, dtype=torch.int32, device="cuda")),
             (_i8(gen, 1000, 3, lo=-127), e)]
    return mats


def test_niu_plan_equals_plain_per_matrix(gen):
    mats = _niu_mats(gen)
    assert len(mats) == 58 and mats[54][0].data_ptr() % 16 == 3
    common.reset_launches()
    plan = niu_mod.niu_plan(mats)
    assert common.launch_counts()["niu_plan"] == 1
    amax = torch.stack([q.to(torch.int32).abs().amax() for q, _ in mats])
    assert torch.equal(plan.amax, amax)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (len(mats),), generator=gen, device="cuda",
                          dtype=torch.int32)
    seeds[0] = -1
    for kw in ({}, dict(prog_noise_scale=2.0, read_noise_scale=1.0, drift=0.8),
               dict(read_noise_scale=0.0)):
        for seed in (seeds, 12345):
            common.reset_launches()
            outs = plan.refresh(seed, **kw)
            assert common.launch_counts()["niu_refresh"] == 1
            for m, ((q, e), got) in enumerate(zip(mats, outs)):
                s = seeds[m] if isinstance(seed, torch.Tensor) else seed
                assert torch.equal(got, ops.niu_refresh_ref(q, e, s, **kw)), (m, tuple(q.shape), kw)


def test_niu_plan_two_refreshes_give_equal_bits(gen):
    mats = _niu_mats(gen)
    plan = niu_mod.niu_plan(mats)
    first = [o.clone() for o in plan.refresh(99)]
    assert all(torch.equal(a, b) for a, b in zip(first, plan.refresh(99)))
    assert not all(torch.equal(a, b) for a, b in zip(first, plan.refresh(100)))
    # the one-matrix entry point draws the same round as the plan
    assert all(torch.equal(ops.niu_refresh(q, e, 99), a) for (q, e), a in zip(mats, first))


# ---------------------------------------------- CUDA graphs and the NIU unit --


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_smoke_engine_captured_equals_eager(gen, kernels, temperature):
    """The decode blocks replayed as CUDA graphs serve what the eager loop
    serves (greedy and sampled: a replay advances the generator as the
    eager rounds do), count the launches each replay makes, and capture
    nothing after warmup."""
    from repro_torch.analysis.sanitize import retrace_guard
    from repro_torch.models import transformer

    cfg = smoke_variant(get_config("olmo-1b"))
    params = transformer.init_params(cfg, 0, "cuda")
    out = {}
    for eager in (True, False):
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=4, max_len=64, max_new_tokens=9, decode_kernels=kernels,
            temperature=temperature, seed=3), "cuda", eager=eager)
        eng.warmup()
        assert eng.trace_counts["decode"] == (0 if eager else 6)
        rng = np.random.default_rng(5)
        for n in (9, 14, 6, 30, 3):
            eng.submit(rng.integers(0, cfg.vocab, n).astype(np.int32))
        decode.reset_launches()
        with retrace_guard(eng.tracing):
            eng.run_until_drained()
        for fn in decode.KERNELS:
            assert fn.launches == (cfg.n_layers * eng.decode_rounds if kernels else 0)
        out[eager] = {r.uid: r.out_tokens for r in eng.completed}
    assert out[True] == out[False]


def test_captured_resnet18_equals_eager(gen):
    from repro_torch.models import resnet

    params = resnet.init_params(18, 0, "cuda", num_classes=10)
    img = _i8(gen, 28, 28, 3, lo=-100, hi=100)
    fwd = resnet.capture_forward_int8(18, params, img.shape)
    for seed in (1, 2):
        x = _i8(torch.Generator(device="cuda").manual_seed(seed), 28, 28, 3, lo=-100, hi=100)
        common.reset_launches()
        got = fwd(x)
        torch.cuda.synchronize()
        assert common.launch_counts()["int8_gemm"] == 20
        assert torch.equal(fwd.trunk, resnet._trunk_int8(18, params, x))
        assert torch.equal(got, resnet.forward_int8(18, params, x))


def test_capture_graph_counts_launches_per_replay(gen):
    x, w_up, w_gate, w_down = (_rnd(gen, 8, 256), _rnd(gen, 256, 512, scale=0.05),
                               _rnd(gen, 256, 512, scale=0.05), _rnd(gen, 512, 256, scale=0.05))
    decode.reset_launches()
    graph, y = common.capture_graph(lambda: decode.fused_mlp(x, w_up, w_gate, None, w_down))
    assert decode.fused_mlp.launches == 1          # the warm-up run; the capture launched nothing
    x.copy_(_rnd(gen, 8, 256))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert decode.fused_mlp.launches == 3 and graph.launches == {decode.fused_mlp: 1}
    assert torch.equal(y, decode.fused_mlp(x, w_up, w_gate, None, w_down))


def test_niu_unit_on_card_rewrites_the_same_tensors(gen):
    from repro_torch.core.aimc import AIMCNoiseModel, NoiseInjectionUnit
    from repro_torch.models import resnet

    params = resnet.init_params(18, 0, "cuda", num_classes=10)
    model = AIMCNoiseModel(prog_noise_scale=0.2, read_noise_scale=0.04)
    niu = NoiseInjectionUnit(params, model, target_filter=lambda p, leaf: p[-1] == "w")
    ptrs = [o.data_ptr() for o in niu.plan.outs]
    for seed in (5, 6):
        out = niu.refresh(torch.Generator(device="cuda").manual_seed(seed))
        assert out is niu.params and [o.data_ptr() for o in niu.plan.outs] == ptrs
        seeds = torch.randint(0, 2 ** 31 - 1, (len(ptrs),), device="cuda", dtype=torch.int32,
                              generator=torch.Generator(device="cuda").manual_seed(seed))
        for m, (name, layer) in enumerate(params.items()):
            q = layer["w"].q
            want = niu_mod.niu_refresh_ref(q.reshape(-1, q.shape[-1]), layer["w"].exp, seeds[m],
                                           prog_noise_scale=0.2, read_noise_scale=0.04,
                                           drift=model.drift())
            assert torch.equal(out[name]["w"].q.reshape(want.shape), want), name
            assert out[name]["w"].exp is layer["w"].exp and out[name]["bias"] is layer["bias"]
