"""The port's PU kernels on the CPU path, held against the JAX package.

Each plain PyTorch version (what a CPU tensor runs) is compared with the
JAX Pallas kernel, run through the Pallas interpreter as
``tests/test_kernels.py`` and ``tests/test_niu_kernel.py`` run it, and
with the JAX oracle, on the same numpy inputs -- bit for bit: the GEMM,
im2col and conv are integer arithmetic; the NIU is equal but where an ulp
of difference in XLA's transcendentals flips a tie (``_niu_case``).  The cases mirror those two files.  The CUDA kernels run
only on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import niu as jniu  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import common, ops  # noqa: E402
from repro_torch.models import resnet  # noqa: E402

kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")
kniu = importlib.import_module("repro_torch.kernels.niu")


@pytest.fixture(autouse=True)
def _no_launches():
    common.reset_launches()
    yield
    assert not any(common.launch_counts().values()), "a CPU tensor must never count as a kernel launch"


def _i8(rng, shape, lo=-128):
    return rng.integers(lo, 128, shape, dtype=np.int8)


def _same(got, want):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_gemm(against, *args, **kw):
    if against == "pallas":
        return jops.int8_gemm(*args, **kw)
    w, x, bias, shift, res = (list(args) + [None, 0, None])[:5]
    return jref.int8_gemm_ref(w, x, bias, shift, kw.get("relu", False), res)


# ---------------------------------------------------------------- GEMM ----


@pytest.mark.parametrize("n,m,p", [(1, 1, 1), (7, 13, 5), (64, 64, 64), (100, 200, 72),
                                   (129, 257, 130), (256, 64, 512)])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_int8_gemm_matches_jax(n, m, p, against):
    rng = np.random.default_rng(n * 1000 + m)
    w, x = _i8(rng, (n, m)), _i8(rng, (m, p))
    got = ops.int8_gemm(torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.int8
    _same(got, _jax_gemm(against, jnp.asarray(w), jnp.asarray(x)))


@pytest.mark.parametrize("shift", [-8, -2, 0, 1, 4, 9, 15, 16, 31])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_int8_gemm_epilogue_shift_relu(shift, relu, against):
    rng = np.random.default_rng(5)
    w, x = _i8(rng, (48, 96)), _i8(rng, (96, 32))
    bias = rng.integers(-5000, 5000, (48,), dtype=np.int32)
    got = ops.int8_gemm(torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(bias),
                        shift=torch.tensor(shift, dtype=torch.int32), relu=relu)
    _same(got, _jax_gemm(against, jnp.asarray(w), jnp.asarray(x), jnp.asarray(bias),
                         jnp.int32(shift), relu=relu))


@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_int8_gemm_residual_fusion(against):
    rng = np.random.default_rng(6)
    w, x, res = _i8(rng, (64, 64)), _i8(rng, (64, 48)), _i8(rng, (64, 48))
    got = ops.int8_gemm(torch.from_numpy(w), torch.from_numpy(x), shift=8,
                        residual=torch.from_numpy(res), relu=True)
    _same(got, _jax_gemm(against, jnp.asarray(w), jnp.asarray(x), None, 8,
                         jnp.asarray(res), relu=True))
    assert int(got.min()) >= 0


@pytest.mark.parametrize("bias", [None, 2 ** 31 - 1])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_int8_gemm_overflow_regime(bias, against):
    """Worst-case int8 x int8 over M=512, and a bias that makes the int32
    sum wrap, as XLA's does."""
    w, x = np.full((8, 512), -128, np.int8), np.full((512, 8), -128, np.int8)
    b = None if bias is None else np.full((8,), bias, np.int32)
    got = ops.int8_gemm(torch.from_numpy(w), torch.from_numpy(x),
                        None if b is None else torch.from_numpy(b), shift=16)
    _same(got, _jax_gemm(against, jnp.asarray(w), jnp.asarray(x),
                         None if b is None else jnp.asarray(b), 16))


@pytest.mark.parametrize("n,m,p", [(1, 1, 1), (7, 13, 5), (64, 64, 64), (100, 200, 72),
                                   (129, 257, 130), (256, 64, 512), (64, 147, 300)])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_int8_gemm_pn_weight_layouts_match_jax(n, m, p, against):
    """The kernel-layout entry point with the weights as (N, M) and as the
    (M, N) view a conv hands it, bias, shift, residual and ReLU on."""
    rng = np.random.default_rng(n * 7 + m + p)
    w, x, res = _i8(rng, (n, m)), _i8(rng, (m, p)), _i8(rng, (n, p))
    bias = rng.integers(-2 ** 20, 2 ** 20, (n,), dtype=np.int32)
    want = _jax_gemm(against, jnp.asarray(w), jnp.asarray(x), jnp.asarray(bias), 6,
                     jnp.asarray(res), relu=True)
    a, tres = torch.from_numpy(x.T.copy()), torch.from_numpy(res.T.copy())
    for layout, wt in (("nm", w), ("mn", w.T.copy())):
        got = kgemm.int8_gemm_pn(a, torch.from_numpy(wt), torch.from_numpy(bias), 6, tres,
                                 relu=True, w_layout=layout)
        _same(got.T, want)


def test_int8_gemm_pn_rejects_an_unknown_layout():
    with pytest.raises(ValueError):
        kgemm.int8_gemm_pn(torch.zeros((2, 4), dtype=torch.int8),
                           torch.zeros((4, 3), dtype=torch.int8), w_layout="km")


def _resnet_gemm_shapes(variant=50, image=224):
    """(P, N, M) of every conv-as-GEMM of one forward, from the specs."""
    specs = resnet.resnet_conv_specs(variant)
    shapes = []

    def conv(spec, hw, res):
        oh = (hw + 2 * spec.pad - spec.k) // spec.stride + 1
        shapes.append((oh * oh, spec.cout, spec.k * spec.k * spec.cin))
        return oh

    hw = conv(specs[0], image, None)
    hw = (hw + 2 - 3) // 2 + 1          # the 3x3 / 2 max-pool
    resnet._walk(specs, hw, hw, conv)
    return shapes


RESNET50_GEMMS = _resnet_gemm_shapes()


def test_resnet50_has_53_gemms_of_20_shapes():
    assert len(RESNET50_GEMMS) == 53 and len(set(RESNET50_GEMMS)) == 20
    assert RESNET50_GEMMS[0] == (12544, 64, 147) and (49, 512, 4608) in RESNET50_GEMMS


@pytest.mark.parametrize("shape", sorted(set(RESNET50_GEMMS)) + [(1, 8, 4608), (7, 33, 100),
                                                                 (12544, 512, 576), (1, 1, 1)])
@pytest.mark.parametrize("sms", [132, 114])
def test_gemm_plan_fills_the_card_and_splits_on_k_tiles(shape, sms):
    p, n, m = shape
    plan = kgemm.gemm_plan(p, n, m, sms)
    kt = -(-m // kgemm.GEMM_BK)
    assert plan.tiles == -(-p // kgemm.GEMM_TILE) * -(-n // kgemm.GEMM_TILE)
    # the split cuts k on k-tile boundaries, every piece non-empty
    assert plan.split == -(-kt // plan.kt_per)
    assert (plan.split - 1) * plan.kt_per < kt <= plan.split * plan.kt_per
    # no finer than pieces of GEMM_MIN_KT k-tiles, and at least a block for
    # every SM unless k is too short to split any finer
    finest = -(-kt // kgemm.GEMM_MIN_KT)
    assert plan.split <= finest
    assert plan.blocks >= sms or plan.split == finest
    if plan.tiles >= 2 * sms:
        assert plan.split == 1
    # the workspace the wrapper hands the kernel holds every partial
    ws, cnt = kgemm.workspace(torch.device("cpu"), 0, plan)
    assert ws.dtype == cnt.dtype == torch.int32
    assert ws.numel() >= plan.ws_ints == (plan.tiles * kgemm.GEMM_TILE ** 2 if plan.split > 1 else 0)
    assert cnt.numel() >= plan.counters and not cnt.any() and not ws.any()


# -------------------------------------------------------------- IM2COL ----


@pytest.mark.parametrize("h,w,c,k,stride,pad", [
    (8, 8, 3, 3, 1, 1), (8, 8, 4, 3, 2, 1), (16, 16, 8, 5, 2, 2), (7, 9, 2, 3, 1, 0),
    (224, 224, 3, 7, 2, 3),     # ResNet conv1
    (4, 4, 1, 1, 1, 0), (10, 10, 3, 1, 2, 0),
])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_im2col_matches_jax(h, w, c, k, stride, pad, against):
    img = _i8(np.random.default_rng(h + c), (h, w, c))
    if against == "pallas":
        want = jops.im2col(jnp.asarray(img), k, stride, pad)
    else:
        want = jref.im2col_ref(jnp.asarray(img), k, stride, pad)
    got = ops.im2col(torch.from_numpy(img), k, stride, pad)
    _same(got, want)
    _same(ops.im2col_ref(torch.from_numpy(img), k, stride, pad), want)


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_im2col_dtype_sweep(dtype):
    x = np.random.default_rng(2).standard_normal((6, 6, 2)).astype(np.float32) * 40
    jdt = {"int8": jnp.int8, "float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = np.asarray(jops.im2col(jnp.asarray(x).astype(jdt), 3, 1, 1), np.float32)
    got = ops.im2col(torch.from_numpy(x).to(tdt), 3, 1, 1)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


# ------------------------------------------------------- conv-as-GEMM -----


@pytest.mark.parametrize("h,cin,cout,k,stride,pad,relu", [
    (8, 3, 16, 3, 1, 1, True),
    (8, 4, 8, 3, 2, 1, False),
    (9, 2, 4, 1, 1, 0, True),
    (10, 3, 6, 1, 2, 0, False),   # k=1 s=2: the PU's strided linear path
    (12, 2, 4, 5, 2, 2, True),
])
@pytest.mark.parametrize("residual", [False, True])
def test_conv2d_int8_matches_jax(h, cin, cout, k, stride, pad, relu, residual):
    rng = np.random.default_rng(h * cin + cout)
    img, w4d = _i8(rng, (h, h, cin)), _i8(rng, (k, k, cin, cout))
    bias = rng.integers(-300, 300, (cout,), dtype=np.int32)
    oh = (h + 2 * pad - k) // stride + 1
    res = _i8(rng, (oh, oh, cout)) if residual else None
    kw = dict(stride=stride, pad=pad, shift=7, relu=relu)
    jres = None if res is None else jnp.asarray(res)
    tres = None if res is None else torch.from_numpy(res)
    want = jops.conv2d_int8(jnp.asarray(img), jnp.asarray(w4d), jnp.asarray(bias), k=k,
                            residual=jres, **kw)
    _same(ops.conv2d_int8(torch.from_numpy(img), torch.from_numpy(w4d), torch.from_numpy(bias),
                          k=k, residual=tres, **kw), want)
    _same(ops.conv2d_int8_ref(torch.from_numpy(img), torch.from_numpy(w4d), torch.from_numpy(bias),
                              residual=tres, **kw),
          jref.conv2d_int8_ref(jnp.asarray(img), jnp.asarray(w4d), jnp.asarray(bias),
                               residual=jres, **kw))


# ----------------------------------------------------------------- NIU ----


NIU_MAX_TIES = 1e-4     # share of a case's elements that may differ at a tie


def _niu_case(against, q, exp, seed, **kw):
    """The port's NIU against the JAX one under the contract of
    ``repro_torch.kernels.niu``: equal at every element but those whose
    float32 value before rounding lies within 2 ulps of a half-integer
    (an ulp of difference in XLA's ``log``/``cos`` flips them), where
    they differ by exactly 1, at most ``NIU_MAX_TIES`` of the elements."""
    fn = jniu.niu_refresh if against == "pallas" else jniu.niu_refresh_ref
    want = np.asarray(fn(jnp.asarray(q), jnp.int32(exp), seed, **kw)).astype(np.int32)
    tq, te = torch.from_numpy(q), torch.tensor(exp, dtype=torch.int32)
    got = ops.niu_refresh(tq, te, seed, **kw)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    g = got.numpy().astype(np.int32)
    bad = g != want
    assert (np.abs(g - want)[bad] == 1).all()
    assert kniu.near_half(kniu.niu_prerounding_ref(tq, te, seed, **kw)).numpy()[bad].all()
    assert bad.sum() <= NIU_MAX_TIES * q.size, (bad.sum(), q.size)
    return got


@pytest.mark.parametrize("r,c", [(256, 256), (300, 200), (64, 512), (100, 100)])
@pytest.mark.parametrize("seed", [7, -5])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_niu_matches_jax(r, c, seed, against):
    _niu_case(against, _i8(np.random.default_rng(r + c), (r, c), lo=-127), -4, seed)


@pytest.mark.parametrize("kw", [
    dict(prog_noise_scale=0.0, read_noise_scale=0.0, drift=1.0),     # identity
    dict(prog_noise_scale=0.0, read_noise_scale=0.0, drift=0.8),     # drift alone
    dict(prog_noise_scale=2.0, read_noise_scale=1.0),                # saturation
    dict(prog_noise_scale=0.1, read_noise_scale=0.0),
], ids=["zero_noise", "drift", "saturation", "prog_only"])
def test_niu_options_match_jax(kw):
    q = _i8(np.random.default_rng(8), (96, 96), lo=-127)
    got = _niu_case("oracle", q, -2, 5, **kw).numpy()
    if kw.get("drift") == 1.0:
        np.testing.assert_array_equal(got, q)
    assert got.min() >= -128 and got.max() <= 127


def test_niu_deterministic_per_seed():
    q = torch.from_numpy(_i8(np.random.default_rng(9), (128, 128), lo=-127))
    e = torch.tensor(-3, dtype=torch.int32)
    a, b, c = (ops.niu_refresh(q, e, s) for s in (42, 42, 43))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_niu_noise_statistics():
    """Perturbation std in q-units ~ scale*(0.25|q| + 0.05 qmax)."""
    q = torch.full((512, 512), 64, dtype=torch.int8)
    out = ops.niu_refresh(q, torch.tensor(0, dtype=torch.int32), 1,
                          prog_noise_scale=0.1, read_noise_scale=0.0)
    err = out.numpy().astype(np.int32) - 64
    expected = np.sqrt((0.1 * (0.25 * 64 + 0.05 * 64)) ** 2 + 1 / 12)
    assert err.std() == pytest.approx(expected, rel=0.1)
    assert abs(err.mean()) < 0.1
