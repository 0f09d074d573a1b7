"""The redesigned NIU round and the GEMM's conv mode, on the CPU path.

- :func:`niu.niu_plan` over a mixed set of matrices: its ``refresh`` on
  CPU tensors equals the JAX Pallas kernel (interpret mode) matrix by
  matrix, with one shared seed and with a seed per matrix, bit for bit
  but at ties that an ulp of difference in XLA's ``log``/``cos`` flips
  (the NIU's contract, ``repro_torch.kernels.niu``);
- the kernel's map of blocks to matrices (``niu_first_blocks``, the binary
  search ``niu_block_matrix``, 16 elements a thread) covers every element
  of every matrix exactly once;
- the conv mode's gather (``csrc/pu.cu::ConvRows``), emulated with the
  kernel's own index formulas (a shift where C is a power of two, a
  division otherwise), equals ``im2col`` tile by tile, against the port's
  plain version and the JAX Pallas kernel;
- ``int8_gemm.conv_mode`` sends exactly ResNet-50's 3x3 and strided 1x1
  convolutions to the conv mode, and not conv1.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import niu as jniu  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import common, niu, ref  # noqa: E402
from repro_torch.models import resnet  # noqa: E402

kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")


@pytest.fixture(autouse=True)
def _no_launches():
    common.reset_launches()
    yield
    assert not any(common.launch_counts().values()), "a CPU tensor must never count as a kernel launch"


# ----------------------------------------------------------------- NIU ----

# (shape, exponent); the last is a 3x3 conv's (k, k, Cin, Cout) weights viewed as (k*k*Cin, Cout)
NIU_MATS = [((1, 1), -9), ((1, 17), 2), ((64, 64), -4), ((300, 200), 0), ((3, 3, 16, 32), -7)]
NIU_SEEDS = [11, -5, 2 ** 31 - 1, 0, -987654321]
NIU_MAX_TIES = 1e-4       # share of a case's elements that may differ at a tie
NIU_GAUSSIAN_ULPS = 4     # the port's Gaussians against XLA's (3 measured on an x86 host)


def _niu_mats():
    rng = np.random.default_rng(17)
    mats = []
    for shape, e in NIU_MATS:
        q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
        mats.append((q.reshape(-1, shape[-1]), torch.tensor(e, dtype=torch.int32)))
    return mats


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prog_noise_scale=0.2, read_noise_scale=0.05, drift=0.9),
    dict(prog_noise_scale=0.1, read_noise_scale=0.0),
], ids=["default", "drift", "no_read"])
@pytest.mark.parametrize("per_matrix", [False, True], ids=["shared_seed", "seed_per_matrix"])
def test_niu_plan_refresh_matches_jax(kw, per_matrix):
    mats = _niu_mats()
    plan = niu.niu_plan(mats)
    seed = torch.tensor(NIU_SEEDS, dtype=torch.int32) if per_matrix else 1234
    outs = plan.refresh(seed, **kw)
    assert len(outs) == len(mats)
    ties, total = 0, 0
    for m, ((q, e), got) in enumerate(zip(mats, outs)):
        s = NIU_SEEDS[m] if per_matrix else 1234
        want = jniu.niu_refresh(jnp.asarray(q.numpy()), jnp.int32(int(e)), s, interpret=True, **kw)
        assert got.dtype == torch.int8 and tuple(got.shape) == tuple(q.shape)
        ties += _ties(got, want, niu.niu_prerounding_ref(q, e, s, **kw))
        total += q.numel()
        # the one-matrix entry point draws the same round
        assert torch.equal(niu.niu_refresh(q, e, s, **kw), got)
    assert ties <= NIU_MAX_TIES * total, (ties, total)


def _ties(got, want, pre) -> int:
    """The NIU's contract with the reference (``repro_torch.kernels.niu``):
    ``got`` equals ``want`` but where the float32 value before rounding,
    ``pre``, lies within 2 ulps of a half-integer, and there it differs by
    exactly 1.  Returns how many elements differ."""
    g, w = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    bad = g != w
    assert (np.abs(g - w)[bad] == 1).all()
    assert niu.near_half(pre).numpy()[bad].all(), pre.numpy()[bad]
    return int(bad.sum())


def test_niu_gaussians_differ_from_xla_by_a_few_ulps():
    """The cause of the ties above: the port's plain Box-Muller Gaussians
    and XLA's, on the 300x200 counter array of seed 1234, differ in the
    last bits of many elements (``torch.log``/``torch.cos`` against XLA's),
    by at most a few float32 ulps, never in sign."""
    counter = niu._counter(300, 200, 1234, "cpu")
    for salt in (niu._SALT_PROG, niu._SALT_READ):
        got = niu._gaussian(counter, salt).numpy()
        want = np.asarray(jniu._gaussian(jnp.asarray(counter.numpy().astype(np.uint32)), salt))
        assert np.array_equal(np.signbit(got), np.signbit(want))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        print(f"salt {salt:#x}: {int((ulps > 0).sum())} of {ulps.size} Gaussians differ from "
              f"XLA's, by at most {int(ulps.max())} ulps")
        assert ulps.max() <= NIU_GAUSSIAN_ULPS


def test_niu_near_half_finds_the_ties():
    x = torch.tensor([-69.49999, -69.5, 2.5000002, 2.4, 0.0, 1e-8, 1.5, 7.0], dtype=torch.float32)
    assert niu.near_half(x).tolist() == [True, True, True, False, False, False, True, False]
    pre = niu.niu_prerounding_ref(*_niu_mats()[3], 1234)
    assert torch.equal(niu.niu_refresh_ref(*_niu_mats()[3], 1234),
                       torch.clamp(torch.round(pre), -128, 127).to(torch.int8))


def test_niu_plan_outputs_share_one_aligned_buffer_and_leave_the_weights():
    mats = _niu_mats()
    before = [q.clone() for q, _ in mats]
    plan = niu.niu_plan(mats)
    a = [o.clone() for o in plan.refresh(3)]
    b = plan.refresh(3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(q, q0) for (q, _), q0 in zip(mats, before))
    base = plan.outs[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in plan.outs)
    offs = [o.data_ptr() - base for o in plan.outs]
    assert all(off % niu.NIU_ALIGN == 0 for off in offs)
    ends = [off + o.numel() for off, o in zip(offs, plan.outs)]
    assert all(e <= nxt for e, nxt in zip(ends, offs[1:]))


def test_niu_plan_rejects_what_the_kernel_cannot_take():
    q = torch.zeros((4, 8), dtype=torch.int8)
    for bad in ([], [(q.t(), 0)], [(q.float(), 0)], [(q.reshape(-1), 0)],
                [(torch.zeros((0, 3), dtype=torch.int8), 0)]):
        with pytest.raises(ValueError):
            niu.niu_plan(bad)
    plan = niu.niu_plan([(q, 0), (q, 1)])
    with pytest.raises(ValueError):
        plan.refresh(torch.tensor([1, 2, 3], dtype=torch.int32))
    with pytest.raises(ValueError):
        plan.refresh(torch.tensor([1.0, 2.0]))


@pytest.mark.parametrize("ns", [
    [1], [16], [17], [niu.NIU_BLOCK], [niu.NIU_BLOCK + 1],
    [1, 17, niu.NIU_BLOCK, 3 * niu.NIU_BLOCK - 5, 16, 100003, 2, 4095],
], ids=["one", "sixteen", "seventeen", "one_block", "block_and_one", "mixed"])
def test_niu_blocks_cover_every_element_once(ns):
    """Emulates the grid of ``niu_refresh_kernel`` / ``niu_absmax_kernel``:
    block b's matrix by the binary search, thread t's 16 elements from
    ``i0 = (b - first[m]) * NIU_BLOCK + 16 t``, cut at the matrix's end."""
    first = niu.niu_first_blocks(ns)
    assert len(first) == len(ns) + 1 and first[0] == 0
    hits = [np.zeros(n, dtype=np.int64) for n in ns]
    for b in range(first[-1]):
        m = niu.niu_block_matrix(first[:-1], b)
        assert first[m] <= b < first[m + 1]
        for t in range(niu.NIU_THREADS):
            i0 = (b - first[m]) * niu.NIU_BLOCK + t * niu.NIU_PER_THREAD
            hits[m][i0: min(i0 + niu.NIU_PER_THREAD, ns[m])] += 1
    for n, h in zip(ns, hits):
        assert (h == 1).all(), n
    # every block holds some element of its matrix: no block is idle
    assert first[-1] == sum(-(-n // niu.NIU_BLOCK) for n in ns)


# ------------------------------------------------------ the conv mode ----

TILE, BK = kgemm.GEMM_TILE, kgemm.GEMM_BK


def _conv_gather(img: torch.Tensor, k: int, stride: int, pad: int, shift: bool) -> torch.Tensor:
    """The implicit patch matrix as ``ConvRows`` loads it, tile by tile:
    for each (p0, k0) tile, each thread's row p's (y0, x0) from ``init``
    and each 16-byte chunk's source from ``async``; ``shift`` takes k >>
    log2(C) (C a power of two), else k // C.  Padded to whole tiles."""
    h, w, c = img.shape
    oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    p_all, m = oh * ow, k * k * c
    flat = img.reshape(-1)
    q = torch.arange(TILE * BK // 16)                 # the chunks of one stage: 256 threads
    r, col = q >> 2, (q & 3) * 16
    out = torch.zeros((-(-p_all // TILE) * TILE, -(-m // BK) * BK), dtype=img.dtype)
    c_shift = c.bit_length() - 1
    for p0 in range(0, p_all, TILE):
        p = p0 + r
        oy = p // ow
        ox = p - oy * ow
        y0 = torch.where(p < p_all, oy * stride - pad, torch.tensor(-(1 << 28)))
        x0 = ox * stride - pad
        for k0 in range(0, m, BK):
            kk = k0 + col
            seg = kk >> c_shift if shift else kk // c
            ci = kk - seg * c
            ki = seg // k
            kj = seg - ki * k
            iy, ix = y0 + ki, x0 + kj
            ok = (kk < m) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            src = torch.where(ok, (iy * w + ix) * c + ci, torch.zeros_like(ci))
            idx = src[:, None] + torch.arange(16)
            chunk = torch.where(ok[:, None], flat[idx], torch.zeros((), dtype=img.dtype))
            for j in range(16):
                out[p0 + r, k0 + col + j] = chunk[:, j]
    return out[:p_all, :m]


def _resnet_3x3_geometries(variant):
    """(H, C, stride) of each distinct 3x3 conv of a ResNet at 224x224."""
    specs, seen = resnet.resnet_conv_specs(variant), []

    def conv(spec, hw, res):
        if spec.k == 3 and (hw, spec.cin, spec.stride) not in seen:
            seen.append((hw, spec.cin, spec.stride))
        return (hw + 2 * spec.pad - spec.k) // spec.stride + 1

    hw = conv(specs[0], 224, None)
    hw = (hw + 2 - 3) // 2 + 1          # the 3x3 / 2 max-pool
    resnet._walk(specs, hw, hw, conv)
    return seen


CONV_GEOMS = sorted(set(_resnet_3x3_geometries(18) + _resnet_3x3_geometries(50)))
ODD_GEOMS = [(9, 16, 2), (9, 48, 2), (5, 32, 1), (13, 48, 1)]     # (H, C, stride), pad 1


def test_conv_geometries_are_the_resnet_3x3_convs():
    assert (56, 64, 1) in CONV_GEOMS and (7, 512, 1) in CONV_GEOMS and (14, 512, 2) in CONV_GEOMS
    assert all(c % 16 == 0 for _, c, _ in CONV_GEOMS) and len(CONV_GEOMS) == 10


@pytest.mark.parametrize("h,c,stride", CONV_GEOMS + ODD_GEOMS)
def test_conv_mode_gather_equals_im2col(h, c, stride):
    img = torch.from_numpy(np.random.default_rng(h * c + stride).integers(-128, 128, (h, h, c),
                                                                          dtype=np.int8))
    want = ref.im2col_ref(img, 3, stride, 1)
    paths = [True, False] if c & (c - 1) == 0 else [False]      # shift where C is a power of two
    for shift in paths:
        assert torch.equal(_conv_gather(img, 3, stride, 1, shift), want), shift
    np.testing.assert_array_equal(want.numpy(), np.asarray(jops.im2col(
        jnp.asarray(img.numpy()), 3, stride, 1, interpret=True)))


@pytest.mark.parametrize("h,c,k,stride,pad", [(8, 16, 1, 2, 0), (7, 32, 1, 1, 1), (6, 16, 5, 1, 2)])
def test_conv_mode_gather_other_kernel_sizes(h, c, k, stride, pad):
    img = torch.from_numpy(np.random.default_rng(h + c + k).integers(-128, 128, (h, h, c),
                                                                      dtype=np.int8))
    assert torch.equal(_conv_gather(img, k, stride, pad, True), ref.im2col_ref(img, k, stride, pad))
    assert torch.equal(_conv_gather(img, k, stride, pad, False), ref.im2col_ref(img, k, stride, pad))


@pytest.mark.parametrize("h,cin,cout,k,stride,pad", [(9, 16, 32, 3, 2, 1), (8, 48, 16, 3, 1, 1),
                                                     (10, 32, 64, 1, 2, 0)])
@pytest.mark.parametrize("residual", [False, True])
def test_int8_conv_gemm_cpu_path_matches_jax(h, cin, cout, k, stride, pad, residual):
    rng = np.random.default_rng(h * cin + cout + k)
    img, w4d = rng.integers(-128, 128, (h, h, cin), dtype=np.int8), rng.integers(
        -128, 128, (k, k, cin, cout), dtype=np.int8)
    bias = rng.integers(-3000, 3000, (cout,), dtype=np.int32)
    oh = (h + 2 * pad - k) // stride + 1
    res = rng.integers(-128, 128, (oh, oh, cout), dtype=np.int8) if residual else None
    assert kgemm.conv_mode(cin, cout, k, stride, pad)
    got = kgemm.int8_conv_gemm(torch.from_numpy(img), torch.from_numpy(w4d), torch.from_numpy(bias),
                               7, None if res is None else torch.from_numpy(res),
                               k=k, stride=stride, pad=pad, relu=True)
    want = jops.conv2d_int8(jnp.asarray(img), jnp.asarray(w4d), jnp.asarray(bias), k=k,
                            stride=stride, pad=pad, shift=7, relu=True,
                            residual=None if res is None else jnp.asarray(res))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_mode_takes_the_resnet50_3x3_and_strided_1x1_convs_only():
    specs = resnet.resnet_conv_specs(50)
    taken = [s for s in specs if kgemm.conv_mode(s.cin, s.cout, s.k, s.stride, s.pad)]
    assert len([s for s in taken if s.k == 3]) == 16 == len([s for s in specs if s.k == 3])
    assert [s for s in taken if s.k != 3] == [s for s in specs if s.k == 1 and s.stride == 2]
    assert len(taken) == 19 and specs[0] not in taken and specs[0].k == 7
    assert not kgemm.conv_mode(64, 256, 1, 1, 0) and not kgemm.conv_mode(3, 64, 7, 2, 3)
    assert not kgemm.conv_mode(48, 24, 3, 1, 1) and kgemm.conv_mode(48, 32, 3, 1, 1)
