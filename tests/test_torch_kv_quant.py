"""The int8 power-of-two KV cache (``kv_quant``) in the port, held against
the JAX package.

Smoke configs of the reference's own kv_quant tests (olmo-1b and dense
mixtral-8x7b; ``tests/test_kv_quant.py``), float32 unless a case says
otherwise, the reference's parameters converted through ``interop``.

The contract with ``repro.models.transformer.kv_quantize``: exponents
equal, except where ``amax / 127`` lies within ``TIE_ULPS`` float32 ulps of
a power of two (there the two ``log2`` may round apart and ``ceil``
flips), counted; payloads equal wherever the exponents are and |e| <= 12;
at |e| >= 13 the reference divides by XLA's inexact ``exp2``, and the
port's payload is the one an exact power of two gives (checked in
float64).  Where the two packages' k and v differ in their last bits
(float32 products summed in another order), a payload may round the
other way at a half step: the decode and prefill caches are held to
payloads within 1, exponents equal but at ties, and both counted against
``MAX_FLIP_SHARE``.

- ``kv_quantize`` / ``kv_dequantize`` on seeded rows from 2**-20 to
  2**20, constructed ties, zero rows; the reference test's half-step
  bound; dequantization exact in bf16 and float32;
- ``init_cache``: four leaves, int8, exponents -126, the reference's
  shapes (a ring's too);
- ``decode_step`` over 10 tokens, both paths, against the reference's
  (``ATOL_F32``, equal argmax), and the quantized decode against the bf16
  cache within the reference test's 0.25 with equal argmax;
- prefill's quantized cache, bucketed with ``lengths`` too, then a
  per-lane decode step;
- the ring with ``kv_quant`` through two wraps against the reference's
  construction (``test_ring_with_kv_quant_composes``);
- the plain int8 attention equal to the plain bf16 attention on the
  dequantized cache bit for bit;
- greedy streams of the port's engine against the JAX engine's, both
  paths, and staged decode at M = 1 and 2;
- the staged lane groups' attention calls planned as the full batch's
  (``plan_lanes``), so their splits, and with them their sums, are the
  single-PU call's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu as tpu  # noqa: E402
from repro_torch.kernels import decode, ref  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

ATOL_F32 = 1e-4
TIE_ULPS = 8                # float32 ulps around a power of two where log2 may round apart
MAX_FLIP_SHARE = 1e-3       # cache entries a last-bit difference may round the other way
_P = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops on one intra-op thread (test processes run side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a, np.float32) if np.asarray(a).dtype.kind == "f" else np.asarray(a)


def _once(key, make):
    if key not in _P:
        _P[key] = make()
    return _P[key]


def _cfgs(arch="olmo", dtype="float32", **kw):
    """(reference, port) smoke configs with ``kv_quant``: olmo-1b or dense
    mixtral-8x7b (window 64)."""
    out = []
    for get, smoke in ((jget_config, jsmoke), (get_config, smoke_variant)):
        if arch == "mixtral":
            cfg = dataclasses.replace(smoke(get("mixtral-8x7b")), n_experts=0, top_k=0)
        else:
            cfg = smoke(get("olmo-1b"))
        out.append(dataclasses.replace(cfg, kv_quant=True, dtype=dtype, **kw))
    return out


def _jparams(arch="olmo"):
    def make():
        jcfg, _ = _cfgs(arch)
        return jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))

    return _once(("params", arch), make)


def _ties(x: np.ndarray) -> np.ndarray:
    """Rows whose ``max(amax, 1e-30) / 127`` lies within ``TIE_ULPS``
    float32 ulps of a power of two."""
    amax = np.abs(x.astype(np.float32)).max(-1)
    r = (np.maximum(amax, np.float32(1e-30)) / np.float32(127.0)).astype(np.float32)
    frac = r.view(np.int32) & 0x7FFFFF
    return (frac <= TIE_ULPS) | (frac >= 0x800000 - TIE_ULPS)


def _rows():
    """Seeded rows (2, 64, 4, 32) at scales 2**-20 to 2**20, one row zero,
    and constructed ties (amax / 127 a power of two, and one ulp above)."""
    rng = np.random.default_rng(0)
    scale = 2.0 ** rng.integers(-20, 21, (2, 64, 4, 1))
    x = (rng.standard_normal((2, 64, 4, 32)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    for i, n in enumerate((-9, -3, 0, 4)):
        row = x[1, i, 0]
        row[:] = np.clip(row, -0.5, 0.5) * 2.0 ** n
        row[0] = np.float32(127 * 2.0 ** n)                       # exactly a power of two
        x[1, i, 1] = row
        x[1, i, 1, 0] = np.nextafter(row[0], np.float32(np.inf))  # one ulp above
    return x


# ------------------------------------------------ the cache's arithmetic ---


def test_kv_quantize_matches_jax_under_the_contract():
    x = _rows()
    jq, je = (np.asarray(a) for a in jtf.kv_quantize(jnp.asarray(x)))
    tq, te = transformer.kv_quantize(torch.from_numpy(x))
    tq, te = tq.numpy(), te.numpy()
    assert tq.dtype == te.dtype == np.int8 and tq.shape == x.shape and te.shape == x.shape[:-1]
    ties = _ties(x)
    assert ties.sum() >= 8                                    # the constructed ones at least
    assert (te == je)[~ties].all(), "exponents differ away from a power-of-two tie"
    small = (np.abs(te.astype(np.int32)) <= 12) & (te == je)
    assert small.sum() > 0.3 * small.size
    np.testing.assert_array_equal(tq[small], jq[small])
    # every row, ties and |e| >= 13 included: the exact power of two's payload
    e = te.astype(np.float64)[..., None]
    want = np.clip(np.round(x.astype(np.float64) / np.exp2(e)), -128, 127)
    np.testing.assert_array_equal(tq, want.astype(np.int8))
    assert (te[0, 0, 0], tq[0, 0, 0].any()) == (je[0, 0, 0], False)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_kv_dequantize_is_exact_and_matches_jax(dt):
    x = _rows()
    q, e = transformer.kv_quantize(torch.from_numpy(x))
    got = transformer.kv_dequantize(q, e, dt)
    assert got.dtype == dt
    exact = q.numpy().astype(np.float64) * np.exp2(e.numpy().astype(np.float64))[..., None]
    np.testing.assert_array_equal(got.double().numpy(), exact)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    jgot = np.asarray(jtf.kv_dequantize(jnp.asarray(q.numpy()), jnp.asarray(e.numpy()), jdt),
                      np.float64)
    small = np.abs(e.numpy().astype(np.int32)) <= 12
    np.testing.assert_array_equal(jgot[small], exact[small])


def test_kv_roundtrip_within_half_a_step_and_zero_rows():
    """The reference test's bound (``test_kv_roundtrip_error_bound``) and
    its zero rows (``test_kv_quant_zero_rows_safe``)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 4, 32)).astype(np.float32) * 3)
    q, e = transformer.kv_quantize(x)
    back = transformer.kv_dequantize(q, e, torch.float32)
    step = ref.pow2_exact(e.to(torch.int32))[..., None]
    assert ((back - x).abs() <= step / 2).all()
    zq, ze = transformer.kv_quantize(torch.zeros(1, 4, 2, 8))
    assert not zq.any() and not transformer.kv_dequantize(zq, ze, torch.float32).any()
    # an unwritten slot (payload 0, exponent -126) is exactly 0
    zero = transformer.kv_dequantize(torch.zeros(3, 8, dtype=torch.int8),
                                     torch.full((3,), -126, dtype=torch.int8), torch.bfloat16)
    assert not zero.any()


def test_init_cache_is_the_references():
    for arch, kw in (("olmo", {}), ("mixtral", dict(kv_ring=True))):
        jcfg, tcfg = _cfgs(arch, **kw)
        model_api.get_api(tcfg)                             # kv_quant is ported
        got = transformer.init_cache(tcfg, 2, 96, "cpu")
        want = jtf.init_cache(jcfg, 2, 96)
        assert len(got) == len(want) == 4
        assert [tuple(c.shape) for c in got] == [c.shape for c in want]
        assert all(c.dtype == torch.int8 for c in got)
        assert not got[0].any() and not got[1].any()
        assert (got[2] == -126).all() and (got[3] == -126).all()
        assert got[0].shape[2] == (64 if kw else 96)
        # the reference's cache carried over, int8 leaves included
        conv = interop.cache_from_jax(tuple(np.asarray(c) for c in want))
        assert all(torch.equal(a, b) for a, b in zip(conv, got))


# -------------------------------------------------------------- decode ---


def _cache_close(tcache, jcache, what):
    """Payloads within 1 and exponents equal, but for at most
    ``MAX_FLIP_SHARE`` entries (last-bit differences of k, v at a half
    step, and ties); returns the count of those that differ."""
    assert len(tcache) == len(jcache) == 4
    flips = 0
    for i, (a, b) in enumerate(zip(tcache, jcache)):
        a, b = _np(a).astype(np.int32), np.asarray(b).astype(np.int32)
        assert a.shape == b.shape, what
        if i < 2:
            assert np.abs(a - b).max() <= 1, what
        flips += int((a != b).sum())
    n = sum(c.numel() for c in tcache)
    assert flips <= MAX_FLIP_SHARE * n, (what, flips, n)
    return flips


def _jdecode(jcfg):
    return _once(("jdecode", jcfg), lambda: jax.jit(
        lambda p, c, t, i: jtf.decode_step(jcfg, p, c, t, i)))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", ["olmo", "mixtral"])
def test_decode_steps_match_jax(arch, kernels):
    """10 tokens, the reference test's run (``test_quantized_decode_tracks_bf16_path``)."""
    jcfg, tcfg = _cfgs(arch, decode_kernels=kernels)
    jparams, tparams = jax.tree.map(jnp.asarray, _jparams(arch)), interop.from_jax(_jparams(arch))
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 10)).astype(np.int32)
    jcache, tcache = jtf.init_cache(jcfg, 2, 24), transformer.init_cache(tcfg, 2, 24, "cpu")
    step = _jdecode(jcfg)
    decode.reset_launches()
    for i in range(10):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tl, tcache = transformer.decode_step(tcfg, tparams, tcache,
                                             torch.from_numpy(toks[:, i:i + 1]),
                                             torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
        assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
    _cache_close(tcache, jcache, f"{arch} decode cache")
    assert all(fn.launches == 0 for fn in decode.KERNELS)  # CPU: the plain versions
    # the bf16 cache on the same tokens: the reference test's 0.25, argmax equal
    _, plain = _cfgs(arch, decode_kernels=kernels, dtype="bfloat16")
    out = []
    for cfg in (plain, dataclasses.replace(plain, kv_quant=False)):
        cache = transformer.init_cache(cfg, 2, 24, "cpu")
        for i in range(10):
            lg, cache = transformer.decode_step(cfg, tparams, cache,
                                                torch.from_numpy(toks[:, i:i + 1]),
                                                torch.tensor(i, dtype=torch.int32))
        out.append(_np(lg))
    assert np.abs(out[0] - out[1]).max() < 0.25
    assert (out[0].argmax(-1) == out[1].argmax(-1)).all()


def test_prefill_quantized_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = jax.tree.map(jnp.asarray, _jparams()), interop.from_jax(_jparams())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    lengths = np.asarray([16, 11], np.int32)
    for lens in (None, lengths):
        jl, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks),
                                 lengths=None if lens is None else jnp.asarray(lens))
        tl, tcache = transformer.prefill(tcfg, tparams, torch.from_numpy(toks),
                                         lengths=None if lens is None else torch.from_numpy(lens))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
        assert [c.dtype for c in tcache] == [torch.int8] * 4
        _cache_close(tcache, jcache, f"prefill lengths={lens}")
    # the quantized prefill cache in a longer buffer, then a per-lane step
    cache = transformer.init_cache(tcfg, 2, 32, "cpu")
    jfull = jtf.init_cache(jcfg, 2, 32)
    cache = tuple(c.index_copy_(2, torch.arange(16), t) for c, t in zip(cache, tcache))
    jfull = tuple(c.at[:, :, :16].set(t) for c, t in zip(jfull, jcache))
    pos, nxt = np.asarray(lengths), np.asarray([[7], [300]], np.int32)
    jl, _ = jtf.decode_step(jcfg, jparams, jfull, jnp.asarray(nxt), jnp.asarray(pos))
    tl, _ = transformer.decode_step(tcfg, tparams, cache, torch.from_numpy(nxt),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)


def test_ring_with_kv_quant_through_two_wraps():
    """The reference's construction (``test_kv_ring.py::
    test_ring_with_kv_quant_composes``): dense mixtral with the ring and
    the int8 cache, decoded past two wraps, against the reference's run,
    and with the argmax of the bf16 full cache (the reference's check)."""
    jcfg, tcfg = _cfgs("mixtral", kv_ring=True)
    jparams, tparams = jax.tree.map(jnp.asarray, _jparams("mixtral")), \
        interop.from_jax(_jparams("mixtral"))
    s = 2 * tcfg.window + 9
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (1, s)).astype(np.int32)
    jcache, tcache = jtf.init_cache(jcfg, 1, s + 8), transformer.init_cache(tcfg, 1, s + 8, "cpu")
    step = _jdecode(jcfg)
    for i in range(s):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tl, tcache = transformer.decode_step(tcfg, tparams, tcache,
                                             torch.from_numpy(toks[:, i:i + 1]),
                                             torch.tensor(i, dtype=torch.int32))
    assert tcache[0].shape[2] == tcache[2].shape[2] == tcfg.window
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
    _cache_close(tcache, jcache, "ring cache")
    base = dataclasses.replace(tcfg, kv_ring=False, kv_quant=False, dtype="bfloat16")
    cache = transformer.init_cache(base, 1, s + 8, "cpu")
    for i in range(s):
        lb, cache = transformer.decode_step(base, tparams, cache, torch.from_numpy(toks[:, i:i + 1]),
                                            torch.tensor(i, dtype=torch.int32))
    assert (_np(tl).argmax(-1) == _np(lb).argmax(-1)).all()
    # a prompt past the window: the ring re-layout of all four leaves
    jl, jring = jtf.prefill(jcfg, jparams, jnp.asarray(toks[:, :tcfg.window + 17]))
    tl, tring = transformer.prefill(tcfg, tparams, torch.from_numpy(toks[:, :tcfg.window + 17]))
    assert [tuple(c.shape) for c in tring] == [c.shape for c in jring]
    _cache_close(tring, jring, "ring prefill")


# ------------------------------------------------------------ attention ---


@pytest.mark.parametrize("case", ["valid_len", "ring", "no_valid_slot"])
def test_plain_int8_attention_equals_bf16_on_the_dequantized_cache(case):
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, hd, sk, d = 3, 8, 2, 32, 40, 64
    q = torch.randn(b, hq, hd, generator=g).to(torch.bfloat16)
    kq, ke = transformer.kv_quantize(torch.randn(b, sk, hkv, hd, generator=g) * 2)
    vq, ve = transformer.kv_quantize(torch.randn(b, sk, hkv, hd, generator=g))
    ke[:, 30:], kq[:, 30:] = -126, 0                           # slots never written
    ve[:, 30:], vq[:, 30:] = -126, 0
    wo = (torch.randn(hq * hd, d, generator=g) * 0.05).to(torch.bfloat16)
    vlen = torch.tensor([30, 17, 1], dtype=torch.int32)
    kw = dict(q_positions=vlen - 1, kv_valid_len=vlen)
    if case == "ring":
        kw = dict(q_positions=vlen + 50, kv_positions=transformer.ring_positions(vlen + 50, sk))
    elif case == "no_valid_slot":
        kw["kv_valid_len"] = torch.tensor([0, 17, 1], dtype=torch.int32)
    k, v = (transformer.kv_dequantize(p, e, torch.bfloat16) for p, e in ((kq, ke), (vq, ve)))
    want = ref.decode_attention_ref(q, k, v, wo, **kw)
    got = ref.decode_attention_ref(q, kq, vq, wo, k_exp=ke, v_exp=ve, **kw)
    assert torch.equal(got, want)
    assert torch.equal(decode.fused_decode_attention(q, kq, vq, wo, k_exp=ke, v_exp=ve, **kw), want)
    with pytest.raises(ValueError, match="together"):
        ref.decode_attention_ref(q, kq, vq, wo, k_exp=ke, **kw)


# -------------------------------------------------------------- serving ---

SERVE = dict(max_batch=2, max_len=64, max_new_tokens=8, seed=0)
PROMPT_LENS = (9, 14, 20, 6)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]


def _stream(eng, prompts):
    """Staggered admissions: the first request decodes alone first."""
    eng.submit(prompts[0].copy())
    eng.step()
    for p in prompts[1:]:
        eng.submit(p.copy())
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _jax_streams():
    def make():
        jcfg, _ = _cfgs()
        eng = jserving.ServingEngine(jcfg, jax.tree.map(jnp.asarray, _jparams()),
                                     jserving.ServeConfig(**SERVE))
        assert eng.bucketed_prefill and len(eng._cache) == 4
        return _stream(eng, _prompts())

    return _once("jax_streams", make)


@pytest.mark.parametrize("kernels", [False, True])
def test_greedy_streams_match_jax_engine(kernels):
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, interop.from_jax(_jparams()),
                        ServeConfig(decode_kernels=kernels, **SERVE), "cpu")
    assert eng.bucketed_prefill and [c.dtype for c in eng._cache] == [torch.int8] * 4
    eng.warmup()
    got = _stream(eng, _prompts())
    assert got == _jax_streams()
    assert all(len(s) == SERVE["max_new_tokens"] for s in got.values())


@pytest.mark.parametrize("m", [1, 2])
def test_staged_decode_matches_single_pu(m):
    """Two stages (the reference's profiles) with M lane groups over the
    int8 cache: the staged slices against ``decode_step`` bit for bit,
    and the engine's streams against the single-PU (JAX) ones."""
    _, tcfg = _cfgs(n_layers=4)
    tparams = transformer.init_params(tcfg, 0, "cpu")
    api = model_api.get_api(tcfg)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([13, 40], dtype=torch.int32)
    g = torch.Generator().manual_seed(2)
    cache = tuple(torch.randint(-128, 128, c.shape, generator=g, dtype=torch.int8)
                  if i < 2 else torch.randint(-12, -4, c.shape, generator=g, dtype=torch.int8)
                  for i, c in enumerate(transformer.init_cache(tcfg, 2, 64, "cpu")))
    staged = tuple(c.clone() for c in cache)
    want, cache = api.decode_step(tcfg, tparams, cache, toks, pos)
    h = api.decode_embed(tcfg, tparams, toks, pos)
    for r in ((0, 2), (2, 4)):
        h, _ = api.decode_stage(tcfg, api.slice_params(tcfg, tparams, r), h,
                                api.slice_cache(tcfg, staged, r), pos)
    assert torch.equal(api.decode_unembed(tcfg, tparams, h), want)
    assert all(torch.equal(a, b) for a, b in zip(staged, cache))

    _, tcfg = _cfgs()
    pus = [tpu.host_offload_config(), tpu.tpu_v5e_config()]
    eng = ServingEngine(tcfg, interop.from_jax(_jparams()),
                        ServeConfig(stream_pus=pus, decode_microbatches=m, **SERVE), "cpu")
    assert eng._staged is not None and eng._staged.n_groups == m
    eng.warmup()
    assert _stream(eng, _prompts()) == _jax_streams()
    assert eng.stats()["stage_decode_rounds"] > 0


def test_lane_groups_reduce_as_the_full_batch(monkeypatch):
    """Staged decode at M = 2 hands each lane group's attention the whole
    batch as ``plan_lanes``: :func:`decode.attn_plan` of a group's call is
    the single-PU call's, so each lane's chunks, and the order of its
    sums, are the same (on the card a group planned from its own lanes
    was split otherwise, and its greedy streams parted); and its norms
    reduce over the batch's row count, the group's rows padded, as torch's
    CUDA reductions split a row by the row count."""
    _, tcfg = _cfgs(decode_kernels=True, n_layers=4, dtype="bfloat16")
    calls, norms = [], []
    inner, inner_norm = decode.fused_decode_attention, transformer.apply_norm

    def record(q, k, v, *a, plan_lanes=None, **kw):
        calls.append((q.shape[0], plan_lanes, k.shape[1], k.shape[2], q.shape[2]))
        return inner(q, k, v, *a, plan_lanes=plan_lanes, **kw)

    def record_norm(cfg, x, p):
        if x.shape[1] == 1:                                 # a decode step's norms
            norms.append(x.shape[0])
        return inner_norm(cfg, x, p)

    monkeypatch.setattr(decode, "fused_decode_attention", record)
    monkeypatch.setattr(transformer, "apply_norm", record_norm)
    pus = [tpu.host_offload_config(), tpu.tpu_v5e_config()]
    prompts = [np.arange(5, 5 + n, dtype=np.int32) % 512 for n in (9, 14, 6, 11)]
    # 2048 slots: enough that 2 and 4 lanes split them differently on 132 SMs
    serve = dict(SERVE, max_batch=4, max_len=2048, max_new_tokens=3)
    plans = {}
    for m in (None, 2):
        staged = {} if m is None else dict(stream_pus=pus, decode_microbatches=m)
        eng = ServingEngine(tcfg, transformer.init_params(tcfg, 0, "cpu"),
                            ServeConfig(decode_kernels=True, **staged, **serve), "cpu")
        for p in prompts:
            eng.submit(p)
        calls.clear()
        norms.clear()
        eng.run_until_drained()
        assert set(norms) == {4} and len(norms) == (2 * tcfg.n_layers + 1) * len(calls) // tcfg.n_layers
        assert {(b, pl) for b, pl, *_ in calls} == ({(4, None)} if m is None else {(2, 4)})
        plans[m] = {decode.attn_plan(pl or b, hkv, sk, hd, 132) for b, pl, sk, hkv, hd in calls}
        own = {decode.attn_plan(b, hkv, sk, hd, 132) for b, pl, sk, hkv, hd in calls}
    assert plans[2] == plans[None] and len(plans[None]) == 1
    # planned from the group's own lanes, the split would differ
    assert own != plans[None]
