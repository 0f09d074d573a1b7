"""The ring KV cache (``kv_ring``) in the port, held against the JAX package.

Smoke configs of the reference's own ring tests: dense mixtral-8x7b
(window 64; ``tests/test_kv_ring.py``) and ``olmo-ring`` (olmo-1b, window
16; ``tests/test_decode_kernels.py``), float32 unless a case says
otherwise, the reference's parameters converted through ``interop``:

- the cache is window-sized (``min(max_len, window)`` slots), shaped as
  the reference's, and ``check_supported`` takes the flag;
- the ``kv_positions`` each decode step hands the attention equal the
  reference's bit for bit, shared () and per lane (B,), before the ring
  wraps and after it has wrapped twice; never-written slots negative;
  ``torch.fmod`` in their place moves no slot a query attends;
- decode through two wraps against the reference's ``decode_step``
  (atol 1e-4, both paths), and the port's ring against the port's full
  cache in bf16 at the reference's own 2e-2 with equal argmax;
- prefill at ``s <``, ``=`` and ``> window``: logits and the ring layout
  against the reference, the slot mapping exact (slot ``p % window``
  holds position ``p``), then a staggered per-lane decode step;
- ``lengths`` raises ``ValueError``; the engine's ``bucketed_prefill``;
- greedy streams of the port's engine against the JAX engine's, with
  and without the decode kernels, under staggered admissions, with
  prompts and decodes that cross the window; staged decode at M = 1 and
  2 against them;
- gemma3 with ``kv_ring`` keeps its full cache and serves as without it;
  ``kv_ring`` + ``kv_quant`` with learned positions still raises naming
  step 9.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu as tpu  # noqa: E402
from repro_torch.kernels import decode  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

ATOL_F32 = 1e-4
WINDOW = 64                 # smoke mixtral's window
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
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _once(key, make):
    if key not in _P:
        _P[key] = make()
    return _P[key]


def _cfgs(arch="mixtral", ring=True, dtype="float32", **kw):
    """(reference, port) smoke configs: dense mixtral-8x7b or olmo-ring."""
    out = []
    for get, smoke in ((jget_config, jsmoke), (get_config, smoke_variant)):
        if arch == "mixtral":
            cfg = dataclasses.replace(smoke(get("mixtral-8x7b")), n_experts=0, top_k=0)
        else:
            cfg = dataclasses.replace(smoke(get("olmo-1b")), window=16)
        out.append(dataclasses.replace(cfg, kv_ring=ring, dtype=dtype, **kw))
    return out


def _jparams(arch="mixtral"):
    def make():
        jcfg, _ = _cfgs(arch)
        return jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))

    return _once(("params", arch), make)


# ------------------------------------------------------------- the cache ---


def test_ring_cache_is_window_sized():
    jcfg, tcfg = _cfgs()
    model_api.get_api(tcfg)                             # kv_ring is ported
    assert transformer.ring_applies(tcfg)
    for max_len in (256, WINDOW, 40):
        got = transformer.init_cache(tcfg, 2, max_len, "cpu")
        want = jtf.init_cache(jcfg, 2, max_len)
        assert [tuple(c.shape) for c in got] == [c.shape for c in want]
        assert got[0].shape[2] == min(max_len, WINDOW)
    _, full = _cfgs(ring=False)
    assert transformer.init_cache(full, 2, 256, "cpu")[0].shape[2] == 256
    _, no_window = _cfgs(window=None)
    assert not transformer.ring_applies(no_window)
    assert transformer.init_cache(no_window, 1, 256, "cpu")[0].shape[2] == 256


def _record(monkeypatch, module, seen):
    """Wrap ``module.gqa_attention`` to keep each call's kv_positions (the
    reference's layers run in a scan: a callback reads them)."""
    inner = module.gqa_attention

    def wrapped(*a, kv_positions=None, **kw):
        if isinstance(kv_positions, torch.Tensor):
            seen.append(kv_positions.numpy().copy())
        else:
            jax.debug.callback(lambda x: seen.append(np.asarray(x)), kv_positions)
        return inner(*a, kv_positions=kv_positions, **kw)

    monkeypatch.setattr(module, "gqa_attention", wrapped)


@pytest.mark.parametrize("pos", [[5], [63], [64], [137], [5, 64, 137]],
                         ids=["shared_5", "shared_63", "shared_64", "shared_137", "per_lane"])
def test_kv_positions_equal_the_references(monkeypatch, pos):
    """One decode step at ``pos`` (137: the ring has wrapped twice); the
    positions both packages hand each layer's attention."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _jparams(), interop.from_jax(_jparams())
    b = len(pos)
    p = np.asarray(pos[0] if b == 1 else pos, np.int32)
    toks = np.zeros((b, 1), np.int32)
    jseen, tseen = [], []
    _record(monkeypatch, jattn, jseen)
    _record(monkeypatch, tattn, tseen)
    jtf.decode_step(jcfg, jax.tree.map(jnp.asarray, jparams), jtf.init_cache(jcfg, b, 256),
                    jnp.asarray(toks), jnp.asarray(p))
    transformer.decode_step(tcfg, tparams, transformer.init_cache(tcfg, b, 256, "cpu"),
                            torch.from_numpy(toks), torch.from_numpy(p))
    assert len(tseen) == len(jseen) == tcfg.n_layers
    for got, want in zip(tseen, jseen):
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    kvp = tseen[0].reshape(-1, WINDOW)
    for lane, q in enumerate(np.broadcast_to(p, (kvp.shape[0],))):
        written = np.arange(WINDOW) <= q                  # slots the ring has filled
        assert (kvp[lane][~written] < 0).all() and (kvp[lane][written] >= 0).all()
        assert kvp[lane][q % WINDOW] == q and (kvp[lane] > q - WINDOW).all()
    # torch.fmod would give a never-written slot s a non-negative position
    t = torch.from_numpy(p)
    slots = torch.arange(WINDOW, dtype=torch.int32)
    fmod = (t[:, None] if b > 1 else t) - torch.fmod((t[:, None] if b > 1 else t) - slots, WINDOW)
    assert torch.equal(transformer.ring_positions(t, WINDOW), torch.from_numpy(tseen[0]))
    assert torch.equal(fmod, torch.from_numpy(tseen[0])) == bool(min(pos) >= WINDOW - 1)


@pytest.mark.parametrize("kernels", [False, True])
def test_fmod_positions_move_no_attended_slot(monkeypatch, kernels):
    """``torch.fmod`` in place of the floor-mod differs only on slots not
    yet written, which it places past the query: the causal mask hides
    them there as it hides a negative position, so decode before the wrap
    gives the same logits and cache bit for bit."""
    def fmod_positions(pos, slots):
        s = torch.arange(slots, dtype=torch.int32)
        p = pos[:, None] if pos.dim() else pos
        return p - torch.fmod(p - s, slots)

    _, tcfg = _cfgs(decode_kernels=kernels)
    tparams = interop.from_jax(_jparams())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab, (2, 1)).astype(np.int32))
    floor_mod = transformer.ring_positions
    for pos in (torch.tensor(5, dtype=torch.int32), torch.tensor([3, 40], dtype=torch.int32)):
        assert not torch.equal(fmod_positions(pos, WINDOW), floor_mod(pos, WINDOW))
        out = []
        for fn in (floor_mod, fmod_positions):
            monkeypatch.setattr(transformer, "ring_positions", fn)
            cache = tuple(torch.randn(c.shape, generator=torch.Generator().manual_seed(6))
                          for c in transformer.init_cache(tcfg, 2, 256, "cpu"))
            out.append(transformer.decode_step(tcfg, tparams, cache, toks, pos))
        (want, want_cache), (got, got_cache) = out
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_cache, want_cache))


# --------------------------------------------------------------- decode ---


def _jdecode(jcfg):
    return _once(("jdecode", jcfg), lambda: jax.jit(
        lambda p, c, t, i: jtf.decode_step(jcfg, p, c, t, i)))


@pytest.mark.parametrize("kernels", [False, True])
def test_decode_through_two_wraps_matches_jax(kernels):
    jcfg, tcfg = _cfgs(decode_kernels=kernels)
    jparams, tparams = jax.tree.map(jnp.asarray, _jparams()), interop.from_jax(_jparams())
    s = 2 * WINDOW + 9                                  # wraps twice
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (2, s)).astype(np.int32)
    jcache = jtf.init_cache(jcfg, 2, s + 8)
    tcache = transformer.init_cache(tcfg, 2, s + 8, "cpu")
    step = _jdecode(jcfg)
    decode.reset_launches()
    for i in range(s):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tl, tcache = transformer.decode_step(tcfg, tparams, tcache,
                                             torch.from_numpy(toks[:, i:i + 1]),
                                             torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
    for a, b in zip(tcache, jcache):
        assert a.shape[2] == WINDOW
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)
    assert all(fn.launches == 0 for fn in decode.KERNELS)  # CPU: the plain versions


def test_ring_matches_full_cache_after_wraps_in_bf16():
    """The reference's own bar (``test_ring_decode_matches_full_after_wrap``):
    the port's ring against the port's full cache."""
    _, ring = _cfgs(dtype="bfloat16")
    _, full = _cfgs(ring=False, dtype="bfloat16")
    tparams = interop.from_jax(_jparams())
    s = 2 * WINDOW + 9
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, ring.vocab, (1, s)).astype(np.int32))
    out = []
    for cfg in (ring, full):
        cache = transformer.init_cache(cfg, 1, s + 8, "cpu")
        for i in range(s):
            lg, cache = transformer.decode_step(cfg, tparams, cache, toks[:, i:i + 1],
                                                torch.tensor(i, dtype=torch.int32))
        out.append(_np(lg))
    np.testing.assert_allclose(out[0], out[1], atol=2e-2, rtol=2e-2)
    assert (out[0].argmax(-1) == out[1].argmax(-1)).all()


# -------------------------------------------------------------- prefill ---


@pytest.mark.parametrize("s", [40, WINDOW, WINDOW + 17])
def test_prefill_ring_layout_matches_jax(s):
    jcfg, tcfg = _cfgs()
    _, full = _cfgs(ring=False)
    jparams, tparams = jax.tree.map(jnp.asarray, _jparams()), interop.from_jax(_jparams())
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, s)).astype(np.int32)
    jl, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks))
    tl, tcache = transformer.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    assert tcache[0].shape[2] == min(s, WINDOW)
    for a, b in zip(tcache, jcache):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)
    # the slot mapping, exactly: slot p % window holds position p's K/V
    _, fcache = transformer.prefill(full, tparams, torch.from_numpy(toks))
    for p in range(max(0, s - WINDOW), s):
        for ring_c, full_c in zip(tcache, fcache):
            assert torch.equal(ring_c[:, :, p % WINDOW], full_c[:, :, p])
    # then one decode step per lane at staggered positions
    cache = transformer.init_cache(tcfg, 2, 256, "cpu")
    jring = jtf.init_cache(jcfg, 2, 256)
    n = tcache[0].shape[2]
    cache = tuple(c.index_copy_(2, torch.arange(n), t) for c, t in zip(cache, tcache))
    jring = tuple(c.at[:, :, :n].set(t) for c, t in zip(jring, jcache))
    pos, nxt = np.asarray([s, s + 3], np.int32), np.asarray([[7], [300]], np.int32)
    jl, _ = jtf.decode_step(jcfg, jparams, jring, jnp.asarray(nxt), jnp.asarray(pos))
    tl, _ = transformer.decode_step(tcfg, tparams, cache, torch.from_numpy(nxt),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)


def test_prefill_refuses_lengths():
    jcfg, tcfg = _cfgs()
    toks = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError):
        jtf.prefill(jcfg, jax.tree.map(jnp.asarray, _jparams()), jnp.asarray(toks),
                    lengths=jnp.asarray([9], jnp.int32))
    with pytest.raises(ValueError, match="kv_ring"):
        transformer.prefill(tcfg, interop.from_jax(_jparams()), torch.from_numpy(toks),
                            lengths=torch.tensor([9], dtype=torch.int32))


# -------------------------------------------------------------- serving ---

SERVE = dict(max_batch=2, max_len=128, max_new_tokens=8, seed=0)
# mixtral (window 64): two prompts past the window, one whose decode
# crosses it; olmo-ring (window 16): every prompt's decode crosses it
PROMPT_LENS = {"mixtral": (70, 60, 90, 58), "olmo": (9, 14, 20, 6)}


def _prompts(arch):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS[arch]]


def _stream(eng, prompts):
    """Staggered admissions: the first request decodes alone first."""
    eng.submit(prompts[0].copy())
    eng.step()
    for p in prompts[1:]:
        eng.submit(p.copy())
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _jax_streams(arch):
    def make():
        jcfg, _ = _cfgs(arch)
        eng = jserving.ServingEngine(jcfg, jax.tree.map(jnp.asarray, _jparams(arch)),
                                     jserving.ServeConfig(**SERVE))
        assert not eng.bucketed_prefill
        return _stream(eng, _prompts(arch))

    return _once(("jax_streams", arch), make)


def test_engine_turns_bucketed_prefill_off_for_rings():
    cases = [_cfgs(), _cfgs(ring=False), _cfgs("olmo"),
             [dataclasses.replace(smoke(get("gemma3-12b")), kv_ring=True, dtype="float32")
              for get, smoke in ((jget_config, jsmoke), (get_config, smoke_variant))]]
    for jcfg, tcfg in cases:
        tparams = transformer.init_params(tcfg, 0, "cpu")
        eng = ServingEngine(tcfg, tparams, ServeConfig(**SERVE), "cpu")
        jeng = jserving.ServingEngine(jcfg, jtf.init_params(jcfg, jax.random.PRNGKey(0)),
                                      jserving.ServeConfig(**SERVE))
        assert eng.bucketed_prefill == jeng.bucketed_prefill == (not transformer.ring_applies(tcfg))
        assert eng._cache[0].shape[2] == jeng._cache[0].shape[2]
    # a ring engine's warmup prefills nothing and captures every block length
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, transformer.init_params(tcfg, 0, "cpu"), ServeConfig(**SERVE), "cpu")
    eng.warmup()
    assert eng._cache[0].shape[2] == WINDOW and not eng.prefill_bucket_s


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", ["mixtral", "olmo"])
def test_greedy_streams_match_jax_engine(arch, kernels):
    _, tcfg = _cfgs(arch)
    eng = ServingEngine(tcfg, interop.from_jax(_jparams(arch)),
                        ServeConfig(decode_kernels=kernels, **SERVE), "cpu")
    eng.warmup()
    got = _stream(eng, _prompts(arch))
    assert got == _jax_streams(arch)
    assert not eng.bucketed_prefill
    # one exact-length prefill call per prompt length
    assert sorted(eng.prefill_bucket_s) == sorted(set(PROMPT_LENS[arch]))
    assert all(len(s) == SERVE["max_new_tokens"] for s in got.values())


@pytest.mark.parametrize("m", [1, 2])
def test_staged_decode_matches_single_pu(m):
    """Two stages (the reference's profiles) with M lane groups: the
    staged slices composed against ``decode_step`` after the ring wraps,
    and the engine's streams against the single-PU (JAX) ones."""
    jcfg, tcfg = _cfgs(n_layers=4)
    tparams = transformer.init_params(tcfg, 0, "cpu")
    api = model_api.get_api(tcfg)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([WINDOW + 3, 2 * WINDOW + 1], dtype=torch.int32)
    cache = tuple(torch.randn(c.shape).to(c.dtype)
                  for c in transformer.init_cache(tcfg, 2, 256, "cpu"))
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
    assert len(eng._staged.ranges) == 2
    eng.warmup()
    assert _stream(eng, _prompts("mixtral")) == _jax_streams("mixtral")
    assert eng.stats()["stage_decode_rounds"] > 0


# ------------------------------------------------- what the ring is not ---


def test_gemma3_with_kv_ring_keeps_its_full_cache():
    """Global layers refuse the ring (the reference's
    ``test_ring_refused_for_global_layers``): the cache stays full and
    the engine serves what it serves without the flag."""
    base = dataclasses.replace(smoke_variant(get_config("gemma3-12b")), n_layers=6,
                               dtype="float32")
    flagged = dataclasses.replace(base, kv_ring=True)
    assert not transformer.ring_applies(flagged)
    jflagged = dataclasses.replace(jsmoke(jget_config("gemma3-12b")), kv_ring=True)
    assert transformer.init_cache(flagged, 1, 256, "cpu")[0].shape[2] == 256 == \
        jtf.init_cache(jflagged, 1, 256)[0].shape[2]
    params = transformer.init_params(base, 0, "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, base.vocab, n).astype(np.int32) for n in (80, 70)]
    streams = []
    for cfg in (base, flagged):
        eng = ServingEngine(cfg, params, ServeConfig(**SERVE), "cpu")
        assert eng.bucketed_prefill and eng._cache[0].shape[2] == SERVE["max_len"]
        streams.append(_stream(eng, prompts))
    assert streams[0] == streams[1]


def test_kv_ring_with_kv_quant_still_raises():
    _, tcfg = _cfgs(kv_quant=True, pos_embed="learned")
    with pytest.raises(NotImplementedError, match="step 9"):
        model_api.get_api(tcfg)
