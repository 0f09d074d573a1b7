"""internvl2-26b (the vlm family) in the port, held against the JAX package.

The vision tower is a stub in both: a prefill takes precomputed patch
embeddings and writes them over the first ``vision_patches`` token slots
(``repro.models.transformer._embed``).  On the smoke config (8 patches,
two layers, d 128, 4 query heads over 2), with the reference's
parameters converted through ``interop`` and its norm scales redrawn so
they count:

- the config equals ``repro.configs``' field by field, ``get_api`` says
  ``family="vlm"`` as the reference's does, and the parameters carry
  across with the port's init's shapes (no new leaf: the reference has
  no patch projection);
- ``_embed``, ``forward_hidden`` and ``prefill`` with seeded random
  patches, zero patches and none, bucketed (prompts shorter and longer
  than the patches) and at exact length: atol 1e-4 in float32 (hidden
  states, logits, caches); in bf16 logits within 2e-2 and the greedy
  token the reference's (one of its tied tokens where its own top logits
  tie exactly); a sequence shorter than the patches raises in both;
- greedy streams of the port's ``ServingEngine`` against the JAX
  engine's in float32, with and without the decode kernels (their plain
  versions on the CPU), a 4-token prompt among them (the counterpart of
  ``test_vlm_short_prompt_served_via_bucket_padding``); the engine's
  buckets start at the patch count;
- the launcher on the CPU: ``--stream`` and ``--multi-pu 2`` (M = 1 and
  M = 2) serve the streams of the plain run;
- the published vocabulary of 92 553 (not a multiple of 128) at smoke
  widths: prefill logits within 1e-4 in float32 and the greedy argmax of
  prefill and three decode steps equal to the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import decode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

ARCH = "internvl2-26b"
ATOL_F32 = 1e-4
ATOL_BF16 = 2e-2
REAL_VOCAB = 92553

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


def _cfgs(dtype="float32", **change):
    jcfg = dataclasses.replace(jsmoke(jget_config(ARCH)), dtype=dtype, **change)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype=dtype, **change)
    return jcfg, tcfg


def _jparams(vocab=None):
    """The reference's init (float32), with every norm scale redrawn."""
    if vocab not in _P:
        jcfg, _ = _cfgs(**({} if vocab is None else {"vocab": vocab}))
        tree = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(7)

        def redraw(path, leaf):
            if "norm" in jax.tree_util.keystr(path):
                return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
            return leaf

        _P[vocab] = jax.tree_util.tree_map_with_path(redraw, tree)
    return _P[vocab]


def _both(dtype="float32", vocab=None):
    """(jcfg, jax params, tcfg, port params), the same float32 numbers
    (a bf16 config computes in bf16 from them in both packages)."""
    jcfg, tcfg = _cfgs(dtype, **({} if vocab is None else {"vocab": vocab}))
    jp = _jparams(vocab)
    return jcfg, jax.tree.map(jnp.asarray, jp), tcfg, interop.from_jax(jp)


def _tokens(vocab, b=3, s=16, seed=4):
    rng = np.random.default_rng(seed)
    # bucketed rows: the full bucket, and two prompts shorter than it, one
    # of them shorter than the 8 patches
    return rng.integers(0, vocab, (b, s)).astype(np.int32), np.asarray([16, 5, 11][:b], np.int32)


def _patches(kind, cfg, b, seed=5):
    """(jax, torch) patch embeddings (B, P, D) of ``kind``: seeded random
    numbers, zeros, or none."""
    if kind == "none":
        return None, None
    rng = np.random.default_rng(seed)
    shape = (b, cfg.vision_patches, cfg.d_model)
    pe = rng.normal(size=shape).astype(np.float32) if kind == "random" else np.zeros(shape, np.float32)
    return jnp.asarray(pe), torch.from_numpy(pe)


PATCHES = ["random", "zero", "none"]


# ------------------------------------------------------------- configs ---


def test_config_equals_the_jax_packages():
    tcfg, jcfg = get_config(ARCH), jget_config(ARCH)
    tf = [f.name for f in dataclasses.fields(tcfg)]
    assert tf == [f.name for f in dataclasses.fields(jcfg)]
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.family == "vlm" and tcfg.vision_patches == 256 and tcfg.pos_embed == "rope"
    assert jcfg.n_heads // jcfg.n_kv_heads in decode.ATTN_GROUPS
    assert ARCH in serve.build_parser().parse_args(["--arch", ARCH]).arch


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_get_api_says_vlm_as_the_references(smoke):
    tcfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if smoke:
        tcfg, jcfg = smoke_variant(tcfg), jsmoke(jcfg)
    tapi, japi_ = model_api.get_api(tcfg), japi.get_api(jcfg)
    assert tapi.family == japi_.family == "vlm"
    assert tapi.supports_bucketed_prefill == japi_.supports_bucketed_prefill is True
    assert model_api.get_api(get_config("olmo-1b")).family == "lm"


def test_params_carry_across_and_match_the_port_init():
    _, tcfg = _cfgs()
    jp = _jparams()
    back = interop.to_numpy(interop.from_jax(jp))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, leaf), got in zip(flat_j, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, leaf, err_msg=jax.tree_util.keystr(path))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    own = transformer.init_params(tcfg, 0, "cpu")
    assert shapes(interop.to_numpy(own)) == shapes(jp)
    assert "unembed" in own and "pos_embed" not in own


# ------------------------------------------------------------- the model ---


@pytest.mark.parametrize("kind", PATCHES)
def test_embed_matches_jax(kind):
    jcfg, jparams, tcfg, tparams = _both()
    toks, _ = _tokens(tcfg.vocab)
    jpe, tpe = _patches(kind, tcfg, toks.shape[0])
    positions = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32)[None], toks.shape)
    want = jtf._embed(jcfg, jparams, jnp.asarray(toks), jpe, positions)
    got = transformer._embed(tcfg, tparams, torch.from_numpy(toks).long(), tpe)
    np.testing.assert_array_equal(_np(got), _np(want))
    if kind == "random":
        # the patches took the first slots, the tokens the rest
        np.testing.assert_array_equal(_np(got)[:, :tcfg.vision_patches], _np(tpe))
        assert not np.array_equal(_np(got)[:, :tcfg.vision_patches],
                                  _np(transformer._embed(tcfg, tparams, torch.from_numpy(toks).long()))
                                  [:, :tcfg.vision_patches])


@pytest.mark.parametrize("kind", PATCHES)
def test_forward_hidden_matches_jax(kind):
    jcfg, jparams, tcfg, tparams = _both()
    toks, _ = _tokens(tcfg.vocab)
    jpe, tpe = _patches(kind, tcfg, toks.shape[0])
    jh, _, jcache = jtf.forward_hidden(jcfg, jparams, jnp.asarray(toks), jpe, return_cache=True)
    th, tcache = transformer.forward_hidden(tcfg, tparams, torch.from_numpy(toks).long(), tpe,
                                            return_cache=True)
    np.testing.assert_allclose(_np(th), _np(jh), atol=ATOL_F32)
    for a, b in zip(tcache, jcache):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)


@pytest.mark.parametrize("kind", PATCHES)
@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "exact"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(kind, bucketed, dtype):
    jcfg, jparams, tcfg, tparams = _both(dtype)
    toks, lengths = _tokens(tcfg.vocab)
    jpe, tpe = _patches(kind, tcfg, toks.shape[0])
    jlen = jnp.asarray(lengths) if bucketed else None
    tlen = torch.from_numpy(lengths) if bucketed else None
    jl, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), jpe, lengths=jlen)
    tl, tcache = transformer.prefill(tcfg, tparams, torch.from_numpy(toks).long(), tpe, lengths=tlen)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    if dtype == "float32":
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    else:
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_BF16)
        _assert_greedy_agrees(_np(tl), _np(jl))


def _assert_greedy_agrees(got, want):
    """The port's greedy token is the reference's; where the reference's
    own bf16 logits tie at the top (the random-patch exact-length case
    ties two tokens at one lane), it is one of the tied tokens."""
    pick = got.argmax(-1)
    top = want.max(-1)
    assert (want[np.arange(len(pick)), pick] == top).all(), (pick, want.argmax(-1))


def test_patches_change_the_prefill():
    """The patches reach the logits: random patches, zero patches and none
    give three different prefills (so the tests above see the wiring)."""
    _, _, tcfg, tparams = _both()
    toks, lengths = _tokens(tcfg.vocab)
    out = [transformer.prefill(tcfg, tparams, torch.from_numpy(toks).long(),
                               _patches(k, tcfg, 3)[1], lengths=torch.from_numpy(lengths))[0]
           for k in PATCHES]
    for i in range(3):
        for j in range(i):
            assert (out[i] - out[j]).abs().max().item() > 1e-2, (PATCHES[i], PATCHES[j])


def test_a_sequence_shorter_than_the_patches_raises_in_both():
    jcfg, jparams, tcfg, tparams = _both()
    toks = np.zeros((1, tcfg.vision_patches - 4), np.int32)
    jpe, tpe = _patches("zero", tcfg, 1)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jtf.prefill(jcfg, jparams, jnp.asarray(toks), jpe)
    with pytest.raises(ValueError, match="patches"):
        transformer.prefill(tcfg, tparams, torch.from_numpy(toks).long(), tpe)
    # the same length without patches, and the patches' own length, serve
    transformer.prefill(tcfg, tparams, torch.from_numpy(toks).long())
    transformer.prefill(tcfg, tparams, torch.zeros((1, tcfg.vision_patches), dtype=torch.long), tpe)


# ------------------------------------------------------------- serving ---


SC = dict(max_batch=2, max_len=48, max_new_tokens=6, seed=0)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    # a 4-token prompt fits only through its bucket's padding
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in (9, 4, 14, 6, 11)]


def _stream(eng, prompts):
    """Staggered admissions: the first request decodes alone first."""
    eng.submit(prompts[0].copy())
    eng.step()
    for p in prompts[1:]:
        eng.submit(p.copy())
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _jax_streams():
    if "streams" not in _P:
        jcfg, jparams, tcfg, _ = _both()
        _P["streams"] = _stream(jserving.ServingEngine(jcfg, jparams, jserving.ServeConfig(**SC)),
                                _prompts(tcfg.vocab))
    return _P["streams"]


@pytest.mark.parametrize("kernels", [False, True], ids=["composed", "kernels"])
def test_greedy_streams_match_jax_engine(kernels):
    _, _, tcfg, tparams = _both()
    decode.reset_launches()
    eng = ServingEngine(tcfg, tparams, ServeConfig(decode_kernels=kernels, **SC), "cpu")
    assert eng.bucketed_prefill and eng._buckets[0] >= tcfg.vision_patches
    got = _stream(eng, _prompts(tcfg.vocab))
    assert got == _jax_streams()
    assert all(len(s) == SC["max_new_tokens"] for s in got.values())
    assert all(fn.launches == 0 for fn in decode.KERNELS)     # plain versions on the CPU


def test_short_prompt_served_via_bucket_padding():
    """The counterpart of the reference's test: a 4-token prompt with 8
    patches is served through its bucket's padding, the reference's tokens."""
    jcfg, jparams, tcfg, tparams = _both()
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab, 4).astype(np.int32)
    want = _stream(jserving.ServingEngine(jcfg, jparams, jserving.ServeConfig(**SC)), [prompt])
    eng = ServingEngine(tcfg, tparams, ServeConfig(**SC), "cpu")
    assert eng.bucketed_prefill
    got = _stream(eng, [prompt])
    assert got == want and len(got[0]) == SC["max_new_tokens"]


def test_engine_buckets_hold_the_patches():
    """A bucket shorter than the patches cannot hold them: the ladder
    starts at the patch count, and a cache shorter than them is refused."""
    _, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, vision_patches=40)
    params = transformer.init_params(cfg, 0, "cpu")
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_len=100, max_new_tokens=4), "cpu")
    assert eng._buckets == (64, 100)
    eng.submit(np.arange(20, dtype=np.int32))        # padded to 64, its patches in slots 0-39
    done = eng.run_until_drained()
    assert len(done) == 1 and len(done[0].out_tokens) == 4
    with pytest.raises(ValueError, match="vision patches"):
        ServingEngine(cfg, params, ServeConfig(max_batch=2, max_len=32, max_new_tokens=4), "cpu")
    lm = ServingEngine(dataclasses.replace(cfg, family="lm"), params,
                       ServeConfig(max_batch=2, max_len=100, max_new_tokens=4), "cpu")
    assert lm._buckets == (16, 32, 64, 100)


ARGV = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "5",
        "--prompt-len", "12", "--max-batch", "2"]


def _launch(extra):
    args = serve.build_parser().parse_args(ARGV + extra)
    eng = serve.make_engine(args)
    eng.warmup()
    serve.submit_requests(eng, args)
    return eng, {r.uid: r.out_tokens for r in eng.run_until_drained()}


@pytest.mark.parametrize("extra", [["--stream"], ["--multi-pu", "2"],
                                   ["--multi-pu", "2", "--microbatches", "2"],
                                   ["--multi-pu", "2", "--decode-kernels"]],
                         ids=["stream", "multi-pu", "multi-pu-M2", "multi-pu-kernels"])
def test_launcher_paths_serve_the_plain_streams(extra):
    if "plain" not in _P:
        _P["plain"] = _launch([])[1]
    eng, got = _launch(extra)
    assert got == _P["plain"] and len(got) == 3
    if "--stream" in extra:
        assert eng.streaming_plan is not None
    else:
        assert eng._staged is not None and len(eng._staged.devices) == 2
        assert "--microbatches" not in extra or eng._staged.n_groups == 2


def test_launcher_serves_with_stream_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--stream",
                       "--requests", "2", "--max-new", "4"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["completed"] == 2 and stats["tokens"] == 8 and stats["stream_tiles"] > 0


# ------------------------------------------------- the published vocab ---


def test_published_vocab_prefill_and_argmax_match_jax():
    """vocab 92 553 at smoke widths: the unembed's odd width."""
    jcfg, jparams, tcfg, tparams = _both(vocab=REAL_VOCAB)
    assert tcfg.vocab == REAL_VOCAB and REAL_VOCAB % 128
    toks, lengths = _tokens(tcfg.vocab, seed=9)
    jpe, tpe = _patches("random", tcfg, toks.shape[0])
    jl, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), jpe, lengths=jnp.asarray(lengths))
    tl, tcache = transformer.prefill(tcfg, tparams, torch.from_numpy(toks).long(), tpe,
                                     lengths=torch.from_numpy(lengths))
    assert tuple(tl.shape) == (3, REAL_VOCAB)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
    np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    # three greedy decode steps at the lanes' own positions
    full = jtf.init_cache(jcfg, 3, 32)
    jcache = tuple(f.at[:, :, :16].set(c) for f, c in zip(full, jcache))
    tcache = interop.cache_from_jax(tuple(np.asarray(c) for c in jcache))
    step = _np(jl).argmax(-1).astype(np.int32)[:, None]
    for r in range(3):
        pos = lengths + r
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(step), jnp.asarray(pos))
        tl, tcache = transformer.decode_step(tcfg, tparams, tcache, torch.from_numpy(step).long(),
                                             torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
        step = _np(jl).argmax(-1).astype(np.int32)[:, None]
