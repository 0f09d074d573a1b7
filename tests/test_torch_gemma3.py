"""gemma3-12b in the port, held against the JAX package.

- the config equals ``repro.configs``' field by field;
- ``transformer.layer_windows`` equals the reference's for gemma3-12b
  (48 layers: five local of 1024 to one global), a pure ``window``
  olmo-1b variant and no window;
- the plain ``fused_decode_attention`` at G = 2 and head_dim 256 (three
  lanes) with a static window, a dynamic one, one whose first slot lies
  mid-block in every lane and one on a block's first slot, against the
  Pallas kernel in interpret mode (blocks of 16 slots) and
  ``decode_attention_ref``, atol 2e-2 in bf16;
- prefill and decode-step logits of a narrow variant against
  ``repro.models.transformer`` on converted parameters: atol 1e-4 in
  float32, argmax-identical in bf16.  The variant is ``smoke_variant``
  (window 64) with 6 layers, so it holds five local layers and one
  global one, and its prompts are 96 to 120 tokens long, past the
  window; its RMSNorm scales are drawn at random (the reference's init
  sets them to 0).  The logits must change when every window is
  dropped, so the comparison reaches the mask;
- greedy streams of the port's ``ServingEngine`` against the JAX
  engine's on that variant in float32, with and without the decode
  kernels, every decode step past the window; staged decode (two
  stages) against the same streams, and the two stage slices of layers
  0-3 and 3-6 against the reference's ``decode_step``;
- the launcher serving gemma3-12b's smoke variant on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core import pu as jpu  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu as tpu  # noqa: E402
from repro_torch.kernels import decode  # noqa: E402
from repro_torch.kernels.ref import BIG_WINDOW  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

ARCH = "gemma3-12b"
LAYERS = 6                  # layers 0-4 local, layer 5 global (global_every 6)
ATOL_F32 = 1e-4
ATOL_BF16 = 2e-2
SERVE = dict(max_batch=2, max_len=128, max_new_tokens=6, seed=0)

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


# ------------------------------------------------------------- configs ---


def test_config_equals_the_jax_packages():
    tcfg, jcfg = get_config(ARCH), jget_config(ARCH)
    tf = [f.name for f in dataclasses.fields(tcfg)]
    assert tf == [f.name for f in dataclasses.fields(jcfg)]
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert (tcfg.n_layers, tcfg.d_model, tcfg.head_dim, tcfg.window, tcfg.global_every) == (
        48, 3840, 256, 1024, 6)
    assert tcfg.n_heads // tcfg.n_kv_heads in decode.ATTN_GROUPS
    assert tcfg.head_dim in decode.ATTN_HEAD_DIMS
    assert ARCH in serve.build_parser().parse_args(["--arch", ARCH]).arch


def _window_cfgs(case):
    """The (port, reference) configs of a ``layer_windows`` case."""
    out = []
    for get, smoke in ((get_config, smoke_variant), (jget_config, jsmoke)):
        if case == "gemma3-12b":
            out.append(get(ARCH))
        elif case == "pure_window":
            out.append(dataclasses.replace(smoke(get("olmo-1b")), n_layers=4, window=16))
        else:
            out.append(get("olmo-1b"))
    return out


@pytest.mark.parametrize("case", ["gemma3-12b", "no_window", "pure_window"])
def test_layer_windows_equal_the_references(case):
    tcfg, jcfg = _window_cfgs(case)
    got = transformer.layer_windows(tcfg, "cpu")
    want = np.asarray(jtf.layer_windows(jcfg))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert transformer.layer_windows(tcfg, "cpu") is got          # made once
    if case == "gemma3-12b":
        assert want.tolist() == ([1024] * 5 + [BIG_WINDOW]) * 8
    # a stage's slice cuts the windows at its layer boundary
    params = {"layers": {"w": torch.zeros(tcfg.n_layers, 1)}, "embed": torch.zeros(1, 1)}
    cut = transformer.slice_params(tcfg, params, (1, 3))["windows"]
    assert cut.tolist() == want[1:3].tolist()


def test_flags_of_later_step_9_parts_still_raise():
    base = get_config(ARCH)
    for change in ({"kv_ring": True, "kv_quant": True, "pos_embed": "learned"},
                   {"kv_quant": True, "pos_embed": "learned"},
                   {"family": "vlm", "pos_embed": "learned"},
                   {"pos_embed": "learned"}):
        with pytest.raises(NotImplementedError, match="step 9"):
            model_api.get_api(dataclasses.replace(base, **change))
    model_api.get_api(base)


# ---------------------------------------------- attention, head_dim 256 ---

B, HQ, HKV, HD, SK, D = 3, 4, 2, 256, 80, 96
_ATTN_CASES = {
    "full": dict(),
    "valid_len": dict(kv_valid_len="vlen"),
    "window_static": dict(kv_valid_len="vlen", window=24),
    "window_dynamic": dict(kv_valid_len="vlen", window_arr=40),
    # first attended slot qpos - w + 1 = 20, 43, 59: mid-block in every lane
    "window_mid_chunk": dict(kv_valid_len="vlen", window_arr=21),
    # first attended slot 16, 39, 55: on a block's first slot in lane 0
    "window_chunk_edge": dict(kv_valid_len="vlen", window_arr=25),
}


def _attn_arrays():
    rng = np.random.default_rng(24)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "q": n(B, HQ, HD), "k": n(B, SK, HKV, HD), "v": n(B, SK, HKV, HD),
        "wo": n(HQ * HD, D) * 0.05, "bo": n(D) * 0.05,
        "qpos": np.asarray([40, 63, 79], np.int32),
        "vlen": np.asarray([41, 64, 80], np.int32),
    }


def _attn_kw(arrays, case, conv):
    kw = dict(_ATTN_CASES[case])
    if "kv_valid_len" in kw:
        kw["kv_valid_len"] = conv(arrays["vlen"])
    if "window_arr" in kw:
        kw["window_arr"] = conv(np.asarray(kw["window_arr"], np.int32))
    kw["q_positions"] = conv(arrays["qpos"])
    return kw


@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_attention_at_head_dim_256_matches_jax(case, against):
    a = _attn_arrays()
    names, act = ("q", "k", "v", "wo", "bo"), ("q", "k", "v")    # bf16 activations
    jargs = [jnp.asarray(a[n], jnp.bfloat16 if n in act else None) for n in names]
    targs = [torch.from_numpy(a[n].copy()) for n in names]
    targs = [t.to(torch.bfloat16) if n in act else t for n, t in zip(names, targs)]
    jkw = _attn_kw(a, case, jnp.asarray)
    if against == "pallas":
        want = jk.fused_decode_attention(*jargs, block_s=16, interpret=True, **jkw)
    else:
        want = jk.decode_attention_ref(*jargs, **jkw)
    decode.reset_launches()
    got = decode.fused_decode_attention(*targs, **_attn_kw(a, case, torch.from_numpy))
    assert decode.fused_decode_attention.launches == 0      # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_BF16)
    if case.startswith("window"):
        full = decode.fused_decode_attention(*targs, **_attn_kw(a, "valid_len", torch.from_numpy))
        assert np.abs(_np(full) - _np(got)).max() > 10 * ATOL_BF16   # the window masks slots


def test_attention_head_dims_the_kernel_takes():
    """The wrapper takes head_dim 256 and refuses a width the CUDA
    dispatch does not instantiate before it touches a device."""
    assert decode.ATTN_HEAD_DIMS == (32, 64, 128, 256)
    q = torch.zeros((1, 2, 192), dtype=torch.bfloat16)
    kv = torch.zeros((1, 16, 1, 192), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not supported by the kernel"):
        decode._attention_ctx(q, kv, kv, q_positions=torch.zeros(1, dtype=torch.int32))
    plan = decode.attn_plan(8, 8, 1608, 256, 132)
    assert (plan.chunk, plan.splits) == (32, 51)


# ------------------------------------------------------- whole models ---


def _cfgs(dtype="float32", decode_kernels=False):
    jcfg = dataclasses.replace(jsmoke(jget_config(ARCH)), n_layers=LAYERS, dtype=dtype)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)), n_layers=LAYERS, dtype=dtype,
                               decode_kernels=decode_kernels)
    return jcfg, tcfg


def _jparams():
    """The reference's init, with the RMSNorm scales redrawn."""
    def make():
        jcfg, _ = _cfgs()
        tree = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(7)

        def redraw(path, leaf):
            if "norm" in jax.tree_util.keystr(path):
                return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
            return leaf

        return jax.tree_util.tree_map_with_path(redraw, tree)

    return _once("params", make)


def _tokens(vocab, seed=4):
    lengths = np.asarray([120, 104, 96], np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (3, 120)).astype(np.int32), lengths


def _no_windows(cfg):
    return dataclasses.replace(cfg, window=None, global_every=None)


def test_variant_holds_local_and_global_layers():
    jcfg, tcfg = _cfgs()
    w = transformer.window_list(tcfg)
    assert w == (64,) * 5 + (BIG_WINDOW,) and list(w) == np.asarray(jtf.layer_windows(jcfg)).tolist()
    assert min(_tokens(tcfg.vocab)[1]) > tcfg.window
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(_jparams())[0]]
    assert "['unembed']" not in names and sum("scale" in n for n in names) == 3
    assert all(np.abs(leaf).max() > 0 for p, leaf in jax.tree_util.tree_flatten_with_path(
        _jparams())[0] if "norm" in jax.tree_util.keystr(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams = jax.tree.map(jnp.asarray, _jparams())
    tparams = interop.from_jax(_jparams())
    toks, lengths = _tokens(tcfg.vocab)
    jl, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    tt, tlen = torch.from_numpy(toks).long(), torch.from_numpy(lengths)
    tl, tcache = transformer.prefill(tcfg, tparams, tt, lengths=tlen)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    if dtype == "float32":
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)
    np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    # the windows mask: dropping them moves every lane's logits
    free, _ = transformer.prefill(_no_windows(tcfg), tparams, tt, lengths=tlen)
    assert (np.abs(_np(free) - _np(tl)).max(-1) > 100 * ATOL_F32).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode_kernels", [False, True])
def test_decode_step_matches_jax(dtype, decode_kernels):
    """Staggered per-lane positions past the window into a prefilled
    cache; the port's decode kernels (their plain versions on the CPU)
    against the JAX composed path, three rounds."""
    jcfg, tcfg = _cfgs(dtype, decode_kernels)
    jparams = jax.tree.map(jnp.asarray, _jparams())
    tparams = interop.from_jax(_jparams())
    toks, lengths = _tokens(tcfg.vocab)
    _, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    full = jtf.init_cache(jcfg, 3, 128)
    jcache = tuple(f.at[:, :, :120].set(c.astype(f.dtype)) for f, c in zip(full, jcache))
    tcache = interop.cache_from_jax(tuple(np.asarray(c) for c in jcache))
    free_cache = tuple(c.clone() for c in tcache)
    step = np.asarray([[7], [300], [42]], np.int32)
    decode.reset_launches()
    for r in range(3):
        pos = lengths + r
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(step), jnp.asarray(pos))
        tl, tcache = transformer.decode_step(
            tcfg, tparams, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos)
        )
        if dtype == "float32":
            np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
            for a, b in zip(tcache, jcache):
                np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
        if r == 0:
            fl, _ = transformer.decode_step(_no_windows(tcfg), tparams, free_cache,
                                            torch.from_numpy(step).long(), torch.from_numpy(pos))
            assert (np.abs(_np(fl) - _np(tl)).max(-1) > 100 * ATOL_F32).all()
        step = _np(jl).argmax(-1).astype(np.int32)[:, None]
    assert all(fn.launches == 0 for fn in decode.KERNELS)


# ------------------------------------------------------------- serving ---


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 512, int(n)).astype(np.int32) for n in (100, 110, 96, 105)]


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
        return _stream(eng, _prompts())

    return _once("jax_streams", make)


@pytest.mark.parametrize("kernels", [False, True])
def test_greedy_streams_match_jax_engine(kernels):
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, interop.from_jax(_jparams()),
                        ServeConfig(decode_kernels=kernels, **SERVE), "cpu")
    got = _stream(eng, _prompts())
    assert got == _jax_streams()
    assert set(eng.prefill_bucket_s) == {128}          # bucketed prefill, prompts padded
    assert all(len(s) == SERVE["max_new_tokens"] for s in got.values())


def test_staged_decode_matches_the_reference():
    """Two stages: the slices of layers 0-3 and 3-6 (one stage of local
    layers only, one holding the global layer) composed against the
    reference's ``decode_step``, and the engine's staged streams
    (``stream_pus``, two of the reference's profiles) against the JAX
    engine's."""
    jcfg, tcfg = _cfgs()
    api = model_api.get_api(tcfg)
    jparams = jax.tree.map(jnp.asarray, _jparams())
    tparams = interop.from_jax(_jparams())
    toks, lengths = _tokens(tcfg.vocab)
    _, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    full = jtf.init_cache(jcfg, 3, 128)
    jcache = tuple(f.at[:, :, :120].set(c) for f, c in zip(full, jcache))
    tcache = interop.cache_from_jax(tuple(np.asarray(c) for c in jcache))
    step, pos = np.asarray([[7], [300], [42]], np.int32), lengths
    jl, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(step), jnp.asarray(pos))
    tstep, tpos = torch.from_numpy(step).long(), torch.from_numpy(pos)
    h = api.decode_embed(tcfg, tparams, tstep, tpos)
    for r in ((0, 3), (3, LAYERS)):
        sp = api.slice_params(tcfg, tparams, r)
        assert sp["windows"].tolist() == list(transformer.window_list(tcfg)[r[0]:r[1]])
        h, _ = api.decode_stage(tcfg, sp, h, api.slice_cache(tcfg, tcache, r), tpos)
    np.testing.assert_allclose(_np(api.decode_unembed(tcfg, tparams, h)), _np(jl), atol=ATOL_F32)
    for a, b in zip(tcache, jcache):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)

    pus = [tpu.host_offload_config(), tpu.tpu_v5e_config()]
    eng = ServingEngine(tcfg, tparams, ServeConfig(stream_pus=pus, **SERVE), "cpu")
    want_ranges = [st.decode_layers for st in jserving.plan_partitioned_streaming(
        jcfg, [jpu.host_offload_config(), jpu.tpu_v5e_config()], batch_tokens=2).stages]
    assert eng._staged.ranges == want_ranges and len(want_ranges) == 2
    assert _stream(eng, _prompts()) == _jax_streams()
    assert eng.stats()["stage_decode_rounds"] > 0


def test_launcher_serves_gemma3_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "80",
            "--max-new", "4", "--decode-kernels", "--no-warmup"]
    assert serve.main(argv) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["completed"] == 3 and stats["tokens"] == 12
    assert stats["kernel_launches_attn"] == 0.0 and stats["cuda_graphs"] == 0.0
