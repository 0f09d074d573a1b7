"""The port's model layer on the CPU, held against the JAX package.

Norms, RoPE and activations against ``repro.models.common``; olmo-1b
smoke prefill (with ``lengths``) and decode-step logits against
``repro.models.transformer`` on converted parameters: atol 1e-4 in a
float32 variant, where only the summation order differs, and
argmax-identical in bf16; the interop round trip; the port's own init
against the reference's shapes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.models.api import get_api  # noqa: E402

ATOL_F32 = 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _pair(a: np.ndarray, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


# ----------------------------------------------------------- building blocks --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln_affine", "ln_nonparam"])
def test_norms_match_jax(dtype, kind):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    if kind == "rms":
        want = jcommon.rms_norm(jx, jnp.asarray(s))
        got = common.rms_norm(tx, torch.from_numpy(s))
    elif kind == "ln_affine":
        want = jcommon.layer_norm(jx, jnp.asarray(s), jnp.asarray(bias))
        got = common.layer_norm(tx, torch.from_numpy(s), torch.from_numpy(bias))
    else:
        cfg = get_config("olmo-1b")
        want = jcommon.apply_norm(jget_config("olmo-1b"), jx, None)
        got = common.apply_norm(cfg, tx, None)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    want = jcommon.apply_rope(jx, jnp.asarray(pos), 1e4)
    got = common.apply_rope(tx, torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5 if dtype == "float32" else 2e-2)
    np.testing.assert_allclose(
        common.rope_freqs(32, 1e4).numpy(), np.asarray(jcommon.rope_freqs(32, 1e4)), rtol=1e-6
    )


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "sq_relu"])
def test_mlp_act_matches_jax(kind):
    rng = np.random.default_rng(3)
    g = rng.normal(size=(4, 33)).astype(np.float32) * 3
    u = rng.normal(size=(4, 33)).astype(np.float32)
    up_j = jnp.asarray(u) if kind == "swiglu" else None
    up_t = torch.from_numpy(u) if kind == "swiglu" else None
    want = jcommon.mlp_act(kind, jnp.asarray(g), up_j)
    got = common.mlp_act(kind, torch.from_numpy(g), up_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ whole model --

_JPARAMS = {}


def _setup(dtype="float32", decode_kernels=False):
    jcfg = dataclasses.replace(jsmoke(jget_config("olmo-1b")), dtype=dtype)
    tcfg = dataclasses.replace(
        smoke_variant(get_config("olmo-1b")), dtype=dtype, decode_kernels=decode_kernels
    )
    if "p" not in _JPARAMS:
        _JPARAMS["p"] = jax.tree.map(
            np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0))
        )
    jparams = jax.tree.map(jnp.asarray, _JPARAMS["p"])
    return jcfg, jparams, tcfg, interop.from_jax(_JPARAMS["p"])


def _tokens(b=3, s=16, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    lengths = np.asarray([16, 9, 5][:b], np.int32)
    return toks, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jcfg, jparams, tcfg, tparams = _setup(dtype)
    toks, lengths = _tokens()
    jl, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    tl, tcache = transformer.prefill(
        tcfg, tparams, torch.from_numpy(toks).long(), lengths=torch.from_numpy(lengths)
    )
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    if dtype == "float32":
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_F32)
    np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode_kernels", [False, True])
def test_decode_step_matches_jax(dtype, decode_kernels):
    """Staggered per-lane positions into a prefilled cache; the port's
    decode kernels (their plain versions on the CPU) against the JAX
    composed path."""
    jcfg, jparams, tcfg, tparams = _setup(dtype, decode_kernels)
    toks, lengths = _tokens()
    _, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    full = jtf.init_cache(jcfg, 3, 32)
    jcache = tuple(f.at[:, :, :16].set(c.astype(f.dtype)) for f, c in zip(full, jcache))
    tcache = interop.cache_from_jax(tuple(np.asarray(c) for c in jcache))
    step = np.asarray([[7], [300], [42]], np.int32)
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
        step = _np(jl).argmax(-1).astype(np.int32)[:, None]


def test_decode_step_scalar_position():
    """A shared () position writes every lane at the same slot."""
    jcfg, jparams, tcfg, tparams = _setup("float32")
    jcache = jtf.init_cache(jcfg, 2, 8)
    tcache = interop.cache_from_jax(tuple(np.asarray(c) for c in jcache))
    step = np.asarray([[5], [9]], np.int32)
    jl, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(step), jnp.asarray(0))
    tl, tcache = transformer.decode_step(
        tcfg, tparams, tcache, torch.from_numpy(step).long(), torch.tensor(0, dtype=torch.int32)
    )
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_F32)
    np.testing.assert_allclose(_np(tcache[0]), _np(jcache[0]), atol=ATOL_F32)


def test_interop_round_trip():
    tree = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": {"c": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))},
        "d": np.asarray([1, 2], np.int32),
    }
    t = interop.from_jax(tree)
    assert t["b"]["c"].dtype == torch.bfloat16 and t["d"].dtype == torch.int32
    back = interop.to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"].astype(np.float32))
    np.testing.assert_array_equal(back["d"], tree["d"])


def test_init_params_shapes_match_jax():
    jcfg = jsmoke(jget_config("olmo-1b"))
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))
    ))
    tparams = transformer.init_params(smoke_variant(get_config("olmo-1b")), 0, "cpu")
    tshapes = jax.tree.map(lambda a: tuple(a.shape), interop.to_numpy(tparams))
    assert tshapes == jshapes
    assert tparams["layers"]["attn"]["wq"].dtype == torch.bfloat16
    again = transformer.init_params(smoke_variant(get_config("olmo-1b")), 0, "cpu")
    assert torch.equal(again["embed"], tparams["embed"])
    std = tparams["layers"]["mlp"]["w_up"].float().std().item()
    assert 0.018 < std < 0.022


@pytest.mark.parametrize(
    "change,step",
    [({"kv_quant": True, "pos_embed": "learned"}, 9),
     ({"kv_ring": True, "window": 16, "pos_embed": "learned"}, 9),
     ({"window": 16, "kv_quant": True, "pos_embed": "learned"}, 9),
     ({"n_experts": 4, "top_k": 2}, 12), ({"family": "ssm"}, 12),
     ({"family": "vlm", "pos_embed": "learned"}, 9),
     ({"pos_embed": "learned"}, 9)],
)
def test_flags_outside_the_slice_raise(change, step):
    cfg = dataclasses.replace(smoke_variant(get_config("olmo-1b")), **change)
    with pytest.raises(NotImplementedError, match=f"step {step}"):
        get_api(cfg)
