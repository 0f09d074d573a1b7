"""The port's decode kernels on the CPU path, held against the JAX package.

Each plain PyTorch version (what a CPU tensor runs) is compared with the
JAX Pallas kernel, run through the Pallas interpreter as
``tests/test_decode_kernels.py`` runs it, and with the JAX oracle in
``repro.kernels.ref``, on the same numpy inputs.  Tolerance: atol 2e-2 in
bf16, the bar ``tests/test_decode_kernels.py`` sets for Pallas against
XLA.  The CUDA kernels run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro_torch.kernels import common, decode, dispatch, ref  # noqa: E402

B, D, HQ, HKV, HD, SK, FF = 3, 96, 4, 2, 32, 40, 112
ATOL = 2e-2


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(11)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "x": n(B, D),
        "wq": n(D, HQ * HD) * 0.05, "wk": n(D, HKV * HD) * 0.05, "wv": n(D, HKV * HD) * 0.05,
        "bq": n(HQ * HD) * 0.05, "bk": n(HKV * HD) * 0.05, "bv": n(HKV * HD) * 0.05,
        "q": n(B, HQ, HD), "k": n(B, SK, HKV, HD), "v": n(B, SK, HKV, HD),
        "wo": n(HQ * HD, D) * 0.05, "bo": n(D) * 0.05,
        "w_up": n(D, FF) * 0.05, "w_gate": n(D, FF) * 0.05, "b_up": n(FF) * 0.05,
        "w_down": n(FF, D) * 0.05, "b_down": n(D) * 0.05,
        "pos": np.asarray([3, 17, 999], np.int32),
        "qpos": np.asarray([5, 20, 39], np.int32),
        "vlen": np.asarray([6, 21, 40], np.int32),
        "ring": rng.integers(-1, 45, (B, SK)).astype(np.int32),
    }


# activations in bf16, weights in f32 (cast to the compute dtype inside)
_BF16 = ("x", "q", "k", "v")


def _jax(a, name):
    return jnp.asarray(a[name], jnp.bfloat16 if name in _BF16 else None)


def _torch(a, name):
    t = torch.from_numpy(a[name].copy())
    return t.to(torch.bfloat16) if name in _BF16 else t


@pytest.fixture(autouse=True)
def _zero_launches():
    decode.reset_launches()
    yield
    for fn in decode.KERNELS:
        assert fn.launches == 0, "a CPU tensor must never count as a kernel launch"


# --------------------------------------------------------------- fused_qkv --


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_fused_qkv_plain_matches_jax(arrays, bias, rope, against):
    names = ["x", "wq", "wk", "wv"] + (["bq", "bk", "bv"] if bias else [])
    jargs = [_jax(arrays, n) for n in names] + [None] * (0 if bias else 3)
    targs = [_torch(arrays, n) for n in names] + [None] * (0 if bias else 3)
    kw = dict(n_heads=HQ, n_kv_heads=HKV, head_dim=HD, rope=rope, theta=1e4)
    if against == "pallas":
        want = jk.fused_qkv(*jargs, jnp.asarray(arrays["pos"]), block_m=64, **kw)
    else:
        want = jk.fused_qkv_ref(*jargs, jnp.asarray(arrays["pos"]), **kw)
    got = decode.fused_qkv(*targs, torch.from_numpy(arrays["pos"]), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        _close(g, w)


# --------------------------------------------------------------- attention --

_ATTN_CASES = {
    "full": dict(),
    "valid_len": dict(kv_valid_len="vlen"),
    "window_static": dict(kv_valid_len="vlen", window=7),
    "window_dynamic": dict(kv_valid_len="vlen", window_arr=9),
    "ring": dict(kv_positions="ring"),
    "ring_shared": dict(kv_positions="ring0"),
    "ring_window": dict(kv_positions="ring", window_arr=9),
    "noncausal": dict(causal=False),
}


def _attn_kw(arrays, case, to):
    kw = dict(_ATTN_CASES[case])
    conv = jnp.asarray if to == "jax" else torch.from_numpy
    if "kv_valid_len" in kw:
        kw["kv_valid_len"] = conv(arrays["vlen"])
    if kw.get("kv_positions") == "ring":
        kw["kv_positions"] = conv(arrays["ring"])
    elif kw.get("kv_positions") == "ring0":
        kw["kv_positions"] = conv(np.ascontiguousarray(arrays["ring"][0]))
    if "window_arr" in kw:
        kw["window_arr"] = conv(np.asarray(kw["window_arr"], np.int32))
    kw["q_positions"] = conv(arrays["qpos"])
    return kw


@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_fused_attention_plain_matches_jax(arrays, case, against):
    names = ["q", "k", "v", "wo", "bo"]
    jargs = [_jax(arrays, n) for n in names]
    jkw = _attn_kw(arrays, case, "jax")
    if against == "pallas":
        want = jk.fused_decode_attention(*jargs, block_s=16, **jkw)
    else:
        want = jk.decode_attention_ref(*jargs, **jkw)
    got = decode.fused_decode_attention(
        *[_torch(arrays, n) for n in names], **_attn_kw(arrays, case, "torch")
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, D)
    _close(got, want)


def test_attention_masked_slots_never_attend(arrays):
    """Poisoning the K/V of slots a lane may not attend (past its valid
    length, or ring slots never written) leaves the output unchanged."""
    t = {n: _torch(arrays, n) for n in ("q", "k", "v", "wo", "bo")}
    for case, hidden in (
        ("valid_len", torch.arange(SK)[None] >= torch.from_numpy(arrays["vlen"])[:, None]),
        ("ring", torch.from_numpy(arrays["ring"]) < 0),
    ):
        kw = _attn_kw(arrays, case, "torch")
        clean = decode.fused_decode_attention(t["q"], t["k"], t["v"], t["wo"], t["bo"], **kw)
        poison = lambda a: torch.where(hidden[..., None, None], torch.tensor(1e4, dtype=a.dtype), a)
        dirty = decode.fused_decode_attention(
            t["q"], poison(t["k"]), poison(t["v"]), t["wo"], t["bo"], **kw
        )
        assert torch.equal(clean, dirty)


def test_window_arr_matches_static_window(arrays):
    t = {n: _torch(arrays, n) for n in ("q", "k", "v", "wo", "bo")}
    qpos = torch.from_numpy(arrays["qpos"])
    for w in (1, 7, 64):
        stat = decode.fused_decode_attention(
            t["q"], t["k"], t["v"], t["wo"], t["bo"], q_positions=qpos, window=w
        )
        dyn = decode.fused_decode_attention(
            t["q"], t["k"], t["v"], t["wo"], t["bo"], q_positions=qpos,
            window_arr=torch.tensor(w, dtype=torch.int32),
        )
        assert torch.equal(stat, dyn)


# --------------------------------------------------------------------- MLP --


@pytest.mark.parametrize(
    "act,gated,bias",
    [("swiglu", True, True), ("swiglu", True, False),
     ("gelu", False, True), ("sq_relu", False, False)],
)
@pytest.mark.parametrize("against", ["pallas", "oracle"])
def test_fused_mlp_plain_matches_jax(arrays, act, gated, bias, against):
    def args(conv):
        return (
            conv(arrays, "x"), conv(arrays, "w_up"),
            conv(arrays, "w_gate") if gated else None,
            conv(arrays, "b_up") if bias else None,
            conv(arrays, "w_down"),
            conv(arrays, "b_down") if bias else None,
        )

    if against == "pallas":
        want = jk.fused_mlp(*args(_jax), act=act, block_f=48)
    else:
        want = jk.fused_mlp_ref(*args(_jax), act=act)
    got = decode.fused_mlp(*args(_torch), act=act)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, D)
    _close(got, want)


def test_gelu_is_the_tanh_form():
    g = torch.tensor([1.0])
    assert abs(ref.mlp_act("gelu", g, None).item() - 0.841192) < 1e-5


@pytest.mark.parametrize("n, sms, want", [
    (2048, 132, 8),      # olmo-1b wo / w_down: 256 blocks, not 64
    (8192, 132, 32),     # olmo-1b d_ff slabs: 256 blocks
    (2048, 64, 32),
    (4096, 132, 16),
    (64, 132, 8),        # too narrow to fill the card: narrowest slab
    (24, 132, 8),
])
def test_gemv_slab_is_the_widest_that_fills_every_sm(monkeypatch, n, sms, want):
    monkeypatch.setattr(decode, "_sm_count", lambda device: sms)
    assert decode._gemv_cols(n, torch.device("cpu")) == want


def test_gemv_slab_needs_a_multiple_of_8(monkeypatch):
    monkeypatch.setattr(decode, "_sm_count", lambda device: 132)
    with pytest.raises(ValueError):
        decode._gemv_cols(2044, torch.device("cpu"))


OLMO_GEMVS = [(8192, 2048), (2048, 8192), (2048, 2048)]   # (N, K): gate/up, down, wo
SMOKE_GEMVS = [(256, 128), (128, 256), (128, 128)]         # the smoke variant's


@pytest.mark.parametrize("n,k", OLMO_GEMVS + SMOKE_GEMVS + [(FF, D), (D, FF), (50304, 2048),
                                                          (2048, 32768), (8, 8)])
@pytest.mark.parametrize("sms", [132, 114])
def test_gemv_plan_splits_k_into_one_wave(n, k, sms):
    plan = decode.gemv_plan(n, k, sms)
    kt = -(-k // decode.GEMV_K)
    assert plan.tiles == -(-n // decode.GEMV_N)
    # whole k-tiles per piece, every piece non-empty, none over the x slice's room
    assert plan.split == -(-kt // plan.kt_per)
    assert (plan.split - 1) * plan.kt_per < kt <= plan.split * plan.kt_per
    assert plan.kt_per <= decode.GEMV_MAX_KT
    # one wave of one block per SM, split as finely as that allows
    if plan.kt_per < decode.GEMV_MAX_KT:
        assert plan.blocks <= max(sms, plan.tiles)
    assert plan.split == kt or plan.tiles * (plan.split + 1) > sms or \
        plan.kt_per == decode.GEMV_MAX_KT
    # the workspace the wrapper hands the kernel holds every partial
    for nmat in (1, 2):
        want = plan.tiles * plan.split * nmat * decode.GEMV_N * 8 if plan.split > 1 else 0
        assert plan.ws_floats(nmat) == want
        ws, cnt = decode.workspace(torch.device("cpu"), 0, want, plan.counters)
        assert ws.dtype == torch.float32 and ws.numel() >= want
        assert cnt.dtype == torch.int32 and cnt.numel() >= plan.counters and not cnt.any()


@pytest.mark.parametrize("sms", [132, 114])
def test_olmo_gemvs_give_nearly_every_sm_a_block(sms):
    for n, k in OLMO_GEMVS:
        plan = decode.gemv_plan(n, k, sms)
        assert sms - plan.tiles < plan.blocks <= sms, (n, k, plan)


def test_swiglu_needs_a_gate(arrays):
    with pytest.raises(ValueError):
        decode.fused_mlp(_torch(arrays, "x"), _torch(arrays, "w_up"),
                         w_down=_torch(arrays, "w_down"), act="swiglu")


# ------------------------------------------------------- device resolution --


def test_cpu_tensor_takes_plain_version_and_counts_nothing(arrays):
    assert not common.use_kernel(torch.zeros(1))
    decode.fused_qkv(
        _torch(arrays, "x"), _torch(arrays, "wq"), _torch(arrays, "wk"), _torch(arrays, "wv"),
        positions=torch.from_numpy(arrays["pos"]), n_heads=HQ, n_kv_heads=HKV, head_dim=HD,
    )
    assert [fn.launches for fn in decode.KERNELS] == [0, 0, 0]


def test_no_card_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_device(None)
    with pytest.raises(RuntimeError):
        common.resolve_device("cuda")
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_kill_switch(monkeypatch):
    class Cfg:
        decode_kernels = True
        is_moe = False

    x = torch.zeros(2, 1, 8)
    monkeypatch.delenv("REPRO_DECODE_KERNELS", raising=False)
    assert dispatch.attention_active(Cfg, x) and dispatch.mlp_active(Cfg, x)
    assert not dispatch.attention_active(Cfg, torch.zeros(2, 3, 8))
    monkeypatch.setenv("REPRO_DECODE_KERNELS", "0")
    assert not dispatch.enabled(Cfg)
