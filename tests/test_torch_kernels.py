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


# ------------------------------------------- the redesigned kernels' plans --

PLAN_WIDTHS = {   # (B, Hq, Hkv, hd, d_model, Sk)
    "olmo-1b": (8, 16, 16, 128, 2048, 584),
    "smoke": (4, 4, 4, 32, 128, 64),
    "hd256": (8, 16, 8, 256, 3840, 4096),
}


@pytest.mark.parametrize("width", sorted(PLAN_WIDTHS))
@pytest.mark.parametrize("sms", [132, 114])
def test_attn_plan_splits_the_cache_into_whole_chunks(width, sms):
    b, hq, hkv, hd, _, sk = PLAN_WIDTHS[width]
    for s in (1, 15, 77, sk, 4096):
        plan = decode.attn_plan(b, hkv, s, hd, sms)
        # whole chunks of ATTN_SLOTS slots whose K rows fit the kernel's shared memory
        assert plan.chunk % decode.ATTN_SLOTS == 0 and 0 < plan.chunk <= decode.ATTN_MAX_SLOTS
        assert plan.chunk * hd * 2 <= decode.ATTN_CHUNK_BYTES
        # every slot in exactly one chunk, none empty
        assert (plan.splits - 1) * plan.chunk < s <= plan.splits * plan.chunk
        # as many chunks as the aim of ATTN_BLOCKS_PER_SM blocks per SM needs, no more
        if plan.chunk > decode.ATTN_SLOTS and plan.chunk * 2 * hd * 2 <= decode.ATTN_CHUNK_BYTES:
            assert b * hkv * plan.splits >= decode.ATTN_BLOCKS_PER_SM * sms * 0.5
        assert plan.ws_floats(b, hkv, hq // hkv, hd) == b * hkv * plan.splits * (hq // hkv) * (hd + 2)
    if width == "olmo-1b":      # several blocks for every SM, where one per (lane, kv-head) gave 128
        plan = decode.attn_plan(b, hkv, sk, hd, sms)
        assert plan == {132: decode.AttnPlan(48, 13), 114: decode.AttnPlan(64, 10)}[sms]
        assert b * hkv * plan.splits >= 8 * sms


QKV_WIDTHS = dict(PLAN_WIDTHS, hd16=(8, 6, 2, 16, 256, 0), hd64=(8, 6, 2, 64, 256, 0))


@pytest.mark.parametrize("width", sorted(QKV_WIDTHS))
@pytest.mark.parametrize("sms", [132, 114])
def test_qkv_column_tiles_keep_rope_pairs_together(width, sms):
    b, hq, hkv, hd, d, _ = QKV_WIDTHS[width]
    tiles = decode.qkv_tiles(hq, hkv, hd)
    for n_cols, t in zip((hq * hd, hkv * hd, hkv * hd), tiles):
        cols = [c for tl in range(t) for c in decode.qkv_columns(tl, hd) if c < n_cols]
        # the tiles of one matrix cover each of its columns once and no other's
        assert sorted(cols) == list(range(n_cols))
        for tl in range(t):
            mine = [c for c in decode.qkv_columns(tl, hd) if c < n_cols]
            assert len(set(c // hd for c in mine)) <= max(1, decode.GEMV_N // hd)
            # both columns of every RoPE pair lie in this tile, at local columns
            # c and c + min(hd, GEMV_N) / 2 as the kernel's epilogue reads them
            half, lhalf = hd // 2, min(hd, decode.GEMV_N) // 2
            full = decode.qkv_columns(tl, hd)
            for lc, c in enumerate(full):
                if c < n_cols and c % hd < half:
                    assert full[lc + lhalf] == c + half
    plan = decode.qkv_plan(hq, hkv, hd, d, sms)
    assert plan.tiles == sum(tiles)
    assert plan == decode.gemv_plan(sum(tiles) * decode.GEMV_N, d, sms)
    if width == "olmo-1b":
        assert tiles == (16, 16, 16) and plan.split == 2 and plan.blocks == 96


def _split_schedule(q, k, v, wo, bo, *, chunk, q_positions, kv_valid_len=None, window=None,
                    window_arr=None, kv_positions=None, causal=True):
    """A plain PyTorch model of the attention kernel's schedule: chunks of
    ``chunk`` slots, each with its own softmax state (m, l, acc) and p
    rounded to bf16 for the PV product; a chunk with no slot to attend
    skipped (l = 0); the partials merged in split order; a lane with no
    slot at all given the mean of V.  Returns (y, chunks skipped)."""
    b, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = ref.dtype_scalar(1.0 / hd ** 0.5, q.dtype)
    qs = (q * scale).float().reshape(b, hkv, g, hd)
    valid = ref.decode_mask(b, sk, q.device, q_positions=q_positions, kv_valid_len=kv_valid_len,
                            window=window, window_arr=window_arr, kv_positions=kv_positions,
                            causal=causal)
    parts, skipped = [], 0
    for c0 in range(0, sk, chunk):
        ok = valid[:, c0:c0 + chunk]
        s = torch.einsum("bkgd,bskd->bkgs", qs, k[:, c0:c0 + chunk].float())
        s = torch.where(ok[:, None, None], s, ref.NEG)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bkgs,bskd->bkgd", p.to(torch.bfloat16).float(),
                           v[:, c0:c0 + chunk].float())
        live = ok.any(-1)[:, None, None]
        skipped += int((~live).sum())
        parts.append((torch.where(live, m, ref.NEG), torch.where(live, p.sum(-1), 0.0), acc))
    m = torch.full_like(parts[0][0], ref.NEG)
    for ms, ls, _ in parts:
        m = torch.where(ls > 0, torch.maximum(m, ms), m)
    num, den = torch.zeros_like(parts[0][2]), torch.zeros_like(parts[0][1])
    for ms, ls, acc in parts:
        c = torch.exp(ms - m)
        den = den + torch.where(ls > 0, ls * c, 0.0)
        num = num + torch.where((ls > 0)[..., None], acc * c[..., None], 0.0)
    ctx = num / torch.clamp(den, min=1e-30)[..., None]
    mean = v.float().sum(1)[:, :, None, :] / sk                 # p = 1 on every slot
    ctx = torch.where((den > 0)[..., None], ctx, mean).to(q.dtype).reshape(b, hq * hd)
    y = ctx @ wo.to(q.dtype)
    return (y if bo is None else y + bo.to(q.dtype)), skipped


_SPLIT_CASES = {
    "valid_len": dict(kv_valid_len="vlen"),
    "window_static": dict(kv_valid_len="vlen", window=7),
    "window_dynamic": dict(kv_valid_len="vlen", window_arr=9),
    "ring": dict(kv_positions="ring"),
    "ring_shared": dict(kv_positions="ring0"),
    "noncausal": dict(causal=False),
    "no_valid_slot": dict(kv_valid_len="vlen0"),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_schedule_matches_jax_kernel(arrays, case):
    """The flash-decoding schedule of ``csrc/decode.cu::attn_kernel``
    (chunks of 8 slots here, so 5 per lane) against the JAX Pallas kernel
    in interpret mode and the port's plain version: skipping a chunk no
    lane slot of it may attend, and merging in split order, changes
    nothing beyond the bf16 tolerance; a lane with no slot to attend
    keeps the plain version's uniform mean over all slots."""
    a = dict(arrays, vlen0=np.asarray([0, 21, 40], np.int32))
    kw = dict(_SPLIT_CASES[case])
    conv = {"jax": jnp.asarray, "torch": torch.from_numpy}
    args = {}
    for to, f in conv.items():
        c = dict(kw, q_positions=f(a["qpos"]))
        if "kv_valid_len" in c:
            c["kv_valid_len"] = f(a[c["kv_valid_len"]])
        if c.get("kv_positions") == "ring":
            c["kv_positions"] = f(a["ring"])
        elif c.get("kv_positions") == "ring0":
            c["kv_positions"] = f(np.ascontiguousarray(a["ring"][0]))
        if "window_arr" in c:
            c["window_arr"] = f(np.asarray(c["window_arr"], np.int32))
        args[to] = c
    names = ["q", "k", "v", "wo", "bo"]
    want = jk.fused_decode_attention(*[_jax(a, n) for n in names], block_s=8, **args["jax"])
    t = [_torch(a, n) for n in names]
    got, skipped = _split_schedule(*t, chunk=8, **args["torch"])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, D)
    _close(got, want)
    _close(got, ref.decode_attention_ref(*t, **args["torch"]))
    if case in ("valid_len", "window_static", "window_dynamic", "no_valid_slot"):
        assert skipped > 0      # whole chunks masked: the kernel issues no load for them
