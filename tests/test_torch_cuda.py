"""The CUDA decode kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  Run on a
machine with an H100 with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They cover what ``chip_smoke.py`` (olmo-1b shapes only) does not: other
batch sizes, grouped-query heads (G = Hq/Hkv > 1), head widths 32 and
64, every activation, and the smoke engine on the card.  Tolerance:
atol = rtol = 2e-2 in bf16, as in ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import decode, ref  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)
HEADS = [(4, 2, 32), (8, 2, 64), (8, 8, 128), (16, 2, 128)]   # (Hq, Hkv, hd)


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
