"""The port's serving engine on the CPU, held against the JAX engine.

Greedy streams of ``repro_torch.runtime.serving.ServingEngine`` equal
those of ``repro.runtime.serving.ServingEngine`` on smoke olmo-1b with
the same (converted) parameters, with and without the decode kernels,
under staggered admissions (as ``tests/test_decode_kernels.py`` runs the
JAX engine).  Plus the admission masking, the launcher's JSON, and the
refusal to fall back to the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import decode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

_P = {}


def _params():
    if "p" not in _P:
        jcfg = jsmoke(jget_config("olmo-1b"))
        _P["p"] = jax.tree.map(
            np.asarray, japi.get_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        )
    return _P["p"]


def _engine(port: bool, **kw):
    sc = dict(max_batch=2, max_len=64, max_new_tokens=5, seed=0)
    sc.update(kw)
    if port:
        cfg = smoke_variant(get_config("olmo-1b"))
        return ServingEngine(cfg, interop.from_jax(_params()), ServeConfig(**sc), "cpu")
    cfg = jsmoke(jget_config("olmo-1b"))
    return jserving.ServingEngine(
        cfg, jax.tree.map(jax.numpy.asarray, _params()), jserving.ServeConfig(**sc)
    )


def _stream(eng, prompts, stagger):
    it = iter(prompts)
    eng.submit(next(it).copy())
    if stagger:
        eng.step()                    # the first request decodes alone first
    for p in it:
        eng.submit(p.copy())
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(n)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("decode_kernels", [False, True])
@pytest.mark.parametrize(
    "lens,max_batch,stagger",
    [((9, 14, 6), 2, True), ((9, 14, 6), 2, False), ((5, 31, 17, 3, 12), 4, True)],
)
def test_greedy_streams_match_jax_engine(decode_kernels, lens, max_batch, stagger):
    prompts = _prompts(lens, 3)
    want = _stream(_engine(False, max_batch=max_batch), prompts, stagger)
    got = _stream(
        _engine(True, max_batch=max_batch, decode_kernels=decode_kernels), prompts, stagger
    )
    assert got == want


def test_dummy_admit_rows_leave_other_lanes_untouched():
    eng = _engine(True, max_batch=4)
    before = {k: v.clone() for k, v in eng._state.items()}
    eng.warmup()                       # every admit row is a dummy
    for k, v in eng._state.items():
        assert torch.equal(v, before[k]), k
    for p in _prompts((7, 9, 12), 5):  # one bucket, 3 rows padded to 4
        eng.submit(p)
    cache0 = [c.clone() for c in eng._cache]
    eng._admit_device()
    assert [s is not None for s in eng._slots] == [True, True, True, False]
    for c, c0 in zip(eng._cache, cache0):
        assert torch.equal(c[:, 3], c0[:, 3])          # the free lane
        assert not torch.equal(c[:, :3], c0[:, :3])
    assert eng._state["active"].tolist() == [True, True, True, False]
    assert eng._state["out_len"].tolist() == [1, 1, 1, 0]
    assert eng._state["pos"].tolist() == [7, 9, 12, 0]


def test_inactive_lanes_keep_their_output_row():
    eng = _engine(True, max_batch=4)
    eng.submit(_prompts((6,), 7)[0], max_new_tokens=3)
    eng.run_until_drained()
    assert len(eng.completed[0].out_tokens) == 3
    assert eng._state["out_buf"][1:].abs().sum().item() == 0
    assert eng._state["out_len"].tolist()[1:] == [0, 0, 0]


def test_eos_first_token_completes_at_admission():
    prompt = _prompts((10,), 9)[0]
    first = _stream(_engine(True), [prompt], False)[0][0]
    eng = _engine(True, eos_token=first)
    out = _stream(eng, [prompt], False)
    assert out == {0: [first]} and eng.decode_rounds == 0


def test_temperature_sampling_is_seeded():
    prompts = _prompts((8, 11), 2)
    a = _stream(_engine(True, temperature=0.8), prompts, False)
    b = _stream(_engine(True, temperature=0.8), prompts, False)
    assert a == b and all(0 <= t < 512 for s in a.values() for t in s)


def test_launcher_prints_kept_keys(capsys):
    decode.reset_launches()
    assert serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "4", "--decode-kernels"]) == 0
    stats = json.loads(capsys.readouterr().out)
    for key in ("completed", "tokens", "rounds", "tokens_per_s", "mean_ttft_s",
                "device_resident", "prefill_s_bucket16", "kernel_launches_qkv",
                "kernel_launches_attn", "kernel_launches_mlp"):
        assert key in stats, key
    # captures are counted as the reference counts jit traces; the CPU
    # runs its decode blocks eagerly and captures nothing
    assert stats["decode_traces"] == stats["prefill_traces"] == stats["cuda_graphs"] == 0
    assert stats["completed"] == 2 and stats["tokens"] == 8
    # CPU tensors run the plain versions: no kernel launch is counted
    assert stats["kernel_launches_qkv"] == 0


def test_launcher_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "olmo-1b", "--smoke"])


def test_temperature_sampling_matches_softmax_and_jax_categorical():
    """The engine's temperature draw follows softmax(logits / T): its token
    counts pass a chi-square test against those probabilities and a
    two-sample test against ``jax.random.categorical`` (the reference's
    sampler) on the same logits, while the counts of a draw at the wrong
    temperature fail the first test.  Seeds are fixed, so the verdicts
    are too."""
    stats = pytest.importorskip("scipy.stats")
    temp, n, rows = 0.8, 40_000, 4
    logits = np.asarray([1.5, 0.2, -0.7, 2.1, 0.0, -2.0, 1.1, 0.6], np.float32)
    eng = _engine(True, temperature=temp)
    eng._gen.manual_seed(1234)
    batch = torch.from_numpy(np.tile(logits, (n // rows, 1)))
    toks = torch.cat([eng._sample_device(batch) for _ in range(rows)]).numpy()
    assert toks.shape == (n,) and toks.dtype == np.int32
    counts = np.bincount(toks, minlength=logits.size)
    p = np.exp((logits.astype(np.float64) - logits.max()) / temp)
    p /= p.sum()
    assert stats.chisquare(counts, n * p).pvalue > 1e-3
    jtoks = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), jax.numpy.asarray(logits) / temp, shape=(n,)))
    jcounts = np.bincount(jtoks, minlength=logits.size)
    assert stats.chi2_contingency(np.stack([counts, jcounts])).pvalue > 1e-3
    wrong = np.exp(logits.astype(np.float64) - logits.max())   # T = 1: the test has power
    assert stats.chisquare(counts, n * wrong / wrong.sum()).pvalue < 1e-9
