"""AIMC noise emulation of the port (``repro_torch.core.aimc``) against
the JAX package's (``repro.core.aimc``), on the CPU.

The reference draws from ``jax.random`` and the port from
``torch.Generator``s (float leaves) and the NIU's counter hash (int8
``QTensor`` leaves, ``kernels.niu``), so the noise is compared in
distribution: on the same parameters (converted with
``repro_torch.interop``) the per-leaf mean and std of the perturbation
must agree with the reference's within ``STAT_RTOL`` of the reference's
std (the estimates' own error is under 0.3 % at these sizes), and with
the model's sigma.  What is deterministic is held exactly: drift alone,
the weights left digital, the exponent grid, ``snr_db`` (within 1e-5
relative: the sums run in another order).  The port's counterparts of
``tests/test_aimc.py`` keep that file's names with ``_port`` added.  Plus
what the port does by design: fixed output tensors, the pristine weights
untouched, ``serve --aimc``, and the example.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core import aimc as jaimc  # noqa: E402
from repro.core.quant import quantize as jquantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aimc  # noqa: E402
from repro_torch.core.quant import QTensor  # noqa: E402
from repro_torch.examples import aimc_emulation  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

STAT_RTOL = 0.02


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(t):
    return np.asarray(t, dtype=np.float32)


# ------------------------------------------------------ counterparts ----


def test_noise_model_matches_the_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(aimc.AIMCNoiseModel)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jaimc.AIMCNoiseModel)]
    assert ours == ref
    for args in [(), (0.0, 0.0, 0.0), (0.0, 0.0, 0.06), (0.0, 0.01, 0.0), (0.3, 0.0, 0.0)]:
        assert aimc.AIMCNoiseModel(*args).enabled() == jaimc.AIMCNoiseModel(*args).enabled()
    m = aimc.AIMCNoiseModel()
    assert m.drift() == (m.t_read / m.t0) ** -m.drift_nu
    assert aimc.AIMCNoiseModel(drift_nu=0.0).drift() == 1.0


def test_fresh_noise_each_round_port():
    w = {"layer": {"w": torch.randn(32, 32, generator=_gen(0))}}
    before = w["layer"]["w"].clone()
    niu = aimc.NoiseInjectionUnit(w, aimc.AIMCNoiseModel())
    a = niu.refresh(_gen(1))["layer"]["w"].clone()
    b = niu.refresh(_gen(2))["layer"]["w"]
    assert (a - b).abs().max().item() > 0
    assert torch.equal(niu.pristine["layer"]["w"], before)       # pristine copy untouched


def test_same_seed_is_deterministic_port():
    w = {"w": torch.randn(16, 16, generator=_gen(0))}
    niu = aimc.NoiseInjectionUnit(w, aimc.AIMCNoiseModel())
    a = niu.refresh(_gen(7))["w"].clone()
    assert torch.equal(niu.refresh(_gen(7))["w"], a)
    q = {"w": aimc.QTensor(q=torch.randint(-127, 128, (24, 40), dtype=torch.int8,
                                           generator=_gen(1)), exp=torch.tensor(-6))}
    niu = aimc.NoiseInjectionUnit(q, aimc.AIMCNoiseModel())
    a = niu.refresh(_gen(7))["w"].q.clone()
    assert torch.equal(niu.refresh(_gen(7))["w"].q, a)
    assert not torch.equal(niu.refresh(_gen(8))["w"].q, a)


def test_noise_statistics_match_model_and_reference():
    """Programming-noise std ~ scale * (0.25|w| + 0.05 w_max) at the
    large-sample limit (drift/read disabled), as the reference's test
    holds it; and the port's std and mean equal the reference's draws'."""
    model = aimc.AIMCNoiseModel(prog_noise_scale=0.1, read_noise_scale=0.0, drift_nu=0.0)
    w = torch.ones((400, 400))
    err = _np(aimc.inject_noise_float(w, _gen(0), model) - w)
    ref = _np(jaimc.inject_noise_float(jnp.ones((400, 400)), jax.random.PRNGKey(0),
                                       jaimc.AIMCNoiseModel(0.1, 0.0, 0.0)) - 1.0)
    expected_sigma = 0.1 * (0.25 * 1.0 + 0.05 * 1.0)
    assert err.std() == pytest.approx(expected_sigma, rel=0.05)
    assert abs(err.mean()) < 3 * expected_sigma / np.sqrt(err.size) * 2
    assert err.std() == pytest.approx(ref.std(), rel=STAT_RTOL)
    assert abs(err.mean() - ref.mean()) < STAT_RTOL * ref.std()


def test_drift_shrinks_weights_port():
    model = aimc.AIMCNoiseModel(prog_noise_scale=0.0, read_noise_scale=0.0,
                                drift_nu=0.06, t_read=3600.0, t0=20.0)
    w = torch.ones((64, 64)) * 2.0
    noisy = aimc.inject_noise_float(w, _gen(0), model)
    factor = (3600.0 / 20.0) ** (-0.06)
    np.testing.assert_allclose(noisy.numpy(), 2.0 * factor, rtol=1e-6)
    want = jaimc.inject_noise_float(jnp.ones((64, 64)) * 2.0, jax.random.PRNGKey(0),
                                    jaimc.AIMCNoiseModel(0.0, 0.0, 0.06, 3600.0, 20.0))
    np.testing.assert_array_equal(noisy.numpy(), np.asarray(want))     # deterministic: exact
    assert factor < 1.0


def test_qtensor_leaves_requantized_on_same_grid_port():
    wq = jquantize(jax.random.normal(jax.random.PRNGKey(0), (32, 32)))
    tq = QTensor(q=interop.to_torch(wq.q), exp=interop.to_torch(wq.exp))
    niu = aimc.NoiseInjectionUnit({"w": tq}, aimc.AIMCNoiseModel())
    out = niu.refresh(_gen(3))
    assert isinstance(out["w"], QTensor) and out["w"].q.dtype == torch.int8
    # exponent (the power-of-two grid) unchanged -- NIU overwrites payload
    assert out["w"].exp is tq.exp and int(out["w"].exp) == int(wq.exp)
    assert bool((out["w"].q != tq.q).any())


def test_biases_and_vectors_stay_digital_port():
    params = {
        "w": torch.randn(8, 8, generator=_gen(0)),
        "bias": torch.ones((8,)),
        "norm_scale": torch.ones((8,)),
    }
    out = aimc.NoiseInjectionUnit(params, aimc.AIMCNoiseModel()).refresh(_gen(0))
    assert out["bias"] is params["bias"] and out["norm_scale"] is params["norm_scale"]
    assert torch.equal(out["bias"], torch.ones(8)) and bool((out["w"] != params["w"]).any())


def test_snr_decreases_with_noise_scale_port():
    w = torch.randn(64, 64, generator=_gen(0))
    lo = aimc.inject_noise_float(w, _gen(1), aimc.AIMCNoiseModel(prog_noise_scale=0.02))
    hi = aimc.inject_noise_float(w, _gen(1), aimc.AIMCNoiseModel(prog_noise_scale=0.4))
    assert float(aimc.snr_db(w, lo)) > float(aimc.snr_db(w, hi))


def test_disabled_model_detected_port():
    assert not aimc.AIMCNoiseModel(0.0, 0.0, 0.0).enabled()
    assert aimc.AIMCNoiseModel().enabled()


@pytest.mark.parametrize("scale", [1e-3, 0.05, 0.5, 3.0])
def test_snr_db_matches_the_reference(scale):
    rng = np.random.default_rng(int(scale * 1000))
    clean = rng.standard_normal((96, 130)).astype(np.float32)
    noisy = (clean + scale * rng.standard_normal(clean.shape)).astype(np.float32)
    got = float(aimc.snr_db(torch.from_numpy(clean), torch.from_numpy(noisy)))
    want = float(jaimc.snr_db(jnp.asarray(clean), jnp.asarray(noisy)))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(aimc.snr_db(torch.from_numpy(clean), torch.from_numpy(clean))) == pytest.approx(
        float(jaimc.snr_db(jnp.asarray(clean), jnp.asarray(clean))), rel=1e-5)


# ---------------------------------- the unit against the reference's unit ----


def _perturbation(pristine, noisy):
    return _np(noisy) - _np(pristine)


@pytest.mark.parametrize("model", [
    dict(),
    dict(prog_noise_scale=0.3, read_noise_scale=0.0, drift_nu=0.0),
    dict(prog_noise_scale=0.0, read_noise_scale=0.1, drift_nu=0.0),
], ids=["default", "prog_only", "read_only"])
def test_qtensor_noise_matches_the_reference_in_distribution(model):
    """Two int8 leaves of different scales, through the port's NIU plan
    (its counter hash) and the reference's float path (``jax.random``):
    per leaf, the mean and std of the dequantized perturbation agree; with
    programming noise alone its std is the model's sigma, averaged over the
    leaf, plus the rounding's step^2 / 12."""
    rng = np.random.default_rng(0)
    jparams = {"a": {"w": jquantize(jnp.asarray(rng.standard_normal((256, 256)), jnp.float32))},
               "b": {"w": jquantize(jnp.asarray(0.01 * rng.standard_normal((3, 3, 64, 96)),
                                                 jnp.float32))}}
    params = interop.resnet_params_from_jax(
        {k: {"w": (np.asarray(v["w"].q), np.asarray(v["w"].exp)), "bias": np.zeros(1, np.int32),
             "shift": np.zeros((), np.int32)} for k, v in jparams.items()})
    m, jm = aimc.AIMCNoiseModel(**model), jaimc.AIMCNoiseModel(**model)
    ours = aimc.NoiseInjectionUnit(params, m).refresh(_gen(0))
    ref = jaimc.NoiseInjectionUnit(jparams, jm).refresh(jax.random.PRNGKey(0))
    for k in jparams:
        clean = jparams[k]["w"].dequantize()
        d = _perturbation(clean, ours[k]["w"].dequantize())
        dj = _perturbation(clean, ref[k]["w"].dequantize())
        assert d.std() == pytest.approx(dj.std(), rel=STAT_RTOL), k
        assert abs(d.mean() - dj.mean()) < STAT_RTOL * dj.std(), k
        if model.get("read_noise_scale", 0.02) == 0.0:
            w = np.asarray(clean)
            sigma = m.prog_noise_scale * (0.25 * np.abs(w) + 0.05 * np.abs(w).max())
            step = 2.0 ** float(jparams[k]["w"].exp)
            assert d.std() == pytest.approx(np.sqrt((sigma ** 2).mean() + step ** 2 / 12), rel=0.05)


def test_float_leaves_match_the_reference_in_distribution():
    """The LM's bf16 leaves, converted from the reference's smoke
    olmo-1b: the same leaves are targeted, kept in bf16, and each one's
    perturbation has the reference's mean and std."""
    jcfg = jsmoke(jget_config("olmo-1b"))
    jparams = japi.get_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.from_jax(jax.tree.map(np.asarray, jparams))
    model = aimc.AIMCNoiseModel(prog_noise_scale=0.2)
    ours = aimc.NoiseInjectionUnit(params, model).refresh(_gen(0))
    ref = jaimc.NoiseInjectionUnit(jparams, jaimc.AIMCNoiseModel(prog_noise_scale=0.2)).refresh(
        jax.random.PRNGKey(0))
    flat = dict(aimc.leaves_with_paths(ours))
    jflat = {tuple(getattr(k, "key", k) for k in p): v
             for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    pristine = dict(aimc.leaves_with_paths(params))
    noisy = 0
    for path, leaf in flat.items():
        want = jflat[path]
        assert leaf.dtype == pristine[path].dtype
        d = _perturbation(pristine[path].float(), leaf.float())
        dj = _perturbation(pristine[path].float(), np.asarray(want, np.float32))
        if not np.any(dj):
            assert not np.any(d), path            # left digital by both
            continue
        noisy += 1
        assert d.std() == pytest.approx(dj.std(), rel=0.05), path
        assert abs(d.mean() - dj.mean()) < 0.05 * dj.std(), path
    assert noisy == sum(aimc._is_weight_leaf(p) and x.dim() >= 2 for p, x in pristine.items())


def test_weight_leaf_filter_takes_the_references_leaves():
    jcfg = jsmoke(jget_config("olmo-1b"))
    jparams = japi.get_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    want = {tuple(getattr(k, "key", k) for k in p)
            for p, _ in jax.tree_util.tree_leaves_with_path(jparams) if jaimc._is_weight_leaf(p)}
    params = interop.from_jax(jax.tree.map(np.asarray, jparams))
    got = {p for p, _ in aimc.leaves_with_paths(params) if aimc._is_weight_leaf(p)}
    assert got == want and ("embed",) in got and ("layers", "attn", "wq") in got
    assert ("layers", "attn_norm", "scale") not in got


def test_outputs_are_fixed_tensors_and_the_pristine_is_untouched():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 16, 32), dtype=np.int8))
    params = {"conv": {"w": QTensor(q=q, exp=torch.tensor(-5, dtype=torch.int32)),
                       "bias": torch.zeros(32, dtype=torch.int32)},
              "dense": {"w": torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))}}
    before = (q.clone(), params["dense"]["w"].clone())
    niu = aimc.NoiseInjectionUnit(params, aimc.AIMCNoiseModel(prog_noise_scale=0.3))
    assert torch.equal(niu.params["conv"]["w"].q, q)            # the pristine values until a refresh
    ptrs = (niu.params["conv"]["w"].q.data_ptr(), niu.params["dense"]["w"].data_ptr())
    outs = []
    for seed in range(3):
        out = niu.refresh(_gen(seed))
        assert out is niu.params
        assert (out["conv"]["w"].q.data_ptr(), out["dense"]["w"].data_ptr()) == ptrs
        assert out["conv"]["w"].q.data_ptr() == niu.plan.outs[0].data_ptr()
        outs.append((out["conv"]["w"].q.clone(), out["dense"]["w"].clone()))
    assert not torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[1][1], outs[2][1])
    assert torch.equal(q, before[0]) and torch.equal(params["dense"]["w"], before[1])
    assert ptrs[0] != q.data_ptr() and ptrs[1] != params["dense"]["w"].data_ptr()


def test_unit_draws_from_its_own_generator_by_default():
    w = {"w": torch.randn(16, 16, generator=_gen(0))}
    a = aimc.NoiseInjectionUnit(w, aimc.AIMCNoiseModel(), seed=4)
    b = aimc.NoiseInjectionUnit(w, aimc.AIMCNoiseModel(), seed=4)
    first = a.refresh()["w"].clone()
    assert torch.equal(b.refresh()["w"], first) and not torch.equal(a.refresh()["w"], first)


# -------------------------------------------------- serving and the example --


def _serve_streams(extra, seed=0):
    args = serve.build_parser().parse_args(
        ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "5",
         "--seed", str(seed)] + extra)
    eng = serve.make_engine(args)
    eng.warmup()
    serve.submit_requests(eng, args)
    eng.run_until_drained()
    return {r.uid: r.out_tokens for r in eng.completed}, eng


def _flat(params):
    return torch.cat([x.float().ravel() for _, x in aimc.leaves_with_paths(params)])


def test_serve_aimc_is_seeded_and_differs_from_the_clean_run():
    """serve --aimc on the smoke model: the same seed serves the same
    streams through the same noisy weights; the weights the rounds read,
    and the logits they give, differ from the clean run's.  (As the
    reference's ``tests/test_serving.py::test_aimc_changes_generations``
    says, a random-init smoke model is argmax-degenerate, so its token ids
    need not move.)"""
    clean, ceng = _serve_streams([])
    a, eng = _serve_streams(["--aimc"])
    b, beng = _serve_streams(["--aimc"])
    _, other = _serve_streams(["--aimc"], seed=1)
    assert a == b and torch.equal(_flat(eng.params), _flat(beng.params))
    assert not torch.equal(_flat(eng.params), _flat(other.params))
    assert not torch.allclose(_flat(eng.params), _flat(eng.niu.pristine), atol=1e-6)
    assert torch.equal(_flat(eng.niu.pristine), _flat(ceng.params))     # never written
    toks = {"tokens": torch.arange(12, dtype=torch.int32)[None]}
    noisy_logits, _ = eng.api.prefill(eng.cfg, eng.params, toks)
    clean_logits, _ = ceng.api.prefill(ceng.cfg, ceng.params, toks)
    assert not torch.allclose(noisy_logits, clean_logits, atol=1e-3)
    st = eng.stats()
    # one decode round a block while the NIU is on, a refresh every round
    assert st["aimc_refreshes"] == st["rounds"] == st["decode_rounds"] > 0
    assert eng.params is eng.niu.params and all(len(s) == 5 for s in a.values())
    assert sorted(a) == sorted(clean)


def test_engine_refreshes_every_n_rounds():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import transformer
    from repro_torch.runtime.serving import ServeConfig, ServingEngine

    cfg = smoke_variant(get_config("olmo-1b"))
    eng = ServingEngine(cfg, transformer.init_params(cfg, 0, "cpu"), ServeConfig(
        max_batch=2, max_len=64, max_new_tokens=7, aimc=aimc.AIMCNoiseModel(),
        aimc_refresh_every=3), "cpu")
    eng.submit(np.arange(9, dtype=np.int32))
    steps = 0
    while eng.pending or eng.active:
        eng.step()
        steps += 1
    assert eng.decode_rounds == eng.rounds == steps == 6          # capped at one round a block
    assert eng.aimc_refreshes == 2                                # rounds 0 and 3


def test_disabled_model_serves_without_a_unit():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import transformer
    from repro_torch.runtime.serving import ServeConfig, ServingEngine

    cfg = smoke_variant(get_config("olmo-1b"))
    eng = ServingEngine(cfg, transformer.init_params(cfg, 0, "cpu"), ServeConfig(
        aimc=aimc.AIMCNoiseModel(0.0, 0.0, 0.0)), "cpu")
    assert eng.niu is None


def test_aimc_example_runs_on_the_cpu(capsys):
    aimc_emulation.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "== ResNet-18 (int8, reduced 28x28 input) =="
    assert out[1] == "  prog_noise=0.00: top1 flips 0/4, logit SNR inf dB"
    assert all(line.startswith(f"  prog_noise={s}: top1 flips ") and line.endswith(" dB")
               for line, s in zip(out[2:5], ("0.05", "0.10", "0.30")))
    assert out[5] == "== olmo-1b (smoke) =="
    assert all(line.startswith(f"  prog_noise={s}: greedy-token flip rate ")
               and line.endswith(" dB over 3 rounds") for line, s in zip(out[6:9], ("0.02", "0.10", "0.30")))
    assert len(out) == 9
