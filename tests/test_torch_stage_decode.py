"""True per-stage decode in the port, held against the JAX package.

``runtime/stage_decode.py`` and the staged parts of the serving engine
and launcher on smoke olmo-1b (4 layers unless a case needs 2), with the
reference's parameters converted through ``interop`` and the reference's
PU profiles, so the partitions (and their decode ranges) are the
reference's:

- the staged composition (embed, K stage slices, unembed) equals
  ``decode_step`` for K = 2 and 3, logits and cache;
- a runner round equals ``decode_step`` and keeps the virtual clock;
- the greedy streams of ``stream_pus`` with K = 2 and 3 and M = 1, 2 and
  4 under staggered admissions equal the port's single-PU streams and
  the JAX engine's, single-PU and staged (the JAX staged engine is run
  at K = 2, M = 2; it equals the JAX single-PU engine on every case,
  ``tests/test_stage_decode.py``);
- eos mid-stream, the K > layers guard, ``stage_decode=False``, the
  coalesced block against the threaded executor, a temperature stream
  deterministic per seed, no capture after warmup (with the stand-in
  capture of ``test_torch_graphs.py``), and ``serve --multi-pu 2``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core import pu as jpu  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu as tpu  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine, plan_partitioned_streaming  # noqa: E402
from repro_torch.runtime.stage_decode import StagedDecodeRunner  # noqa: E402

_P = {}
KW = dict(max_batch=4, max_len=64, max_new_tokens=6, seed=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops on one intra-op thread: the default (one a core)
    oversubscribes the cores when test processes run side by side, and
    the stage threads each start a team of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_layers=4, port=True):
    cfg = smoke_variant(get_config("olmo-1b")) if port else jsmoke(jget_config("olmo-1b"))
    return dataclasses.replace(cfg, n_layers=n_layers)


def _jparams(n_layers=4):
    if n_layers not in _P:
        jcfg = _cfg(n_layers, port=False)
        _P[n_layers] = jax.tree.map(
            np.asarray, japi.get_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    return _P[n_layers]


def _pus(k, port=True):
    m = tpu if port else jpu
    return [m.host_offload_config() if i % 2 == 0 else m.tpu_v5e_config() for i in range(k)]


def _port(n_layers=4, **kw):
    sc = dict(KW, **kw)
    if "stream_pus" in sc and isinstance(sc["stream_pus"], int):
        sc["stream_pus"] = _pus(sc["stream_pus"])
    return ServingEngine(_cfg(n_layers), interop.from_jax(_jparams(n_layers)), ServeConfig(**sc), "cpu")


def _jax(n_layers=4, **kw):
    sc = dict(KW, **kw)
    if "stream_pus" in sc:
        sc["stream_pus"] = _pus(sc["stream_pus"], port=False)
    return jserving.ServingEngine(_cfg(n_layers, port=False),
                                  jax.tree.map(jax.numpy.asarray, _jparams(n_layers)),
                                  jserving.ServeConfig(**sc))


def _waves(n_layers=4):
    rng = np.random.default_rng(31)
    vocab = _cfg(n_layers).vocab
    return [[rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
            for lens in ((9, 14, 6, 21), (5, 17, 11))]


def _serve(eng, waves):
    """Staggered admissions: the second wave arrives after one step."""
    for i, wave in enumerate(waves):
        for p in wave:
            eng.submit(p.copy())
        if i + 1 < len(waves):
            eng.step()
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _ref(key, make):
    if key not in _P:
        _P[key] = make()
    return _P[key]


# ---------------------------------------------------------------- model ---


@pytest.mark.parametrize("k", [2, 3])
def test_staged_composition_is_decode_step(k):
    cfg = _cfg()
    api = model_api.get_api(cfg)
    params = interop.from_jax(_jparams())
    cache = tuple(torch.randn(c.shape, generator=torch.Generator().manual_seed(1)).to(c.dtype)
                  for c in api.init_cache(cfg, 2, 32, "cpu"))
    toks = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = torch.tensor([2, 9], dtype=torch.int32)
    want, want_cache = api.decode_step(cfg, params, tuple(c.clone() for c in cache), toks, pos)
    bounds = [0, 1, 4] if k == 2 else [0, 1, 3, 4]
    staged = tuple(c.clone() for c in cache)
    h = api.decode_embed(cfg, params, toks, pos)
    for r in zip(bounds, bounds[1:]):
        h, _ = api.decode_stage(cfg, api.slice_params(cfg, params, r), h,
                                api.slice_cache(cfg, staged, r), pos)
    assert torch.equal(api.decode_unembed(cfg, params, h), want)
    assert all(torch.equal(a, b) for a, b in zip(staged, want_cache))


def test_runner_round_matches_decode_step_and_keeps_the_clock():
    cfg = _cfg()
    api = model_api.get_api(cfg)
    params = interop.from_jax(_jparams())
    plan = plan_partitioned_streaming(cfg, _pus(2), batch_tokens=2)
    runner = StagedDecodeRunner(cfg, api, params, plan)
    cache = api.init_cache(cfg, 2, 32, "cpu")
    runner.load_cache(cache)
    toks = torch.tensor([[5], [11]], dtype=torch.int32)
    pos = torch.tensor([4, 8], dtype=torch.int32)
    logits = runner.decode_round(toks, pos)
    want, want_cache = api.decode_step(cfg, params, api.init_cache(cfg, 2, 32, "cpu"), toks, pos)
    assert torch.equal(logits, want)
    assert runner.export_cache() is cache                       # views: nothing to write back
    assert all(torch.equal(a, b) for a, b in zip(cache, want_cache))
    assert runner.last_report.real_stage_compute and runner.clock_ok
    assert runner.last_report.frame_done_t[0] == pytest.approx(float(plan.pipeline_events(1)[-1, 0]))
    # the reference's guards
    with pytest.raises(ValueError, match="no decode layer range"):
        from repro_torch.plan import partition_gemms

        StagedDecodeRunner(cfg, api, params, partition_gemms([("a", 64, 64, 8)] * 2, _pus(2)))
    runner.configure(n_groups=2)
    with pytest.raises(ValueError, match="load_cache"):
        runner.decode_block([{}, {}], 1)
    runner.load_cache(cache)
    with pytest.raises(ValueError, match="serial M=1"):
        runner.decode_round(toks, pos)
    # lane groups are views of the master cache, contiguous per layer
    k = max(range(2), key=lambda i: runner.ranges[i][1] - runner.ranges[i][0])
    g1 = runner.stage_caches[k][1][0]
    assert g1.shape[0] > 1 and g1.data_ptr() == cache[0][runner.ranges[k][0], 1].data_ptr()
    assert g1[0].is_contiguous() and not g1.is_contiguous()


# ---------------------------------------------------- staged serving ---


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_staged_streams_match_single_pu_and_jax(k, m):
    """Greedy streams of K stages and M lane groups equal the port's
    single-PU engine's and the JAX engine's; the virtual clock holds."""
    waves = _waves()
    jax_single = _ref("jax_single", lambda: _serve(_jax(), waves))
    port_single = _ref("port_single", lambda: _serve(_port(), waves))
    assert port_single == jax_single
    eng = _port(stream_pus=k, decode_microbatches=m)
    assert eng._staged.coalesce and eng._staged.n_groups == m
    assert _serve(eng, waves) == port_single
    s = eng.stats()
    assert s["stage_decode"] == 1.0 and s["stage_decode_clock_ok"] == 1.0
    assert s["stage_decode_microbatches"] == float(m) and s["stage_decode_rounds"] > 0
    assert sum(s[f"stage{i}_decode_layers"] for i in range(k)) == 4
    want_ranges = [st.decode_layers for st in jserving.plan_partitioned_streaming(
        _cfg(port=False), _pus(k, port=False), batch_tokens=4).stages]
    assert eng._staged.ranges == want_ranges


def test_staged_streams_match_the_jax_staged_engine():
    waves = _waves()
    want = _serve(_jax(stream_pus=2, decode_microbatches=2), waves)
    got = _serve(_port(stream_pus=2, decode_microbatches=2), waves)
    assert got == want == _ref("jax_single", lambda: _serve(_jax(), waves))


@pytest.mark.parametrize("m", [2, 4])
def test_overlapped_decode_eos_midstream(m):
    waves = _waves()[:1]
    free = _serve(_port(max_new_tokens=8), waves)
    eos = next(t[len(t) // 2] for t in free.values() if len(t) >= 3)
    want = _serve(_port(max_new_tokens=8, eos_token=eos), waves)
    assert want != free                        # eos cut a stream
    got = _serve(_port(max_new_tokens=8, eos_token=eos, stream_pus=2, decode_microbatches=m), waves)
    assert got == want


def test_k_exceeds_num_layers_guard():
    """K = 3 over the 2-layer smoke model: a stage is empty (it passes
    the hidden state through) and the streams are still the single-PU
    engine's."""
    eng = _port(n_layers=2, stream_pus=3, decode_microbatches=2)
    ranges = eng._staged.ranges
    assert len(ranges) == 3 and any(a == b for a, b in ranges)
    assert sum(b - a for a, b in ranges) == 2
    assert ranges == [s.decode_layers for s in jserving.plan_partitioned_streaming(
        _cfg(2, port=False), _pus(3, port=False), batch_tokens=4).stages]
    waves = _waves(2)
    assert _serve(eng, waves) == _serve(_port(n_layers=2), waves)


def test_stage_decode_escape_hatch():
    eng = _port(stream_pus=2, stage_decode=False)
    assert eng._staged is None and eng.partitioned_plan is not None
    assert _serve(eng, _waves()) == _ref("port_single", lambda: _serve(_port(), _waves()))
    s = eng.stats()
    assert "stage_decode" not in s and s["partition_stages"] == 2.0


def test_coalesced_block_matches_threaded_executor():
    """The coalesced pass and the threaded session run the same schedule:
    equal streams, rounds and virtual bubble."""
    results = {}
    for mode in ("coalesced", "threaded"):
        eng = _port(stream_pus=2, decode_microbatches=2)
        eng._staged.coalesce = mode == "coalesced"
        streams = _serve(eng, _waves())
        results[mode] = streams, eng.stats()
        assert results[mode][1]["stage_decode_clock_ok"] == 1.0
    (cs, cst), (ts, tst) = results["coalesced"], results["threaded"]
    assert cs == ts
    assert cst["stage_decode_rounds"] == tst["stage_decode_rounds"]
    assert cst["stage_decode_bubble"] == pytest.approx(tst["stage_decode_bubble"], rel=1e-9)


def test_temperature_stream_is_deterministic_per_seed():
    streams = []
    for seed in (0, 0, 1):
        streams.append(_serve(_port(stream_pus=2, decode_microbatches=2, temperature=0.8,
                                    seed=seed), _waves()))
    assert streams[0] == streams[1] and streams[0] != streams[2]
    eng = _port(stream_pus=2, decode_microbatches=2, temperature=0.8)
    gens = eng._staged_gens
    assert len(gens) == 2 and gens[0].initial_seed() != gens[1].initial_seed()


class _EagerReplay(common.CapturedGraph):
    """A stand-in for a captured graph: each replay runs the recorded
    function again, eagerly."""

    def __init__(self, fn):
        super().__init__(None, {})
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_warmup_captures_each_block_length_and_traffic_none(monkeypatch, temperature):
    """With the coalesced blocks captured (a stand-in on the CPU): warmup
    captures one graph per pow2 block length, under ``"decode"``, and
    traffic captures nothing; the streams equal the eager engine's."""
    captured = []

    def capture(fn, *, pool=None, generators=()):
        assert list(generators) == (eng._staged_gens if temperature else [])
        fn()
        captured.append(fn)
        return _EagerReplay(fn), None

    monkeypatch.setattr(serving, "capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    kw = dict(stream_pus=2, decode_microbatches=2, max_decode_block=4, temperature=temperature)
    ref = _port(**kw)
    ref.warmup()
    want = _serve(ref, _waves())
    eng = _port(**kw)
    eng.cuda_graphs = True
    eng._staged._capture = lambda fn: eng._capture(fn, eng._staged_gens)
    eng.warmup()
    assert eng.trace_counts == {"decode": 3, "prefill": 0} and len(eng._staged.graphs) == 3
    with sanitize.retrace_guard(eng.tracing):
        got = _serve(eng, _waves())
    assert got == want and len(captured) == 3
    s = eng.stats()
    assert s["stage_decode_clock_ok"] == 1.0 and s["decode_traces"] == 3.0


def test_launcher_multi_pu_on_the_cpu(capsys):
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "5"]
    assert serve.main(argv + ["--multi-pu", "2", "--no-warmup"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["completed"] == 3 and stats["tokens"] == 15
    assert stats["partition_stages"] == 2.0 and stats["stage_decode"] == 1.0
    assert stats["stage_decode_autotuned"] == 1.0 and stats["partition_autotuned_m"] >= 1
    streams = []
    for extra in ([], ["--multi-pu", "2", "--microbatches", "1"],
                  ["--multi-pu", "2", "--microbatches", "2"], ["--multi-pu", "2", "--no-stage-decode"]):
        args = serve.build_parser().parse_args(argv + extra)
        eng = serve.make_engine(args)
        serve.submit_requests(eng, args)
        streams.append({r.uid: r.out_tokens for r in eng.run_until_drained()})
        if extra:
            assert [p.name for p in eng.serve_cfg.stream_pus] == \
                [tpu.h100_host_offload_config().name] * 2
    assert streams[0] == streams[1] == streams[2] == streams[3]
