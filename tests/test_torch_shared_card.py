"""Staged decode on one shared card: M = 1 as the single-PU captured pass.

``runtime.serving.staged_lane_groups`` picks the lane-group count M: a
request is honoured, stages that share one CUDA device
(``shares_one_card``) take M = 1 without the tuner, and otherwise the
tuner picks M.  An engine on the CPU with the shared-card condition and
the stand-in capture of ``tests/test_torch_graphs.py`` patched in runs
M = 1 through the coalesced pass (no ``decode_round`` after warmup),
captures once per pow2 block length at warmup and nothing after, and
serves the single-PU engine's greedy streams; an explicit M = 2 there is
still honoured.  Smoke olmo-1b, 4 layers, the port's own seeded weights.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

KW = dict(max_batch=4, max_len=64, max_new_tokens=6, seed=0, max_decode_block=4)
_P = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops on one intra-op thread: the stage threads each start
    a team of their own, and test processes run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(smoke_variant(get_config("olmo-1b")), n_layers=4)


def _params():
    if "p" not in _P:
        _P["p"] = transformer.init_params(_cfg(), 0, "cpu")
    return _P["p"]


def _engine(**kw):
    sc = dict(KW, **kw)
    if sc.get("stream_pus"):
        sc["stream_pus"] = [pu.h100_host_offload_config() for _ in range(sc["stream_pus"])]
    return ServingEngine(_cfg(), _params(), ServeConfig(**sc), "cpu")


def _waves():
    rng = np.random.default_rng(31)
    return [[rng.integers(0, 512, int(n)).astype(np.int32) for n in lens]
            for lens in ((9, 14, 6, 21), (5, 17, 11))]


def _serve(eng):
    """Staggered admissions: the second wave arrives after one step."""
    waves = _waves()
    for i, wave in enumerate(waves):
        for p in wave:
            eng.submit(p.copy())
        if i + 1 < len(waves):
            eng.step()
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


# ---------------------------------------------------------------- the rule --


def test_the_m_rule():
    tuned = types.SimpleNamespace(n_groups=2, queue_depth=3)
    calls = []

    def tune():
        calls.append(1)
        return tuned

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert serving.shares_one_card(cuda, True)
    assert not serving.shares_one_card(cuda, False) and not serving.shares_one_card(cpu, True)
    assert serving.staged_lane_groups(0, 8, True, tune) == (1, None) and not calls
    assert serving.staged_lane_groups(0, 8, False, tune) == (2, tuned) and len(calls) == 1
    # a request is honoured, on a shared card too, clamped to a divisor
    assert serving.staged_lane_groups(2, 8, True, tune) == (2, None)
    assert serving.staged_lane_groups(3, 8, True, tune) == (2, None)
    assert serving.staged_lane_groups(1, 8, False, tune) == (1, None)
    assert serving.staged_lane_groups(8, 4, False, tune) == (4, None) and len(calls) == 1


def test_the_cpu_keeps_the_tuner():
    """The CPU's stages have no device: the tuner picks M, as before."""
    eng = _engine(stream_pus=2)
    assert not eng.stages_share_card and eng.staged_tune is not None
    assert eng._staged.n_groups == eng.staged_tune.n_groups
    assert eng.stats()["stage_decode_autotuned"] == 1.0


# ------------------------------------------------ the engine on a shared card --


class _EagerReplay(common.CapturedGraph):
    """A stand-in for a captured graph: each replay runs the recorded
    function again, eagerly."""

    def __init__(self, fn):
        super().__init__(None, {})
        self.fn = fn

    def replay(self):
        self.fn()


def _shared_card_engine(monkeypatch, captured, **kw):
    """A staged engine that takes the CPU for one shared card, its
    coalesced blocks captured by the stand-in."""
    monkeypatch.setattr(serving, "shares_one_card", lambda device, shared: True)
    eng = _engine(stream_pus=2, **kw)

    def capture(fn, *, pool=None, generators=()):
        want = [eng._gen] if eng.serve_cfg.temperature > 0 and eng._staged.n_groups == 1 else (
            eng._staged_gens if eng.serve_cfg.temperature > 0 else [])
        assert list(generators) == want
        fn()
        captured.append(fn)
        return _EagerReplay(fn), None

    monkeypatch.setattr(serving, "capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    eng.cuda_graphs = True
    eng._staged._capture = eng._staged_capture
    return eng


def test_shared_card_runs_m1_as_one_captured_pass(monkeypatch):
    want = _serve(_engine())                                   # the single-PU engine
    captured = []
    eng = _shared_card_engine(monkeypatch, captured)
    runner = eng._staged
    assert eng.stages_share_card and runner.coalesce and runner.n_groups == 1
    assert eng.staged_tune is None
    eng.warmup()
    assert eng.trace_counts == {"decode": 3, "prefill": 0} and len(runner.graphs) == 3
    assert sorted(runner._co_graphs) == [(1, 1), (1, 2), (1, 4)]
    rounds = []
    inner = runner.decode_round
    runner.decode_round = lambda *a: rounds.append(1) or inner(*a)
    with sanitize.retrace_guard(eng.tracing):
        got = _serve(eng)
    assert got == want and len(captured) == 3 and not rounds
    s = eng.stats()
    assert s["stage_decode_microbatches"] == 1.0 and s["stage_decode_coalesced"] == 1.0
    assert s["stage_decode_clock_ok"] == 1.0 and s["decode_traces"] == 3.0
    assert s["stage_decode_rounds"] == s["decode_rounds"]            # warmup resets the count
    assert not any(k.startswith("stage_decode_autotune") for k in s)


def test_shared_card_m1_samples_as_the_single_pu_engine(monkeypatch):
    """Under temperature the one lane group draws from the engine's own
    generator in the single-PU order (no warmup on either engine, so the
    draws line up from the first)."""
    want = _serve(_engine(temperature=0.8))
    captured = []
    eng = _shared_card_engine(monkeypatch, captured, temperature=0.8)
    got = _serve(eng)
    assert got == want and captured and eng._staged.n_groups == 1


def test_shared_card_honours_a_pinned_m(monkeypatch):
    captured = []
    eng = _shared_card_engine(monkeypatch, captured, decode_microbatches=2)
    assert eng._staged.n_groups == 2 and eng.staged_tune is None
    eng.warmup()
    assert sorted(eng._staged._co_graphs) == [(2, 1), (2, 2), (2, 4)]
    with sanitize.retrace_guard(eng.tracing):
        got = _serve(eng)
    assert got == _serve(_engine())
