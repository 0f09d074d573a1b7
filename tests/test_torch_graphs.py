"""The CUDA-graph bookkeeping of the port, on the CPU.

- ``repro_torch.analysis.sanitize``'s ``TraceCounter`` and
  ``retrace_guard`` behave as the JAX package's on the same sequences of
  bumps (there a bump is a jit trace, here a graph capture);
- ``kernels.common``: a replay adds the launches its capture counted;
  scalar arguments are static tensors, made once; the split-K scratch a
  graph being captured reads is pinned and never grown under it;
- the serving engine's graph path, with the capture replaced by a stand-in
  that records the block and replays it eagerly (CUDA graphs exist only
  on the card): one capture per block length, none after warmup or a
  second time at first use, streams equal to the eager engine's; its
  temperature draw is ``torch.multinomial``'s, which a graph cannot
  capture;
- the captured ResNet forward refuses parameters on the CPU.

The captures themselves run on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import sanitize as jsanitize  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import common, decode  # noqa: E402
from repro_torch.models import resnet, transformer  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

# (kinds given at construction, bumps before the guard, bumps inside it,
# max_new_traces, kinds the guard watches)
GUARD_CASES = [
    (("decode", "prefill"), ["decode"], [], 0, None),
    (("decode", "prefill"), [], ["decode"], 0, None),
    (("decode", "prefill"), ["prefill"], ["decode", "decode"], 2, None),
    (("decode", "prefill"), [], ["decode", "prefill", "decode"], 2, None),
    (("decode", "prefill"), [], ["prefill", "prefill"], 0, ("decode",)),
    (("decode",), [], ["stage"], 0, None),
    ((), ["decode"], ["stage", "decode"], 1, ("stage",)),
]


@pytest.mark.parametrize("kinds,before,inside,allowed,watch", GUARD_CASES)
def test_trace_counter_and_guard_match_the_reference(kinds, before, inside, allowed, watch):
    counters = (sanitize.TraceCounter(kinds), jsanitize.TraceCounter(kinds))
    errors = (sanitize.RetraceError, jsanitize.RetraceError)
    guards = (sanitize.retrace_guard, jsanitize.retrace_guard)
    verdicts, states = [], []
    for tc, err, guard in zip(counters, errors, guards):
        for k in before:
            tc.bump(k)
        try:
            with guard(tc, allowed, kinds=watch):
                for k in inside:
                    tc.bump(k)
            verdicts.append(None)
        except err as e:
            verdicts.append(str(e).split("(", 1)[1])      # the allowance and the per-kind delta
        states.append((tc.counts, tc.snapshot(), tc.total()))
    assert verdicts[0] == verdicts[1] and states[0] == states[1]


def test_trace_counter_wrap_bumps_per_call_like_the_reference():
    ours, ref = sanitize.TraceCounter(), jsanitize.TraceCounter()
    f, g = ours.wrap("decode", lambda x: x + 1), ref.wrap("decode", lambda x: x + 1)
    assert [f(1), f(2)] == [g(1), g(2)] == [2, 3]
    assert ours.counts == ref.counts == {"decode": 2}


class _Graph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_launches_its_capture_counted():
    common.reset_launches()
    g = common.CapturedGraph(_Graph(), {decode.fused_qkv: 32, decode.fused_mlp: 32,
                                        decode.fused_decode_attention: 0})
    assert set(g.launches) == {decode.fused_qkv, decode.fused_mlp}
    for _ in range(3):
        g.replay()
    assert g.graph.replays == 3
    counts = common.launch_counts()
    assert counts["fused_qkv"] == counts["fused_mlp"] == 96
    assert counts["fused_decode_attention"] == 0 and counts["int8_gemm"] == 0
    common.reset_launches()
    assert common.launch_snapshot()[decode.fused_qkv] == 0


def test_scalar_arguments_are_static_tensors():
    cpu = torch.device("cpu")
    a, b, c = (common.device_int(v, "shift", cpu) for v in (7, 7, -3))
    assert a is b and a is not c
    assert a.dtype == torch.int32 and a.shape == () and a.item() == 7 and c.item() == -3
    t = torch.tensor(5, dtype=torch.int32)
    assert common.device_int(t, "shift", cpu).item() == 5
    with pytest.raises(ValueError):
        common.device_int(torch.tensor([1, 2]), "shift", cpu)


def test_scratch_is_pinned_and_never_grown_under_a_capture():
    cpu = torch.device("cpu")
    ws, cnt = common.split_k_scratch("test_graphs", cpu, 1, 64, torch.float32, 4)
    common._PINNED.append([])
    try:
        for _ in range(3):
            assert common.split_k_scratch("test_graphs", cpu, 1, 32, torch.float32, 2) == (ws, cnt)
        assert common._PINNED[-1] == [(ws, cnt)]               # kept once, however often used
        with pytest.raises(RuntimeError, match="grow"):
            common.split_k_scratch("test_graphs", cpu, 1, 65, torch.float32, 4)
        with pytest.raises(RuntimeError, match="grow"):
            common.split_k_scratch("test_graphs", cpu, 2, 8, torch.float32, 1)
    finally:
        common._PINNED.pop()
    ws2, _ = common.split_k_scratch("test_graphs", cpu, 1, 65, torch.float32, 4)
    assert ws2.numel() == 65 and ws.numel() == 64      # the pinned one is left as it was


class _EagerReplay(common.CapturedGraph):
    """A stand-in for a captured graph: each replay runs the recorded
    function again, eagerly."""

    def __init__(self, fn):
        super().__init__(None, {})
        self.fn = fn

    def replay(self):
        self.fn()


def _engine(graphs, **kw):
    sc = dict(max_batch=2, max_len=64, max_new_tokens=9, seed=0)
    sc.update(kw)
    cfg = smoke_variant(get_config("olmo-1b"))
    eng = ServingEngine(cfg, transformer.init_params(cfg, 0, "cpu"), ServeConfig(**sc), "cpu")
    eng.cuda_graphs = graphs            # the CPU has no graphs: the stand-in replays eagerly
    return eng


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p.copy())
    with sanitize.retrace_guard(eng.tracing):
        eng.run_until_drained()
    return {r.uid: r.out_tokens for r in eng.completed}


@pytest.mark.parametrize("warm", [True, False], ids=["warmup", "first_use"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_captures_each_block_length_once(monkeypatch, warm, temperature):
    captured = []

    def capture(fn, *, pool=None, generators=()):
        """``common.capture_graph`` without the card: the warm-up run,
        then a graph that replays ``fn`` eagerly."""
        assert list(generators) == ([eng._gen] if temperature else [])
        fn()
        captured.append(fn)
        return _EagerReplay(fn), None

    monkeypatch.setattr(serving, "capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (9, 14, 6)]
    ref = _engine(False, temperature=temperature)
    ref.warmup()
    want = _serve(ref, prompts)
    eng = _engine(True, temperature=temperature)
    if warm:
        eng.warmup()
        assert eng.trace_counts == {"decode": 6, "prefill": 0}      # R = 1, 2, ..., 32
        got = _serve(eng, prompts)
    else:
        ref2 = _engine(False, temperature=temperature)
        want = _serve(ref2, prompts)
        for p in prompts:
            eng.submit(p.copy())
        eng.run_until_drained()
        got = {r.uid: r.out_tokens for r in eng.completed}
        n = len(eng._graphs)
        assert n >= 1 and eng.trace_counts["decode"] == n == len(captured)
    assert got == want
    st = eng.stats()
    assert st["decode_traces"] == len(captured) and st["prefill_traces"] == 0
    assert st["cuda_graphs"] == 1.0 and ref.stats()["cuda_graphs"] == 0.0


def test_cpu_engine_runs_eagerly_and_counts_no_capture():
    eng = _engine(False)
    assert not ServingEngine(eng.cfg, eng.params, eng.serve_cfg, "cpu", eager=False).cuda_graphs
    eng.warmup()
    assert eng.trace_counts == eng.tracing.counts == {"decode": 0, "prefill": 0}
    assert eng.trace_counts is eng.tracing.counts


def test_temperature_draw_is_torch_multinomials():
    eng = _engine(False, temperature=0.7)
    logits = torch.randn(4, 300, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(11)
    eng._gen.manual_seed(11)
    for _ in range(20):
        want = torch.multinomial(torch.softmax(logits / 0.7, dim=-1), 1, generator=gen)[:, 0]
        assert torch.equal(eng._sample_device(logits), want.to(torch.int32))


def test_captured_forward_needs_the_card():
    params = resnet.init_params(18, 0, "cpu", num_classes=10)
    with pytest.raises(ValueError, match="card"):
        resnet.capture_forward_int8(18, params, (28, 28, 3))
