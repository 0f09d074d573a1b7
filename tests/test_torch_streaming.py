"""The port's weight streaming (``core/streaming.py``, serving's planners)
against the JAX package's, exactly, and the streaming executor driving the
port's ``int8_gemm`` (its plain version, on CPU tensors).

Mirrors ``tests/test_streaming.py``: the executor's tiled GEMM against
``repro.kernels.ref.int8_gemm_ref`` on the same int8 operands, bit for
bit; fetches in the plan's issue order; residency within the capacity.
Then ``gemm_sequence_tiles``, ``plan_streaming``, ``model_gemms`` and the
``plan_model_streaming`` summaries of olmo-1b, mixtral-8x7b, mamba2-780m
and internvl2-26b, and ``plan_partitioned_streaming``, each ``==`` to the
JAX package's; and ``runtime.resnet_streaming``, the ResNet forward's
GEMMs streamed through the executor, equal to the resident calls.
"""
import dataclasses
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.core import pu as jpu
from repro.core import streaming as jstreaming
from repro.kernels import ref as jref
from repro.plan import plan as jplan_tiles
from repro.runtime import serving as jserving

from repro_torch.analysis import sanitize
from repro_torch.configs import get_config
from repro_torch.core import pu as tpu
from repro_torch.core import streaming as tstreaming
from repro_torch.core.streaming import StageStreamCore, StreamingExecutor, StreamingPlan, WeightTile
from repro_torch.models import resnet
from repro_torch.plan import plan as tplan_tiles
from repro_torch.runtime import resnet_streaming as rs
from repro_torch.runtime import serving as tserving

kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")

TINY = dict(name="tiny", r_sa=4, c_sa=4, fast_clock_hz=1e6, fast_mem_bytes=512,
            weight_bw_bytes_per_s=1e6, act_bw_bytes_per_s=1e6)
ARCHS = ["olmo-1b", "mixtral-8x7b", "mamba2-780m", "internvl2-26b"]


def np_i8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


def jax_gemm(w, x, shift):
    return np.asarray(jref.int8_gemm_ref(jnp.asarray(w), jnp.asarray(x), shift=shift))


def port_gemm(w, x, shift):
    return kgemm.int8_gemm(torch.from_numpy(np.ascontiguousarray(w)), torch.from_numpy(x),
                           shift=shift).numpy()


# ------------------------------------------------- executor, as the JAX tests --


def test_gemm_sequence_tiles_match_jax():
    gemms = [("a", 10, 8, 3), ("b", 4, 8, 3), ("c", 129, 7, 2)]
    for t_pu, j_pu in ((tpu.PUConfig(**TINY), jpu.PUConfig(**TINY)), (tpu.PU_2X, jpu.PU_2X),
                       (tpu.tpu_v5e_config(), jpu.tpu_v5e_config())):
        tt = tstreaming.gemm_sequence_tiles(gemms, t_pu)
        jt = jstreaming.gemm_sequence_tiles(gemms, j_pu)
        assert [dataclasses.astuple(t) for t in tt] == [dataclasses.astuple(t) for t in jt]
        assert [dataclasses.astuple(t.cost(t_pu)) for t in tt] == \
            [dataclasses.astuple(t.cost(j_pu)) for t in jt]


def test_executor_streamed_tiles_equal_jax_gemm():
    """Every tile through the port's int8_gemm == the JAX oracle on it; the
    row-tiled GEMM == one big GEMM."""
    rng = np.random.default_rng(0)
    pu = tpu.PUConfig(**TINY)
    gemms = [(f"g{i}", 8, 16, 4) for i in range(6)]
    tiles = tstreaming.gemm_sequence_tiles(gemms, pu)
    plan = tstreaming.plan_streaming(tiles, pu)
    assert plan.schedule.feasible
    weights = {t.name: np_i8(rng, (t.n, t.m)) for t in tiles}
    x = np_i8(rng, (16, 4))
    ex = StreamingExecutor(plan, fetch=lambda name: weights[name])
    outs = ex.run([lambda w: port_gemm(w, x, 8) for _ in tiles])
    assert ex.peak_resident_bytes <= pu.fast_mem_bytes
    assert ex.fetches == [name for name, _ in plan.prefetch_order()]
    for t, o in zip(tiles, outs):
        np.testing.assert_array_equal(o, jax_gemm(weights[t.name], x, 8))
    # one matrix, row-tiled, against the whole GEMM
    n, m, p = 16, 32, 8
    w, x = np_i8(rng, (n, m)), np_i8(rng, (m, p))
    big = tpu.PUConfig(**{**TINY, "fast_mem_bytes": 4096})
    tiles = tstreaming.gemm_sequence_tiles([("w", n, m, p)], big)
    plan = tstreaming.plan_streaming(tiles, big)
    ex = StreamingExecutor(plan, fetch=lambda name: w[int(name.split("rows")[1]):][:4])
    got = np.concatenate(ex.run([lambda wt: port_gemm(wt, x, 6) for _ in tiles]), axis=0)
    np.testing.assert_array_equal(got, jax_gemm(w, x, 6))


def test_executor_fetches_follow_issue_order_like_jax():
    """tile3's load hides in tile0's window: fetched before tile2's."""
    costs = [(1.0, 6.0, 10), (1.0, 1.0, 10), (1.0, 1.0, 10), (4.0, 1.0, 10)]
    tp = tplan_tiles([tpu.TileCost(*c) for c in costs], capacity=100)
    jp = jplan_tiles([jpu.TileCost(*c) for c in costs], capacity=100)
    assert list(tp.windows) == list(jp.windows) == [-1, 0, 1, 0]
    wtiles = [WeightTile(name=f"t{i}", layer_index=i, n=1, m=1, p=1) for i in range(4)]
    splan = StreamingPlan(tiles=wtiles, plan=tp, pu=tpu.PUConfig(name="x", fast_mem_bytes=100))
    ex = StreamingExecutor(splan, fetch=lambda name: name)
    assert ex.run([lambda w: w for _ in wtiles]) == ["t0", "t1", "t2", "t3"]
    assert ex.fetches == ["t0", "t1", "t3", "t2"] == [n for n, _ in splan.prefetch_order()]


def test_infeasible_plan_raises():
    plan = tstreaming.plan_streaming(
        [WeightTile(name="big", layer_index=0, n=4, m=4096, p=1)], tpu.PUConfig(**TINY))
    assert not plan.schedule.feasible
    with pytest.raises(AssertionError):
        StreamingExecutor(plan, fetch=lambda n: None).run([lambda w: None])


@pytest.mark.parametrize("sanitized", [False, True])
def test_stage_core_blocking_prefetch_worker(sanitized):
    """The blocking mode: a prefetch thread waits on capacity while the
    caller retires tiles in order; under the lock-order recorder no
    violation is recorded."""
    pu = tpu.PUConfig(**TINY)
    tiles = tstreaming.gemm_sequence_tiles([(f"g{i}", 8, 16, 4) for i in range(8)], pu)
    plan = tstreaming.plan_streaming(tiles, pu)
    sanitize.reset_lock_monitor()
    cond = sanitize.instrument_condition("StageStreamCore._cond", active=sanitized)
    core = StageStreamCore(costs=[t.cost(pu).mem_bytes for t in tiles], capacity=pu.fast_mem_bytes,
                           issue_order=plan.issue_order(), fetch=lambda j: j,
                           names=[t.name for t in tiles])
    core._cond = cond
    worker = threading.Thread(target=core.prefetch_all)
    worker.start()
    got = []
    for i in range(len(tiles)):
        got.append(core.acquire(i, timeout=30))
        core.release(i)
    worker.join(30)
    assert got == list(range(len(tiles)))
    assert core.fetches == [tiles[j].name for j in plan.issue_order()]
    assert core.peak_resident_bytes <= pu.fast_mem_bytes
    assert sanitize.lock_violations() == []
    assert isinstance(cond, sanitize._InstrumentedCondition) == sanitized


def test_lock_order_recorder_reports_an_inversion():
    sanitize.reset_lock_monitor()
    a = sanitize.instrument_condition("A", active=True)
    b = sanitize.instrument_condition("B", active=True)
    with a, b:
        pass
    with b, a:
        pass
    (v,) = sanitize.lock_violations()
    assert (v.kind, v.first, v.second) == ("order", "B", "A")
    sanitize.reset_lock_monitor()


# ----------------------------------------------------- LM-scale planning --


def plan_summary(splan):
    s = dict(splan.summary())
    return s, splan.prefetch_order(), splan.issue_order()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gemms_and_streaming_plans_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for tokens in (1, 8, 64):
        assert tserving.model_gemms(cfg, tokens) == jserving.model_gemms(jcfg, tokens)
    for t_pu, j_pu in ((tpu.host_offload_config(), jpu.host_offload_config()),
                       (tpu.tpu_v5e_config(), jpu.tpu_v5e_config())):
        for tokens in (8, 16):
            tp = tserving.plan_model_streaming(cfg, t_pu, batch_tokens=tokens)
            jp = jserving.plan_model_streaming(jcfg, j_pu, batch_tokens=tokens)
            assert plan_summary(tp) == plan_summary(jp)
            assert [dataclasses.astuple(t) for t in tp.tiles] == \
                [dataclasses.astuple(t) for t in jp.tiles]
    # the port's own default profile is the card's, not the TPU's
    assert tserving.plan_model_streaming(cfg).pu == tpu.h100_host_offload_config()


def test_plan_search_through_serving_matches_jax():
    cfg, jcfg = get_config("olmo-1b"), jget_config("olmo-1b")
    from repro.plan import SearchConfig as JSearch
    from repro_torch.plan import SearchConfig as TSearch

    small_t = dataclasses.replace(tpu.host_offload_config(), fast_mem_bytes=2 * 10**9)
    small_j = dataclasses.replace(jpu.host_offload_config(), fast_mem_bytes=2 * 10**9)
    for strategy in ("beam", "anneal"):
        tp = tserving.plan_model_streaming(cfg, small_t, 8, TSearch(strategy, seed=1))
        jp = jserving.plan_model_streaming(jcfg, small_j, 8, JSearch(strategy, seed=1))
        assert plan_summary(tp) == plan_summary(jp)


def test_partitioned_streaming_matches_jax():
    cfg, jcfg = get_config("olmo-1b"), jget_config("olmo-1b")
    for k in (2, 3):
        tpus = [tpu.host_offload_config() if i % 2 == 0 else tpu.tpu_v5e_config()
                for i in range(k)]
        jpus = [jpu.host_offload_config() if i % 2 == 0 else jpu.tpu_v5e_config()
                for i in range(k)]
        tp = tserving.plan_partitioned_streaming(cfg, tpus, batch_tokens=8)
        jp = jserving.plan_partitioned_streaming(jcfg, jpus, batch_tokens=8)
        for ts, js in zip(tp.stages, jp.stages):
            assert (ts.layer_start, ts.layer_stop, ts.decode_layers, ts.tile_names,
                    ts.tiles_per_layer, ts.compute_s, ts.handoff_in_bytes, ts.stage_s) == \
                (js.layer_start, js.layer_stop, js.decode_layers, js.tile_names,
                 js.tiles_per_layer, js.compute_s, js.handoff_in_bytes, js.stage_s)
        assert (tp.fps, tp.latency_s) == (jp.fps, jp.latency_s)
    # a family the port does not serve yet fails naming its step
    with pytest.raises(NotImplementedError, match="step 12"):
        tserving.plan_partitioned_streaming(get_config("mamba2-780m"), tpus, batch_tokens=8)


# ---------------------------------------- the ResNet forward, streamed ---


def geometry_conv_mode(x, w4d, k, stride, pad):
    """The conv mode by geometry alone (on the card the main path also
    asks for a CUDA map), so the CPU drives both kinds of call."""
    return kgemm.conv_mode(x.shape[-1], w4d.shape[-1], k, stride, pad)


@pytest.mark.parametrize("variant", [18, 50])
def test_resnet_forward_streamed_equals_resident(variant):
    params = resnet.init_params(variant, 0, "cpu")
    img = torch.from_numpy(np.random.default_rng(0).integers(-100, 100, (32, 32, 3), dtype=np.int8))
    calls = rs.forward_calls(variant, params, img, conv_mode=geometry_conv_mode)
    n_convs = len(resnet.resnet_conv_specs(variant))
    assert len(calls) == n_convs + 1 and calls[-1].name == "fc"
    assert sum(c.conv_mode for c in calls) == 19       # the 3x3 convs and strided 1x1s
    # the recorded outputs are the forward's own: the trunk ends in the fc's input
    trunk, _ = resnet.trunk_int8_calls(variant, params, img)
    assert torch.equal(calls[-1].a, trunk.reshape(-1, trunk.shape[-1]))
    for c in calls:
        assert torch.equal(c.resident(), c.out), c.name
    for pu in (tpu.PU_2X, tpu.PU_1X):
        run = rs.stream_calls(calls, pu)
        for c, o in zip(calls, run.outputs):
            assert torch.equal(o, c.out), c.name
        assert run.executor.peak_resident_bytes <= pu.fast_mem_bytes
        assert run.arena_high_water <= pu.fast_mem_bytes
        assert run.executor.fetches == [name for name, _ in run.plan.prefetch_order()]
        assert len(run.executor.fetches) == len(rs.call_tiles(calls, pu))
        assert run.bytes_streamed == sum(c.w.numel() for c in calls)


def test_resnet50_tiles_against_the_simulator():
    """At 224x224 the forward's tiles are the simulator's but for conv1's
    padding, the avgpool layer, the fc over the map and the order of each
    block's downsample conv."""
    params = resnet.init_params(50, 0, "cpu")
    img = torch.zeros((224, 224, 3), dtype=torch.int8)
    calls = rs.forward_calls(50, params, img)
    lines = rs.simulator_differences(calls, 50, tpu.PU_2X)
    assert lines[0] == "431 tiles in 54 calls; the simulator 463 tiles in 55 layers"
    assert any(l.startswith("avgpool (N=2048, M=49, P=1, 32 tiles)") for l in lines)
    assert "conv1: (N, M, P) (64, 147, 12544) here, (64, 160, 12544) in the simulator" in lines
    assert "fc: (N, M, P) (1000, 2048, 49) here, (1000, 2048, 1) in the simulator" in lines
    assert lines[-1].startswith("order:") and len(lines) == 5


def test_tile_arena_first_fit_and_coalescing():
    arena = rs.TileArena(256, torch.device("cpu"))
    a, b, c = arena.alloc(64), arena.alloc(60), arena.alloc(64)
    assert (a, b, c) == (0, 64, 128)
    arena.free(b, 60)
    assert arena.free_blocks == [(64, 64), (192, 64)]
    with pytest.raises(RuntimeError):       # 112 bytes are free, but not in one piece
        arena.alloc(100)
    assert arena.alloc(48) == 64
    arena.free(64, 48)
    arena.free(a, 64)
    arena.free(c, 64)
    assert arena.free_blocks == [(0, 256)] and arena.high_water == 192
    with pytest.raises(RuntimeError):
        arena.alloc(257)
