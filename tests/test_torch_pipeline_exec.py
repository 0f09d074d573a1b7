"""The port's stage-parallel runtime against the JAX package's.

``runtime/pipeline_exec.py`` (the executor, its sessions and reports),
``runtime/autotune.py``, ``FleetSim.execute_pipelines``, serving's
``execute_partition`` and the sanitizer's ``instrument_lock`` /
``require_held``, each run on the same plans in the port and in the JAX
package: the fetch orders and the virtual fields of a report (which the
executed event stream derives from the plan, so they do not depend on
thread timing) are compared with ``==``.  Wall times and the tuned queue
depth, which do, are not.  Then ``launch.mesh.stage_devices`` and
``runtime.resnet_streaming.stream_partitioned`` (ResNet-18 at 28x28 over
PU_1x and PU_2x, each call of each image bit for bit against its
resident run).
"""
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import sanitize as jsanitize  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core import pu as jpu  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.plan import partition_layers as jpartition_layers  # noqa: E402
from repro.runtime import autotune as jautotune  # noqa: E402
from repro.runtime import pipeline_exec as jexec  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu as tpu  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.streaming import gemm_sequence_tiles, plan_streaming  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch.mesh import stage_devices  # noqa: E402
from repro_torch.models import resnet, transformer  # noqa: E402
from repro_torch.plan import partition_gemms, partition_layers  # noqa: E402
from repro_torch.runtime import autotune, pipeline_exec  # noqa: E402
from repro_torch.runtime import resnet_streaming as rs  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops on one intra-op thread: the default (one a core)
    oversubscribes the cores when test processes run side by side, and
    the stage threads each start a team of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the fields of a PipelineReport / StageTrace that the virtual clock sets
REPORT_FIELDS = ("n_stages", "n_microbatches", "frame_done_t", "makespan_s", "measured_fps",
                 "predicted_makespan_s", "predicted_fps", "steady_fps", "bubble_measured",
                 "bubble_predicted")
TRACE_FIELDS = ("stage", "pu", "frames", "fetches", "peak_resident_bytes", "busy_s", "stall_s",
                "handoff_s", "starve_s", "first_start_t", "last_end_t", "fetch_orders")


def virtual(rep):
    return ({f: getattr(rep, f) for f in REPORT_FIELDS},
            [{f: getattr(t, f) for f in TRACE_FIELDS} for t in rep.stages])


def k2(variant):
    """The ResNet partition over the paper's two PUs, in both packages."""
    return (jsim.simulate_partitioned([jpu.PU_1X, jpu.PU_2X], jsim.resnet_gemm_layers(variant)),
            tsim.simulate_partitioned([tpu.PU_1X, tpu.PU_2X], tsim.resnet_gemm_layers(variant)))


# ------------------------------------------------------------ executor ---


@pytest.mark.parametrize("variant", [18, 50])
def test_resnet_k2_report_matches_reference(variant):
    """Fetch orders per stage and every virtual field of the report, at
    K = 2 over PU_1x / PU_2x, equal the reference's."""
    jplan, tplan = k2(variant)
    for m in (1, 8):
        want = jexec.execute_partitioned_plan(jplan, m, record_fetch_orders=True)
        got = pipeline_exec.execute_partitioned_plan(tplan, m, record_fetch_orders=True)
        assert virtual(got) == virtual(want)
        assert got.outputs == list(range(m)) and not got.real_stage_compute
        for k, st in enumerate(tplan.stages):
            assert got.stages[k].fetch_orders == [[st.tile_names[i] for i in st.plan.issue_order()]] * m
            assert got.stages[k].peak_resident_bytes <= st.pu.fast_mem_bytes
        assert got.summary().keys() == want.summary().keys()
    assert got.max_concurrent_stages == 2          # the stages overlapped


def _chain(n_layers, n_pus, port=True):
    """One tile per layer, every layer 1 s, loads 0.1 s (as the
    reference's tests build it)."""
    pu = (tpu if port else jpu).PUConfig(
        name="big", r_sa=8, c_sa=8, fast_clock_hz=1e6, fast_mem_bytes=1 << 24,
        weight_bw_bytes_per_s=1e9, act_bw_bytes_per_s=1e9)
    cost = (tpu if port else jpu).TileCost
    return (partition_layers if port else jpartition_layers)(
        list(range(n_layers)), [pu] * n_pus,
        latency_s=lambda p, l: 1.0, tiles_of=lambda p, l: [cost(load_s=0.1, exec_s=1.0, mem_bytes=64)],
        name_of=lambda l: f"l{l}", act_bytes_of=lambda l: 16, use_cache=False)


def test_outputs_keep_order_and_stage_compute_matches_a_sequential_scan():
    rep = pipeline_exec.execute_partitioned_plan(
        _chain(6, 3), n_microbatches=5, payloads=["a", "b", "c", "d", "e"])
    assert rep.outputs == ["a", "b", "c", "d", "e"]
    assert all(t1 < t2 for t1, t2 in zip(rep.frame_done_t, rep.frame_done_t[1:]))
    want = jexec.execute_partitioned_plan(_chain(6, 3, port=False), n_microbatches=5)
    assert virtual(rep)[0]["frame_done_t"] == want.frame_done_t
    # real per-stage compute: the threaded pipeline folds the same layers
    rng = np.random.default_rng(0)
    ws = [rng.normal(size=(8, 8)) * 0.3 for _ in range(8)]
    plan = _chain(8, 2)
    ex = pipeline_exec.StagePipelineExecutor(
        plan, fetch=lambda k, i, name: ws[plan.stages[k].layer_start + i],
        run_tile=lambda k, i, w, x: np.tanh(x @ w),
        run_stage=lambda k, x: x + k, stage_devices=[torch.device("cpu")] * 2)
    x = rng.normal(size=(8, 8))
    rep = ex.run(np.split(x, 4))
    ref = x
    for k in range(2):
        for w in ws[4 * k:4 * k + 4]:
            ref = np.tanh(ref @ w)
        ref = ref + k
    np.testing.assert_allclose(np.concatenate(rep.outputs), ref, atol=1e-12)
    assert rep.real_stage_compute and ex.streams == [None, None]


def test_run_tile_error_propagates_and_the_session_closes():
    def bad(k, i, w, carry):
        if k == 1 and i == 1:
            raise RuntimeError("boom")
        return carry

    ex = pipeline_exec.StagePipelineExecutor(_chain(4, 2), run_tile=bad)
    with pytest.raises(RuntimeError, match="boom"):
        ex.run(list(range(3)))
    session = ex.open_session()
    session.put(0)
    with pytest.raises(RuntimeError, match="boom"):
        session.get(timeout=30)
    session.abort()
    assert all(not t.is_alive() for t in session.threads)
    with pytest.raises(ValueError, match="closed"):
        session.put(1)


def test_single_stage_stall_matches_the_streaming_executor():
    """A one-stage partition is the single-PU path: its stall per frame
    is the single-PU plan's, it never starves and has no bubble."""
    gemms = [(f"g{i}", 8, 16, 4) for i in range(6)]
    pu = tpu.PUConfig(name="tiny", r_sa=4, c_sa=4, fast_clock_hz=1e6, fast_mem_bytes=512,
                      weight_bw_bytes_per_s=1e6, act_bw_bytes_per_s=1e6)
    single = plan_streaming(gemm_sequence_tiles(gemms, pu), pu)
    plan = partition_gemms(gemms, [pu])
    rep = pipeline_exec.execute_partitioned_plan(plan, n_microbatches=3)
    assert rep.stages[0].stall_s / 3 == pytest.approx(single.plan.total_stall)
    assert rep.stages[0].starve_s == 0.0 and rep.bubble_measured == pytest.approx(0.0, abs=1e-9)


def test_prefetch_follows_the_relocated_issue_order():
    costs = [(1.0, 6.0), (1.0, 1.0), (1.0, 1.0), (4.0, 1.0)]
    plan = partition_layers(
        list(range(4)), [tpu.PUConfig(name="t", fast_mem_bytes=100)],
        latency_s=lambda p, l: 1.0,
        tiles_of=lambda p, l: [tpu.TileCost(load_s=costs[l][0], exec_s=costs[l][1], mem_bytes=10)],
        name_of=lambda l: f"l{l}", use_cache=False)
    rep = pipeline_exec.execute_partitioned_plan(plan, 3, record_fetch_orders=True)
    assert rep.stages[0].fetch_orders == [["l0/t0", "l1/t0", "l3/t0", "l2/t0"]] * 3


def test_place_moves_nested_tensors_only():
    t = torch.ones(3)
    out = pipeline_exec.place({"a": (t, 2), "b": [t]}, torch.device("cpu"), None)
    assert out["a"][0] is t and out["a"][1] == 2 and out["b"][0] is t


# ---------------------------------------------------------- tuning, fleet --


def test_analytic_microbatches_match_reference():
    for k in (1, 2, 3, 4, 6):
        for target in (0.05, 0.1, 0.25, 0.5, 1.0):
            assert autotune.analytic_microbatches(k, target) == \
                jautotune.analytic_microbatches(k, target)
    with pytest.raises(ValueError):
        autotune.analytic_microbatches(2, 0.0)


@pytest.mark.parametrize("variant, target", [(50, 0.10), (50, 0.25), (18, 0.08)])
def test_tune_pipeline_matches_reference(variant, target):
    jplan, tplan = k2(variant)
    want = jautotune.tune_pipeline(jplan, jautotune.AutotuneConfig(target_bubble=target))
    got = autotune.tune_pipeline(tplan, autotune.AutotuneConfig(target_bubble=target))
    facts = lambda r: (r.n_microbatches, r.analytic_m, r.within_tolerance,   # noqa: E731
                       [(t["m"], t["bubble"], t["fps"]) for t in r.trials])
    assert facts(got) == facts(want)
    assert got.queue_depth in (2, 3, 4) and len(got.depth_trials) == 3


def _decode_plans(k):
    jcfg = jsmoke(jget_config("olmo-1b"))
    cfg = smoke_variant(get_config("olmo-1b"))
    jpus = [jpu.host_offload_config() if i % 2 == 0 else jpu.tpu_v5e_config() for i in range(k)]
    tpus = [tpu.host_offload_config() if i % 2 == 0 else tpu.tpu_v5e_config() for i in range(k)]
    from repro_torch.runtime.serving import plan_partitioned_streaming

    return (jserving.plan_partitioned_streaming(jcfg, jpus, batch_tokens=4),
            plan_partitioned_streaming(cfg, tpus, batch_tokens=4))


@pytest.mark.parametrize("k, lanes", [(2, 4), (3, 8)])
def test_tune_staged_decode_matches_reference(k, lanes):
    """M is chosen on the virtual bubble of functional probe blocks: the
    same M and the same trials as the reference (the knee rule on this
    imbalance-dominated smoke plan)."""
    jplan, tplan = _decode_plans(k)
    want = jautotune.tune_staged_decode(jplan, lanes, jautotune.AutotuneConfig(target_bubble=0.1))
    got = autotune.tune_staged_decode(tplan, lanes, autotune.AutotuneConfig(target_bubble=0.1))
    facts = lambda r: (r.n_groups, r.lanes, r.within_tolerance,   # noqa: E731
                       [(t["m"], t["bubble"], t["fps"]) for t in r.trials])
    assert facts(got) == facts(want)
    assert virtual(got.report)[0]["bubble_measured"] == got.bubble_measured


def test_fleet_execute_pipelines_matches_reference():
    for variant in (18, 50):
        jplan, tplan = k2(variant)
        want = jsim.FleetSim(pipelines=[("k2", jplan, 1)]).execute_pipelines(8)
        got = tsim.FleetSim(pipelines=[("k2", tplan, 1)]).execute_pipelines(8)
        assert got.keys() == want.keys() == {"k2"}
        for rec in (got["k2"], want["k2"]):
            assert rec.pop("wall_s") > 0
        assert got == want
        assert got["k2"]["measured_fps"] == pytest.approx(got["k2"]["predicted_fps"])


def test_execute_partition_stats_match_reference():
    """``execute_partition`` pinned and auto-tuned: the ``partition_*``
    stats equal the JAX engine's but for the wall time and the queue
    depth chosen on it."""
    jcfg = jsmoke(jget_config("olmo-1b"))
    cfg = smoke_variant(get_config("olmo-1b"))
    jpus = [jpu.host_offload_config(), jpu.tpu_v5e_config()]
    tpus = [tpu.host_offload_config(), tpu.tpu_v5e_config()]
    sc = dict(max_batch=2, max_len=64, max_new_tokens=4, seed=0, stage_decode=False,
              target_bubble=0.15)
    import jax

    from repro.models import api as japi

    jeng = jserving.ServingEngine(jcfg, japi.get_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0)),
                                  jserving.ServeConfig(stream_pus=jpus, **sc))
    teng = ServingEngine(cfg, transformer.init_params(cfg, 0, "cpu"),
                         ServeConfig(stream_pus=tpus, **sc), "cpu")
    assert teng._staged is None and "stage_decode" not in teng.stats()
    with pytest.raises(ValueError):
        ServingEngine(cfg, teng.params, ServeConfig(stream_pus=tpus[:1], **sc), "cpu").execute_partition()
    wall = ("partition_executed_wall_s", "partition_autotuned_queue_depth")
    for m in (4, None):
        for eng in (jeng, teng):
            eng.execute_partition(n_microbatches=m)
        want = {k: v for k, v in jeng.stats().items() if k.startswith("partition_") and k not in wall}
        got = {k: v for k, v in teng.stats().items() if k.startswith("partition_") and k not in wall}
        assert got == want and len(got) == (10 if m else 14)
    assert got["partition_autotune_within_tolerance"] == 0.0      # the imbalance floor


# ----------------------------------------------------------- sanitizer ---


@pytest.mark.parametrize("active", [False, True])
def test_instrument_lock_and_require_held_match_reference(monkeypatch, active):
    monkeypatch.setenv("REPRO_SANITIZE", "1" if active else "0")
    verdicts = []
    for mod in (sanitize, jsanitize):
        mod.reset_lock_monitor()
        a, b = mod.instrument_lock("A"), mod.instrument_lock("B")
        assert isinstance(a, type(threading.Lock())) != active
        with a:
            mod.require_held(a, site="held")
            with b:
                pass
        mod.require_held(a, site="not held")
        with b:
            with a:                          # B then A, after A then B
                pass
        cond = mod.instrument_condition("C")
        with cond:
            cond.notify_all()
        verdicts.append([(v.kind, v.first, v.second, v.site if v.kind == "unguarded" else "")
                         for v in mod.lock_violations()])
        mod.reset_lock_monitor()
    assert verdicts[0] == verdicts[1]
    assert verdicts[0] == ([("unguarded", "A", "", "not held"), ("order", "B", "A", "")]
                           if active else [])


def test_executor_lock_is_instrumented_under_the_sanitizer(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    sanitize.reset_lock_monitor()
    ex = pipeline_exec.StagePipelineExecutor(_chain(4, 2))
    assert ex._active_lock.name == "StagePipelineExecutor._active_lock"
    ex.run(list(range(4)))
    assert sanitize.lock_violations() == []
    sanitize.reset_lock_monitor()


# -------------------------------------------------------- stage devices ---


def test_stage_devices_split_or_share():
    cards = [torch.device("cuda", i) for i in range(4)]
    assert stage_devices(2, cards) == ([cards[:2], cards[2:]], False)
    assert stage_devices(4, cards) == ([[c] for c in cards], False)
    assert stage_devices(3, cards) == ([cards] * 3, True)
    assert stage_devices(2, cards[:1]) == ([cards[:1]] * 2, True)
    assert stage_devices(1, cards[:1]) == ([cards[:1]], False)
    with pytest.raises(ValueError):
        stage_devices(2, [])


# ------------------------------------------------- ResNet, partitioned ---


def geometry_conv_mode(x, w4d, k, stride, pad):
    """The conv mode by geometry alone, so the CPU drives both kinds of call."""
    return kgemm.conv_mode(x.shape[-1], w4d.shape[-1], k, stride, pad)


def test_stream_partitioned_resnet18_bit_for_bit():
    params = resnet.init_params(18, 0, "cpu")
    calls = [rs.forward_calls(18, params, torch.from_numpy(
        np.random.default_rng(m).integers(-100, 100, (28, 28, 3), dtype=np.int8)),
        conv_mode=geometry_conv_mode) for m in range(3)]
    pus = [tpu.PU_1X, tpu.PU_2X]
    common.reset_launches()
    run = rs.stream_partitioned(calls, pus)
    assert common.launch_counts()["int8_gemm"] == 0          # the CPU ran the plain version
    for per_image, outs in zip(calls, run.outputs):
        for c, o in zip(per_image, outs):
            assert torch.equal(o, c.out), c.name
    plan = run.plan
    assert [s.pu.name for s in plan.stages] == ["pu1x", "pu2x"]
    assert plan.stages[0].layer_start == 0 and plan.stages[-1].layer_stop == len(calls[0])
    want = jsim.simulate_partitioned([jpu.PU_1X, jpu.PU_2X], [
        jsim.GemmLayer(c.name, c.n, c.m, c.p, residual=c.residual is not None) for c in calls[0]])
    assert [(s.layer_start, s.layer_stop, s.tile_names) for s in plan.stages] == \
        [(s.layer_start, s.layer_stop, s.tile_names) for s in want.stages]
    rep = run.report
    assert rep.outputs == [0, 1, 2] and rep.n_microbatches == 3
    for k, st in enumerate(plan.stages):
        assert rep.stages[k].fetch_orders == [[st.tile_names[i] for i in st.plan.issue_order()]] * 3
        assert rep.stages[k].peak_resident_bytes <= st.pu.fast_mem_bytes
        assert run.arena_high_water[k] <= st.pu.fast_mem_bytes
    assert run.bytes_streamed == 3 * sum(c.w.numel() for c in calls[0])
    assert rep.bubble_predicted == 1 / 4 and rep.max_concurrent_stages >= 1
