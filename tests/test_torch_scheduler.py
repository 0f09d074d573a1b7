"""The port's scheduler, PU cost model, simulator and WRB model against
the JAX package's, exactly.

``core/scheduler.py`` (``simulate``, the baseline and adaptive schedules,
``two_phase`` and the ``reference_*`` oracles), ``core/pu.py`` (the FPGA
and TPU profiles the reference plans with), ``core/simulator.py`` (per
layer, per model, partitioned, the Table I fleet) and ``core/wrb.py``,
each called with the same inputs in the port and in the JAX package and
compared with ``==``.  Tile lists come from ``np.random.default_rng``; no
hypothesis.  The H100 profiles, which the JAX package lacks, are held to
the data sheet.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pu as jpu
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro.core import wrb as jwrb

from repro_torch.core import pu as tpu
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core import wrb as twrb

SEEDS = tuple(range(6))


def draw_tiles(seed, count=20):
    """(tiles, cap) cases: 1-40 tiles, times 0.01-10 (half of the lists
    from dyadic values, for ties), 1-50 bytes, capacity 50-200."""
    rng = np.random.default_rng(5000 + seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(1, 41))
        if rng.random() < 0.5:
            load, exe = rng.uniform(0.01, 10, n), rng.uniform(0.01, 10, n)
        else:
            vals = (0.01, 0.125, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0)
            load, exe = rng.choice(vals, n), rng.choice(vals, n)
        mem = rng.integers(1, 51, n)
        out.append(([(float(l), float(e), int(m)) for l, e, m in zip(load, exe, mem)],
                    int(rng.integers(50, 201))))
    return out


def both(tiles):
    return ([jpu.TileCost(*t) for t in tiles], [tpu.TileCost(*t) for t in tiles])


def sched_facts(s):
    d = dataclasses.asdict(s)
    if s.feasible and s.tiles:
        d.update(total_stall=s.total_stall, makespan=s.makespan, busy=s.busy_time,
                 util=s.utilization, peak=s.peak_memory(), trace=s.memory_trace())
    return d


def two_phase_facts(r):
    return dict(baseline=sched_facts(r.baseline), adaptive=sched_facts(r.adaptive),
                reduction=r.stall_reduction, time_ratios=r.time_ratios(),
                memory_ratios=r.memory_ratios())


@pytest.mark.parametrize("seed", SEEDS)
def test_two_phase_and_reference_match_jax(seed):
    for tiles, cap in draw_tiles(seed):
        jt, tt = both(tiles)
        for exhaustive in (False, True):
            assert two_phase_facts(tsched.two_phase(tt, cap, exhaustive=exhaustive)) == \
                two_phase_facts(jsched.two_phase(jt, cap, exhaustive=exhaustive))
        assert two_phase_facts(tsched.reference_two_phase(tt, cap)) == \
            two_phase_facts(jsched.reference_two_phase(jt, cap))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_single_phase_entry_points_match_jax(seed):
    for tiles, cap in draw_tiles(seed):
        jt, tt = both(tiles)
        for preload in (True, False):
            assert sched_facts(tsched.baseline_schedule(tt, cap, preload)) == \
                sched_facts(jsched.baseline_schedule(jt, cap, preload))
            assert sched_facts(tsched.adaptive_schedule(tt, cap, preload)) == \
                sched_facts(jsched.adaptive_schedule(jt, cap, preload))
            assert sched_facts(tsched.reference_adaptive_schedule(tt, cap, preload)) == \
                sched_facts(jsched.reference_adaptive_schedule(jt, cap, preload))


def test_scheduler_edge_cases_match_jax():
    cases = [
        ([], 10),
        ([(1.0, 0.0, 5)], 10),                       # zero exec
        ([(1.0, 2.0, 10), (3.0, 1.0, 10)], 20),      # capacity exact
        ([(1.0, 1.0, 11)], 10),                      # tile over capacity
        ([(5.0, 0.5, 10)] * 12, 1000),               # load bound
        ([(0.5, 8.0, 10), (0.5, 2.0, 10), (3.0, 2.0, 10)], 1000),
        ([(1.0, 6.0, 10), (1.0, 1.0, 10), (4.0, 1.0, 10)], 100),   # the quickstart's
    ]
    for tiles, cap in cases:
        jt, tt = both(tiles)
        assert two_phase_facts(tsched.two_phase(tt, cap)) == two_phase_facts(jsched.two_phase(jt, cap))


# ---------------------------------------------------------- PU profiles --


def test_reference_profiles_equal_jax():
    for name in ("PU_1X", "PU_2X"):
        assert dataclasses.asdict(getattr(tpu, name)) == dataclasses.asdict(getattr(jpu, name))
    assert dataclasses.asdict(tpu.tpu_v5e_config()) == dataclasses.asdict(jpu.tpu_v5e_config())
    assert dataclasses.asdict(tpu.host_offload_config()) == \
        dataclasses.asdict(jpu.host_offload_config())
    for t, j in ((tpu.PU_2X, jpu.PU_2X), (tpu.PU_1X, jpu.PU_1X),
                 (tpu.tpu_v5e_config(), jpu.tpu_v5e_config())):
        assert t.peak_ops_per_s == j.peak_ops_per_s
        for n, m, p in ((64, 147, 12544), (1000, 2048, 1), (17, 9, 3), (4096, 4096, 64)):
            assert [dataclasses.astuple(x) for x in t.gemm_tiles(n, m, p)] == \
                [dataclasses.astuple(x) for x in j.gemm_tiles(n, m, p)]
            assert t.tile_bytes(m, n) == j.tile_bytes(m, n)


def test_h100_profiles_hold_the_data_sheet():
    smem = tpu.h100_config()
    host = tpu.h100_host_offload_config()
    assert smem.peak_ops_per_s == pytest.approx(989e12, rel=1e-12)
    assert host.peak_ops_per_s == pytest.approx(989e12, rel=1e-12)
    assert smem.weight_bw_bytes_per_s == 3.35e12 and smem.fast_mem_bytes == 132 * 228 * 1024
    assert host.weight_bw_bytes_per_s == 64e9 and host.fast_mem_bytes == 80 * 10**9
    assert (smem.r_sa, smem.c_sa) == (128, 64)     # the decode GEMV's block tile
    assert "tpu" not in smem.name and "tpu" not in host.name


# ------------------------------------------------------------ simulator --


def model_sim_facts(s):
    plan = s.plan.to_json_dict()
    plan.pop("plan_wall_s")
    return dict(layers=[dataclasses.asdict(l) for l in s.layers], pu=dataclasses.asdict(s.pu),
                schedule=two_phase_facts(s.schedule), plan=plan,
                frame_s=(s.frame_s_resident, s.frame_s_scheduled),
                fps=(s.fps_resident, s.fps_scheduled), macs=s.total_macs, eff=s.efficiency)


@pytest.mark.parametrize("variant", [18, 50])
def test_simulator_matches_jax(variant):
    jl, tl = jsim.resnet_gemm_layers(variant), tsim.resnet_gemm_layers(variant)
    assert [dataclasses.astuple(l) for l in tl] == [dataclasses.astuple(l) for l in jl]
    for jp, tp in ((jpu.PU_1X, tpu.PU_1X), (jpu.PU_2X, tpu.PU_2X)):
        for a, b in zip(jl, tl):
            ja, tb = jsim.simulate_layer(jp, a), tsim.simulate_layer(tp, b)
            assert dataclasses.astuple(tb)[1:] == dataclasses.astuple(ja)[1:]
        for mode in ("two_phase", "baseline", "resident"):
            assert model_sim_facts(tsim.simulate_model(tp, tl, schedule_mode=mode)) == \
                model_sim_facts(jsim.simulate_model(jp, jl, schedule_mode=mode))


@pytest.mark.parametrize("variant, fps, fps_per_tops", [(18, 1260.91, 273.64),
                                                         (50, 558.84, 121.28)])
def test_table1_fleet_matches_jax(variant, fps, fps_per_tops):
    """The simulated Table I row (5x PU_1x + 5x PU_2x), and a fleet with a
    partitioned pipeline beside the replicated PUs."""
    jl, tl = jsim.resnet_gemm_layers(variant), tsim.resnet_gemm_layers(variant)
    jf = jsim.FleetSim(sims=[("pu1x", jsim.simulate_model(jpu.PU_1X, jl), 5),
                             ("pu2x", jsim.simulate_model(jpu.PU_2X, jl), 5)])
    tf = tsim.FleetSim(sims=[("pu1x", tsim.simulate_model(tpu.PU_1X, tl), 5),
                             ("pu2x", tsim.simulate_model(tpu.PU_2X, tl), 5)])
    assert (tf.fps, tf.tops, tf.fps_per_tops) == (jf.fps, jf.tops, jf.fps_per_tops)
    assert (round(tf.fps, 2), round(tf.fps_per_tops, 2)) == (fps, fps_per_tops)
    jf.pipelines.append(("k2", jsim.simulate_partitioned([jpu.PU_1X, jpu.PU_2X], jl), 1))
    tf.pipelines.append(("k2", tsim.simulate_partitioned([tpu.PU_1X, tpu.PU_2X], tl), 1))
    assert (tf.fps, tf.tops, tf.fps_per_tops) == (jf.fps, jf.tops, jf.fps_per_tops)


# ------------------------------------------------------------------ WRB --


def test_wrb_matches_jax():
    for cap in (1, 2, 4, 8):
        for r_sa, r_g in ((64, 8), (64, 16), (32, 8)):
            jc = jwrb.WRBConfig(capacity_waves=cap, r_sa=r_sa, r_g=r_g)
            tc = twrb.WRBConfig(capacity_waves=cap, r_sa=r_sa, r_g=r_g)
            for n_waves in (0, 1, 17, 128):
                for interval in (1, 2, 4, 8, 16):
                    assert dataclasses.asdict(twrb.simulate_wrb(tc, n_waves, interval)) == \
                        dataclasses.asdict(jwrb.simulate_wrb(jc, n_waves, interval))
                    for oo in (False, True) if n_waves else ():
                        assert dataclasses.asdict(twrb._simulate(tc, n_waves, interval, oo)) == \
                            dataclasses.asdict(jwrb._simulate(jc, n_waves, interval, oo))
            assert [dataclasses.asdict(s) for s in twrb.ooo_benefit(tc, 64, 2)] == \
                [dataclasses.asdict(s) for s in jwrb.ooo_benefit(jc, 64, 2)]
