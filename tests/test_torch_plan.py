"""The port's planner (``repro_torch.plan``) against the JAX package's
(``repro.plan``), exactly.

Every comparison is ``==`` on floats: windows, every ``Timeline`` array,
``total_stall``, ``to_json_dict()`` (its ``plan_wall_s``, a wall-clock
reading, left out), the summaries, residency and issue order.  The inputs
are fixed: 200 tile lists drawn from ``np.random.default_rng(seed)`` (1-40
tiles, load and exec times in the range of ``tests/test_plan.py``'s
strategies, half of the lists from a few dyadic values so that ties and
exact concealments occur), ResNet-18/50 on PU_1x/PU_2x, and the two inputs
of ROADMAP queue 3 on which the JAX planner disagrees with its own
reference: the port reproduces both.  No hypothesis: nothing is drawn
afresh and nothing is saved between runs.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import plan as jplan
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro.core.pu import PU_1X as J_PU_1X, PU_2X as J_PU_2X, TileCost as JTile
from repro.plan import cache as jcache
from repro.plan.engine import PlanEngine as JEngine

from repro_torch import plan as tplan
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core.pu import PU_1X, PU_2X, TileCost
from repro_torch.plan import cache as tcache
from repro_torch.plan.engine import PlanEngine

DYADIC = (0.01, 0.0625, 0.125, 0.25, 0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 10.0)
SEEDS = tuple(range(10))         # 10 seeds x 20 lists = 200 tile lists
PER_SEED = 20


def draw_cases(seed, cap_range=(50, 200)):
    """``PER_SEED`` (tiles, cap, exhaustive, windows) cases from ``seed``;
    ``windows`` is a random window assignment (``-1 .. j-1`` for tile j)."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(PER_SEED):
        n = int(rng.integers(1, 41))
        if rng.random() < 0.5:
            load, exe = rng.uniform(0.01, 10, n), rng.uniform(0.01, 10, n)
        else:
            load, exe = rng.choice(DYADIC, n), rng.choice(DYADIC, n)
        mem = rng.integers(1, 51, n)
        tiles = [(float(l), float(e), int(m)) for l, e, m in zip(load, exe, mem)]
        cap = int(rng.integers(cap_range[0], cap_range[1] + 1))
        windows = [int(rng.integers(-1, j)) for j in range(n)]
        cases.append((tiles, cap, bool(rng.integers(2)), windows))
    return cases


def both(tiles):
    """The same tile list as the JAX package's and the port's TileCost."""
    return ([JTile(load_s=l, exec_s=e, mem_bytes=m) for l, e, m in tiles],
            [TileCost(load_s=l, exec_s=e, mem_bytes=m) for l, e, m in tiles])


def plan_facts(p):
    """Everything a plan exposes, as plain values (the wall clock left out)."""
    d = p.to_json_dict()
    d.pop("plan_wall_s")
    s = p.summary()
    s.pop("plan_wall_s")
    facts = dict(json=d, summary=s, issue_order=p.issue_order(), relocations=p.relocations())
    if p.feasible:
        for which in ("baseline", "adaptive"):
            t, r = p.residency(which)
            facts[f"residency_{which}"] = (t.tolist(), r.tolist())
            facts[f"peak_{which}"] = p.peak_memory(which)
        facts["stalls"] = p.timeline.stalls().tolist()
    return facts


def schedule_facts(s):
    return dataclasses.asdict(s)


def assert_same_plan(jp, tp):
    assert plan_facts(tp) == plan_facts(jp)
    for which in ("baseline", "adaptive"):
        assert schedule_facts(tp.to_schedule(which)) == schedule_facts(jp.to_schedule(which))


# ------------------------------------------------------------ planner ----


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_matches_jax(seed):
    """``plan`` (the incremental two-phase planner) on 20 tile lists."""
    for tiles, cap, exhaustive, _ in draw_cases(seed):
        jt, tt = both(tiles)
        assert_same_plan(jplan.plan(jt, cap, exhaustive=exhaustive),
                         tplan.plan(tt, cap, exhaustive=exhaustive))


@pytest.mark.parametrize("seed", SEEDS)
def test_bounded_scan_and_no_preload_match_jax(seed):
    """``max_window_scan`` and ``preload_first=False``."""
    for tiles, cap, exhaustive, _ in draw_cases(seed):
        jt, tt = both(tiles)
        assert_same_plan(jplan.plan(jt, cap, max_window_scan=3, exhaustive=exhaustive),
                         tplan.plan(tt, cap, max_window_scan=3, exhaustive=exhaustive))
        assert_same_plan(jplan.plan(jt, cap, preload_first=False),
                         tplan.plan(tt, cap, preload_first=False))


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_simulate_matches_jax_on_random_windows(seed):
    """``PlanEngine.simulate`` on arbitrary window assignments (feasible,
    infeasible and deadlocking ones alike): every array of the state."""
    for tiles, cap, _, windows in draw_cases(seed, cap_range=(30, 150)):
        jt, tt = both(tiles)
        args = ([t.load_s for t in tt], [t.exec_s for t in tt], [t.mem_bytes for t in tt], cap)
        j, t = JEngine(*args).simulate(windows), PlanEngine(*args).simulate(windows)
        for f in ("feasible", "total_stall", "queue", "queue_keys", "qpos_of", "load_start",
                  "load_end", "exec_start", "exec_end", "stall_cum", "snaps"):
            assert getattr(t, f) == getattr(j, f), f
        jt_, tt_ = j.timeline(), t.timeline()
        for f in ("load_start", "load_end", "exec_start", "exec_end"):
            assert getattr(tt_, f).tolist() == getattr(jt_, f).tolist()
        # the reference event simulation, the port's against the JAX one
        assert schedule_facts(tsched.simulate(tt, cap, windows)) == schedule_facts(
            jsched.simulate(jt, cap, windows))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_try_relocation_matches_jax(seed):
    """``PlanEngine.try_relocation``: suffix re-simulation with early abort."""
    rng = np.random.default_rng(1000 + seed)
    for tiles, cap, _, _ in draw_cases(seed):
        if len(tiles) < 3:
            continue
        jt, tt = both(tiles)
        args = ([t.load_s for t in tt], [t.exec_s for t in tt], [t.mem_bytes for t in tt], cap)
        je, te = JEngine(*args), PlanEngine(*args)
        base_w = list(range(-1, len(tiles) - 1))
        jb, tb = je.simulate(base_w), te.simulate(base_w)
        if not jb.feasible:
            continue
        for _ in range(5):
            j = int(rng.integers(2, len(tiles)))
            w = int(rng.integers(-1, j - 1))
            abort = float(jb.total_stall) * float(rng.choice([0.5, 1.0, 2.0]))
            assert te.try_relocation(tb, j, w, abort) == je.try_relocation(jb, j, w, abort)


@pytest.mark.parametrize("strategy", ["beam", "anneal"])
@pytest.mark.parametrize("seed", [0, 3])
def test_search_matches_jax_at_fixed_seeds(strategy, seed):
    """Beam and anneal search (numpy ``default_rng``, so bit for bit)."""
    for tiles, cap, _, _ in draw_cases(100 + seed)[:6]:
        jt, tt = both(tiles)
        jcfg = jplan.SearchConfig(strategy=strategy, seed=seed, anneal_steps=200)
        tcfg = tplan.SearchConfig(strategy=strategy, seed=seed, anneal_steps=200)
        assert tcfg.descriptor() == jcfg.descriptor() and tcfg.key_bytes() == jcfg.key_bytes()
        assert_same_plan(jplan.plan(jt, cap, search=jcfg), tplan.plan(tt, cap, search=tcfg))


def test_search_on_resnet18_under_pressure_matches_jax():
    jt = jsim.model_tiles(J_PU_2X, jsim.resnet_gemm_layers(18))
    tt = tsim.model_tiles(PU_2X, tsim.resnet_gemm_layers(18))
    cap = int(PU_2X.fast_mem_bytes * 0.25)
    for strategy in ("beam", "anneal"):
        jp = jplan.plan(jt, cap, search=jplan.SearchConfig(strategy=strategy, seed=7,
                                                           anneal_steps=300))
        tp = tplan.plan(tt, cap, search=tplan.SearchConfig(strategy=strategy, seed=7,
                                                           anneal_steps=300))
        assert_same_plan(jp, tp)


@pytest.mark.parametrize("variant", [18, 50])
@pytest.mark.parametrize("pu", ["pu1x", "pu2x"])
def test_resnet_plans_match_jax(variant, pu):
    """The paper's workload: ResNet tiles against the URAM, at the PU's
    capacity and at 60 % of it with a bounded scan."""
    jpu, tpu = {"pu1x": (J_PU_1X, PU_1X), "pu2x": (J_PU_2X, PU_2X)}[pu]
    jt = jsim.model_tiles(jpu, jsim.resnet_gemm_layers(variant))
    tt = tsim.model_tiles(tpu, tsim.resnet_gemm_layers(variant))
    assert [dataclasses.astuple(t) for t in tt] == [dataclasses.astuple(t) for t in jt]
    assert_same_plan(jplan.plan(jt, jpu.fast_mem_bytes), tplan.plan(tt, tpu.fast_mem_bytes))
    cap = int(tpu.fast_mem_bytes * 0.6)
    assert_same_plan(jplan.plan(jt, cap, max_window_scan=6),
                     tplan.plan(tt, cap, max_window_scan=6))


# ------------------------------------------------ ROADMAP queue 3 inputs --

# The incremental planner disagrees with ``reference_two_phase``: tile 8's
# load lands in window 6 with the planner, in window 3 with the reference.
QUEUE3_PLANNER = ([(1, 1), (1, 1), (1, 1), (1, 5), (1, 2), (1, 1), (4, 5), (4, 1), (3, 0.5),
                   (3, 1)], 50)
# ``PlanEngine.simulate`` sums the stalls in event order, the reference
# scheduler in tile order: the totals differ in the last bit.
QUEUE3_ENGINE = ([(1, 1), (4, 0.06), (1, 0.125), (1, 0.125), (1, 0.0625), (1, 0.125), (1, 0.5),
                  (1, 0.01), (1, 1)], [-1, 0, 0, 0, 0, 0, 0, 0, 0], 30)


def test_queue3_planner_input_reproduced():
    pairs, cap = QUEUE3_PLANNER
    jt, tt = both([(float(l), float(e), 1) for l, e in pairs])
    jp, tp = jplan.plan(jt, cap), tplan.plan(tt, cap)
    assert_same_plan(jp, tp)
    jref = jsched.reference_two_phase(jt, cap)
    tref = tsched.reference_two_phase(tt, cap)
    for which in ("baseline", "adaptive"):
        assert schedule_facts(getattr(tref, which)) == schedule_facts(getattr(jref, which))
    # the discrepancy itself, as the JAX package has it
    assert tp.windows[8] == 6 and tref.adaptive.tiles[8].window == 3
    tpt = tsched.two_phase(tt, cap)
    assert schedule_facts(tpt.adaptive) == schedule_facts(jsched.two_phase(jt, cap).adaptive)


def test_queue3_engine_input_reproduced():
    pairs, windows, cap = QUEUE3_ENGINE
    jt, tt = both([(float(l), float(e), 1) for l, e in pairs])
    args = ([t.load_s for t in tt], [t.exec_s for t in tt], [t.mem_bytes for t in tt], cap)
    t_eng = PlanEngine(*args).simulate(windows)
    j_eng = JEngine(*args).simulate(windows)
    t_ref, j_ref = tsched.simulate(tt, cap, windows), jsched.simulate(jt, cap, windows)
    assert t_eng.total_stall == j_eng.total_stall == 8.992500000000001
    assert t_ref.total_stall == j_ref.total_stall == 8.9925
    assert schedule_facts(t_ref) == schedule_facts(j_ref)


# ------------------------------------------------------------ the IR -----


def test_json_round_trip_and_infeasible_plan_match_jax():
    tiles = [(1.0, 2.0, 10), (2.0, 1.0, 12), (1.5, 1.5, 8), (0.1, 0.0, 3)]
    jt, tt = both(tiles)
    tp = tplan.plan(tt, 30)
    back = tplan.ExecutionPlan.from_json_dict(json.loads(json.dumps(tp.to_json_dict())))
    assert plan_facts(back) == plan_facts(tp)
    # the JAX package's JSON form parses in the port to the same plan
    jd = jplan.plan(jt, 30).to_json_dict()
    assert plan_facts(tplan.ExecutionPlan.from_json_dict(jd)) == plan_facts(tp)
    # a tile over capacity: infeasible, the same empty timelines
    jb, tb = both([(1.0, 1.0, 40)] + tiles)
    assert plan_facts(tplan.plan(tb, 30)) == plan_facts(jplan.plan(jb, 30))
    assert not tplan.plan(tb, 30).feasible
    assert plan_facts(tplan.infeasible_plan(tb, 30, True)) == plan_facts(
        jplan.infeasible_plan(jb, 30, True))


# ----------------------------------------------------------- the cache ---


def test_plan_cache_keys_and_spills_stay_apart_from_jax(tmp_path, monkeypatch):
    """The port never reads the JAX package's spill files, nor the JAX
    package the port's: disjoint keys, and by default separate spill
    directories."""
    tiles = [(1.0, 2.0, 10), (2.0, 1.0, 12), (1.5, 1.5, 8)]
    jt, tt = both(tiles)
    assert tcache.plan_key(tt, 50) != jcache.plan_key(jt, 50)
    jc, tc = jcache.PlanCache(persist_dir=tmp_path), tcache.PlanCache(persist_dir=tmp_path)
    jp = jc.get_or_plan(jt, 50)
    tp = tc.get_or_plan(tt, 50)
    assert tc.stats()["disk_hits"] == 0 and len(list(tmp_path.glob("*.json"))) == 2
    assert plan_facts(tp) == plan_facts(jp)
    # a fresh port cache reads its own spill back
    again = tcache.PlanCache(persist_dir=tmp_path)
    assert plan_facts(again.get_or_plan(tt, 50)) == plan_facts(tp)
    assert again.stats()["disk_hits"] == 1
    monkeypatch.delenv("REPRO_PLAN_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro").mkdir(parents=True)
    (tmp_path / "ROADMAP.md").write_text("")
    assert tcache._default_persist_dir() == tmp_path / "experiments" / "plans_torch"
    assert jcache._default_persist_dir() == tmp_path / "experiments" / "plans"
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", "0")
    assert tcache._default_persist_dir() is None


def test_plan_cache_hits_and_search_keys():
    cache = tplan.PlanCache(max_entries=2)
    _, tt = both([(1.0, 2.0, 10), (2.0, 2.0, 15), (1.5, 1.0, 12)])
    p1 = cache.get_or_plan(tt, 50)
    assert cache.get_or_plan(list(tt), 50) is p1
    assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1, "disk_hits": 0,
                             "disk_errors": 0}
    keys = {tplan.plan_key(tt, 50), tplan.plan_key(tt, 50, search=tplan.SearchConfig("beam")),
            tplan.plan_key(tt, 50, search=tplan.SearchConfig("anneal", seed=1))}
    assert len(keys) == 3
    assert tplan.plan_key(tt, 50, search=tplan.SearchConfig()) == tplan.plan_key(tt, 50)


# -------------------------------------------------------- partitioning ---


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_balance_layer_ranges_matches_jax(seed):
    rng = np.random.default_rng(2000 + seed)
    for _ in range(10):
        k, n = int(rng.integers(1, 5)), int(rng.integers(5, 30))
        costs = rng.uniform(0.1, 5.0, (k, n))
        assert tplan.balance_layer_ranges(costs) == jplan.balance_layer_ranges(costs)
        pts = sorted(set(rng.integers(0, n + 1, 6).tolist()) | {0, n})
        bounds = sorted(rng.integers(0, n + 1, k - 1).tolist()) if k > 1 else []
        assert (tplan.snap_boundaries_nonempty(bounds, pts, n)
                == jplan.snap_boundaries_nonempty(bounds, pts, n))


def stage_facts(pplan):
    out = []
    for s in pplan.stages:
        d = {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name != "plan"}
        d["pu"] = dataclasses.astuple(d["pu"])
        d["plan"] = plan_facts(s.plan)
        out.append(d)
    return out, (pplan.fps, pplan.latency_s, pplan.bottleneck_s, pplan.tops,
                 pplan.fps_per_tops, pplan.feasible)


def test_partition_gemms_matches_jax():
    gemms = [(f"g{i}", 64 * (1 + i % 5), 128 * (1 + i % 3), 16) for i in range(24)]
    for pus in ((0,), (0, 1), (1, 0, 1)):
        jp = jplan.partition_gemms(gemms, [(J_PU_2X, J_PU_1X)[k] for k in pus], use_cache=False)
        tp = tplan.partition_gemms(gemms, [(PU_2X, PU_1X)[k] for k in pus], use_cache=False)
        assert stage_facts(tp) == stage_facts(jp)
        for m in (1, 4):
            assert tp.bubble_prediction(m) == jp.bubble_prediction(m)
            assert tp.pipeline_events(m).tolist() == jp.pipeline_events(m).tolist()


@pytest.mark.parametrize("variant", [18, 50])
def test_partition_layers_matches_jax(variant):
    """``simulate_partitioned``: ResNet layers split over PU_1x and PU_2x."""
    jp = jsim.simulate_partitioned([J_PU_1X, J_PU_2X], jsim.resnet_gemm_layers(variant))
    tp = tsim.simulate_partitioned([PU_1X, PU_2X], tsim.resnet_gemm_layers(variant))
    assert stage_facts(tp) == stage_facts(jp)
