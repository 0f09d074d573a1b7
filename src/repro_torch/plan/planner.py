"""Two-phase planner plus a pluggable schedule-search layer.

Phase 1 (baseline): tile *i*'s load is issued during tile *i-1*'s
execution window.  Phase 2 (adaptive): stalled tiles, visited in
descending stall order, have their loads tentatively relocated into
earlier windows (nearest-first, windows able to conceal the load unless
``exhaustive``); any relocation reducing overall stall is retained.

The heuristic phase replicates ``core.scheduler.adaptive_schedule``
exactly -- same visit order, same acceptance test, same early exit --
so its windows and timelines are bit-identical to the reference; each
candidate is evaluated by the event-indexed engine (plan/engine.py):
an O(1) critical-path reject for provably-dominated relocations, suffix
re-simulation for the rest.  Two planner-level shortcuts preserve
bit-identity while skipping dead work:

- **candidate prefilter**: a prefix-max over execution times answers
  "can any window conceal this load" in O(1); a stalled tile with no
  concealing window would scan every window and try nothing, so it is
  skipped outright (identical decisions, zero trials).
- **load-bound early exit**: when *no* stalled tile has a concealing
  window -- the signature of decode-style workloads whose loads dwarf
  every execution -- the adaptive phase exits immediately and the plan
  is tagged ``skipped_load_bound`` so benchmarks and serving surface
  why no relocation happened.

On top of the (cheap) heuristic, :class:`SearchConfig` selects a
search strategy over *multi-tile* window reassignments, funded by the
engine's incremental evaluation:

- ``beam``: breadth-limited best-first search; each round expands the
  current beam's states by single-tile relocations (stall-descending
  tiles, nearest-first windows) and keeps the ``beam_width`` best
  distinct window vectors.  Deterministic by construction.
- ``anneal``: annealing with a geometric temperature ladder; proposals
  relocate one (biased-random) tile's load to a random earlier window.
  All randomness comes from ``numpy.random.default_rng(seed)`` -- no
  global state -- so a (workload, config) pair always reproduces the
  same schedule.  The acceptance rule is a *restricted* Metropolis:
  proposals the engine proves no better than the incumbent (its O(1)
  critical-path/dominance rejects) are discarded without replay, even
  though classic Metropolis would accept some of them as lateral or
  small-uphill moves; proposals it cannot prove worse replay to an
  exact stall and then pass the usual ``exp(-delta/T)`` test (with
  replays aborted past ``~12 T``, where acceptance probability is
  <= e^-12).  Uphill exploration therefore happens only through
  moves whose badness is not provable from the committed timeline --
  in practice most non-trivial proposals, and the measured gains over
  the heuristic (BENCH_plan.json search records) are the acceptance
  criterion for this variant.

Both searches start from the heuristic schedule and return the best
state ever visited, so they never return more stall than the heuristic
seed -- property-tested in tests/test_plan.py.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pu import TileCost
from repro_torch.plan import engine as _engine
from repro_torch.plan.ir import ExecutionPlan, infeasible_plan

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Schedule-search selection, threaded from serving and benchmarks
    down to the plan-cache key (so plans from different strategies or
    seeds never alias)."""

    strategy: str = "heuristic"          # heuristic | beam | anneal
    seed: int = 0
    # beam search
    beam_width: int = 4
    beam_rounds: int = 16
    candidates_per_tile: int = 12
    tiles_per_round: int = 12
    # simulated annealing
    anneal_steps: int = 800
    anneal_t0: float = 0.25              # T0 as a fraction of seed stall
    anneal_tmin: float = 1e-3            # final T as a fraction of T0
    # search may use windows that only partially conceal a load
    exhaustive_windows: bool = True

    def __post_init__(self):
        if self.strategy not in ("heuristic", "beam", "anneal"):
            raise ValueError(f"unknown search strategy {self.strategy!r}")

    def descriptor(self) -> str:
        """Stable string identifying the search (folded into cache keys
        and recorded on the resulting ExecutionPlan)."""
        if self.strategy == "heuristic":
            return "heuristic"
        if self.strategy == "beam":
            return (
                f"beam(w={self.beam_width},r={self.beam_rounds},"
                f"c={self.candidates_per_tile},t={self.tiles_per_round},"
                f"x={int(self.exhaustive_windows)},seed={self.seed})"
            )
        return (
            f"anneal(s={self.anneal_steps},t0={self.anneal_t0!r},"
            f"tmin={self.anneal_tmin!r},x={int(self.exhaustive_windows)},"
            f"seed={self.seed})"
        )

    def key_bytes(self) -> bytes:
        return self.descriptor().encode()


def plan(
    tiles: Sequence[TileCost],
    capacity: int,
    *,
    preload_first: bool = True,
    adaptive: bool = True,
    exhaustive: bool = False,
    max_window_scan: Optional[int] = None,
    search: Optional[SearchConfig] = None,
) -> ExecutionPlan:
    """Plan a costed tile sequence against one fast-memory capacity."""
    t_begin = time.perf_counter()
    n = len(tiles)
    load_s = [t.load_s for t in tiles]
    exec_s = [t.exec_s for t in tiles]
    mem = [t.mem_bytes for t in tiles]
    eng = _engine.PlanEngine(load_s, exec_s, mem, capacity, preload_first)

    baseline_windows = list(range(-1, n - 1))
    base = eng.simulate(baseline_windows)
    if not base.feasible:
        return infeasible_plan(tiles, capacity, preload_first)

    windows = list(baseline_windows)
    best = base
    best_stall = base.total_stall
    skipped_load_bound = False

    if adaptive and n:
        base_stalls = base.timeline().stalls()
        stalled = sorted(
            (i for i in range(n) if base_stalls[i] > _EPS),
            key=lambda i: -base_stalls[i],
        )
        # prefix max of exec times: pmax[k] answers "can any window
        # <= k conceal a load of duration l" with one comparison, using
        # the same floats the reference filter compares
        pmax = (
            np.maximum.accumulate(np.asarray(exec_s, np.float64)).tolist()
            if (stalled and not exhaustive)
            else None
        )
        any_candidates = False
        for j in stalled:
            if windows[j] <= 0:
                continue
            l_j = load_s[j]
            if pmax is not None and pmax[windows[j] - 1] < l_j - _EPS:
                # no window can conceal l_j: the reference would scan
                # every window and try nothing
                continue
            any_candidates = True
            scanned = 0
            for k in range(windows[j] - 1, -1, -1):
                if not exhaustive and exec_s[k] < l_j - _EPS:
                    continue  # paper: window k cannot conceal l_j
                if max_window_scan is not None and scanned >= max_window_scan:
                    break
                scanned += 1
                ok, trial_stall, stall_j = eng.try_relocation(
                    best, j, k, best_stall - _EPS
                )
                if ok and trial_stall < best_stall - _EPS:
                    windows[j] = k
                    # promote: full re-sim rebuilds the snapshots the next
                    # suffix replay resumes from
                    best = eng.simulate(windows)
                    best_stall = best.total_stall
                    if stall_j <= _EPS:
                        break
        skipped_load_bound = bool(stalled) and not any_candidates

    searcher = search if (search and search.strategy != "heuristic") else None
    if searcher is not None and adaptive and n:
        if searcher.strategy == "beam":
            best, windows = _beam_search(eng, windows, best, searcher)
        else:
            best, windows = _anneal_search(eng, windows, best, searcher)

    return ExecutionPlan(
        tiles=tuple(tiles),
        capacity=capacity,
        preload_first=preload_first,
        baseline_windows=tuple(base.windows),
        windows=tuple(best.windows),
        baseline=base.timeline(),
        timeline=best.timeline(),
        plan_wall_s=time.perf_counter() - t_begin,
        search=searcher.descriptor() if searcher else "heuristic",
        skipped_load_bound=skipped_load_bound,
    )


# ---------------------------------------------------------------- search --


def _stalled_tiles(
    eng: "_engine.PlanEngine", state, windows, limit: int
) -> List[int]:
    stalls = state.stalls()
    order = sorted(
        (i for i in range(eng.n) if stalls[i] > _EPS and windows[i] > 0),
        key=lambda i: (-stalls[i], i),
    )
    return order[:limit] if limit else order


def _window_candidates(
    eng: "_engine.PlanEngine", windows, j: int, cfg: SearchConfig
) -> List[int]:
    """Earlier windows for tile j: the nearest half of the candidate
    budget (where the heuristic searches) plus an evenly-strided sample
    of the remaining range (escape hatches past its local optimum),
    optionally filtered to windows able to fully conceal the load."""
    w = windows[j]
    l_j = eng.load_s[j]

    def admissible(k: int) -> bool:
        return cfg.exhaustive_windows or eng.exec_s[k] >= l_j - _EPS

    out: List[int] = []
    near = max(cfg.candidates_per_tile // 2, 1)
    k = w - 1
    while k >= 0 and len(out) < near:
        if admissible(k):
            out.append(k)
        k -= 1
    if k > 0:
        far_budget = cfg.candidates_per_tile - len(out)
        if far_budget > 0:
            stride = max(k // far_budget, 1)
            kk = k - 1
            while kk >= 0 and far_budget > 0:
                if admissible(kk):
                    out.append(kk)
                    far_budget -= 1
                kk -= stride
    return out


def _beam_search(
    eng: "_engine.PlanEngine", windows0: List[int], state0, cfg: SearchConfig
) -> Tuple[object, List[int]]:
    """Beam over multi-tile reassignments; monotone in the best state."""
    w0 = tuple(windows0)
    beam = [(state0.total_stall, w0, state0)]
    best_state, best_windows = state0, w0
    for _round in range(cfg.beam_rounds):
        candidates: dict = {}
        for stall_s, wins, st in beam:
            lw = list(wins)
            for j in _stalled_tiles(eng, st, lw, cfg.tiles_per_round):
                for k in _window_candidates(eng, lw, j, cfg):
                    ok, tstall, _sj = eng.try_relocation(
                        st, j, k, stall_s - _EPS
                    )
                    if ok and tstall < stall_s - _EPS:
                        nw = wins[:j] + (k,) + wins[j + 1:]
                        prev = candidates.get(nw)
                        if prev is None or tstall < prev:
                            candidates[nw] = tstall
        if not candidates:
            break
        ranked = sorted(candidates.items(), key=lambda kv: (kv[1], kv[0]))
        beam = []
        improved = False
        for nw, _tstall in ranked[: cfg.beam_width]:
            stt = eng.simulate(list(nw))
            if not stt.feasible:
                continue
            beam.append((stt.total_stall, nw, stt))
            if stt.total_stall < best_state.total_stall - _EPS:
                best_state, best_windows = stt, nw
                improved = True
        if not beam or not improved:
            break
    return best_state, list(best_windows)


def _anneal_search(
    eng: "_engine.PlanEngine", windows0: List[int], state0, cfg: SearchConfig
) -> Tuple[object, List[int]]:
    """Metropolis annealing over single-tile relocations (earlier
    windows only), geometric temperature ladder, best-ever retained."""
    rng = np.random.default_rng(cfg.seed)
    n = eng.n
    cur = state0
    cur_windows = list(windows0)
    cur_stall = state0.total_stall
    best_state, best_windows = state0, list(windows0)
    t0 = max(cfg.anneal_t0 * max(cur_stall, _EPS), 1e-300)
    stalls = None
    steps = max(cfg.anneal_steps, 1)
    for step in range(steps):
        temp = t0 * (cfg.anneal_tmin ** (step / max(steps - 1, 1)))
        if stalls is None:
            stalls = cur.stalls()
            stalled = [
                i for i in range(n)
                if stalls[i] > _EPS and cur_windows[i] > 0
            ]
            movable = [i for i in range(1, n) if cur_windows[i] > 0]
        if not movable:
            break
        if stalled and rng.random() < 0.7:
            j = stalled[int(rng.integers(len(stalled)))]
        else:
            j = movable[int(rng.integers(len(movable)))]
        k = int(rng.integers(0, cur_windows[j]))
        if not cfg.exhaustive_windows and eng.exec_s[k] < eng.load_s[j] - _EPS:
            continue
        # not-ok covers both the engine's O(1) provably-no-better
        # rejects (restricted Metropolis -- see the module docstring)
        # and replays aborted past ~12 T (acceptance <= e^-12)
        ok, tstall, _sj = eng.try_relocation(
            cur, j, k, cur_stall + 12.0 * temp
        )
        if not ok:
            continue
        delta = tstall - cur_stall
        if delta < 0 or rng.random() < math.exp(-delta / temp):
            cur_windows[j] = k
            cur = eng.simulate(cur_windows)
            if not cur.feasible:     # should not happen: trial was feasible
                cur = eng.simulate(best_windows)
                cur_windows = list(best_windows)
            cur_stall = cur.total_stall
            stalls = None
            if cur_stall < best_state.total_stall - _EPS:
                best_state, best_windows = cur, list(cur_windows)
    return best_state, best_windows
