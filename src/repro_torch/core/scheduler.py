"""Two-phase weight-transfer scheduling (paper SS III, Fig. 4); a copy of
``repro.core.scheduler``, bit for bit.

A model runs tile-by-tile: tile *i* has weights load time ``l_i`` (off-chip
to fast memory), execution time ``e_i``, and a fast-memory footprint.  The
load channel is serial, executions are strictly in inference order, a tile's
memory is allocated from the moment its load starts and released when its
execution completes, and the sum of live allocations can never exceed the
fast-memory capacity.

Phase 1 (*baseline*): the load of tile *i* is issued during the execution
window of tile *i-1* ("loading the next tile's weights is attempted while
the preceding tile operates").  A tile with ``l_i <= e_{i-1}`` and enough
free memory exhibits zero stall; otherwise the pipeline waits ``l_i -
e_{i-1}`` -- or up to ``l_i`` when memory is the limiting factor.

Phase 2 (*adaptive*): remaining stalls are examined in descending stall
order; each stalled tile's load is tentatively relocated into an earlier
execution window with adequate memory headroom.  Any relocation that
reduces total stall is retained, otherwise reversed, and earlier windows
are examined in turn.

The scheduler is memory-hierarchy agnostic: it only sees ``TileCost``
(load seconds / exec seconds / bytes) plus a capacity, so the same code
plans URAM@FPGA (the paper), shared memory or host offload on the H100,
and the JAX package's TPU profiles (see ``core/pu.py``).

``two_phase`` / ``adaptive_schedule`` are thin wrappers over the unified
planning subsystem (``repro_torch.plan``, see DESIGN.md SS1): the incremental
planner there is bit-identical but an order of magnitude faster on the
adaptive phase.  ``simulate`` and the ``reference_*`` entry points keep
the original full-replay implementation as the semantics oracle.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from typing import List, Optional, Sequence

from repro_torch.core.pu import TileCost


@dataclasses.dataclass
class TileSchedule:
    """Resolved timing of one tile."""

    index: int
    window: int          # load issued during this tile's execution window (-1 = preload)
    load_start: float
    load_end: float
    exec_start: float
    exec_end: float
    stall: float         # wait between previous exec end and this exec start
    mem_bytes: int


@dataclasses.dataclass
class Schedule:
    """A fully resolved schedule plus summary statistics."""

    tiles: List[TileSchedule]
    feasible: bool
    capacity: int

    @property
    def total_stall(self) -> float:
        return sum(t.stall for t in self.tiles)

    @property
    def makespan(self) -> float:
        return self.tiles[-1].exec_end if self.tiles else 0.0

    @property
    def busy_time(self) -> float:
        return sum(t.exec_end - t.exec_start for t in self.tiles)

    @property
    def utilization(self) -> float:
        """Fraction of the makespan the compute array is busy.

        This is the paper's "performance efficiency" (98% reported in SS V).
        """
        ms = self.makespan
        return self.busy_time / ms if ms > 0 else 1.0

    def peak_memory(self) -> int:
        """Peak bytes of simultaneously-resident tiles (for assertions)."""
        events = []
        for t in self.tiles:
            events.append((t.load_start, 1, t.mem_bytes))
            events.append((t.exec_end, 0, -t.mem_bytes))
        # Releases at the same timestamp apply before allocations.
        events.sort(key=lambda e: (e[0], e[1]))
        cur = peak = 0
        for _, _, d in events:
            cur += d
            peak = max(peak, cur)
        return peak

    def memory_trace(self) -> List[tuple]:
        """(time, resident_bytes) samples at every allocation/release edge."""
        stamps = sorted(
            {t.load_start for t in self.tiles} | {t.exec_end for t in self.tiles}
        )
        out = []
        for s in stamps:
            cur = sum(
                t.mem_bytes for t in self.tiles if t.load_start <= s < t.exec_end
            )
            out.append((s, cur))
        return out


_EPS = 1e-12


def simulate(
    tiles: Sequence[TileCost],
    capacity: int,
    windows: Optional[Sequence[int]] = None,
    preload_first: bool = True,
) -> Schedule:
    """Event-driven simulation of a window assignment.

    ``windows[j] = k`` issues tile *j*'s load during tile *k*'s execution
    window (k < j).  ``windows[j] = -1`` (with ``preload_first``) issues the
    load at t=0 before the pipeline starts -- the paper pre-loads the first
    tile "to avoid an initial delay".

    Loads are serialized on one channel in queue order sorted by
    (window, tile).  A load waits for (a) its window to open, (b) the
    channel, and (c) sufficient free memory; memory is released when a
    tile's execution completes.  If a memory wait can only be satisfied by
    the execution of a tile whose own load is queued *behind* the blocked
    load, the assignment deadlocks and is reported infeasible.
    """
    n = len(tiles)
    if n == 0:
        return Schedule(tiles=[], feasible=True, capacity=capacity)
    if windows is None:
        windows = [j - 1 for j in range(n)]
    windows = list(windows)
    if preload_first:
        windows[0] = -1
    for j, w in enumerate(windows):
        if not (-1 <= w < j):
            raise ValueError(f"window[{j}]={w} must be in [-1, {j-1}]")
    if any(t.mem_bytes > capacity for t in tiles):
        return Schedule(tiles=[], feasible=False, capacity=capacity)

    queue = sorted(range(n), key=lambda j: (windows[j], j))

    nan = math.nan
    load_start = [nan] * n
    load_end = [nan] * n
    exec_start = [nan] * n
    exec_end = [nan] * n

    # Allocation edges of issued loads / scheduled execs: (+bytes at
    # load_start, -bytes at exec_end).  Kept as parallel numpy arrays so
    # memory queries are vectorized (the adaptive phase re-simulates many
    # candidate schedules; this is the hot path).
    edge_t = np.empty(2 * n + 8, np.float64)
    edge_d = np.empty(2 * n + 8, np.float64)
    n_edges = 0
    release_edges: List[tuple] = []  # (time, bytes) from scheduled execs

    def add_edge(t: float, d: float):
        nonlocal n_edges
        edge_t[n_edges] = t
        edge_d[n_edges] = d
        n_edges += 1

    def usage_at(t: float) -> float:
        if n_edges == 0:
            return 0.0
        mask = edge_t[:n_edges] <= t
        return float(edge_d[:n_edges][mask].sum())

    def earliest_fit(t0: float, need: int) -> Optional[float]:
        """Earliest t >= t0 where `need` bytes fit, given known releases."""
        if usage_at(t0) + need <= capacity:
            return t0
        for ts, _ in sorted(release_edges):
            if ts <= t0:
                continue
            if usage_at(ts) + need <= capacity:
                return ts
        return None

    channel_free = -math.inf
    prev_exec_end = 0.0
    i_exec = 0
    qpos = 0

    while i_exec < n:
        # Greedily schedule every execution whose weights are loaded: this
        # only adds release information and never delays a load.
        if not math.isnan(load_end[i_exec]):
            exec_start[i_exec] = max(prev_exec_end, load_end[i_exec])
            exec_end[i_exec] = exec_start[i_exec] + tiles[i_exec].exec_s
            prev_exec_end = exec_end[i_exec]
            add_edge(exec_end[i_exec], -tiles[i_exec].mem_bytes)
            release_edges.append((exec_end[i_exec], tiles[i_exec].mem_bytes))
            i_exec += 1
            continue
        if qpos >= n:
            return Schedule(tiles=[], feasible=False, capacity=capacity)
        j = queue[qpos]
        w = windows[j]
        # Pre-loaded tiles (window -1) complete their transfer at t=0: the
        # paper pre-loads the first tile "to avoid an initial delay" (SS V).
        open_t = -tiles[j].load_s if w == -1 else exec_start[w]
        if math.isnan(open_t):
            # Window tile has not executed: its load is behind us in the
            # queue => deadlock.
            return Schedule(tiles=[], feasible=False, capacity=capacity)
        t0 = max(open_t, channel_free)
        t_issue = earliest_fit(t0, tiles[j].mem_bytes)
        if t_issue is None:
            return Schedule(tiles=[], feasible=False, capacity=capacity)
        load_start[j] = t_issue
        load_end[j] = t_issue + tiles[j].load_s
        channel_free = load_end[j]
        add_edge(t_issue, tiles[j].mem_bytes)
        qpos += 1

    out = []
    for i in range(n):
        prev_end = exec_end[i - 1] if i > 0 else 0.0
        out.append(
            TileSchedule(
                index=i,
                window=windows[i],
                load_start=load_start[i],
                load_end=load_end[i],
                exec_start=exec_start[i],
                exec_end=exec_end[i],
                stall=max(0.0, exec_start[i] - prev_end),
                mem_bytes=tiles[i].mem_bytes,
            )
        )
    return Schedule(tiles=out, feasible=True, capacity=capacity)


def baseline_schedule(
    tiles: Sequence[TileCost], capacity: int, preload_first: bool = True
) -> Schedule:
    """Phase 1: prefetch next tile during the current tile's execution."""
    return simulate(tiles, capacity, None, preload_first=preload_first)


def adaptive_schedule(
    tiles: Sequence[TileCost],
    capacity: int,
    preload_first: bool = True,
    baseline: Optional[Schedule] = None,
    exhaustive: bool = False,
    max_window_scan: Optional[int] = None,
    search=None,
) -> Schedule:
    """Phase 2: relocate stalled loads into earlier execution windows.

    Follows the paper: stalled tiles are visited in descending stall order;
    for each, earlier windows are examined nearest-first, considering tiles
    "with processing time e_k and adequate memory space to conceal l_j" --
    i.e. candidate windows must be able to fully hide the load
    (``e_k >= l_j``).  Any relocation that reduces *overall* stall is
    retained, otherwise reversed; the search for a tile stops early once its
    stall is fully hidden.

    ``exhaustive=True`` drops the concealment filter and also tries windows
    that can only partially hide a load (beyond-paper variant; slower,
    occasionally better -- compared in the benchmark harness).
    ``max_window_scan`` bounds candidate windows examined per stalled tile.

    Thin wrapper over the unified planning subsystem (``repro_torch.plan``),
    which evaluates candidates by incremental suffix re-simulation; the
    result is bit-identical to :func:`reference_adaptive_schedule` (the
    original full-replay implementation, kept for verification and the
    scheduler microbenchmark).  A caller-supplied ``baseline`` with a
    non-default window assignment falls back to the reference path.
    """
    if baseline is not None:
        if not baseline.feasible:
            return baseline
        default = [-1] + list(range(len(tiles) - 1))
        if [t.window for t in baseline.tiles] != default:
            return reference_adaptive_schedule(
                tiles, capacity, preload_first, baseline=baseline,
                exhaustive=exhaustive, max_window_scan=max_window_scan,
            )
    from repro_torch import plan as _plan

    result = _plan.plan(
        tiles, capacity, preload_first=preload_first,
        exhaustive=exhaustive, max_window_scan=max_window_scan,
        search=search,
    )
    return result.to_schedule("adaptive")


def reference_adaptive_schedule(
    tiles: Sequence[TileCost],
    capacity: int,
    preload_first: bool = True,
    baseline: Optional[Schedule] = None,
    exhaustive: bool = False,
    max_window_scan: Optional[int] = None,
) -> Schedule:
    """Original O(n^2)-per-candidate adaptive phase (full re-simulation).

    Semantics reference for ``repro_torch.plan``: kept verbatim so the property
    tests and the scheduler microbenchmark can assert the incremental
    planner reproduces it bit-for-bit (same windows, stalls, makespan).
    """
    if baseline is None:
        baseline = baseline_schedule(tiles, capacity, preload_first)
    if not baseline.feasible:
        return baseline

    windows = [t.window for t in baseline.tiles]
    best = baseline

    stalled = sorted(
        (t for t in baseline.tiles if t.stall > _EPS),
        key=lambda t: -t.stall,
    )
    for st in stalled:
        j = st.index
        if windows[j] <= 0:
            continue
        l_j = tiles[j].load_s
        scanned = 0
        for k in range(windows[j] - 1, -1, -1):
            if not exhaustive and tiles[k].exec_s < l_j - _EPS:
                continue  # paper: window k cannot conceal l_j
            if max_window_scan is not None and scanned >= max_window_scan:
                break
            scanned += 1
            trial_windows = list(windows)
            trial_windows[j] = k
            trial = simulate(tiles, capacity, trial_windows, preload_first)
            if trial.feasible and trial.total_stall < best.total_stall - _EPS:
                best = trial
                windows = trial_windows
                if trial.tiles[j].stall <= _EPS:
                    break
    return best


@dataclasses.dataclass
class TwoPhaseResult:
    baseline: Schedule
    adaptive: Schedule

    @property
    def stall_reduction(self) -> float:
        b = self.baseline.total_stall
        if b <= 0:
            return 0.0
        return (b - self.adaptive.total_stall) / b

    def time_ratios(self) -> List[float]:
        """Fig. 5(b): e_i / l_{i+1} -- >1 means full load/exec overlap."""
        ts = self.baseline.tiles
        out = []
        for i in range(len(ts) - 1):
            e_i = ts[i].exec_end - ts[i].exec_start
            l_next = ts[i + 1].load_end - ts[i + 1].load_start
            out.append(e_i / l_next if l_next > 0 else math.inf)
        return out

    def memory_ratios(self) -> List[float]:
        """Fig. 5(c): (mem_i + mem_{i+1}) / capacity -- <=1 means the current

        and next tile fit simultaneously.
        """
        ts = self.baseline.tiles
        cap = self.baseline.capacity
        return [
            (ts[i].mem_bytes + ts[i + 1].mem_bytes) / cap
            for i in range(len(ts) - 1)
        ]


def two_phase(
    tiles: Sequence[TileCost],
    capacity: int,
    preload_first: bool = True,
    exhaustive: bool = False,
    max_window_scan: Optional[int] = None,
    search=None,
) -> TwoPhaseResult:
    """Run both phases and return both schedules (paper Fig. 4).

    Thin wrapper over ``repro_torch.plan`` (single planning path for the
    repo); ``search`` (a ``repro_torch.plan.SearchConfig``) upgrades the
    adaptive phase to beam/annealing search over multi-tile
    reassignments.  See :func:`reference_two_phase` for the original
    implementation.
    """
    from repro_torch import plan as _plan

    result = _plan.plan(
        tiles, capacity, preload_first=preload_first,
        exhaustive=exhaustive, max_window_scan=max_window_scan,
        search=search,
    )
    return result.to_two_phase()


def reference_two_phase(
    tiles: Sequence[TileCost],
    capacity: int,
    preload_first: bool = True,
    exhaustive: bool = False,
    max_window_scan: Optional[int] = None,
) -> TwoPhaseResult:
    """Both phases via the original full-replay planner (verification)."""
    base = baseline_schedule(tiles, capacity, preload_first)
    adpt = reference_adaptive_schedule(
        tiles, capacity, preload_first, baseline=base,
        exhaustive=exhaustive, max_window_scan=max_window_scan,
    )
    return TwoPhaseResult(baseline=base, adaptive=adpt)
