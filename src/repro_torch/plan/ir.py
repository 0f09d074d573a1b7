"""ExecutionPlan: the shared plan IR for scheduling/streaming/serving.

One ``ExecutionPlan`` captures everything the repo previously scattered
across three ad-hoc shapes (``core.scheduler.Schedule`` /
``core.streaming.StreamingPlan`` / ``core.simulator.TwoPhaseResult``):

- the costed tile sequence (``TileCost`` per tile) and the fast-memory
  capacity it was planned against;
- the window assignment for both phases (baseline prefetch + adaptive
  relocations) -- ``windows[j] = k`` issues tile *j*'s load during tile
  *k*'s execution window, ``-1`` preloads before t=0;
- the resolved timeline (load/exec start/end arrays) for both phases;
- a vectorized residency account (prefix sums over allocation edges).

Consumers (``core.scheduler``, ``core.streaming``, ``core.simulator``,
``runtime.serving``, the benchmark harness) all read this IR; the legacy
entry points convert it to their historical return types via
:meth:`ExecutionPlan.to_schedule` / :meth:`ExecutionPlan.to_two_phase`,
which are bit-identical to the original planners by construction (same
event arithmetic, see plan/engine.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.pu import TileCost


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Resolved timing of one window assignment (arrays indexed by tile)."""

    load_start: np.ndarray     # float64 (n,)
    load_end: np.ndarray
    exec_start: np.ndarray
    exec_end: np.ndarray
    feasible: bool

    @property
    def n(self) -> int:
        return len(self.load_start)

    def stalls(self) -> np.ndarray:
        """Per-tile wait between the previous exec end and this exec start."""
        if not self.feasible or self.n == 0:
            return np.zeros(0, np.float64)
        prev_end = np.concatenate(([0.0], self.exec_end[:-1]))
        return np.maximum(0.0, self.exec_start - prev_end)

    @property
    def total_stall(self) -> float:
        # left-to-right summation: keeps parity with the reference
        # scheduler's ``sum(t.stall for t in tiles)``
        total = 0.0
        for s in self.stalls().tolist():
            total += s
        return total

    @property
    def makespan(self) -> float:
        if not self.feasible or self.n == 0:
            return 0.0
        return float(self.exec_end[-1])

    @property
    def busy_time(self) -> float:
        if not self.feasible:
            return 0.0
        return float(np.sum(self.exec_end - self.exec_start))

    @property
    def utilization(self) -> float:
        ms = self.makespan
        return self.busy_time / ms if ms > 0 else 1.0


def _empty_timeline(feasible: bool) -> Timeline:
    z = np.zeros(0, np.float64)
    return Timeline(z, z, z, z, feasible)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A fully planned tile sequence on one PU's fast memory."""

    tiles: Tuple[TileCost, ...]
    capacity: int
    preload_first: bool
    baseline_windows: Tuple[int, ...]
    windows: Tuple[int, ...]               # final (adaptive) assignment
    baseline: Timeline
    timeline: Timeline                     # final (adaptive) timeline
    plan_wall_s: float = 0.0               # planner wall time (diagnostics)
    # descriptor of the schedule search that produced `windows`
    # ("heuristic", or a SearchConfig descriptor like "beam(w=4,...)")
    search: str = "heuristic"
    # the adaptive phase detected a load-bound workload (no execution
    # window can conceal any stalled load) and exited without trials
    skipped_load_bound: bool = False

    # ---- summary statistics -------------------------------------------

    @property
    def n(self) -> int:
        return len(self.tiles)

    @property
    def feasible(self) -> bool:
        return self.timeline.feasible

    @property
    def total_stall(self) -> float:
        return self.timeline.total_stall

    @property
    def baseline_stall(self) -> float:
        return self.baseline.total_stall

    @property
    def stall_reduction(self) -> float:
        b = self.baseline_stall
        if b <= 0:
            return 0.0
        return (b - self.total_stall) / b

    @property
    def makespan(self) -> float:
        return self.timeline.makespan

    @property
    def utilization(self) -> float:
        return self.timeline.utilization

    @property
    def weight_bytes(self) -> int:
        return int(sum(t.mem_bytes for t in self.tiles))

    def issue_order(self) -> List[int]:
        """Tile indices in load-channel issue order.

        The load channel is serial and drains its queue sorted by
        ``(window, tile)``; every executor must fetch in this order.
        """
        return sorted(range(self.n), key=lambda i: (self.windows[i], i))

    def relocations(self) -> List[Tuple[int, int, int]]:
        """(tile, from_window, to_window) moved by the adaptive phase."""
        return [
            (j, b, w)
            for j, (b, w) in enumerate(zip(self.baseline_windows, self.windows))
            if b != w
        ]

    # ---- residency account (vectorized prefix sums) -------------------

    def residency(self, which: str = "adaptive") -> Tuple[np.ndarray, np.ndarray]:
        """(edge_times, resident_bytes) after each allocation/release edge.

        Memory is held from ``load_start`` to ``exec_end``; releases at a
        shared timestamp apply before allocations (matches the hardware:
        the URAM slot frees the cycle the consuming round retires).
        """
        tl = self.baseline if which == "baseline" else self.timeline
        if not tl.feasible or tl.n == 0:
            return np.zeros(0, np.float64), np.zeros(0, np.float64)
        mem = np.array([t.mem_bytes for t in self.tiles], np.float64)
        times = np.concatenate((tl.load_start, tl.exec_end))
        deltas = np.concatenate((mem, -mem))
        # kind flag orders releases (0) before allocations (1) at ties
        kind = np.concatenate((np.ones(tl.n), np.zeros(tl.n)))
        order = np.lexsort((kind, times))
        return times[order], np.cumsum(deltas[order])

    def peak_memory(self, which: str = "adaptive") -> int:
        _, resident = self.residency(which)
        return int(resident.max()) if len(resident) else 0

    # ---- legacy views --------------------------------------------------

    def to_schedule(self, which: str = "adaptive"):
        """Convert one phase to the legacy ``core.scheduler.Schedule``."""
        from repro_torch.core import scheduler as sched

        tl = self.baseline if which == "baseline" else self.timeline
        if not tl.feasible:
            return sched.Schedule(tiles=[], feasible=False, capacity=self.capacity)
        windows = (
            self.baseline_windows if which == "baseline" else self.windows
        )
        out = []
        prev_end = 0.0
        for i, t in enumerate(self.tiles):
            es = float(tl.exec_start[i])
            out.append(
                sched.TileSchedule(
                    index=i,
                    window=windows[i],
                    load_start=float(tl.load_start[i]),
                    load_end=float(tl.load_end[i]),
                    exec_start=es,
                    exec_end=float(tl.exec_end[i]),
                    stall=max(0.0, es - prev_end),
                    mem_bytes=t.mem_bytes,
                )
            )
            prev_end = float(tl.exec_end[i])
        return sched.Schedule(tiles=out, feasible=True, capacity=self.capacity)

    def to_two_phase(self):
        """Convert to the legacy ``core.scheduler.TwoPhaseResult``."""
        from repro_torch.core import scheduler as sched

        return sched.TwoPhaseResult(
            baseline=self.to_schedule("baseline"),
            adaptive=self.to_schedule("adaptive"),
        )

    # ---- persistence ----------------------------------------------------

    def to_json_dict(self) -> dict:
        """Loss-free JSON form (floats round-trip exactly via repr)."""
        def tl(t: Timeline) -> dict:
            return {
                "load_start": t.load_start.tolist(),
                "load_end": t.load_end.tolist(),
                "exec_start": t.exec_start.tolist(),
                "exec_end": t.exec_end.tolist(),
                "feasible": t.feasible,
            }

        return {
            "version": 1,
            "tiles": [[t.load_s, t.exec_s, t.mem_bytes] for t in self.tiles],
            "capacity": self.capacity,
            "preload_first": self.preload_first,
            "baseline_windows": list(self.baseline_windows),
            "windows": list(self.windows),
            "baseline": tl(self.baseline),
            "timeline": tl(self.timeline),
            "plan_wall_s": self.plan_wall_s,
            "search": self.search,
            "skipped_load_bound": self.skipped_load_bound,
        }

    @staticmethod
    def from_json_dict(d: dict) -> "ExecutionPlan":
        """Parse a persisted plan, validating its structure.

        A spill file can be corrupt in ways ``json.loads`` cannot see --
        truncated arrays, mismatched tile counts, windows out of range.
        Serving such a plan would silently execute a wrong schedule, so
        shape inconsistencies raise ``ValueError`` (the cache treats
        that like any other corrupt spill: recompute and rewrite).
        """
        if d.get("version") != 1:
            raise ValueError(f"unknown plan version {d.get('version')!r}")
        n = len(d["tiles"])

        def tl(x: dict) -> Timeline:
            t = Timeline(
                load_start=np.asarray(x["load_start"], np.float64),
                load_end=np.asarray(x["load_end"], np.float64),
                exec_start=np.asarray(x["exec_start"], np.float64),
                exec_end=np.asarray(x["exec_end"], np.float64),
                feasible=bool(x["feasible"]),
            )
            lens = {
                len(t.load_start), len(t.load_end),
                len(t.exec_start), len(t.exec_end),
            }
            if t.feasible and lens != ({n} if n else {0}):
                raise ValueError(
                    f"timeline arrays of length {sorted(lens)} do not "
                    f"match {n} tiles"
                )
            return t

        def wins(key: str) -> Tuple[int, ...]:
            w = tuple(int(v) for v in d[key])
            if len(w) != n or any(not (-1 <= v < i) for i, v in enumerate(w)):
                raise ValueError(f"invalid {key} for {n} tiles")
            return w

        return ExecutionPlan(
            tiles=tuple(
                TileCost(load_s=l, exec_s=e, mem_bytes=int(m))
                for l, e, m in d["tiles"]
            ),
            capacity=int(d["capacity"]),
            preload_first=bool(d["preload_first"]),
            baseline_windows=wins("baseline_windows"),
            windows=wins("windows"),
            baseline=tl(d["baseline"]),
            timeline=tl(d["timeline"]),
            plan_wall_s=float(d.get("plan_wall_s", 0.0)),
            search=str(d.get("search", "heuristic")),
            skipped_load_bound=bool(d.get("skipped_load_bound", False)),
        )

    def summary(self) -> dict:
        return {
            "tiles": self.n,
            "capacity_bytes": float(self.capacity),
            "weight_bytes": float(self.weight_bytes),
            "feasible": self.feasible,
            "baseline_stall_s": self.baseline_stall,
            "adaptive_stall_s": self.total_stall,
            "stall_reduction": self.stall_reduction,
            "baseline_util": self.baseline.utilization,
            "adaptive_util": self.utilization,
            "makespan_s": self.makespan,
            "relocations": len(self.relocations()),
            "plan_wall_s": self.plan_wall_s,
            "search": self.search,
            "skipped_load_bound": self.skipped_load_bound,
        }


def infeasible_plan(
    tiles: Sequence[TileCost], capacity: int, preload_first: bool
) -> ExecutionPlan:
    n = len(tiles)
    base_windows = tuple(range(-1, n - 1))
    return ExecutionPlan(
        tiles=tuple(tiles),
        capacity=capacity,
        preload_first=preload_first,
        baseline_windows=base_windows,
        windows=base_windows,
        baseline=_empty_timeline(False),
        timeline=_empty_timeline(False),
    )
