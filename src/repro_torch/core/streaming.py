"""Weight-streaming executor: the paper's scheduler driving real inference
(a copy of ``repro.core.streaming``).

Bridges the two-phase schedule (core/scheduler.py) and a model: the
model's weight matrices are partitioned into named tiles, costed under a
memory-hierarchy profile (core/pu.py PUConfig -- URAM@FPGA, shared memory
or host offload on the H100, or the JAX package's TPU profiles), scheduled,
and the plan is exposed to the serving engine which issues prefetches in
plan order.

:class:`StreamingExecutor` runs the plan: ``fetch`` brings a tile's
weights into fast memory (on the card, a copy from pinned host memory into
a device tensor), each ``tile_fns[i]`` computes with them, and the
residency account is the one the plan was verified against.
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple,
)

import numpy as np

from repro_torch.analysis import sanitize
from repro_torch.core.pu import PUConfig, TileCost
from repro_torch.core import scheduler as sched

if TYPE_CHECKING:  # repro_torch.plan imports core.pu: keep the cycle lazy
    from repro_torch.plan import ExecutionPlan


@dataclasses.dataclass(frozen=True)
class WeightTile:
    """A named weight tile: one schedulable unit of the model."""

    name: str          # e.g. "layer3/mlp/up/rows0"
    layer_index: int   # inference order of the consuming layer
    n: int             # tile rows (<= R_SA after padding at the PU level)
    m: int             # reduction dim
    p: int             # activation columns it will be applied to

    def cost(self, pu: PUConfig) -> TileCost:
        return TileCost(
            load_s=pu.load_time(self.m, self.n),
            exec_s=pu.exec_time(self.m, self.p, self.n),
            mem_bytes=pu.tile_bytes(self.m, self.n),
        )


@dataclasses.dataclass
class StreamingPlan:
    tiles: List[WeightTile]
    plan: "ExecutionPlan"
    pu: PUConfig

    @property
    def result(self) -> sched.TwoPhaseResult:
        """Legacy two-schedule view of the underlying ExecutionPlan."""
        return self.plan.to_two_phase()

    @property
    def schedule(self) -> sched.Schedule:
        return self.plan.to_schedule("adaptive")

    def issue_order(self) -> List[int]:
        """Tile indices in channel (load-issue) order.

        The load channel is serial and drains its queue sorted by
        ``(window, tile)``; this is the order the executor must fetch in.
        """
        return self.plan.issue_order()

    def prefetch_order(self) -> List[Tuple[str, int]]:
        """(tile name, window) in load-issue order."""
        windows = self.plan.windows
        return [(self.tiles[i].name, windows[i]) for i in self.issue_order()]

    def summary(self) -> Dict[str, float]:
        out = {
            "tiles": len(self.tiles),
            "capacity_bytes": float(self.pu.fast_mem_bytes),
            "weight_bytes": float(self.plan.weight_bytes),
            "baseline_stall_s": self.plan.baseline_stall,
            "adaptive_stall_s": self.plan.total_stall,
            "stall_reduction": self.plan.stall_reduction,
            "baseline_util": self.plan.baseline.utilization,
            "adaptive_util": self.plan.utilization,
            "makespan_s": self.plan.makespan,
        }
        return out


def plan_streaming(
    tiles: Sequence[WeightTile], pu: PUConfig, search=None
) -> StreamingPlan:
    """Plan a tile sequence on ``pu`` via the shared (cached) planner.

    ``search`` (a ``repro_torch.plan.SearchConfig``) selects the schedule
    search strategy; it is folded into the plan-cache key.
    """
    from repro_torch.plan import plan_cached

    costs = [t.cost(pu) for t in tiles]
    result = plan_cached(costs, pu.fast_mem_bytes, search=search)
    return StreamingPlan(tiles=list(tiles), plan=result, pu=pu)


def gemm_sequence_tiles(
    gemms: Sequence[Tuple[str, int, int, int]], pu: PUConfig
) -> List[WeightTile]:
    """Tile a sequence of (name, N, M, P) GEMMs into R_SA-row tiles,

    exactly the paper's `R_SA x M_v` partitioning (SS III).
    """
    tiles: List[WeightTile] = []
    for li, (name, n, m, p) in enumerate(gemms):
        n_tiles = -(-n // pu.r_sa)
        for t in range(n_tiles):
            rows = min(pu.r_sa, n - t * pu.r_sa)
            tiles.append(
                WeightTile(
                    name=f"{name}/rows{t * pu.r_sa}",
                    layer_index=li,
                    n=rows,
                    m=m,
                    p=p,
                )
            )
    return tiles


class StageStreamCore:
    """Residency-accounted prefetch/execute core of one streaming stage.

    Owns one PU's fast-memory account.  The *prefetch side* walks the
    plan's issue order -- the serial load channel drained sorted by
    ``(window, tile)`` -- and never reorders it; the *execute side*
    retires tiles strictly in inference (index) order and frees their
    bytes at retire, exactly when the hardware's URAM slot frees.

    The two sides may run on one thread, alternated by a plan-time gate
    (:class:`StreamingExecutor`), or on separate threads with the
    prefetch worker blocking on capacity (``runtime.pipeline_exec``) --
    feasibility of the underlying plan guarantees the blocking mode is
    deadlock-free: whenever the execute side waits on tile *i*, every
    queue entry up to *i* fits alongside the not-yet-retired residents,
    because the plan's verified peak residency at *i*'s exec covers
    precisely that set.
    """

    def __init__(
        self,
        *,
        costs: Sequence[int],            # mem_bytes per tile (index order)
        capacity: int,
        issue_order: Sequence[int],
        fetch: Callable[[int], Any],     # tile index -> weights
        names: Optional[Sequence[str]] = None,
    ):
        self.costs = list(costs)
        self.capacity = capacity
        self.issue_order = list(issue_order)
        self._fetch = fetch
        self.names = list(names) if names is not None else [
            str(i) for i in range(len(self.costs))
        ]
        # under REPRO_SANITIZE=1 the condition feeds the lock-order
        # recorder (one class-level name: ordering is a property of the
        # code, not the instance); otherwise a plain Condition
        self._cond = sanitize.instrument_condition("StageStreamCore._cond")
        self._resident: Dict[int, Any] = {}
        self._resident_bytes = 0
        self._qpos = 0
        self._failed: Optional[BaseException] = None
        self.peak_resident_bytes = 0
        self.fetches: List[str] = []     # names, in actual fetch order

    # -- prefetch side ------------------------------------------------------

    def next_issue(self) -> Optional[int]:
        """Peek the next tile in issue order without fetching it."""
        with self._cond:
            if self._qpos >= len(self.issue_order):
                return None
            return self.issue_order[self._qpos]

    def issue_next(self, *, block: bool) -> Optional[int]:
        """Fetch the next tile in issue order; returns its index.

        ``block=True`` (async worker) waits until the tile fits in fast
        memory -- the load channel stalling on URAM space; ``block=False``
        (plan-time-gated sync driver) asserts it fits, because the caller
        only issues loads the verified schedule has already started.
        """
        with self._cond:
            if self._qpos >= len(self.issue_order):
                return None
            j = self.issue_order[self._qpos]
            need = self.costs[j]
            if block:
                while self._resident_bytes + need > self.capacity:
                    if self._failed is not None:
                        return None
                    self._cond.wait(timeout=60.0)
            else:
                assert self._resident_bytes + need <= self.capacity, (
                    f"residency {self._resident_bytes + need} exceeds "
                    f"capacity {self.capacity}"
                )
            self._qpos += 1
        # fetch outside the lock: callbacks may be slow (host DMA, disk)
        try:
            w = self._fetch(j)
        except BaseException as e:
            with self._cond:
                self._failed = e
                self._cond.notify_all()
            raise
        with self._cond:
            self._resident[j] = w
            self._resident_bytes += need
            self.fetches.append(self.names[j])
            self.peak_resident_bytes = max(
                self.peak_resident_bytes, self._resident_bytes
            )
            self._cond.notify_all()
        return j

    def prefetch_all(self) -> None:
        """Blocking-worker loop: drain the whole issue queue."""
        while self.issue_next(block=True) is not None:
            pass

    # -- execute side -------------------------------------------------------

    def is_resident(self, i: int) -> bool:
        with self._cond:
            return i in self._resident

    def acquire(self, i: int, timeout: float = 120.0) -> Any:
        """Block until tile *i* is resident; return its weights."""
        deadline = _time.monotonic() + timeout
        with self._cond:
            while i not in self._resident:
                if self._failed is not None:
                    raise RuntimeError(
                        f"prefetch worker failed: {self._failed!r}"
                    ) from self._failed
                remaining = deadline - _time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    raise RuntimeError(
                        f"tile {i} not resident after {timeout}s "
                        "(prefetch stalled?)"
                    )
            return self._resident[i]

    def release(self, i: int) -> None:
        with self._cond:
            del self._resident[i]
            self._resident_bytes -= self.costs[i]
            self._cond.notify_all()

    def abort(self, exc: BaseException) -> None:
        """Unblock both sides after a failure on either."""
        with self._cond:
            self._failed = exc
            self._cond.notify_all()


class StreamingExecutor:
    """Execute a tiled computation under a streaming plan (one PU).

    ``tile_fns[i]`` computes tile *i*'s output given its weights; weights
    are fetched via ``fetch(tile_name)`` no earlier than the plan's issue
    order allows, and evicted once executed (bounded residency).  The
    executor asserts the plan's memory bound at runtime -- it is the
    software twin of the hardware's URAM allocator.  Prefetch and compute
    are interleaved on the calling thread, gated by the plan's timeline;
    the stage-parallel runtime (``runtime.pipeline_exec``) drives the same
    :class:`StageStreamCore` with a concurrent prefetch worker instead.
    """

    def __init__(
        self,
        plan: StreamingPlan,
        fetch: Callable[[str], Any],
    ):
        self.plan = plan
        self.fetch = fetch
        self.peak_resident_bytes = 0
        self.fetches: List[str] = []

    def run(
        self, tile_fns: Sequence[Callable[[Any], Any]]
    ) -> List[Any]:
        schedule = self.plan.schedule
        assert schedule.feasible, "infeasible streaming plan"
        tiles = self.plan.tiles
        # The load channel is serial: fetches MUST follow the plan's issue
        # order (queue sorted by (window, tile)).  Issuing by raw
        # load_start with an exemption for tile i's own load could pull a
        # late load ahead of queued earlier ones, breaking the residency
        # account the schedule was verified against.
        core = StageStreamCore(
            costs=[schedule.tiles[i].mem_bytes for i in range(len(tiles))],
            capacity=self.plan.pu.fast_mem_bytes,
            issue_order=self.plan.issue_order(),
            fetch=lambda j: self.fetch(tiles[j].name),
            names=[t.name for t in tiles],
        )
        outputs: List[Optional[Any]] = [None] * len(tiles)
        try:
            for i in range(len(tiles)):
                # Issue, in plan order, every prefetch the plan starts no
                # later than tile i's execution.  Tile i's own load is
                # always among them: its load_start precedes its
                # exec_start, and everything queued before it starts no
                # later still.
                while True:
                    j = core.next_issue()
                    if j is None or (
                        schedule.tiles[j].load_start
                        > schedule.tiles[i].exec_start
                    ):
                        break
                    core.issue_next(block=False)
                assert core.is_resident(i), (
                    f"tile {i} executed before its load"
                )
                outputs[i] = tile_fns[i](core.acquire(i))
                core.release(i)
        finally:
            # publish even on failure: the partial fetch order is the
            # first thing debugging a mid-run fault needs
            self.peak_resident_bytes = core.peak_resident_bytes
            self.fetches = core.fetches
        return outputs
