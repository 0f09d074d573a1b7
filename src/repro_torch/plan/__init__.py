"""repro_torch.plan: the unified planning subsystem.

Single planning path for the whole repo -- the two-phase weight-transfer
heuristic (paper SS III) planned once into an :class:`ExecutionPlan` IR
that scheduling (``core.scheduler``), streaming (``core.streaming``),
simulation (``core.simulator``), and serving (``runtime.serving``) all
consume.  See DESIGN.md.

- ``ir``:        ExecutionPlan / Timeline (tiles + windows + resolved
                 timeline + vectorized residency account)
- ``engine``:    event-indexed engine (critical-path trial rejection,
                 suffix re-simulation, prefix-sum memory queries)
- ``planner``:   two-phase planner (bit-identical to the reference)
                 plus the SearchConfig beam/anneal search layer
- ``partition``: multi-PU pipeline partitioning (contiguous layer
                 ranges balanced on exec time, per-PU scheduling)
- ``cache``:     content-hashed plan cache (search-strategy aware)
"""
from repro_torch.plan.cache import PLAN_CACHE, PlanCache, plan_cached, plan_key
from repro_torch.plan.ir import ExecutionPlan, Timeline, infeasible_plan
from repro_torch.plan.partition import (
    PartitionedPlan,
    StagePlan,
    balance_layer_ranges,
    partition_gemms,
    partition_layers,
    snap_boundaries_nonempty,
)
from repro_torch.plan.planner import SearchConfig, plan

__all__ = [
    "ExecutionPlan",
    "Timeline",
    "infeasible_plan",
    "plan",
    "SearchConfig",
    "plan_cached",
    "plan_key",
    "PlanCache",
    "PLAN_CACHE",
    "PartitionedPlan",
    "StagePlan",
    "balance_layer_ranges",
    "partition_gemms",
    "partition_layers",
    "snap_boundaries_nonempty",
]
