"""Pipeline parallelism (counterpart of ``repro.parallel.pipeline``).

So far only the analytic GPipe bubble model, which the planner's
partitioning (``plan.partition``) shares; the torch pipelining runner
comes with ROADMAP queue 1, step 15.
"""
from __future__ import annotations


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1) / (M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
