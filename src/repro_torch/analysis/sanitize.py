"""Capture accounting for the serving hot path (counterpart of
``repro.analysis.sanitize``'s retrace accounting).

In the JAX package a "trace" is a jit trace: a new shape traces and
compiles the decode block again.  Here it is a CUDA-graph capture: the
serving engine captures one graph per decode-block length, and live
traffic must replay those graphs, never capture anew.
:class:`TraceCounter` counts captures by kind and :func:`retrace_guard`
raises :class:`RetraceError` when a guarded region captured more than it
was allowed.  The reference's ``TraceCounter.jit`` has no counterpart:
the engine bumps the counter where it captures.

The reference's transfer guard and lock-order recorder are not here
(ROADMAP queue 1, steps 11 and 16).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence


class RetraceError(RuntimeError):
    """A guarded region captured more graphs than it was allowed."""


class TraceCounter:
    """Per-kind capture counters.

    ``counts`` is a plain dict, so owners can expose it directly (the
    serving engine aliases it as ``trace_counts``).  ``wrap(kind, fn)``
    returns ``fn`` with a counter bump on entry, for a function that runs
    once per capture."""

    def __init__(self, kinds: Sequence[str] = ()):
        self.counts: Dict[str, int] = {k: 0 for k in kinds}

    def bump(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def wrap(self, kind: str, fn):
        def traced(*args, **kwargs):
            self.bump(kind)
            return fn(*args, **kwargs)

        return traced

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)

    def total(self) -> int:
        return sum(self.counts.values())


@contextlib.contextmanager
def retrace_guard(
    counter: TraceCounter,
    max_new_traces: int = 0,
    kinds: Optional[Sequence[str]] = None,
):
    """Fail if ``counter`` records more than ``max_new_traces`` new
    captures inside the block (optionally restricted to ``kinds``): warm
    the engine, then serve live traffic under ``retrace_guard
    (engine.tracing)``."""
    before = counter.snapshot()
    yield counter
    after = counter.snapshot()
    keys = set(before) | set(after)
    if kinds is not None:
        keys &= set(kinds)
    new = {
        k: after.get(k, 0) - before.get(k, 0)
        for k in sorted(keys)
        if after.get(k, 0) != before.get(k, 0)
    }
    total = sum(new.values())
    if total > max_new_traces:
        raise RetraceError(
            f"{total} new graph capture(s) inside a retrace_guard "
            f"(allowed {max_new_traces}): {new}"
        )
