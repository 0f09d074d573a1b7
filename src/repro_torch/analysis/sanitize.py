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

The lock-order recorder is the reference's, copied: it wraps
``StageStreamCore._cond`` (via :func:`instrument_condition`) and
``StagePipelineExecutor._active_lock`` (via :func:`instrument_lock`) and
records every pairwise acquisition order into a process-wide edge
registry; acquiring A-then-B after B-then-A was seen anywhere, or
reaching a :func:`require_held` check without the lock, is reported by
:func:`lock_violations`.  It gates on ``REPRO_SANITIZE=1``
(:func:`enabled`): with the flag unset the factories return plain
``threading`` objects.  The reference's transfer guard is not here
(ROADMAP queue 1, step 16).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

_FALSY = ("", "0", "false", "False", "no")


def enabled() -> bool:
    """True when the runtime sanitizers are switched on
    (``REPRO_SANITIZE`` set to anything truthy)."""
    return os.environ.get("REPRO_SANITIZE", "") not in _FALSY


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


# ---------------------------------------------------------------------------
# lock-order recorder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockOrderViolation:
    kind: str      # "order": an inconsistent pairwise order; "unguarded"
    first: str     # lock held / expected
    second: str    # lock acquired out of order
    site: str      # file:line of the offending acquisition


_tl = threading.local()
_registry_lock = threading.Lock()
_edges: Dict[Tuple[str, str], str] = {}
_violations: List[LockOrderViolation] = []


def _held() -> List[str]:
    held = getattr(_tl, "held", None)
    if held is None:
        held = []
        _tl.held = held
    return held


def _call_site() -> str:
    # the frame that called acquire()/require_held(): two sanitize
    # frames sit above it on the stack
    frames = traceback.extract_stack(limit=4)
    for fr in reversed(frames):
        if "sanitize" not in (fr.filename or ""):
            return f"{fr.filename}:{fr.lineno}"
    return "<unknown>"


def reset_lock_monitor() -> None:
    """Clear the process-wide edge registry and recorded violations."""
    with _registry_lock:
        _edges.clear()
        _violations.clear()


def lock_violations() -> List[LockOrderViolation]:
    """Violations recorded since the last :func:`reset_lock_monitor`."""
    with _registry_lock:
        return list(_violations)


def _note_acquired(name: str) -> None:
    held = _held()
    site = _call_site()
    with _registry_lock:
        for prev in held:
            if prev == name:
                continue
            _edges.setdefault((prev, name), site)
            first_site = _edges.get((name, prev))
            if first_site is not None:
                _violations.append(
                    LockOrderViolation(
                        kind="order", first=prev, second=name, site=site
                    )
                )
    held.append(name)


def _note_released(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class _InstrumentedLock:
    """A ``threading.Lock``/``RLock`` wrapper feeding the recorder.

    Lock *names* are class-level (e.g. every ``StageStreamCore``
    instance shares ``"StageStreamCore._cond"``): ordering violations
    are a property of the code's lock classes, not of instances.
    """

    def __init__(self, inner, name: str):
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _note_released(self.name)

    def held_by_me(self) -> bool:
        return self.name in _held()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class _InstrumentedCondition(_InstrumentedLock):
    """Condition wrapper: acquire/release feed the recorder, the wait
    and notify family delegates.  ``wait`` keeps the lock "held" from
    the recorder's view -- while waiting, the thread acquires nothing
    else through this code path, so edges stay accurate."""

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def instrument_lock(name: str, lock=None, active: Optional[bool] = None):
    """A (possibly instrumented) lock: plain ``threading.Lock`` when
    the sanitizers are off, recorder-wrapped otherwise."""
    inner = lock if lock is not None else threading.Lock()
    if not (enabled() if active is None else active):
        return inner
    return _InstrumentedLock(inner, name)


def instrument_condition(name: str, cond=None, active: Optional[bool] = None):
    """A (possibly instrumented) condition variable: a plain
    ``threading.Condition`` when the sanitizers are off (or ``active`` is
    false), recorder-wrapped otherwise."""
    inner = cond if cond is not None else threading.Condition()
    if not (enabled() if active is None else active):
        return inner
    return _InstrumentedCondition(inner, name)


def require_held(lock, site: str = "") -> None:
    """Record an ``unguarded`` violation when the calling thread does
    not hold ``lock``.  No-op for uninstrumented locks (sanitizers
    off), so call sites can assert lock discipline unconditionally."""
    if not isinstance(lock, _InstrumentedLock):
        return
    if lock.held_by_me():
        return
    with _registry_lock:
        _violations.append(
            LockOrderViolation(
                kind="unguarded",
                first=lock.name,
                second="",
                site=site or _call_site(),
            )
        )
