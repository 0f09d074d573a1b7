"""Content-hashed plan cache with cross-process persistence (a copy of
``repro.plan.cache``, with its own key space and spill directory).

``ServingEngine`` and the benchmark harness repeatedly plan identical
(tiles, capacity) pairs -- every engine restart, every benchmark repeat,
every fleet member sharing a PU profile.  Plans are pure functions of
their inputs, so they are cached under a content hash of the packed tile
costs plus the planner options.  ``ExecutionPlan`` is frozen and its
arrays are never mutated by consumers, so sharing one instance is safe.

Beyond the in-memory LRU, a cache may *spill* plans to
``<persist_dir>/<hash>.json`` (atomic tmp+rename writes) and load them
back on a memory miss, so serving restarts and CI runs reuse plans
across processes.  The shared module-level ``PLAN_CACHE`` persists to
``experiments/plans_torch/`` when launched from the repo root; set
``REPRO_PLAN_CACHE_DIR`` to relocate it, or to ``0``/empty to disable
persistence.  Corrupt or unreadable spill files are ignored (the plan
is simply recomputed and rewritten).

The port's plans and the JAX package's never read each other's spill
files, in two ways: by default they spill to different directories
(``experiments/plans_torch`` here, ``experiments/plans`` there), and
every key here starts from :data:`KEY_DOMAIN` and the hash of the port's
own ``planner.py``, ``engine.py`` and ``ir.py``, so even a shared
``REPRO_PLAN_CACHE_DIR`` holds two disjoint key spaces.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Sequence, Union

from repro_torch.core.pu import TileCost
from repro_torch.plan.ir import ExecutionPlan
from repro_torch.plan.planner import SearchConfig, plan as _plan


# Folded into every key: the port's keys never equal the JAX package's.
KEY_DOMAIN = b"repro_torch.plan"


def _planner_fingerprint() -> bytes:
    """Hash of the planner implementation itself.

    Folded into every plan key so persisted spill files are invalidated
    when planner/engine/IR code changes -- without this, a PR that
    alters planning semantics would silently validate against stale
    on-disk plans produced by the old code.
    """
    h = hashlib.sha256(KEY_DOMAIN)
    base = Path(__file__).resolve().parent
    for mod in ("planner.py", "engine.py", "ir.py"):
        try:
            h.update((base / mod).read_bytes())
        except OSError:          # zipapp / frozen install: no invalidation,
            h.update(mod.encode())   # but keys stay stable and correct
    return h.digest()


_PLANNER_FP = _planner_fingerprint()


def plan_key(
    tiles: Sequence[TileCost],
    capacity: int,
    *,
    preload_first: bool = True,
    adaptive: bool = True,
    exhaustive: bool = False,
    max_window_scan: Optional[int] = None,
    search: Optional[SearchConfig] = None,
) -> str:
    """Content hash of everything the planner's output depends on.

    The search descriptor (strategy, parameters, *and seed*) is part of
    the key: a heuristic plan, a beam plan, and two differently-seeded
    annealed plans of the same workload are distinct artifacts and must
    never alias in memory or on disk.
    """
    h = hashlib.sha256(_PLANNER_FP)
    h.update(
        struct.pack(
            "<q???q",
            capacity,
            preload_first,
            adaptive,
            exhaustive,
            -1 if max_window_scan is None else max_window_scan,
        )
    )
    if search is not None and search.strategy != "heuristic":
        h.update(search.key_bytes())
    for t in tiles:
        h.update(struct.pack("<ddq", t.load_s, t.exec_s, t.mem_bytes))
    return h.hexdigest()


class PlanCache:
    """Thread-safe LRU keyed by :func:`plan_key`, optionally persistent.

    ``persist_dir`` enables the disk tier: memory miss -> try
    ``<persist_dir>/<key>.json`` -> plan and spill.  Disk I/O failures
    never fail planning; they only cost a recompute.
    """

    def __init__(
        self,
        max_entries: int = 256,
        persist_dir: Optional[Union[str, Path]] = None,
    ):
        self.max_entries = max_entries
        self.persist_dir = Path(persist_dir) if persist_dir else None
        self._entries: "OrderedDict[str, ExecutionPlan]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.disk_errors = 0

    # -- disk tier ----------------------------------------------------------

    def _spill_path(self, key: str) -> Optional[Path]:
        return self.persist_dir / f"{key}.json" if self.persist_dir else None

    def _load_from_disk(self, key: str) -> Optional[ExecutionPlan]:
        path = self._spill_path(key)
        if path is None:
            return None
        try:
            plan = ExecutionPlan.from_json_dict(
                json.loads(path.read_text())
            )
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, TypeError):
            with self._lock:
                self.disk_errors += 1
            return None
        with self._lock:
            self.disk_hits += 1
        return plan

    def _save_to_disk(self, key: str, plan: ExecutionPlan) -> None:
        path = self._spill_path(key)
        if path is None:
            return
        # pid+tid: concurrent same-key spills from different threads
        # must not share one tmp file (truncation/rename races)
        tmp = path.with_suffix(
            f".tmp.{os.getpid()}.{threading.get_ident()}"
        )
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(plan.to_json_dict()))
            tmp.replace(path)     # atomic: readers never see a torn file
        except (OSError, TypeError, ValueError):
            # TypeError/ValueError: unserializable tile fields (e.g.
            # numpy scalars) must not fail planning that already
            # succeeded -- the contract is spill failures only cost a
            # recompute next process
            with self._lock:
                self.disk_errors += 1
            try:
                tmp.unlink()      # don't accumulate stale partial spills
            except OSError:
                pass

    # -- lookup -------------------------------------------------------------

    def get_or_plan(
        self, tiles: Sequence[TileCost], capacity: int, **opts
    ) -> ExecutionPlan:
        key = plan_key(tiles, capacity, **opts)
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return cached
            self.misses += 1
        result = self._load_from_disk(key)
        if result is None:
            result = _plan(tiles, capacity, **opts)
            self._save_to_disk(key, result)
        with self._lock:
            self._entries[key] = result
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return result

    def clear(self) -> None:
        """Drop the in-memory tier (spill files are left on disk)."""
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0
            self.disk_hits = 0
            self.disk_errors = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "disk_hits": self.disk_hits,
                "disk_errors": self.disk_errors,
            }


def _default_persist_dir() -> Optional[Path]:
    """Resolve the shared cache's spill directory.

    ``REPRO_PLAN_CACHE_DIR`` wins (``0``/empty disables); otherwise use
    ``experiments/plans_torch`` when the cwd looks like the repo root.  The
    root check uses *tracked* markers (``src/repro_torch`` + ``ROADMAP.md``)
    -- ``experiments/`` itself is gitignored, so fresh clones and CI
    checkouts don't have it yet and it is created on first spill.
    Ad-hoc invocations elsewhere don't litter spill files.
    """
    env = os.environ.get("REPRO_PLAN_CACHE_DIR")
    if env is not None:
        return None if env in ("", "0") else Path(env)
    if Path("src/repro_torch").is_dir() and Path("ROADMAP.md").is_file():
        # absolute, so a later chdir (daemonized serving, per-job
        # scratch dirs) keeps reading/writing the repo-root spill tree
        return Path.cwd() / "experiments" / "plans_torch"
    return None


PLAN_CACHE = PlanCache(persist_dir=_default_persist_dir())


def plan_cached(tiles: Sequence[TileCost], capacity: int, **opts) -> ExecutionPlan:
    """Module-level cache shared by serving, simulation, and benchmarks."""
    return PLAN_CACHE.get_or_plan(tiles, capacity, **opts)
