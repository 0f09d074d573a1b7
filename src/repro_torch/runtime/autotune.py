"""Auto-tune microbatch depth M and handoff queue depth per partition
(a copy of ``repro.runtime.autotune``).

The GPipe bubble floor (K-1)/(M+K-1) says how deep a microbatch burst
must be before the fill/drain cost amortizes, but the *executed* bubble
of a real partition also carries handoff transfers and stage imbalance
(``BENCH_stream.json`` measures ~1.1-1.2x the analytic floor).  Instead
of hard-coding M, :func:`tune_pipeline` closes the loop with the
runtime: it seeds M from the analytic floor for the requested target
bubble, then *measures* the executed bubble through
:class:`runtime.pipeline_exec.StagePipelineExecutor` and walks M until
the measurement lands inside the tolerance band (or the measurement is
as close to it as the discrete M grid allows).  Measured bubble is
monotone non-increasing in M, so the walk terminates after a handful of
executor runs (each is a full microbatched execution of the partition).

Queue depth is tuned second, at the chosen M: the virtual-time account
is depth-invariant by construction (bounded queues pace *real* threads,
not the event clock), so depth selection uses the real wall time of the
threaded run and keeps the smallest depth within ``wall_tolerance`` of
the best -- deeper queues only buy memory pressure.

Every trial is recorded in the result so benchmarks and serving stats
can show the tuning trajectory, not just the outcome.  M is chosen on
the virtual bubble, so it equals the reference's choice; the queue depth
is chosen on wall time, so it may not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.plan.partition import PartitionedPlan
from repro_torch.runtime.pipeline_exec import (
    FetchFn,
    PipelineReport,
    RunTileFn,
    StagePipelineExecutor,
    execute_partitioned_plan,
)


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    target_bubble: float = 0.10    # requested fill/drain bubble fraction
    # acceptance is one-sided: measured bubble <= target * (1 + tol)
    # (undershoot costs nothing; the walk still steps M down toward the
    # band so depth is not overspent)
    tolerance: float = 0.10
    m_min: int = 1
    m_max: int = 64
    max_trials: int = 12           # executor runs spent on the M walk
    queue_depths: Tuple[int, ...] = (2, 3, 4)
    wall_tolerance: float = 0.25   # depth must be within 25% of best wall


@dataclasses.dataclass
class AutotuneResult:
    n_microbatches: int
    queue_depth: int
    bubble_measured: float
    target_bubble: float
    within_tolerance: bool
    measured_fps: float
    analytic_m: int                # the GPipe seed the walk started from
    trials: List[dict]             # every (M, bubble, fps) evaluated
    depth_trials: List[dict]       # every (depth, wall_s) evaluated
    report: PipelineReport         # executor report at the chosen point

    def summary(self) -> dict:
        return {
            "n_microbatches": float(self.n_microbatches),
            "queue_depth": float(self.queue_depth),
            "bubble_measured": self.bubble_measured,
            "target_bubble": self.target_bubble,
            "within_tolerance": self.within_tolerance,
            "measured_fps": self.measured_fps,
            "analytic_m": float(self.analytic_m),
            "trials": self.trials,
            "depth_trials": self.depth_trials,
        }


def analytic_microbatches(n_stages: int, target_bubble: float) -> int:
    """Smallest M with the GPipe floor (K-1)/(M+K-1) <= target."""
    if n_stages <= 1 or target_bubble >= 1.0:
        return 1
    if target_bubble <= 0.0:
        raise ValueError("target_bubble must be positive")
    return max(1, math.ceil((n_stages - 1) * (1.0 - target_bubble)
                            / target_bubble))


@dataclasses.dataclass
class StagedDecodeTune:
    """Result of tuning the *overlapped staged decode* schedule: lane
    groups M (must divide the slot batch) and handoff queue depth."""

    n_groups: int
    queue_depth: int
    lanes: int
    bubble_measured: float          # executed bubble at the chosen point
    target_bubble: float
    within_tolerance: bool
    virtual_fps: float              # lane-group frames / virtual makespan
    trials: List[dict]              # every (m, bubble, fps) evaluated
    depth_trials: List[dict]
    report: PipelineReport

    def summary(self) -> dict:
        return {
            "n_groups": float(self.n_groups),
            "queue_depth": float(self.queue_depth),
            "lanes": float(self.lanes),
            "bubble_measured": self.bubble_measured,
            "target_bubble": self.target_bubble,
            "within_tolerance": self.within_tolerance,
            "virtual_fps": self.virtual_fps,
            "trials": self.trials,
            "depth_trials": self.depth_trials,
        }


def _probe_staged_decode(
    plan: PartitionedPlan, m: int, rounds: int, queue_depth: int
) -> PipelineReport:
    """One functional overlapped-decode block: R rounds of M lane-group
    frames with the real cross-round dependency chain (round r+1 of a
    group enters stage 0 at the virtual time round r drained), no model
    compute.  Measures the executed bubble the schedule actually
    achieves -- fill, imbalance, and the sampling round-trip included."""
    ex = StagePipelineExecutor(plan, queue_depth=queue_depth)
    session = ex.open_session()
    scale = 1.0 / m
    try:
        for g in range(m):
            session.put(g, ready_t=0.0, scale=scale, round_id=0)
        for i in range(rounds * m):
            frame, _payload, end_t = session.get()
            r, g = divmod(frame, m)
            if r + 1 < rounds:
                session.put(g, ready_t=end_t, scale=scale, round_id=r + 1)
    except BaseException:
        session.abort()
        raise
    return session.close()


def tune_staged_decode(
    plan: PartitionedPlan,
    lanes: int,
    cfg: AutotuneConfig = AutotuneConfig(),
    *,
    probe_rounds: int = 16,
) -> StagedDecodeTune:
    """Tune lane-group count M and queue depth for overlapped staged
    decode on ``plan`` with a ``lanes``-slot batch.

    Candidate M are the divisors of ``lanes`` (lane groups must tile the
    slot batch so per-group state slices stay static shapes).  Every
    candidate is probed with a functional overlapped block and the
    *executed* bubble decides, exactly like :func:`tune_pipeline`: the
    smallest M inside the one-sided tolerance band wins.  When no
    candidate reaches the band (an imbalance- or stall-dominated plan
    whose bubble floor no M can cross), the knee rule applies: the
    smallest M whose bubble is within a quarter of the observed spread
    of the best -- deeper lane splitting costs real dispatch overhead
    per frame, so it must buy measurable bubble to be worth it.  Queue
    depth is then picked by real wall time at the chosen M (virtual
    metrics are depth-invariant)."""
    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    hi_band = cfg.target_bubble * (1.0 + cfg.tolerance)
    divisors = [m for m in range(1, lanes + 1) if lanes % m == 0]
    divisors = [m for m in divisors if cfg.m_min <= m <= cfg.m_max] or [1]

    trials: List[dict] = []
    reps = {}
    best_m = None
    for m in divisors:
        rep = _probe_staged_decode(plan, m, probe_rounds, queue_depth=2)
        reps[m] = rep
        trials.append(
            {"m": m, "bubble": rep.bubble_measured,
             "fps": rep.measured_fps, "wall_s": rep.wall_s}
        )
        if rep.bubble_measured <= hi_band:
            # divisors ascend, so the first M inside the band is the
            # smallest -- stop before spending probes on deeper splits
            best_m = m
            break
    if best_m is None:
        # knee rule over the full probe set
        bubbles = {m: reps[m].bubble_measured for m in reps}
        b_min, b_max = min(bubbles.values()), max(bubbles.values())
        knee = b_min + 0.25 * (b_max - b_min)
        best_m = min(m for m, b in bubbles.items() if b <= knee)
    best_rep = reps[best_m]
    within = best_rep.bubble_measured <= hi_band

    depth_trials: List[dict] = []
    depths = sorted(set(cfg.queue_depths)) or [2]
    chosen_depth, chosen_rep = depths[0], None
    if depths == [2]:
        chosen_rep = best_rep
    else:
        drep = {}
        for d in depths:
            r = best_rep if d == 2 else _probe_staged_decode(
                plan, best_m, probe_rounds, queue_depth=d
            )
            drep[d] = r
            depth_trials.append({"depth": d, "wall_s": r.wall_s,
                                 "bubble": r.bubble_measured})
        best_wall = min(r.wall_s for r in drep.values())
        for d in depths:
            if drep[d].wall_s <= best_wall * (1.0 + cfg.wall_tolerance):
                chosen_depth, chosen_rep = d, drep[d]
                break
    assert chosen_rep is not None

    return StagedDecodeTune(
        n_groups=best_m,
        queue_depth=chosen_depth,
        lanes=lanes,
        bubble_measured=chosen_rep.bubble_measured,
        target_bubble=cfg.target_bubble,
        within_tolerance=within,
        virtual_fps=chosen_rep.measured_fps,
        trials=trials,
        depth_trials=depth_trials,
        report=chosen_rep,
    )


def tune_pipeline(
    plan: PartitionedPlan,
    cfg: AutotuneConfig = AutotuneConfig(),
    *,
    fetch: Optional[FetchFn] = None,
    run_tile: Optional[RunTileFn] = None,
    payloads_of: Optional[Callable[[int], Sequence[Any]]] = None,
) -> AutotuneResult:
    """Tune (M, queue depth) for ``plan`` against ``cfg.target_bubble``.

    ``payloads_of(M)`` supplies the microbatch payloads for a trial at
    depth M (defaults to ``range(M)`` -- the functional-validation mode
    the stream bench uses).
    """
    K = len(plan.stages)
    lo_band = cfg.target_bubble * (1.0 - cfg.tolerance)
    hi_band = cfg.target_bubble * (1.0 + cfg.tolerance)
    seen: dict = {}
    trials: List[dict] = []

    def run_m(m: int) -> PipelineReport:
        if m in seen:
            return seen[m]
        payloads = list(payloads_of(m)) if payloads_of else list(range(m))
        # depth pinned explicitly: the depth-tuning loop reuses these
        # reports as the depth-2 trials
        rep = execute_partitioned_plan(
            plan, n_microbatches=m, fetch=fetch, run_tile=run_tile,
            payloads=payloads, queue_depth=2,
        )
        seen[m] = rep
        trials.append(
            {"m": m, "bubble": rep.bubble_measured,
             "fps": rep.measured_fps, "wall_s": rep.wall_s}
        )
        return rep

    m = min(max(analytic_microbatches(K, cfg.target_bubble), cfg.m_min),
            cfg.m_max)
    analytic_m = m
    best_m, best_rep, best_err = None, None, math.inf

    rep = run_m(m)
    while True:
        b = rep.bubble_measured
        err = abs(b - cfg.target_bubble)
        if err < best_err or (err == best_err and (best_m is None or m < best_m)):
            best_m, best_rep, best_err = m, rep, err
        if lo_band <= b <= hi_band:
            break
        if len(trials) >= cfg.max_trials:
            break
        if b > hi_band:
            # too much fill cost: deepen the burst (bubble ~ (K-1)/(M+K-1),
            # so jump to the M that analytic scaling predicts, minimum +1)
            if m >= cfg.m_max:
                break
            nxt = max(m + 1, math.ceil((m + K - 1) * b / cfg.target_bubble)
                      - (K - 1))
            m = min(nxt, cfg.m_max)
        else:
            # bubble below band: a shallower burst frees latency/memory
            if m <= cfg.m_min:
                break
            m = max(m - 1, cfg.m_min)
        if m in seen:
            break
        rep = run_m(m)

    assert best_m is not None and best_rep is not None
    # the band may be unreachable on the discrete M grid (or capped by
    # m_min/m_max), so "within tolerance" is one-sided: the executed
    # bubble must not exceed the band's upper edge (undershoot is free)
    within = best_rep.bubble_measured <= hi_band

    # queue depth: virtual metrics are depth-invariant, so pick the
    # smallest configured depth whose real wall time is within tolerance
    # of the best.  The M walk already executed at depth 2, so that
    # configuration is reused rather than re-run.
    depth_trials: List[dict] = []
    depths = sorted(set(cfg.queue_depths)) or [2]
    chosen_depth = depths[0]
    chosen_rep = best_rep if depths[0] == 2 else None
    if depths != [2]:
        reps = {}
        for d in depths:
            if d == 2:
                r = best_rep
            else:
                payloads = (
                    list(payloads_of(best_m)) if payloads_of
                    else list(range(best_m))
                )
                r = execute_partitioned_plan(
                    plan, n_microbatches=best_m, fetch=fetch,
                    run_tile=run_tile, payloads=payloads, queue_depth=d,
                )
            reps[d] = r
            depth_trials.append({"depth": d, "wall_s": r.wall_s,
                                 "bubble": r.bubble_measured})
        best_wall = min(r.wall_s for r in reps.values())
        for d in depths:
            if reps[d].wall_s <= best_wall * (1.0 + cfg.wall_tolerance):
                chosen_depth = d
                chosen_rep = reps[d]
                break
    assert chosen_rep is not None

    return AutotuneResult(
        n_microbatches=best_m,
        queue_depth=chosen_depth,
        bubble_measured=chosen_rep.bubble_measured,
        target_bubble=cfg.target_bubble,
        within_tolerance=within,
        measured_fps=chosen_rep.measured_fps,
        analytic_m=analytic_m,
        trials=trials,
        depth_trials=depth_trials,
        report=chosen_rep,
    )
