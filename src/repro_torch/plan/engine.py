"""Vectorized event-indexed engine for window-assignment simulation.

The reference simulator (``core.scheduler.simulate``) replays the whole
event queue for every candidate schedule and answers each memory query
with an O(n) masked sum, making the adaptive phase ~O(n^3) on
ResNet-50-scale tile lists.  This engine produces *bit-identical*
timelines while cutting the planner's hot path to near O(changed-tiles
* log n) per candidate:

- **prefix-sum memory account**: release edges retire in tile order, so
  bytes freed after the first k executions is a static prefix sum
  (``rel_cum``, built once with numpy).  Allocation edges arrive in
  channel order with non-decreasing issue times, and every memory query
  the simulation makes happens at ``t >= channel_free`` -- *after* all
  issued loads -- so the allocation side collapses to one running
  ``issued_bytes`` scalar.  All byte quantities are integers, so
  regrouping the sums is exact: no float drift versus the reference's
  masked sum.

- **closed-form earliest-fit**: with the allocation side constant over
  a query, residency at successive release times is *monotone
  decreasing*, so "earliest release time with room for ``need`` bytes"
  is a single ``bisect`` over the release prefix-sum -- the interval
  index over the residency timeline.  (A segment tree is unnecessary:
  the monotone account makes the interval query a binary search.)  The
  returned time is identical to the reference's linear release scan,
  including release-time ties, because tied releases share one
  timestamp.

- **suffix re-simulation**: the adaptive phase relocates one tile's load
  into an earlier window.  In the serialized load queue (sorted by
  ``(window, tile)``) every entry before the relocated load's new
  position is untouched, so a trial restores the engine state snapshot
  taken just before that queue position and replays only the suffix.
  Scratch buffers are patched back slice-wise from the committed state
  (only the ranges the previous trial dirtied), so a trial costs
  O(suffix), not O(n).

- **dominance abort**: a trial whose replay state is pointwise no
  earlier than the committed state -- aligned issued-load set, scalars
  ``>=`` the committed snapshot, and no live event time earlier than
  the committed one -- can only finish with a makespan (and therefore a
  total stall) ``>=`` the committed total, so it is terminated
  immediately as a reject (the planner's acceptance test
  ``trial < best`` fails either way).  Most rejected relocations
  trip this a few events past the *old* queue position of the moved
  load, so their cost is O(queue distance moved), not O(n).

- **monotone-stall early abort**: per-tile stalls are non-negative and
  accumulate left-to-right, so a trial whose partial stall already
  reaches the incumbent's can never be accepted and is abandoned
  mid-replay.  Rejected-trial outcomes are unaffected (both paths
  reject), keeping the planner's decision sequence identical to the
  reference.

Determinism note: event processing order, tie-breaks, and every float
operation mirror the reference implementation exactly; the only changes
are query data structures and replay extent.  Every comparison the
closed-form earliest-fit answers is between exact integer-valued
doubles, so it is equivalence, not approximation.  ``tests/test_plan.py``
asserts equality against the reference on randomized tile sets and
randomized window assignments.
"""
from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left, bisect_right
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.plan.ir import Timeline

_NEG_INF = -math.inf


def _empty_timeline() -> Timeline:
    z = np.zeros(0, np.float64)
    return Timeline(z, z, z, z, False)


@dataclasses.dataclass
class SimState:
    """A completed full simulation plus the snapshots needed to resume."""

    windows: List[int]
    queue: List[int]                   # tile ids in channel (issue) order
    queue_keys: List[Tuple[int, int]]  # (window, tile) sorted keys
    qpos_of: List[int]                 # tile id -> queue position
    feasible: bool
    total_stall: float
    # per-tile timelines (valid only when feasible)
    load_start: List[float]
    load_end: List[float]
    exec_start: List[float]
    exec_end: List[float]
    # stall_cum[i] = left-to-right sum of stalls of executions [0, i)
    stall_cum: List[float]
    # snaps[q] = (channel_free, prev_exec_end, i_exec, issued_bytes)
    # just before issuing queue position q
    snaps: List[Tuple[float, float, int, float]]
    # last_read_q[i] = last queue position whose load opens on window i
    # (-1 if none): liveness bound for early-exec divergences, computed
    # lazily by PlanEngine.try_relocation
    last_read_q: Optional[List[int]] = None
    # win_readers[w] = queue positions whose load opens on window w,
    # computed lazily by PlanEngine.try_relocation
    win_readers: Optional[List[List[int]]] = None

    def timeline(self) -> Timeline:
        if not self.feasible:
            return _empty_timeline()
        return Timeline(
            load_start=np.asarray(self.load_start, np.float64),
            load_end=np.asarray(self.load_end, np.float64),
            exec_start=np.asarray(self.exec_start, np.float64),
            exec_end=np.asarray(self.exec_end, np.float64),
            feasible=True,
        )

    def stalls(self) -> List[float]:
        """Per-execution stall via successive differences of the running
        sum -- used for search-tile selection, where tiny rounding in a
        difference cannot change any decision (acceptance always uses
        the exact totals)."""
        cum = self.stall_cum
        return [cum[i + 1] - cum[i] for i in range(len(cum) - 1)]


class PlanEngine:
    """Event engine over one costed tile sequence and capacity."""

    def __init__(
        self,
        load_s: Sequence[float],
        exec_s: Sequence[float],
        mem_bytes: Sequence[int],
        capacity: int,
        preload_first: bool = True,
    ):
        self.n = len(load_s)
        self.load_s = [float(v) for v in load_s]
        self.exec_s = [float(v) for v in exec_s]
        self.mem = [float(v) for v in mem_bytes]
        self.capacity = capacity
        self.preload_first = preload_first
        # releases retire in tile order: bytes released after the first k
        # executions is a static prefix sum (numpy cumsum is exact here:
        # integer-valued doubles)
        rel = np.zeros(self.n + 1, np.float64)
        np.cumsum(np.asarray(self.mem, np.float64), out=rel[1:])
        self.rel_cum: List[float] = rel.tolist()
        # exec_cum[t] = sum of exec_s[:t] (chain-bound critical path)
        ec = np.zeros(self.n + 1, np.float64)
        np.cumsum(np.asarray(self.exec_s, np.float64), out=ec[1:])
        self.exec_cum: List[float] = ec.tolist()
        self.any_oversized = any(m > capacity for m in self.mem)
        # trial scratch, patched from the committed state between trials
        n = self.n
        self._s_le: List[float] = [0.0] * n
        self._s_es: List[float] = [0.0] * n
        self._s_ee: List[float] = [0.0] * n
        self._scratch_of: Optional[SimState] = None
        self._dirty_exec: Tuple[int, int] = (0, 0)
        self._dirty_loads: List[int] = []
        # critical-path scan state for one (committed state, tile) scan
        self._scan_base: Optional[SimState] = None
        self._scan_j: int = -1
        self._scan_D: List[float] = []
        self._scan_abs: List[float] = []
        self._scan_nofit: int = -1
        self._scan_margin: float = 0.0
        self._load_sum = float(np.sum(np.asarray(self.load_s, np.float64)))

    # ---- residency queries ---------------------------------------------

    def _earliest_fit(
        self, t0: float, need: float, issued: float, ne: int, ee: List[float]
    ) -> Optional[float]:
        """Earliest t >= t0 with room for ``need`` bytes.

        ``issued`` is the byte total of every load issued so far.  All
        queries happen at ``t >= channel_free`` >= every allocation edge,
        so residency(t) = issued - rel_cum[#releases <= t]; it only drops
        at release times, monotonically, which turns the earliest-fit
        interval query into two binary searches.
        """
        rel_cum = self.rel_cum
        if issued - rel_cum[bisect_right(ee, t0, 0, ne)] + need <= self.capacity:
            return t0
        # first release index idx (in (r0, ne]) freeing enough; ties on
        # the release timestamp share the time value, so returning
        # ee[idx-1] matches the reference's scan over distinct times
        idx = bisect_left(
            rel_cum,
            issued + need - self.capacity,
            bisect_right(ee, t0, 0, ne) + 1,
            ne + 1,
        )
        if idx > ne:
            return None
        return ee[idx - 1]

    # ---- full simulation (with resume snapshots) ----------------------

    def simulate(self, windows: Sequence[int]) -> SimState:
        n = self.n
        windows = list(windows)
        if self.preload_first and n:
            windows[0] = -1
        for j, w in enumerate(windows):
            if not (-1 <= w < j):
                raise ValueError(f"window[{j}]={w} must be in [-1, {j-1}]")

        queue = sorted(range(n), key=lambda j: (windows[j], j))
        queue_keys = [(windows[j], j) for j in queue]
        qpos_of = [0] * n
        for pos, j in enumerate(queue):
            qpos_of[j] = pos

        state = SimState(
            windows=windows,
            queue=queue,
            queue_keys=queue_keys,
            qpos_of=qpos_of,
            feasible=True,
            total_stall=0.0,
            load_start=[math.nan] * n,
            load_end=[math.nan] * n,
            exec_start=[math.nan] * n,
            exec_end=[math.nan] * n,
            stall_cum=[0.0] * (n + 1),
            snaps=[(0.0, 0.0, 0, 0.0)] * n,
        )
        if n == 0:
            return state
        if self.any_oversized:
            state.feasible = False
            return state

        load_s, exec_s, mem = self.load_s, self.exec_s, self.mem
        ls, le = state.load_start, state.load_end
        es, ee = state.exec_start, state.exec_end
        stall_cum, snaps = state.stall_cum, state.snaps
        loaded = [False] * n

        channel_free = _NEG_INF
        prev_exec_end = 0.0
        stall_acc = 0.0
        issued = 0.0
        i_exec = 0
        qpos = 0

        while i_exec < n:
            if loaded[i_exec]:
                le_i = le[i_exec]
                start = prev_exec_end if prev_exec_end >= le_i else le_i
                s = start - prev_exec_end
                if s > 0.0:
                    stall_acc += s
                es[i_exec] = start
                end = start + exec_s[i_exec]
                ee[i_exec] = end
                prev_exec_end = end
                i_exec += 1
                stall_cum[i_exec] = stall_acc
                continue
            if qpos >= n:
                state.feasible = False
                return state
            snaps[qpos] = (channel_free, prev_exec_end, i_exec, issued)
            j = queue[qpos]
            w = windows[j]
            if w == -1:
                open_t = -load_s[j]
            elif w < i_exec:
                open_t = es[w]
            else:
                # window tile has not executed: its load is queued behind
                # this one => deadlock
                state.feasible = False
                return state
            t0 = open_t if open_t >= channel_free else channel_free
            t_issue = self._earliest_fit(t0, mem[j], issued, i_exec, ee)
            if t_issue is None:
                state.feasible = False
                return state
            ls[j] = t_issue
            le[j] = t_issue + load_s[j]
            channel_free = le[j]
            loaded[j] = True
            issued += mem[j]
            qpos += 1

        state.total_stall = stall_acc
        return state

    # ---- critical-path index -------------------------------------------

    def _scan_build(self, base: SimState, j: int, p_old: int) -> None:
        """Longest constraint path from every issue node to ``ee[j-1]``.

        The committed event system is a max-plus DAG; its constraint
        edges also hold in any relocation trial of tile *j* (with event
        times pointwise >= committed), so longest paths computed here
        lower-bound the trial's timing.  Edges:

        - channel:    issue(q) --l(x_q)--> issue(q')   (next queue slot;
                      position p_old -- tile j's old load -- is skipped,
                      it no longer sits between its neighbours)
        - load->exec: issue(q) --l(x_q)--> es(x_q)
        - exec chain: es(i)    --e(i)-->   es(i+1)
        - window:     es(w)    --0-->      issue(q), q reading window w
        - memory fit: es(r)    --e(r)-->   issue(q), where release r is
                      the first leaving room for x_q's bytes given the
                      trial's byte account (displaced positions carry
                      j's bytes as extra residency)

        Positions whose load can never fit alongside j's bytes make any
        trial displacing them infeasible; ``_scan_nofit`` records the
        largest such position.
        """
        n = self.n
        load_s, exec_s, mem = self.load_s, self.exec_s, self.mem
        rel_cum, capacity = self.rel_cum, self.capacity
        queue = base.queue
        snaps = base.snaps
        ls_of = base.load_start     # issue time by tile
        es_b = base.exec_start
        if base.win_readers is None:
            wr: List[List[int]] = [[] for _ in range(n)]
            for q, x in enumerate(queue):
                w = base.windows[x]
                if w >= 0:
                    wr[w].append(q)
            base.win_readers = wr
        win_readers = base.win_readers

        mem_j = mem[j]
        fit_readers: List[List[int]] = [[] for _ in range(n)]
        fit_rel_t: List[float] = [_NEG_INF] * (p_old + 1)
        q_nofit = -1
        for q in range(n):
            if q == p_old:
                continue
            x = queue[q]
            target = snaps[q][3] + mem[x] - capacity
            if q < p_old:
                target += mem_j
            if target <= 0.0:
                continue
            idx = bisect_left(rel_cum, target, 1, n + 1)
            if idx > n:
                if q < p_old and q > q_nofit:
                    q_nofit = q
            else:
                fit_readers[idx - 1].append(q)
                if q < p_old:
                    # absolute anchor: with j's bytes resident, this
                    # displaced load cannot issue before the committed
                    # time of its binding release
                    fit_rel_t[q] = base.exec_end[idx - 1]

        D_i = [_NEG_INF] * n        # issue nodes, by queue position
        D_e = [_NEG_INF] * (n + 1)  # exec-start nodes, by tile index
        # reverse-topological sweep: two sorted node families merged by
        # committed event time, descending.  At ties the issue node goes
        # first so a window-bound load (t_issue == es of its window, the
        # common base pattern) keeps its window edge; the opposite tie
        # (issue == exec-start of the same tile) needs a zero-duration
        # load and merely under-estimates -- the bound stays sound.
        qi = n - 1
        ei = n - 1
        while qi >= 0 or ei >= 0:
            t_q = ls_of[queue[qi]] if qi >= 0 else _NEG_INF
            if ei >= 0 and (qi < 0 or es_b[ei] > t_q):
                i = ei
                if i == j - 1:
                    d = exec_s[i]           # the probe: ee[j-1] itself
                else:
                    d = _NEG_INF
                    dn = D_e[i + 1]
                    if dn > _NEG_INF:
                        d = exec_s[i] + dn
                for q in win_readers[i]:
                    if q != p_old and D_i[q] > d:
                        d = D_i[q]
                for q in fit_readers[i]:
                    dq = D_i[q]
                    if dq > _NEG_INF and exec_s[i] + dq > d:
                        d = exec_s[i] + dq
                D_e[i] = d
                ei -= 1
            else:
                q = qi
                if q == p_old:
                    qi -= 1
                    continue                # skipped: D_i stays -inf
                x = queue[q]
                lw = load_s[x]
                d = _NEG_INF
                qn = q + 1 if q + 1 != p_old else q + 2
                if qn < n:
                    dn = D_i[qn]
                    if dn > _NEG_INF:
                        d = lw + dn
                de = D_e[x]
                if de > _NEG_INF and lw + de > d:
                    d = lw + de
                D_i[q] = d
                qi -= 1

        # suffix max of the absolute (le_j-independent) fit anchors:
        # displaced position q' >= p forces ee[j-1] >= release time +
        # LP(issue(q') -> ee[j-1]) whatever the relocated load's timing
        asuf = [_NEG_INF] * (p_old + 1)
        best = _NEG_INF
        for q in range(p_old - 1, -1, -1):
            ft = fit_rel_t[q]
            if ft > _NEG_INF and D_i[q] > _NEG_INF and ft + D_i[q] > best:
                best = ft + D_i[q]
            asuf[q] = best

        self._scan_base = base
        self._scan_j = j
        self._scan_D = D_i
        self._scan_abs = asuf
        self._scan_nofit = q_nofit
        # conservative float-error margin: LP regroups sums the replay
        # would do sequentially; discount worst-case accumulation error
        self._scan_margin = 1e-11 * (
            self._load_sum + self.exec_cum[-1] + abs(base.exec_end[-1])
        )

    # ---- suffix re-simulation ------------------------------------------

    def _sync_scratch(self, base: SimState) -> None:
        if self._scratch_of is not base:
            # new committed state: refresh the whole scratch
            self._s_le[:] = base.load_end
            self._s_es[:] = base.exec_start
            self._s_ee[:] = base.exec_end
            self._scratch_of = base
        else:
            # patch back only what the previous trial overwrote
            e0, e1 = self._dirty_exec
            if e1 > e0:
                self._s_es[e0:e1] = base.exec_start[e0:e1]
                self._s_ee[e0:e1] = base.exec_end[e0:e1]
            for x in self._dirty_loads:
                self._s_le[x] = base.load_end[x]
        self._dirty_exec = (0, 0)
        self._dirty_loads = []

    def try_relocation(
        self, base: SimState, j: int, new_window: int, abort_stall: float
    ) -> Tuple[bool, float, float]:
        """Re-simulate ``base`` with tile j's load moved to ``new_window``.

        Replays only the queue suffix from the relocated load's new
        position.  The trial is abandoned as soon as either

        (a) its accumulated stall reaches ``abort_stall`` (it could no
            longer be accepted), or
        (b) it is *dominated* by the committed state: at an aligned
            queue position (both sides have issued the same load set)
            with no live event earlier than the committed one, every
            remaining trial event is pointwise >= the committed event,
            so the trial's final makespan -- and therefore its total
            stall (makespan minus the fixed execution sum) -- is >= the
            committed total and the acceptance test must fail.

        For (b) the replay tracks *early* divergences only: a load end
        earlier than committed is live until its tile executes (the exec
        start consumes it), an exec time earlier than committed is live
        forever (window opens and release queries read it).  Equal or
        later event times preserve dominance by the monotonicity of
        ``max``, ``+``, and the release account.  Most rejected
        relocations therefore cost O(queue distance moved), not O(n).

        Returns (acceptable, total_stall, stall_of_j); on abort,
        dominance, or infeasibility, (False, inf, inf).
        """
        n = self.n
        p = bisect_left(base.queue_keys, (new_window, j))
        p_old = base.qpos_of[j]
        channel_free, prev_exec_end, i_exec, issued = base.snaps[p]
        i_exec0 = i_exec
        stall_acc = base.stall_cum[i_exec]
        stall_j = math.inf
        load_s, exec_s, mem = self.load_s, self.exec_s, self.mem
        rel_cum, capacity = self.rel_cum, self.capacity
        base_le, base_es, base_ee = base.load_end, base.exec_start, base.exec_end

        # ---- step 0 against committed state: tile j's relocated load --
        # Nothing is replayed yet, so the issue time of the moved load is
        # computable exactly from the committed arrays in O(log n).
        if new_window == -1:
            open_t = -load_s[j]
        elif new_window < i_exec:
            open_t = base_es[new_window]
        else:
            return False, math.inf, math.inf    # window not executed yet
        t0 = open_t if open_t >= channel_free else channel_free
        mem_j = mem[j]
        r0 = bisect_right(base_ee, t0, 0, i_exec)
        if issued - rel_cum[r0] + mem_j <= capacity:
            t_issue_j = t0
        else:
            idx = bisect_left(
                rel_cum, issued + mem_j - capacity, r0 + 1, i_exec + 1
            )
            if idx > i_exec:
                return False, math.inf, math.inf
            t_issue_j = base_ee[idx - 1]
        le_j = t_issue_j + load_s[j]
        if le_j >= base_le[j]:
            # the relocated load cannot finish earlier than committed, so
            # tile j's execution -- and by the dominance induction every
            # other event -- is >= the committed one: never accepted
            return False, math.inf, math.inf

        # ---- critical-path reject (zero replay) ------------------------
        # A relocation inserts j's load at queue position p, so the
        # trial adds one constraint to the committed event system: the
        # load at position p starts no earlier than le_j.  All committed
        # constraint edges (serial channel, load->exec, serial exec
        # chain, window opens, memory fits) still hold in the trial with
        # event times pointwise >= committed, so the longest constraint
        # path from position p's issue node to ee[j-1] lower-bounds the
        # trial's exec chain into j:
        #
        #     ee_t[j-1] >= le_j + LP(issue(p) -> ee[j-1])
        #
        # If that already reaches the committed exec start of j, tile
        # j's execution cannot improve and (by the dominance induction)
        # neither can the total: the trial is rejected without replaying
        # anything.  LP over all positions is one O(n log n) backward
        # pass per (committed state, tile) scan; each candidate window
        # then costs O(1).  This is the payoff of the event-indexed
        # engine: the planner's scan queries an index instead of
        # replaying the timeline.
        if self._scan_base is not base or self._scan_j != j:
            self._scan_build(base, j, p_old)
        if p < p_old:
            if p <= self._scan_nofit:
                return False, math.inf, math.inf    # can never fit with j
            margin = self._scan_margin
            d = self._scan_D[p]
            if (
                d > _NEG_INF
                and le_j + d - margin >= base_es[j]
            ):
                return False, math.inf, math.inf
            if self._scan_abs[p] - margin >= base_es[j]:
                return False, math.inf, math.inf

        self._sync_scratch(base)
        le, es, ee = self._s_le, self._s_es, self._s_ee
        dirty_loads = self._dirty_loads

        qpos_of = base.qpos_of

        # trial queue = base queue with j's load moved from p_old to p;
        # resolved lazily so a short replay never pays O(n) setup.  A
        # tile's *trial* queue position is derived from its base
        # position (entries in [p, p_old) shift one slot later), so the
        # loaded test needs no per-trial structure at all.
        base_windows = base.windows
        base_queue = base.queue
        base_snaps = base.snaps

        # early-divergence liveness: a load end earlier than committed is
        # live until its tile executes; an exec earlier than committed is
        # live until (a) no future load opens on its window and (b) the
        # committed channel frontier has passed its committed release
        # time (then both sides count the release identically in every
        # future memory query)
        if base.last_read_q is None:
            lr = [-1] * n
            for pos, x in enumerate(base_queue):
                w = base_windows[x]
                if w >= 0:
                    lr[w] = pos
            base.last_read_q = lr
        last_read_q = base.last_read_q
        early_exec: set = set()   # execs earlier than committed, maybe live
        early_le: set = set()     # loads ending earlier, not yet executed

        qfront = p                # p + qidx: trial channel frontier
        feasible = True
        while i_exec < n:
            q_i = qpos_of[i_exec]
            if (q_i + 1 if p <= q_i < p_old else (p if i_exec == j else q_i)) < qfront:
                le_i = le[i_exec]
                start = prev_exec_end if prev_exec_end >= le_i else le_i
                s = start - prev_exec_end
                if s > 0.0:
                    stall_acc += s
                if i_exec == j:
                    stall_j = s if s > 0.0 else 0.0
                if stall_acc >= abort_stall:
                    feasible = False
                    break
                end = start + exec_s[i_exec]
                # start < committed start iff end < committed end: both
                # add the same exec_s with the same rounding
                if start < base_es[i_exec]:
                    early_exec.add(i_exec)
                if early_le:
                    early_le.discard(i_exec)
                es[i_exec] = start
                ee[i_exec] = end
                prev_exec_end = end
                i_exec += 1
                continue
            if qfront > p_old and qfront < n and not early_le:
                sc, sp, si, sb = base_snaps[qfront]
                if (
                    channel_free >= sc
                    and prev_exec_end >= sp
                    and i_exec == si
                    and issued == sb
                ):
                    for i in early_exec:
                        if last_read_q[i] >= qfront or base_ee[i] > sc:
                            break
                    else:
                        # every early divergence is dead and every
                        # remaining event is >= the committed one: total
                        # stall >= committed total, reject now
                        feasible = False
                        break
            if qfront >= n:
                feasible = False
                break
            if qfront == p:
                x = j
                w = new_window
            else:
                qa = qfront - 1
                x = base_queue[qa] if qa < p_old else base_queue[qa + 1]
                w = base_windows[x]
            if w == -1:
                open_t = -load_s[x]
            elif w < i_exec:
                open_t = es[w]
            else:
                feasible = False
                break
            t0 = open_t if open_t >= channel_free else channel_free
            # inlined earliest-fit over the release prefix-sum
            mem_x = mem[x]
            r0 = bisect_right(ee, t0, 0, i_exec)
            if issued - rel_cum[r0] + mem_x <= capacity:
                t_issue = t0
            else:
                idx = bisect_left(
                    rel_cum, issued + mem_x - capacity, r0 + 1, i_exec + 1
                )
                if idx > i_exec:
                    feasible = False
                    break
                t_issue = ee[idx - 1]
            le_x = t_issue + load_s[x]
            le[x] = le_x
            dirty_loads.append(x)
            if le_x < base_le[x]:
                early_le.add(x)
            channel_free = le_x
            issued += mem_x
            qfront += 1

        self._dirty_exec = (i_exec0, i_exec)
        if not feasible:
            return False, math.inf, math.inf
        return True, stall_acc, stall_j
    # NOTE: ``stall_j`` above is exact because tile j's execution always
    # lies inside the replayed suffix: at the snapshot its load is not yet
    # issued, so its execution cannot have been scheduled.  The dominance
    # abort never fires while tile j's relocated (usually earlier) load
    # end is live, so a trial that actually improves j runs to completion
    # and reports its exact stall.
