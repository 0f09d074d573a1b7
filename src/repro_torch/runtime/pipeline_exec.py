"""Stage-parallel multi-PU streaming runtime: run a PartitionedPlan
(counterpart of ``repro.runtime.pipeline_exec``).

``repro_torch.plan.partition`` produces a :class:`PartitionedPlan` -- K
contiguous layer ranges, each with its own two-phase weight-streaming
schedule on its own PU.  :class:`StagePipelineExecutor` makes the plan a
runnable artifact:

- **One thread per stage**, each paired with its own *prefetch worker*
  that drains the stage plan's load-channel issue order through a
  :class:`repro_torch.core.streaming.StageStreamCore` (capacity-gated, so
  the residency bound the plan was verified against is enforced at
  runtime).
- **Double-buffered handoff queues** between stages carry activation
  payloads; a bounded queue (default depth 2) gives the ping-pong
  buffering of the hardware proposal and applies backpressure to
  upstream stages.
- **Microbatch injection**: the caller feeds M microbatches; the
  pipeline fills, streams, and drains (the GPipe schedule), and the
  ``bubble_fraction`` model cross-checks the *measured* fill/drain
  bubble against the analytic prediction.
- **Real stage compute** (``run_stage``): with a per-stage callback the
  handoff queues carry live ``(B, 1, d_model)`` hidden-state tensors --
  each stage folds its model-layer slice over the inbound activations
  (``runtime.stage_decode`` wires ``ModelAPI.decode_stage`` here).

On the card (``stage_devices``) each stage thread queues its work on a
CUDA stream of its own on its stage's device.  A frame carries the event
its producer recorded after its work; the consuming stage waits on it on
its own stream and then places the payload on its device (``.to(dev,
non_blocking=True)``, a no-op where the stages share the device) -- the
counterpart of the reference's ``jax.device_put`` onto the consuming
stage's submesh.  The caller's stream waits on a drained frame's event
in :meth:`PipelineSession.get`, and a frame put in waits on the caller's
stream, so the caller reads and writes payloads in stream order.

Timing: throughput is accounted in *virtual time* derived from the
executed event stream -- each stage advances its clock by its
plan-derived stage time as it actually executes each frame, and
handoffs carry the producer's virtual finish time.  By construction
these event times reproduce the ``PartitionedPlan.pipeline_events``
recurrence (the virtual fields of a :class:`PipelineReport` equal the
reference's); what keeps the account honest is the runtime structure
around it: the *bounded* handoff queues mean a secretly serialized
schedule (a stage waiting for its upstream to finish all frames)
deadlocks for M > queue depth + 1 instead of reporting good numbers, a
stalled prefetch worker trips the acquire timeout, and
ordering/residency are asserted per fetch.  Real wall time and
``max_concurrent_stages`` -- the observed high-water mark of stages
simultaneously mid-frame, 1 if stages never actually overlap -- are
reported alongside as concurrency diagnostics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.analysis import sanitize
from repro_torch.core.streaming import StageStreamCore
from repro_torch.plan.partition import PartitionedPlan, StagePlan


# fetch(stage, tile_index, tile_name) -> weights
FetchFn = Callable[[int, int, str], Any]
# run_tile(stage, tile_index, weights, carry) -> carry
RunTileFn = Callable[[int, int, Any, Any], Any]
# run_stage(stage, carry) -> carry: one real compute step over the whole
# stage (e.g. a layer-sliced decode_stage on device); applied after the
# tile acquire/release loop so the streaming/residency account still runs
RunStageFn = Callable[[int, Any], Any]


def place(payload, dev: torch.device, stream):
    """Every tensor of ``payload`` (nested tuples, lists, dicts) on
    ``dev``, for the work ``stream`` queues next (``None`` off the card).
    A CUDA tensor is first recorded as in use by that stream (by the
    source device's current stream, which runs a copy across devices), so
    the producer's allocator keeps its block until it has been read."""
    if isinstance(payload, torch.Tensor):
        if stream is not None and payload.is_cuda:
            payload.record_stream(
                stream if payload.device == dev
                else torch.cuda.current_stream(payload.device)
            )
        return payload.to(dev, non_blocking=True)
    if isinstance(payload, (tuple, list)):
        return type(payload)(place(p, dev, stream) for p in payload)
    if isinstance(payload, dict):
        return {k: place(v, dev, stream) for k, v in payload.items()}
    return payload


def _recorded(stream) -> Optional["torch.cuda.Event"]:
    """An event recorded on ``stream`` now (``None`` off the card)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


@dataclasses.dataclass
class StageTrace:
    """Executed-event account of one stage."""

    stage: int
    pu: str
    frames: int = 0
    fetches: int = 0
    peak_resident_bytes: int = 0
    busy_s: float = 0.0            # virtual occupancy (stage_s per frame)
    stall_s: float = 0.0           # weight-streaming stalls (from the plan)
    handoff_s: float = 0.0         # inbound activation transfer charged
    starve_s: float = 0.0          # waited on upstream after first frame
    first_start_t: float = 0.0
    last_end_t: float = 0.0
    fetch_orders: List[List[str]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PipelineReport:
    """Result of one microbatched run through the stage pipeline."""

    n_stages: int
    n_microbatches: int
    outputs: List[Any]
    frame_done_t: List[float]      # virtual completion time per frame
    makespan_s: float              # virtual
    measured_fps: float            # M / makespan (virtual)
    predicted_makespan_s: float    # PartitionedPlan.pipeline_makespan(M)
    predicted_fps: float
    steady_fps: float              # analytic 1/bottleneck (no fill)
    bubble_measured: float
    bubble_predicted: float        # GPipe (K-1)/(M+K-1)
    wall_s: float                  # real wall time of the threaded run
    max_concurrent_stages: int     # observed stages simultaneously mid-frame
    stages: List[StageTrace]
    # True when a run_stage callback executed real per-frame compute (the
    # handoff queues carried live activations, not functional stand-ins)
    real_stage_compute: bool = False

    def summary(self) -> Dict[str, float]:
        return {
            "stages": float(self.n_stages),
            "microbatches": float(self.n_microbatches),
            "makespan_s": self.makespan_s,
            "measured_fps": self.measured_fps,
            "predicted_fps": self.predicted_fps,
            "steady_fps": self.steady_fps,
            "bubble_measured": self.bubble_measured,
            "bubble_predicted": self.bubble_predicted,
            "wall_s": self.wall_s,
            "max_concurrent_stages": float(self.max_concurrent_stages),
            "fetches": float(sum(s.fetches for s in self.stages)),
            "stall_s": float(sum(s.stall_s for s in self.stages)),
        }


def _stage_tile_names(k: int, stage: StagePlan) -> List[str]:
    if stage.tile_names:
        return list(stage.tile_names)
    return [f"s{k}/t{i}" for i in range(stage.plan.n)]


# marker a failed stage pushes downstream so a consumer blocked on the
# drain queue wakes immediately instead of waiting out the stall timeout
_FAILED = object()


class PipelineSession:
    """A persistent in-flight frame loop over the stage threads.

    :meth:`StagePipelineExecutor.run` opens the pipeline, pushes a fixed
    batch of M microbatches, and drains it to completion.  Overlapped
    staged decode needs a different contract: frames are injected *as
    their dependencies drain* (round r+1 of a lane group may only enter
    stage 0 once round r of the same group left the last stage -- its
    logits feed the token the next round consumes), and the pipeline
    must stay open across rounds so the fill bubble is paid once per
    decode block, not once per round.  A session keeps the K stage
    threads (and their prefetch workers) alive between ``put``/``get``
    calls; ``close()`` joins them and yields the :class:`PipelineReport`.

    Frames carry ``(scale, round_id)`` alongside the payload: ``scale``
    prorates the virtual stage/handoff/stall account for lane-group
    microbatches carrying ``1/M`` of the slot batch, and ``round_id``
    lets each stage run its weight-streaming tile loop once per round
    (lane groups of the same round reuse the resident weights).

    The drain queue is unbounded: the owner consumes frames between
    puts, and a bounded drain could deadlock the owner's blocking
    ``put`` against a full pipeline.

    On the card a frame also carries the event that orders its payload:
    ``put`` records one on the caller's current stream (or takes
    ``ready_event``), and ``get`` makes the caller's current stream wait
    on the last stage's.
    """

    def __init__(
        self, ex: "StagePipelineExecutor", queue_depth: Optional[int] = None
    ):
        self.ex = ex
        K = len(ex.plan.stages)
        depth = ex.queue_depth if queue_depth is None else queue_depth
        self.qs: List["queue.Queue"] = [
            queue.Queue(maxsize=depth) for _ in range(K)
        ]
        self.qs.append(queue.Queue())          # unbounded drain
        self.traces = [
            StageTrace(stage=k, pu=s.pu.name)
            for k, s in enumerate(ex.plan.stages)
        ]
        self.errors: List[BaseException] = []
        self._frames_in = 0
        self._done_t: Dict[int, float] = {}
        self._wall = 0.0
        self._closed = False
        with ex._active_lock:
            ex._active = 0
            ex._max_active = 0
            ex._live_cores.clear()
        self.threads = [
            threading.Thread(
                target=ex._stage_loop,
                args=(k, self.qs[k], self.qs[k + 1], self.traces[k],
                      self.errors),
                name=f"stage-{k}", daemon=True,
            )
            for k in range(K)
        ]
        self._t0 = time.perf_counter()
        for t in self.threads:
            t.start()

    @property
    def frames_in(self) -> int:
        return self._frames_in

    def put(
        self,
        payload: Any,
        *,
        ready_t: float = 0.0,
        scale: float = 1.0,
        round_id: Optional[int] = None,
        ready_event: Optional["torch.cuda.Event"] = None,
    ) -> int:
        """Inject one frame into stage 0; returns its frame index.

        ``ready_t`` is the virtual time the payload becomes available
        (the drain time of the frame it depends on); ``round_id``
        defaults to the frame index (every frame streams its own tiles);
        ``ready_event`` (on the card) marks the payload ready, default
        the caller's current stream now.  Blocks on the bounded stage-0
        queue for backpressure."""
        if self._closed:
            raise ValueError("session is closed")
        if self.errors:
            raise self.errors[0]
        f = self._frames_in
        rid = f if round_id is None else round_id
        if ready_event is None:
            ready_event = self.ex._caller_event()
        self.qs[0].put(
            (f, payload, float(ready_t), float(scale), rid, ready_event)
        )
        # lint: disable=RPL004 -- owner-thread only by contract (put/get/close share one caller thread)
        self._frames_in += 1
        return f

    def get(self, timeout: float = 300.0):
        """Block until the next frame drains; returns
        ``(frame, payload, end_t)`` with ``end_t`` the virtual drain
        time.  Frames drain in injection order (FIFO handoffs)."""
        try:
            item = self.qs[-1].get(timeout=timeout)
        except queue.Empty:
            self._stall_unwind()   # raises
        if item is _FAILED or item is None:
            err = self.errors[0] if self.errors else RuntimeError(
                "pipeline closed while frames were in flight"
            )
            raise err
        frame, payload, end_t, _scale, _rid, ev = item
        if ev is not None:
            torch.cuda.current_stream().wait_event(ev)
        # lint: disable=RPL004 -- owner-thread only by contract (put/get/close share one caller thread)
        self._done_t[frame] = end_t
        return frame, payload, end_t

    def _stall_unwind(self):
        """Mirror of ``run``'s deadlock-as-detection recovery: flag the
        error so stages drain, abort in-flight cores, flush the drain
        queue, join, and raise with a diagnosis."""
        err = RuntimeError(
            "pipeline stalled: no frame completed in time "
            f"(drained {len(self._done_t)}/{self._frames_in}; a stage "
            "thread is wedged -- serialized schedule or stuck prefetch)"
        )
        self.errors.append(err)
        with self.ex._active_lock:
            cores = list(self.ex._live_cores.values())
        for c in cores:
            c.abort(err)
        self.qs[0].put(None)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            try:
                if self.qs[-1].get(timeout=5.0) is None:
                    break
            except queue.Empty:
                pass
        for t in self.threads:
            t.join(timeout=5.0)
        # lint: disable=RPL004 -- owner thread, and all stage threads just joined
        self._closed = True
        raise err from None

    def close(self, outputs: Optional[List[Any]] = None) -> PipelineReport:
        """Shut the pipeline down and build the report.  Raises the
        first stage error if any frame failed."""
        if not self._closed:
            # lint: disable=RPL004 -- owner-thread only by contract; stages only read via queue sentinels
            self._closed = True
            self.qs[0].put(None)
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                try:
                    item = self.qs[-1].get(timeout=5.0)
                except queue.Empty:
                    continue
                if item is None:
                    break
                if item is _FAILED:
                    continue
                frame, _payload, end_t, _scale, _rid, ev = item
                if ev is not None:
                    torch.cuda.current_stream().wait_event(ev)
                # lint: disable=RPL004 -- owner thread draining after the close sentinel
                self._done_t[frame] = end_t   # owner never collected it
            for t in self.threads:
                t.join(timeout=60.0)
            # lint: disable=RPL004 -- owner thread, stage threads joined above
            self._wall = time.perf_counter() - self._t0
        if self.errors:
            raise self.errors[0]
        n = self._frames_in
        done_t = [self._done_t.get(f, 0.0) for f in range(n)]
        outs = outputs if outputs is not None else [None] * n
        return self.ex._report(outs, done_t, self.traces, wall_s=self._wall)

    def abort(self) -> None:
        """Best-effort close that never raises (error-path cleanup)."""
        try:
            self.close()
        except BaseException:
            pass


class StagePipelineExecutor:
    """Run all K stages of a :class:`PartitionedPlan` concurrently.

    ``fetch(stage, tile_index, tile_name)`` supplies a tile's weights
    (called from that stage's prefetch worker, in plan issue order);
    ``run_tile(stage, tile_index, weights, carry)`` folds one tile into
    the stage's running activation state.  The carry entering a stage is
    the payload handed off by the previous stage (the microbatch payload
    for stage 0) and the carry after the stage's last tile is handed
    downstream.

    ``stage_devices`` (one ``torch.device`` per stage) places every
    inbound payload on its stage's device; on a CUDA device the stage's
    ``run_tile`` and ``run_stage`` calls run with the stage's own stream
    (``streams[k]``) current.  ``None`` leaves payloads where they are
    and queues the work on the threads' current streams.
    """

    def __init__(
        self,
        plan: PartitionedPlan,
        *,
        fetch: Optional[FetchFn] = None,
        run_tile: Optional[RunTileFn] = None,
        run_stage: Optional[RunStageFn] = None,
        stage_devices: Optional[Sequence[torch.device]] = None,
        queue_depth: int = 2,
        record_fetch_orders: bool = False,
    ):
        if not plan.stages:
            raise ValueError("empty PartitionedPlan")
        if not plan.feasible:
            raise ValueError("infeasible PartitionedPlan (a stage plan "
                             "exceeds its PU's fast memory)")
        self.plan = plan
        self.fetch = fetch or (lambda k, i, name: name)
        self.run_tile = run_tile or (lambda k, i, w, carry: carry)
        # run_stage carries the *real* per-frame compute: the handoff
        # queues then move live activation tensors between stages while
        # the tile loop keeps the streaming account (the virtual clock
        # stays the cross-check against the analytic recurrence)
        self.run_stage = run_stage
        # one device per stage: the consuming stage places each payload
        # on its device (None skips placement), and a CUDA stage queues
        # its work on a stream of its own
        self.stage_devices = (
            [torch.device(d) for d in stage_devices] if stage_devices else None
        )
        if self.stage_devices is not None and len(self.stage_devices) != len(
            plan.stages
        ):
            raise ValueError(
                f"stage_devices has {len(self.stage_devices)} entries for "
                f"{len(plan.stages)} stages"
            )
        self.streams: List[Optional["torch.cuda.Stream"]] = [
            torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in (self.stage_devices or [torch.device("cpu")] * len(plan.stages))
        ]
        self.queue_depth = queue_depth
        self.record_fetch_orders = record_fetch_orders
        # under REPRO_SANITIZE=1 the lock feeds the lock-order recorder
        # (class-level name, like StageStreamCore._cond)
        self._active_lock = sanitize.instrument_lock(
            "StagePipelineExecutor._active_lock"
        )
        self._active = 0
        self._max_active = 0
        self._live_cores: Dict[int, StageStreamCore] = {}

    def _caller_event(self) -> Optional["torch.cuda.Event"]:
        """An event on the caller's current stream of stage 0's device
        (``None`` off the card): a frame's payload is ready there."""
        if self.streams[0] is None:
            return None
        return _recorded(torch.cuda.current_stream(self.stage_devices[0]))

    def _enter_frame(self) -> None:
        with self._active_lock:
            sanitize.require_held(self._active_lock)
            self._active += 1
            self._max_active = max(self._max_active, self._active)

    def _exit_frame(self) -> None:
        with self._active_lock:
            self._active -= 1

    # -- per-stage workers --------------------------------------------------

    def _prefetch_loop(self, jobs: "queue.Queue") -> None:
        """One stage's prefetch worker: drain cores in frame order."""
        while True:
            core = jobs.get()
            if core is None:
                return
            try:
                core.prefetch_all()
            except BaseException as e:   # surfaced via core.acquire
                core.abort(e)

    def _stage_loop(
        self,
        k: int,
        in_q: "queue.Queue",
        out_q: "queue.Queue",
        trace: StageTrace,
        errors: List[BaseException],
    ) -> None:
        stage = self.plan.stages[k]
        costs = [t.mem_bytes for t in stage.plan.tiles]
        issue = stage.plan.issue_order()
        names = _stage_tile_names(k, stage)
        per_frame_stall = stage.plan.total_stall

        jobs: "queue.Queue" = queue.Queue()
        worker = threading.Thread(
            target=self._prefetch_loop, args=(jobs,),
            name=f"prefetch-s{k}", daemon=True,
        )
        worker.start()
        t_cursor = 0.0
        last_round = None
        while True:
            item = in_q.get()
            if item is None:
                break
            if item is _FAILED:
                out_q.put(_FAILED)   # propagate so a blocked get() wakes
                continue
            if errors:
                continue    # some stage failed: drain upstream, don't work
            frame, payload, ready_t, scale, round_id, ready_ev = item
            self._enter_frame()
            # inbound handoff: the activation transfer overlaps the
            # previous frame's compute (DMA), so it delays *arrival*,
            # not the stage clock.
            arrival = ready_t + (stage.handoff_in_s * scale if k else 0.0)
            start = max(t_cursor, arrival)
            if trace.frames == 0:
                trace.first_start_t = start
            else:
                trace.starve_s += max(0.0, arrival - t_cursor)

            # the weight-streaming tile loop runs once per *round*: lane
            # groups of the same round reuse the weights the first group
            # streamed in, so only that group pays the fetch sequence
            # (frames injected via run() carry round_id == frame, which
            # keeps the legacy one-tile-loop-per-frame behaviour)
            stream_tiles = round_id != last_round
            core = None
            carry = payload
            stream = self.streams[k]
            done_ev = None
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    if ready_ev is not None and stream is not None:
                        stream.wait_event(ready_ev)
                    if self.stage_devices is not None:
                        # place the inbound activations on this stage's
                        # device, after the producer's work
                        carry = place(carry, self.stage_devices[k], stream)
                    if stream_tiles:
                        core = StageStreamCore(
                            costs=costs,
                            capacity=stage.pu.fast_mem_bytes,
                            issue_order=issue,
                            fetch=lambda j: self.fetch(k, j, names[j]),
                            names=names,
                        )
                        with self._active_lock:
                            self._live_cores[k] = core  # stall recovery aborts
                        jobs.put(core)
                        for i in range(len(costs)):
                            w = core.acquire(i)
                            carry = self.run_tile(k, i, w, carry)
                            core.release(i)
                    if self.run_stage is not None:
                        # the real per-frame compute: fold the stage's
                        # layer slice over the inbound activations
                        carry = self.run_stage(k, carry)
                    done_ev = _recorded(stream)
            except BaseException as e:
                if core is not None:
                    core.abort(e)   # unblock this stage's prefetch worker
                errors.append(e)
                self._exit_frame()
                out_q.put(_FAILED)
                continue
            last_round = round_id

            end = start + stage.stage_s * scale
            t_cursor = end
            trace.frames += 1
            if core is not None:
                trace.fetches += len(core.fetches)
                trace.peak_resident_bytes = max(
                    trace.peak_resident_bytes, core.peak_resident_bytes
                )
                if self.record_fetch_orders:
                    trace.fetch_orders.append(list(core.fetches))
            trace.busy_s += stage.stage_s * scale
            trace.stall_s += per_frame_stall * scale
            trace.handoff_s += stage.handoff_in_s * scale if k else 0.0
            trace.last_end_t = end
            self._exit_frame()
            out_q.put((frame, carry, end, scale, round_id, done_ev))
        jobs.put(None)
        worker.join(timeout=60.0)
        out_q.put(None)

    # -- the run ------------------------------------------------------------

    def open_session(
        self, queue_depth: Optional[int] = None
    ) -> PipelineSession:
        """Open a persistent :class:`PipelineSession` over this plan --
        the overlapped staged-decode entry point (frames injected as
        their cross-round dependencies drain)."""
        return PipelineSession(self, queue_depth=queue_depth)

    def run(self, microbatches: Sequence[Any]) -> PipelineReport:
        M = len(microbatches)
        if M == 0:
            traces = [
                StageTrace(stage=k, pu=s.pu.name)
                for k, s in enumerate(self.plan.stages)
            ]
            return self._report([], [], traces, wall_s=0.0)

        session = PipelineSession(self)
        # the payloads are ready on the caller's stream (the injector
        # thread's current stream is another)
        ready = self._caller_event()

        def inject():
            # all microbatches are available at t=0; the bounded stage-0
            # queue paces actual injection to the pipeline's intake rate
            try:
                for payload in microbatches:
                    session.put(payload, ready_event=ready)
            except BaseException:
                pass          # a stage failed: the drain loop raises it

        injector = threading.Thread(target=inject, name="inject", daemon=True)
        injector.start()

        outputs: List[Any] = [None] * M
        try:
            for _ in range(M):
                # generous bound: a healthy pipeline delivers frames
                # continuously; hitting it means a stage wedged (the
                # deadlock-as-detection failure mode) -- fail fast with
                # a diagnosis instead of hanging the CI job
                frame, payload, _end_t = session.get(timeout=300.0)
                outputs[frame] = payload
        except BaseException:
            injector.join(timeout=60.0)
            session.abort()
            raise
        injector.join(timeout=60.0)
        return session.close(outputs=outputs)

    def _report(
        self,
        outputs: List[Any],
        done_t: List[float],
        traces: List[StageTrace],
        *,
        wall_s: float,
    ) -> PipelineReport:
        K = len(self.plan.stages)
        M = len(outputs)
        makespan = max(done_t) if done_t else 0.0
        # handoff is overlapped DMA (it delays arrival, never the stage
        # clock), so it is NOT stage occupancy -- counting it as busy
        # would deflate (even negate) the bubble on handoff-heavy plans
        busy = sum(t.busy_s for t in traces)
        bubble = 1.0 - busy / (K * makespan) if makespan > 0 else 0.0
        return PipelineReport(
            n_stages=K,
            n_microbatches=M,
            outputs=outputs,
            frame_done_t=done_t,
            makespan_s=makespan,
            measured_fps=M / makespan if makespan > 0 else 0.0,
            predicted_makespan_s=(
                self.plan.pipeline_makespan(M) if M else 0.0
            ),
            predicted_fps=self.plan.pipeline_fps(M) if M else 0.0,
            steady_fps=self.plan.fps,
            bubble_measured=bubble,
            bubble_predicted=self.plan.bubble_prediction(M) if M else 0.0,
            wall_s=wall_s,
            max_concurrent_stages=self._max_active if M else 0,
            stages=traces,
            real_stage_compute=self.run_stage is not None,
        )


def execute_partitioned_plan(
    plan: PartitionedPlan,
    n_microbatches: int = 4,
    *,
    fetch: Optional[FetchFn] = None,
    run_tile: Optional[RunTileFn] = None,
    payloads: Optional[Sequence[Any]] = None,
    queue_depth: int = 2,
    record_fetch_orders: bool = False,
) -> PipelineReport:
    """Convenience wrapper: execute ``plan`` over M microbatches.

    With the default (functional no-op) ``fetch``/``run_tile`` this
    validates the *runtime* -- issue order, residency bounds, handoff
    flow, pipeline dynamics -- which is what FleetSim's executed mode
    and the ``stream`` benchmark suite need; callers with real weights
    and compute supply both callbacks.
    """
    ex = StagePipelineExecutor(
        plan,
        fetch=fetch,
        run_tile=run_tile,
        queue_depth=queue_depth,
        record_fetch_orders=record_fetch_orders,
    )
    if payloads is None:
        payloads = list(range(n_microbatches))
    return ex.run(list(payloads))
