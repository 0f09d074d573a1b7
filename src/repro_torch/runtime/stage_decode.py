"""True per-stage decode: each pipeline stage runs its model-layer slice
(counterpart of ``repro.runtime.stage_decode``).

A :class:`StagedDecodeRunner` binds a :class:`PartitionedPlan` whose
stages carry ``decode_layer_start/stop`` (attached by
``serving.plan_partitioned_streaming``, snapped to the family's
``decode_slice_points``) to the model's layer-sliced decode entry points
(``ModelAPI.slice_params`` / ``slice_cache`` / ``decode_embed`` /
``decode_stage`` / ``decode_unembed``).  The runner is agnostic to
``cfg.decode_kernels``: the hand-written CUDA decode kernels live *below*
``decode_stage`` (``repro_torch.kernels.dispatch``), so every schedule
launches them with no changes here.

Entry points:

- per-stage **param slices** are views of the bound params (copies on a
  stage's own device when the stages sit on distinct devices), re-sliced
  when the bound params change;
- per-stage **KV caches** are sliced from the engine's master cache at
  :meth:`load_cache`.  The decode path updates the cache in place, so on
  one device a stage's slice, and a lane group's lanes within it, are
  views of the master cache and :meth:`export_cache` writes nothing back;
  a stage on a device of its own holds a copy, written back at export.
  ``decode_stage`` hands the attention one layer at a time, and a layer's
  lanes ``c[i][g0:g1]`` are contiguous, as the attention kernel needs;
- decode rounds push live hidden states through
  :class:`runtime.pipeline_exec.StagePipelineExecutor`: the first stage
  embeds the token batch, every stage folds its layer slice (updating its
  cache slice in place), the last stage unembeds to logits.

Two schedules drive the executor:

- :meth:`decode_round` -- the **serial M=1 reference**: one full-batch
  frame per round through its own pipeline run, with the post-decode
  update applied by the caller.  All fill bubble, but the same
  computation as the single-PU ``decode_step`` (its one-stage
  composition of the same entry points), so its greedy streams are the
  single-PU engine's bit for bit.
- :meth:`decode_block` -- the **overlapped schedule**: each round is M
  lane-group frames flowing through a *persistent*
  :class:`~repro_torch.runtime.pipeline_exec.PipelineSession` that stays
  open across consecutive blocks (between admission barriers), with round
  r+1 of a group entering stage 0 as soon as round r of that group drains
  (its sampled token is the next round's input).  Embed belongs to the
  first stage, unembed and the post-decode transition to the last one.

The stage threads launch their stage's work **eagerly**, each on its own
CUDA stream (the executor's ``streams``); no graph is captured from a
stage thread.  Each stage stream gets its own split-K scratch at its
first launch (``kernels.common.split_k_scratch`` keys it by stream).

When every stage lives on the *same* device, the threaded schedule
cannot overlap anything real: the stages' streams share one card's SMs
and every extra lane-group frame re-reads the whole weight set.
``coalesce=True`` keeps the overlapped *schedule* (frame order, virtual
account, recurrence cross-check at warmup) but executes each block on
the caller's thread as one pass that chains every stage back to back per
lane group -- the counterpart of the reference's one jitted ``lax.scan``
a block.  With ``capture`` (the engine's CUDA-graph capture, on the
card) that pass is **one CUDA graph per (M, block length)**, captured at
its first use in the engine's graph pool and replayed after; each
capture calls ``on_trace("decode")``, as the reference counts a jit
trace.  The virtual account for coalesced blocks is the analytic
recurrence itself, which the threaded warmup block has already validated
(``clock_ok``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.plan.partition import PartitionedPlan
from repro_torch.runtime.pipeline_exec import (
    PipelineReport,
    PipelineSession,
    StagePipelineExecutor,
    place,
)


class StagedDecodeRunner:
    """Drive decode rounds through the stage-parallel pipeline executor.

    ``n_groups`` is the lane-group microbatch count M (1 = the serial
    reference schedule); ``configure`` changes it between blocks (caches
    must be re-loaded after).

    ``postdecode(state, logits)`` is the engine's per-lane post-decode
    transition, which updates ``state`` in place; the last stage applies
    it to each frame's lane group (:meth:`decode_block` needs it;
    :meth:`decode_round` leaves the update to its caller).

    ``stage_devices`` (one ``torch.device`` per stage) puts each stage's
    thread on a CUDA stream of its own on its device; ``None`` runs every
    stage on the params' device with the threads' current streams (the
    CPU).  ``capture(fn)`` -> ``(graph, out)`` captures a coalesced block
    (``kernels.common.capture_graph`` in the engine's pool); ``None``
    runs coalesced blocks eagerly.
    """

    def __init__(
        self,
        cfg,
        api,
        params,
        plan: PartitionedPlan,
        *,
        stage_devices: Optional[Sequence[torch.device]] = None,
        n_groups: int = 1,
        queue_depth: int = 2,
        on_trace=None,
        postdecode: Optional[Callable[[Dict[str, Any], Any], None]] = None,
        coalesce: bool = False,
        capture: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.api = api
        self.plan = plan
        self.ranges: List[Tuple[int, int]] = [
            s.decode_layers for s in plan.stages
        ]
        L = cfg.n_layers
        pts = set(api.decode_slice_points(cfg))
        cursor = 0
        for start, stop in self.ranges:
            if start != cursor or stop < start or stop > L:
                raise ValueError(
                    f"stage decode ranges {self.ranges} do not tile "
                    f"[0, {L}) contiguously"
                )
            if start not in pts or stop not in pts:
                raise ValueError(
                    f"stage range ({start}, {stop}) not on the family's "
                    f"slice points {sorted(pts)}"
                )
            cursor = stop
        if cursor != L:
            raise ValueError(
                f"stage decode ranges {self.ranges} do not cover all "
                f"{L} layers"
            )
        self._on_trace = on_trace or (lambda kind: None)
        self._postdecode = postdecode
        self._capture = capture
        self.home = params["embed"].device
        K = len(self.ranges)
        self.devices: List[torch.device] = (
            [torch.device(d) for d in stage_devices] if stage_devices
            else [self.home] * K
        )
        # a stage off the params' device holds copies of its slices
        self._copies = [d != self.home for d in self.devices]

        self.bound_params = None
        self.stage_params: List[Any] = []
        self._heads: List[Any] = []
        self.rebind(params)
        # stage_caches[k][g]: stage k's cache slice for lane group g
        # (n_groups == 1 keeps the whole stage slice in group 0)
        self.stage_caches: Optional[List[List[Any]]] = None
        self._master = None
        self._stage_full: List[Any] = []
        self.n_groups = int(n_groups)
        self.queue_depth = int(queue_depth)
        self.rounds_executed = 0
        self.clock_ok = True
        self.last_report: Optional[PipelineReport] = None
        # cumulative virtual account across rounds/blocks, so the
        # executed bubble of a whole serving run is reportable
        self.virtual_busy_s = 0.0
        self.virtual_span_s = 0.0
        self._executor = StagePipelineExecutor(
            plan,
            run_stage=self._run_stage,
            stage_devices=stage_devices,
            queue_depth=queue_depth,
        )
        # the M=1 recurrence: one frame through all K stages
        self._expected_done_t = float(plan.pipeline_events(1)[-1, 0])
        # (n_groups, n_rounds) -> last-stage drain times of one
        # overlapped block's recurrence
        self._expected_block: Dict[Tuple[int, int], Tuple[float, ...]] = {}
        # the persistent overlapped session (None between barriers):
        # _session_t is the virtual clock offset (last drain end),
        # _session_rounds the global round counter that keeps the
        # per-round tile loop amortization monotone across blocks
        self._session: Optional[PipelineSession] = None
        self._session_t = 0.0
        self._session_rounds = 0
        # block-mode context read by _run_stage from the stage threads
        # (queue handoffs order every access -- see decode_block)
        self._block_groups: Optional[List[Dict[str, Any]]] = None
        # single-device fast path: a block as one pass on the caller's
        # thread; on the card one CUDA graph per (n_groups, n_rounds)
        self.coalesce = bool(coalesce)
        self._co_graphs: Dict[Tuple[int, int], Any] = {}
        # coalesced rounds / span not yet folded into the virtual account
        self._co_rounds = 0
        self._co_span = 0.0
        # a stream on the params' device for the last stage's post-decode
        # transition when that stage sits on another device
        self._home_stream = None

    # -- configuration ------------------------------------------------------

    def configure(
        self,
        n_groups: Optional[int] = None,
        queue_depth: Optional[int] = None,
    ) -> None:
        """Change the lane-group count / handoff queue depth (e.g. from
        the staged-decode autotuner).  Any open session is flushed and
        loaded caches are dropped: the group split is part of the cache
        layout."""
        self.flush()
        if n_groups is not None:
            if n_groups < 1:
                raise ValueError("n_groups must be >= 1")
            self.n_groups = int(n_groups)
        if queue_depth is not None:
            self.queue_depth = int(queue_depth)
            self._executor.queue_depth = int(queue_depth)
        self.stage_caches = None

    # -- param/cache residency ---------------------------------------------

    def rebind(self, params) -> None:
        """(Re-)slice per-stage params from ``params``: views on the
        params' device, copies on a stage's own device (called at
        construction, and for copies after each NIU refresh).  The first
        stage also holds the embedding, the last the final norm and the
        unembedding (``_heads``)."""
        self.bound_params = params
        K = len(self.ranges)
        head = {k: v for k, v in params.items() if k != "layers"}
        self.stage_params, self._heads = [], []
        for k, r in enumerate(self.ranges):
            sp = self.api.slice_params(self.cfg, params, r)
            hd = head if k in (0, K - 1) else None
            if self._copies[k]:
                sp = place(sp, self.devices[k], None)
                hd = place(hd, self.devices[k], None)
            self.stage_params.append(sp)
            self._heads.append(hd)

    def load_cache(self, cache) -> None:
        """Slice the engine's master cache into per-stage, per-lane-group
        cache slices.  Cache leaves are layer-leading ``(L, B, ...)``:
        stage slices cut axis 0, lane groups cut axis 1 into M static
        chunks.  Views of ``cache`` where a stage shares its device,
        copies on a stage's own device."""
        self.flush()
        M = self.n_groups
        B = max((leaf.shape[1] for leaf in cache if leaf.dim() >= 2), default=0)
        if M > 1 and B % M:
            raise ValueError(
                f"n_groups={M} does not divide the {B}-lane slot batch"
            )
        g = B // M
        self._master = cache
        self._stage_full = []
        self.stage_caches = []
        for k, r in enumerate(self.ranges):
            sc = self.api.slice_cache(self.cfg, cache, r)
            if self._copies[k]:
                sc = tuple(t.to(self.devices[k]) for t in sc)
            self._stage_full.append(sc)
            self.stage_caches.append(
                [sc] if M == 1
                else [tuple(t[:, i * g:(i + 1) * g] for t in sc) for i in range(M)]
            )

    def export_cache(self):
        """The master cache with every stage's updates in it: a stage on
        its own device writes its copy back into the master's layer range
        (stage slices on the master's device are views, already there).
        Flushes the overlapped session first -- exporting IS the
        round-boundary barrier admissions synchronize on."""
        self.flush()
        if self.stage_caches is None:
            raise ValueError("no stage caches loaded")
        for k, r in enumerate(self.ranges):
            if self._copies[k]:
                for dst, src in zip(
                    self.api.slice_cache(self.cfg, self._master, r),
                    self._stage_full[k],
                ):
                    dst.copy_(src)
        return self._master

    # -- the decode schedules -----------------------------------------------

    def _stage(self, k: int, x, g: int, pos):
        """Stage ``k``'s layer slice over ``x`` against lane group ``g``'s
        cache slice (updated in place)."""
        x, _ = self.api.decode_stage(
            self.cfg, self.stage_params[k], x, self.stage_caches[k][g], pos
        )
        return x

    def _run_stage(self, k: int, payload):
        K = len(self.ranges)
        if self._block_groups is None:
            # the M=1 reference frame: the payload IS the inter-stage
            # handoff -- (tokens, pos, g) entering stage 0, (hidden, pos,
            # g) between stages, (logits, pos, g) draining.  pos rides
            # along because every stage's KV write needs the per-lane
            # positions, g selects the stage's lane-group cache slice
            x, pos, g = payload
            if k == 0:
                x = self.api.decode_embed(self.cfg, self._heads[0], x, pos)
            x = self._stage(k, x, g, pos)
            if k == K - 1:
                x = self.api.decode_unembed(self.cfg, self._heads[k], x)
            return (x, pos, g)

        # overlapped block mode: stage 0 frames carry only the group
        # index -- the group's decode state lives in _block_groups[g],
        # written solely by the last stage and re-read by stage 0 one
        # queue round-trip later (the handoff queues, and their events
        # on the card, order every cross-thread access)
        if k == 0:
            g = payload
            st = self._block_groups[g]
            tokens, pos = st["tokens"], st["pos"]
            if self._copies[0]:
                tokens, pos = place((tokens, pos), self.devices[0],
                                     self._executor.streams[0])
            x = self.api.decode_embed(self.cfg, self._heads[0], tokens, pos)
            x = self._stage(0, x, g, pos)
            if K == 1:
                self._finish_group(g, x)
                return g
            return (x, pos, g)
        x, pos, g = payload
        x = self._stage(k, x, g, pos)
        if k < K - 1:
            return (x, pos, g)
        self._finish_group(g, x)
        return g

    def _finish_group(self, g: int, hidden) -> None:
        """Unembed the last stage's hidden state and apply ``postdecode``
        to lane group g's state on the last-stage thread.  Where the last
        stage sits on another device than the group state, the logits
        move to the state's device on a stream there, which this stage's
        stream then waits on, so the frame's drain event covers the
        transition."""
        k = len(self.ranges) - 1
        logits = self.api.decode_unembed(self.cfg, self._heads[k], hidden)
        st = self._block_groups[g]
        stream = self._executor.streams[k]
        if not self._copies[k] or stream is None:
            self._postdecode(st, logits.to(self.home))
            return
        if self._home_stream is None:
            self._home_stream = torch.cuda.Stream(self.home)
        hs = self._home_stream
        with torch.cuda.stream(hs):
            hs.wait_stream(stream)
            self._postdecode(st, place(logits, self.home, hs))
        stream.wait_stream(hs)

    def decode_round(self, tokens, pos):
        """One serial staged decode round -> logits (B, V): the M=1
        reference schedule (one full-batch frame through all K stages,
        its own pipeline run, all fill bubble).

        The token batch enters stage 0 (which embeds it), the hidden
        state flows through every stage's layer slice via the executor's
        handoff queues, and the last stage's unembed output drains as the
        frame payload.  Stage caches update in place."""
        if self.stage_caches is None:
            raise ValueError("load_cache() before decode_round()")
        if self.n_groups != 1:
            raise ValueError(
                "decode_round is the serial M=1 reference; use "
                "decode_block with n_groups > 1"
            )
        if self._session is not None:
            raise ValueError("flush() the overlapped session first")
        report = self._executor.run([(tokens, pos.to(torch.int32), 0)])
        self.rounds_executed += 1
        self.last_report = report
        self.virtual_busy_s += sum(t.busy_s for t in report.stages)
        self.virtual_span_s += report.makespan_s
        # virtual-clock cross-check: the executed event stream must
        # reproduce the plan's single-frame recurrence
        tol = 1e-9 * max(1.0, abs(self._expected_done_t))
        if abs(report.frame_done_t[0] - self._expected_done_t) > tol:
            self.clock_ok = False
        logits, _, _ = report.outputs[0]
        if logits.device != self.home:
            logits = logits.to(self.home)
        return logits

    def _expected_drains(self, M: int, n_rounds: int) -> Tuple[float, ...]:
        """Per-frame expected drain times of an (M, n_rounds) block as
        host floats.  The analytic recurrence yields numpy scalars;
        converting once here, when a block shape is first seen, keeps
        per-frame clock checks free of host conversions on the decode
        hot path."""
        key = (M, n_rounds)
        cached = self._expected_block.get(key)
        if cached is None:
            drains = self.plan.decode_pipeline_events(
                M, n_rounds, 1.0 / M
            )[-1]
            # lint: disable=RPL002 -- one-time fill per block shape from numpy host scalars, not per-frame
            cached = tuple(float(t) for t in drains)
            self._expected_block[key] = cached
        return cached

    def decode_block(
        self,
        groups: List[Dict[str, Any]],
        n_rounds: int,
        force_threaded: bool = False,
    ) -> List[Dict[str, Any]]:
        """``n_rounds`` overlapped rounds over M lane-group states.

        ``groups[g]`` is lane group g's decode-state dict (at least
        ``tokens`` (gsize, 1) and ``pos`` (gsize,)); the post-decode
        transition runs on the last-stage thread, in place, and its
        ``tokens``/``pos`` feed the group's next round.  Returns the
        group states (the same list, updated in place).  The reference's
        ``update`` callback, which no caller passes, is not ported.

        Schedule: all M groups of round 0 are injected up front (they
        fill the pipeline); thereafter group g of round r+1 is injected
        the moment group g of round r drains -- the cross-round overlap.
        The session persists across consecutive blocks: the fill bubble
        is paid once per barrier interval (``flush`` / ``load_cache`` /
        ``export_cache`` close it), and each block's frames rebase the
        virtual clock by the previous block's last drain time, so the
        rebased ``PartitionedPlan.decode_pipeline_events`` recurrence
        stays an exact cross-check (``clock_ok``).  The handoff queues
        are FIFO, so frames drain in injection order and the block-local
        frame index is ``i = r*M + g``.

        With ``coalesce`` set (all stages on one device) the same
        schedule executes as one pass on this thread, a CUDA graph on
        the card (``force_threaded=True`` overrides, e.g. for the warmup
        block that cross-checks the virtual clock through the real
        executor)."""
        M = self.n_groups
        if self.stage_caches is None:
            raise ValueError("load_cache() before decode_block()")
        if len(groups) != M:
            raise ValueError(f"got {len(groups)} group states for M={M}")
        if self._postdecode is None:
            raise ValueError("decode_block needs a bound postdecode transition")
        if self.coalesce and not force_threaded:
            return self._decode_block_coalesced(groups, n_rounds)
        scale = 1.0 / M
        expected = self._expected_drains(M, n_rounds)

        if self._session is None:
            self._session = self._executor.open_session(
                queue_depth=self.queue_depth
            )
            self._session_t = 0.0
            self._session_rounds = 0
        session = self._session
        base = session.frames_in
        t0 = self._session_t
        r0 = self._session_rounds
        self._block_groups = groups
        last_end = t0
        try:
            for g in range(M):
                session.put(g, ready_t=t0, scale=scale, round_id=r0)
            for _ in range(n_rounds * M):
                frame, g, end_t = session.get()
                r = (frame - base) // M
                want = t0 + expected[frame - base]
                tol = 1e-9 * max(1.0, abs(want))
                if abs(end_t - want) > tol:
                    self.clock_ok = False
                last_end = end_t
                if r + 1 < n_rounds:
                    session.put(
                        g, ready_t=end_t, scale=scale,
                        round_id=r0 + r + 1,
                    )
        except BaseException:
            self._session = None
            self._block_groups = None
            session.abort()
            raise
        self._session_t = last_end
        self._session_rounds += n_rounds
        self.rounds_executed += n_rounds
        return groups

    def _coalesced_rounds(self, groups: List[Dict[str, Any]], n_rounds: int) -> None:
        """``n_rounds`` rounds of every lane group through every stage
        back to back, on this thread's current stream."""
        K = len(self.ranges)
        for _ in range(n_rounds):
            for g, st in enumerate(groups):
                x = self.api.decode_embed(self.cfg, self._heads[0], st["tokens"], st["pos"])
                for k in range(K):
                    x = self._stage(k, x, g, st["pos"])
                logits = self.api.decode_unembed(self.cfg, self._heads[K - 1], x)
                self._postdecode(st, logits)

    def _decode_block_coalesced(
        self, groups: List[Dict[str, Any]], n_rounds: int
    ) -> List[Dict[str, Any]]:
        """Run one overlapped block as a single pass (see the module
        docstring): with ``capture``, the replay of its CUDA graph,
        captured at the (M, n_rounds) block's first use, whose eager run
        on the capture stream is then the block.  The graph holds the
        group states' and cache slices' addresses, which stay put: both
        are views of the engine's fixed tensors.  The virtual account is
        the analytic recurrence, folded in at :meth:`flush` -- exactly
        what the threaded executor's clock reproduces (``clock_ok`` from
        the warmup block)."""
        M = self.n_groups
        if self._session is not None:
            # a threaded session epoch ends here: fold its account
            # before the coalesced rounds start their own
            self.flush()
        if self._capture is None:
            self._coalesced_rounds(groups, n_rounds)
        else:
            key = (M, n_rounds)
            graph = self._co_graphs.get(key)
            if graph is not None:
                graph.replay()
            else:
                self._on_trace("decode")
                self._co_graphs[key], _ = self._capture(
                    lambda: self._coalesced_rounds(groups, n_rounds)
                )
        self.rounds_executed += n_rounds
        self._co_rounds += n_rounds
        # span folds per block: between blocks the host syncs (the
        # engine inspects drained state), so the next block's recurrence
        # starts with all M frames ready at the previous block's last
        # drain -- spans of consecutive blocks simply add
        self._co_span += self._expected_drains(M, n_rounds)[-1]
        return groups

    def flush(self) -> None:
        """Close the persistent overlapped session (if open) and fold
        its executed trace into the cumulative virtual account.  The
        round-boundary barrier: admissions/evictions (which mutate slot
        membership) and reconfiguration call this, paying the next
        block's fill bubble exactly where the schedule requires it."""
        if self._co_rounds:
            # fold pending coalesced rounds analytically: M*R frames at
            # scale 1/M give each stage R * stage_s of busy time; the
            # span accrued per block (see _decode_block_coalesced)
            R = self._co_rounds
            self._co_rounds = 0
            self.virtual_busy_s += R * sum(
                s.stage_s for s in self.plan.stages
            )
            self.virtual_span_s += self._co_span
            self._co_span = 0.0
        session, self._session = self._session, None
        self._block_groups = None
        if session is None:
            return
        report = session.close()
        self.last_report = report
        self.virtual_busy_s += sum(t.busy_s for t in report.stages)
        self.virtual_span_s += report.makespan_s

    @property
    def holds_copies(self) -> bool:
        """True when some stage holds copies of its params (its own
        device), which an in-place weight update does not reach."""
        return any(self._copies)

    @property
    def graphs(self) -> List[Any]:
        """The coalesced blocks' captured graphs."""
        return list(self._co_graphs.values())

    @property
    def bubble_fraction(self) -> float:
        """Cumulative executed bubble across every round/block so far:
        1 - busy / (K * span) over the accumulated virtual account.
        (``flush()`` first to fold an open session.)"""
        K = len(self.plan.stages)
        if self.virtual_span_s <= 0:
            return 0.0
        return 1.0 - self.virtual_busy_s / (K * self.virtual_span_s)
