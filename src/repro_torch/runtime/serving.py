"""Batched serving engine, default device-resident path (counterpart of
``repro.runtime.serving``).

Request flow (continuous batching, decode-centric):

    submit(prompt tokens) -> queue
    engine round: (AIMC noise refresh,) admit waiting requests into free
                  slots (bucketed batched prefill, one call per length
                  bucket), then run a block of decode rounds entirely on
                  the device.

The JAX engine runs a decode block as one jitted ``lax.scan`` with the
cache and state donated.  Here a block of ``R`` rounds updates
preallocated cache and state tensors in place: sampling, append,
per-slot position/remaining bookkeeping and the done flags all stay on
the device, and nothing is read back inside the block.  On the card the
block is a CUDA graph: one graph per power-of-two ``R`` up to
``max_decode_block``, captured by :meth:`ServingEngine.warmup` (or at its
first use), all in one memory pool, and replayed; ``eager=True`` runs the
same rounds as a Python loop instead (the CPU always does).  A capture
that fails raises: nothing falls back to the loop.  Captures are counted
by ``tracing`` (kind ``"decode"``), as the reference counts jit traces.
At the block boundary the host reads ``active`` and ``out_len`` (and a
finished request's tokens) -- the same designed sync points as the
reference.

Dummy rows of a padded admit batch are never scattered: the host knows
how many rows are real and only those are written, where the reference
relies on out-of-bounds scatters being dropped.

With ``ServeConfig.aimc`` the engine serves through a
:class:`~repro_torch.core.aimc.NoiseInjectionUnit`: it refreshes the
weights every ``aimc_refresh_every`` rounds, in place, into the tensors
the captured graphs read, and caps a decode block at one round, as the
reference does.

With ``ServeConfig.stream_pu`` the engine plans the weight streaming of
one decode round with the paper's two-phase scheduler
(:func:`plan_model_streaming`, host memory -> HBM on the H100 by default)
and reports the plan in ``stats()`` under ``stream_*``; planning changes
nothing that is served.

With ``stream_pus`` (K >= 2) the engine splits one decode round's GEMMs
across the K profiles (:func:`plan_partitioned_streaming`) and runs
**true per-stage decode**: each round's hidden state flows through the
stage pipeline, every stage executing its model-layer slice against its
own KV-cache slice (``runtime.stage_decode``), with greedy streams equal
to the single-PU engine's.  The stages share the engine's card unless
``launch.mesh.stage_devices`` finds one device per stage; on a shared
device an overlapped block (M > 1 lane groups) runs on the engine's
thread and, on the card, replays one CUDA graph per block length.  The
lane groups' decode states are views of the engine's state tensors, so
splitting and merging them moves nothing.  ``stage_decode=False`` keeps
the single-PU decode loop with the partition attached analytically, and
:meth:`ServingEngine.execute_partition` runs the partition through the
stage-parallel runtime with functional tiles.

Not in this slice (ROADMAP queue 1): the host-sampling path and
CUDA-graph capture of the bucketed prefill (it runs eagerly).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.sanitize import TraceCounter
from repro_torch.configs.base import ModelConfig
from repro_torch.core.aimc import AIMCNoiseModel, NoiseInjectionUnit
from repro_torch.core.pu import PUConfig, h100_host_offload_config
from repro_torch.core.streaming import StreamingPlan, WeightTile, plan_streaming
from repro_torch.kernels import decode as kdecode
from repro_torch.kernels.common import capture_graph, resolve_device
from repro_torch.launch.mesh import stage_devices
from repro_torch.models import api as model_api
from repro_torch.plan import (
    PartitionedPlan,
    SearchConfig,
    partition_gemms,
    snap_boundaries_nonempty,
)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8             # decode slots
    max_len: int = 512             # KV capacity per slot
    max_new_tokens: int = 32
    eos_token: int = -1            # -1: never stop on a token
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0
    # prompt length buckets for batched prefill; None -> power-of-two
    # ladder 16, 32, ... capped at max_len
    prefill_buckets: Optional[Sequence[int]] = None
    # max decode rounds per host sync (blocks are powers of two <= this)
    max_decode_block: int = 32
    pad_token: int = 0             # token fed to inactive/padded lanes
    # hand-written CUDA decode kernels on the per-token hot path; the
    # composed PyTorch path (False) is the A/B reference
    decode_kernels: bool = False
    # AIMC noise emulation (paper SS VI): the NIU refreshes the weights
    # every ``aimc_refresh_every`` engine rounds
    aimc: Optional[AIMCNoiseModel] = None
    aimc_refresh_every: int = 1
    # weight streaming (host->HBM level); None disables planning
    stream_pu: Optional[PUConfig] = None
    # multi-PU partitioned streaming: the model's layer sequence is split
    # across these profiles (contiguous ranges balanced on exec time, one
    # two-phase schedule per PU); overrides ``stream_pu``, and one profile
    # degenerates to it
    stream_pus: Optional[List[PUConfig]] = None
    # schedule-search strategy for the streaming/partition planners
    # (None/heuristic = the paper's one-shot heuristic; beam/anneal search
    # the schedule)
    plan_search: Optional[SearchConfig] = None
    # multi-PU decode rounds run each stage's model-layer slice through
    # the stage pipeline; False keeps the single-PU decode loop with the
    # partition attached analytically
    stage_decode: bool = True
    # lane-group microbatches M of the overlapped staged decode: 0
    # auto-tunes M (and the handoff queue depth) on the executed bubble
    # at construction (runtime.autotune.tune_staged_decode); 1 pins the
    # serial reference schedule; > 1 pins M, clamped to the largest
    # divisor of max_batch <= the request
    decode_microbatches: int = 0
    # handoff queue depth of the staged-decode pipeline when M is pinned
    stage_queue_depth: int = 2
    # target fill/drain bubble of the auto-tuned microbatch depth
    target_bubble: float = 0.10


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def default_prefill_buckets(max_len: int) -> Tuple[int, ...]:
    """Power-of-two ladder 16, 32, ... capped at ``max_len``."""
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))


class ServingEngine:
    """Continuous-batching LM server over the port's model API.

    ``eager=True`` runs the decode blocks as a Python loop on the card
    instead of replaying their CUDA graphs (the A/B reference of the
    capture; the CPU always runs eagerly)."""

    def __init__(self, cfg: ModelConfig, params: Any, serve_cfg: ServeConfig, device=None,
                 *, eager: bool = False):
        if serve_cfg.decode_kernels and not cfg.decode_kernels:
            cfg = dataclasses.replace(cfg, decode_kernels=True)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on {self.device}"
            )
        self.cfg = cfg
        self.api = model_api.get_api(cfg)
        self.serve_cfg = serve_cfg
        self.params = params
        # AIMC: the NIU's output pytree is what every round reads; a
        # refresh rewrites its tensors in place
        self.niu: Optional[NoiseInjectionUnit] = None
        self.aimc_refreshes = 0
        if serve_cfg.aimc is not None and serve_cfg.aimc.enabled():
            self.niu = NoiseInjectionUnit(params, serve_cfg.aimc, seed=serve_cfg.seed)
            self.params = self.niu.params
        # the paper's weight-streaming plan of one decode round (host-side
        # numpy; a single profile in stream_pus is the same plan), or its
        # partition across two or more profiles
        self.streaming_plan: Optional[StreamingPlan] = None
        self.partitioned_plan: Optional[PartitionedPlan] = None
        self.plan_s = 0.0
        pus = serve_cfg.stream_pus or ([serve_cfg.stream_pu] if serve_cfg.stream_pu else [])
        t0 = time.perf_counter()
        if len(pus) == 1:
            self.streaming_plan = plan_model_streaming(
                cfg, pus[0], batch_tokens=serve_cfg.max_batch,
                search=serve_cfg.plan_search,
            )
        elif pus:
            self.partitioned_plan = plan_partitioned_streaming(
                cfg, pus, batch_tokens=serve_cfg.max_batch,
                search=serve_cfg.plan_search,
            )
        self.plan_s = time.perf_counter() - t0
        self.last_pipeline_report = None
        self.last_autotune = None
        # decode blocks as CUDA graphs on the card, one per block length
        self.cuda_graphs = self.device.type == "cuda" and not eager
        self._graphs: Dict[int, Any] = {}
        self._pool = None
        # captures by kind, as the reference counts jit traces
        # (repro.analysis.sanitize); trace_counts aliases the live dict
        self.tracing = TraceCounter(("decode", "prefill"))
        self.trace_counts: Dict[str, int] = self.tracing.counts

        self._queue: deque[Request] = deque()
        self._uid = 0
        self._slots: List[Optional[Request]] = [None] * serve_cfg.max_batch
        self._slot_emitted: List[int] = [0] * serve_cfg.max_batch
        self.completed: List[Request] = []
        self.rounds = 0
        self.decode_rounds = 0
        self.decode_s = 0.0
        # wall-clock per admitted prefill call, keyed by bucket length
        self.prefill_bucket_s: Dict[int, List[float]] = {}

        self._cache = self.api.init_cache(
            cfg, serve_cfg.max_batch, serve_cfg.max_len, self.device
        )
        ladder = [
            b for b in (
                serve_cfg.prefill_buckets
                or default_prefill_buckets(serve_cfg.max_len)
            )
            if b <= serve_cfg.max_len
        ]
        self._buckets = tuple(sorted(set(ladder + [serve_cfg.max_len])))

        B, dev = serve_cfg.max_batch, self.device
        self._state: Dict[str, torch.Tensor] = {
            "tokens": torch.zeros((B, 1), dtype=torch.int32, device=dev),
            "pos": torch.zeros((B,), dtype=torch.int32, device=dev),
            "remaining": torch.zeros((B,), dtype=torch.int32, device=dev),
            "active": torch.zeros((B,), dtype=torch.bool, device=dev),
            "out_buf": torch.zeros((B, serve_cfg.max_len), dtype=torch.int32, device=dev),
            "out_len": torch.zeros((B,), dtype=torch.int32, device=dev),
        }
        self._lanes = torch.arange(B, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(serve_cfg.seed)
        self._setup_staged()

    def _setup_staged(self):
        """True per-stage decode over the partitioned plan: the stages'
        devices, the runner, and its lane-group count M (tuned on the
        executed bubble of a functional probe block, or pinned)."""
        sc = self.serve_cfg
        self.stage_device_groups: Optional[List[List[torch.device]]] = None
        self.stage_devices_shared = False
        self._staged = None
        self._staged_live = False
        # between barriers: the lane groups' decode states, views of _state
        self._staged_groups: Optional[List[Dict[str, Any]]] = None
        self._staged_gens: List[torch.Generator] = []
        self.staged_tune = None
        if self.partitioned_plan is None:
            return
        K = len(self.partitioned_plan.stages)
        devices = None
        if self.device.type == "cuda":
            self.stage_device_groups, self.stage_devices_shared = stage_devices(K)
            devices = (
                [self.device] * K if self.stage_devices_shared
                else [g[0] for g in self.stage_device_groups]
            )
        if not sc.stage_decode:
            return
        from repro_torch.runtime.stage_decode import StagedDecodeRunner

        # stages on one device cannot overlap real compute: keep the
        # overlapped schedule but run each block on this thread (a CUDA
        # graph on the card); distinct devices run the threaded executor
        same_device = devices is None or len(set(devices)) == 1
        self._staged = StagedDecodeRunner(
            self.cfg, self.api, self.params, self.partitioned_plan,
            stage_devices=devices,
            on_trace=self.tracing.bump,
            postdecode=self._postdecode_update,
            coalesce=same_device,
            capture=(
                (lambda fn: self._capture(fn, self._staged_gens))
                if self.cuda_graphs else None
            ),
        )
        if sc.decode_microbatches == 0:
            from repro_torch.runtime.autotune import AutotuneConfig, tune_staged_decode

            self.staged_tune = tune_staged_decode(
                self.partitioned_plan, sc.max_batch,
                AutotuneConfig(target_bubble=sc.target_bubble),
            )
            self._staged.configure(
                n_groups=self.staged_tune.n_groups,
                queue_depth=self.staged_tune.queue_depth,
            )
        else:
            m = max(
                d for d in range(1, sc.max_batch + 1)
                if sc.max_batch % d == 0 and d <= sc.decode_microbatches
            )
            self._staged.configure(n_groups=m, queue_depth=sc.stage_queue_depth)
        # each lane group samples from a generator of its own, seeded
        # from the engine's (the reference chains one key per group)
        if sc.temperature > 0 and self._staged.n_groups > 1:
            self._staged_gens = [
                torch.Generator(device=self.device).manual_seed(self._gen.initial_seed() + 1 + g)
                for g in range(self._staged.n_groups)
            ]

    # -- client API --------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None) -> int:
        # clamp the budget to max_len - 2 so at least two prompt tokens
        # survive truncation (see _truncated_prompt)
        budget = max_new_tokens or self.serve_cfg.max_new_tokens
        req = Request(
            uid=self._uid,
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max(1, min(budget, self.serve_cfg.max_len - 2)),
            submitted_at=time.perf_counter(),
        )
        self._uid += 1
        self._queue.append(req)
        return req.uid

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def run_until_drained(self, max_rounds: int = 10_000) -> List[Request]:
        while (self.pending or self.active) and self.rounds < max_rounds:
            self.step()
        return self.completed

    def warmup(self):
        """Run every (prompt bucket x pow2 admit width) prefill shape once
        and, for every pow2 decode-block length, the block once and (on
        the card) its CUDA-graph capture, so the kernel library is built
        and loaded, and the allocator and matmul libraries are warm before
        live traffic, which then captures nothing.  Warmup admissions
        scatter no row and no slot is active, so the served state is
        untouched -- except the sampling generator, which each call
        advances like a live one when ``temperature > 0``.

        With staged decode the decode part is the reference's: one
        threaded block through the executor (its virtual clock checked
        against the overlapped recurrence, ``clock_ok``), then, where the
        blocks are coalesced, every pow2 block length once (captured on
        the card); the account is then reset."""
        sc = self.serve_cfg
        nbs, nb = [], 1
        while nb < _pow2_ceil(sc.max_batch):
            nbs.append(nb)
            nb *= 2
        nbs.append(_pow2_ceil(sc.max_batch))
        dev = self.device
        for S in self._buckets:
            for nb in nbs:
                self._admit_impl(
                    self.params, self._cache, self._state,
                    torch.full((nb, S), sc.pad_token, dtype=torch.int32, device=dev),
                    torch.ones((nb,), dtype=torch.int32, device=dev),
                    torch.zeros((0,), dtype=torch.int64, device=dev),
                    torch.ones((nb,), dtype=torch.int32, device=dev),
                )
        if self._staged is not None:
            self._warmup_staged()
        else:
            R = 1
            while R <= sc.max_decode_block:
                if R not in self._graphs:
                    self._decode_block(R)
                R *= 2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _warmup_staged(self):
        runner = self._staged
        self._staged_decode_block(2, force_threaded=True)
        if runner.coalesce and runner.n_groups > 1:
            R = 1
            while R <= self.serve_cfg.max_decode_block:
                self._staged_decode_block(R)
                R *= 2
        self._staged_sync_state()
        runner.export_cache()
        runner.flush()
        runner.stage_caches = None
        self._staged_live = False
        runner.rounds_executed = 0
        runner.virtual_busy_s = 0.0
        runner.virtual_span_s = 0.0
        runner.last_report = None

    def step(self):
        """One engine round: the NIU's refresh when it is due, admission,
        then one decode block."""
        sc = self.serve_cfg
        if self.niu is not None and self.rounds % sc.aimc_refresh_every == 0:
            self.niu.refresh()
            self.aimc_refreshes += 1
            if self._staged is not None and self._staged.holds_copies:
                self._staged.rebind(self.params)    # copies on other devices
        self._step_device()

    # ======================================================================
    # device-resident path
    # ======================================================================

    def _sample_device(self, logits: torch.Tensor, gen=None) -> torch.Tensor:
        """Greedy argmax (first maximum, as ``jnp.argmax``), or a
        temperature draw from ``gen`` (default the engine's generator)."""
        sc = self.serve_cfg
        if sc.temperature > 0:
            # torch.multinomial's own draw for one sample (argmax of p / q,
            # q ~ Exp(1)), without its check that reads the probabilities
            # back to the host, which a CUDA graph cannot capture
            probs = torch.softmax(logits.float() / sc.temperature, dim=-1)
            q = torch.empty_like(probs).exponential_(1, generator=gen or self._gen)
            return torch.argmax(probs / q, dim=-1).to(torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _apply_eos(self, done, tok):
        """Fold eos termination into ``done``; any non-negative
        ``eos_token`` -- including 0 -- is a real stop token."""
        if self.serve_cfg.eos_token >= 0:
            return done | (tok == self.serve_cfg.eos_token)
        return done

    def _postdecode_update(self, state: Dict[str, torch.Tensor], logits: torch.Tensor):
        """Sample-append bookkeeping after one decode round, in place.
        Inactive lanes keep their ``out_buf`` row: the write is masked,
        where the reference drops an out-of-bounds scatter.
        Width-polymorphic: the lanes are the state's, so the same
        transition serves the slot batch and a lane group's view of it
        (which samples from its own ``state["gen"]``)."""
        sc = self.serve_cfg
        tok = self._sample_device(logits, state.get("gen"))
        act = state["active"]
        acti = act.to(torch.int32)
        tok = torch.where(act, tok, sc.pad_token)
        col = state["out_len"].clamp(max=sc.max_len - 1).to(torch.int64)
        buf = state["out_buf"]
        lanes = self._lanes[: act.shape[0]]
        buf[lanes, col] = torch.where(act, tok, buf[lanes, col])
        state["out_len"] += acti
        state["pos"] += acti
        state["remaining"] -= acti
        done = (state["remaining"] <= 0) | (state["pos"] >= sc.max_len - 1)
        done = self._apply_eos(done, tok)
        state["active"] &= ~done
        state["tokens"][:, 0] = tok

    def _decode_block_impl(self, params, cache, state, n_rounds: int):
        """``n_rounds`` decode rounds on the device: sample-append and the
        per-slot bookkeeping stay on the device, generated tokens land in
        ``out_buf``; the cache and state are updated in place."""
        for _ in range(n_rounds):
            logits, cache = self.api.decode_step(
                self.cfg, params, cache, state["tokens"], state["pos"]
            )
            self._postdecode_update(state, logits)
        return cache, state

    def _decode_block(self, n_rounds: int):
        """``n_rounds`` decode rounds: on the card a replay of the block's
        CUDA graph (captured at the length's first use, whose eager run on
        the capture stream is then the block), else the eager loop."""
        if not self.cuda_graphs:
            self._decode_block_impl(self.params, self._cache, self._state, n_rounds)
            return
        graph = self._graphs.get(n_rounds)
        if graph is not None:
            graph.replay()
            return
        self.tracing.bump("decode")
        self._graphs[n_rounds], _ = self._capture(
            lambda: self._decode_block_impl(self.params, self._cache, self._state, n_rounds),
            [self._gen],
        )

    def _capture(self, fn, generators):
        """``fn`` captured as a CUDA graph in the engine's pool; when
        sampling, each replay advances ``generators``."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        sampled = tuple(generators) if self.serve_cfg.temperature > 0 else ()
        return capture_graph(fn, pool=self._pool, generators=sampled)

    def _staged_decode_block(self, n_rounds: int, force_threaded: bool = False):
        """``n_rounds`` true per-stage decode rounds: hidden states flow
        through the stage pipeline (every stage running its model-layer
        slice against its own KV cache slice), then the shared
        ``_postdecode_update`` transition applies -- so greedy streams
        equal the single-PU block's.

        With ``n_groups == 1`` each round is one full-batch frame (the
        serial reference).  With M > 1 the decode state is split into M
        lane-group views and the rounds run *overlapped*
        (``StagedDecodeRunner.decode_block``).  Every state operation is
        per lane, so the greedy streams are unchanged; under temperature
        each group draws from its own generator, deterministic per seed
        but another stream than the single-PU loop's."""
        runner = self._staged
        if runner.bound_params is not self.params:
            runner.rebind(self.params)
        if not self._staged_live:
            runner.load_cache(self._cache)
            self._staged_live = True
        M = runner.n_groups
        if M == 1:
            for _ in range(n_rounds):
                logits = runner.decode_round(self._state["tokens"], self._state["pos"])
                self._postdecode_update(self._state, logits)
            return
        if self._staged_groups is None:
            g = self.serve_cfg.max_batch // M
            self._staged_groups = [
                {k: v[i * g:(i + 1) * g] for k, v in self._state.items()}
                for i in range(M)
            ]
            for st, gen in zip(self._staged_groups, self._staged_gens):
                st["gen"] = gen
        runner.decode_block(self._staged_groups, n_rounds, force_threaded=force_threaded)

    def _staged_sync_state(self):
        """The state half of the round-boundary barrier: the lane groups'
        states are views of ``_state``, so every update is already there;
        the groups are dropped, and cut again at the next staged block."""
        self._staged_groups = None

    def _admit_impl(self, params, cache, state, tokens, lengths, slots, max_new):
        """Batched prefill of one length bucket + on-device admission.

        ``slots`` (n,) names the lanes of the first n rows; the remaining
        rows pad the batch to a power of two and are never written."""
        n = slots.shape[0]
        batch = {"tokens": tokens, "lengths": lengths}
        logits, one_cache = self.api.prefill(self.cfg, params, batch)
        tok = self._sample_device(logits)
        scatter_cache_lanes(cache, one_cache, slots)
        # a request whose budget is one token (or whose first token is
        # eos) completes at admission: it never occupies a decode slot
        done0 = self._apply_eos(max_new <= 1, tok)
        state["tokens"][slots, 0] = tok[:n]
        state["pos"][slots] = lengths[:n]
        state["remaining"][slots] = max_new[:n] - 1
        state["active"][slots] = ~done0[:n]
        state["out_buf"][slots, 0] = tok[:n]
        state["out_len"][slots] = 1
        return tok, done0

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _truncated_prompt(self, req: Request) -> np.ndarray:
        """Tail of the prompt that fits the KV budget alongside the
        request's generation budget: the last KV write lands at
        ``keep + max_new - 2``, so ``keep = max_len - max_new``."""
        keep = max(1, self.serve_cfg.max_len - req.max_new_tokens)
        return req.prompt[-keep:]

    def _admit_device(self):
        """Admit every waiting request a free slot can take.  Requests of
        one round whose prompts fall in the same length bucket share a
        single prefill call."""
        sc = self.serve_cfg
        free = [i for i, s in enumerate(self._slots) if s is None]
        admits: List[Tuple[int, Request]] = []
        while free and self._queue:
            admits.append((free.pop(0), self._queue.popleft()))
        if not admits:
            return
        if self._staged is not None and self._staged_live:
            # the round-boundary barrier: admission mutates slot
            # membership, so the per-stage cache slices go back into the
            # master layout first (export_cache also flushes the
            # overlapped session; the slices are cut again at the next
            # staged block, which pays the fill bubble there)
            self._staged_sync_state()
            self._cache = self._staged.export_cache()
            self._staged_live = False
        groups: Dict[int, List[Tuple[int, Request, np.ndarray]]] = {}
        for slot, req in admits:
            prompt = self._truncated_prompt(req)
            groups.setdefault(self._bucket_for(len(prompt)), []).append(
                (slot, req, prompt)
            )

        dev = self.device
        for S, group in sorted(groups.items()):
            nb = len(group)
            # pad the admit batch to a power of two, as the reference does
            nb_pad = _pow2_ceil(nb)
            tokens = np.full((nb_pad, S), sc.pad_token, np.int32)
            lengths = np.ones((nb_pad,), np.int32)
            max_new = np.ones((nb_pad,), np.int32)
            slots = np.zeros((nb,), np.int64)
            for j, (slot, req, prompt) in enumerate(group):
                tokens[j, : len(prompt)] = prompt
                lengths[j] = len(prompt)
                slots[j] = slot
                max_new[j] = req.max_new_tokens
            t0 = time.perf_counter()
            tok, done0 = self._admit_impl(
                self.params, self._cache, self._state,
                torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev),
                torch.from_numpy(slots).to(dev), torch.from_numpy(max_new).to(dev),
            )
            # designed admission-boundary sync: the admit must land
            # before the slots update
            done0_host = done0[:nb].tolist()
            self.prefill_bucket_s.setdefault(S, []).append(time.perf_counter() - t0)
            now = time.perf_counter()
            tok_host = tok[:nb].tolist() if any(done0_host) else None
            for j, (slot, req, prompt) in enumerate(group):
                req.first_token_at = now
                if done0_host[j]:
                    req.out_tokens = [tok_host[j]]
                    req.done_at = now
                    self.completed.append(req)
                else:
                    self._slots[slot] = req
                    self._slot_emitted[slot] = 1

    def _step_device(self):
        """One block: admit (bucketed batched prefill), then the largest
        power-of-two decode block that no active request can out-finish
        (while admissions wait), then sync the per-slot flags."""
        sc = self.serve_cfg
        self._admit_device()
        if not any(s is not None for s in self._slots):
            self.rounds += 1
            return
        remaining = [
            max(1, req.max_new_tokens - self._slot_emitted[i])
            for i, req in enumerate(self._slots)
            if req is not None
        ]
        # with admissions waiting, sync when the earliest slot frees;
        # with an empty queue run until the last slot could finish
        r = min(remaining) if self._queue else max(remaining)
        # with the NIU on, every round sees a fresh noise instance
        cap = 1 if self.niu is not None else sc.max_decode_block
        r = max(1, min(r, cap))
        R = 1 << (r.bit_length() - 1)          # largest power of two <= r
        t0 = time.perf_counter()
        if self._staged is not None:
            self._staged_decode_block(R)
        else:
            self._decode_block(R)
        # the designed block-boundary sync: two (B,) vectors after R rounds
        active, out_len = torch.stack(
            [self._state["active"].to(torch.int32), self._state["out_len"]]
        ).tolist()
        now = time.perf_counter()
        self.decode_s += now - t0
        self.rounds += R
        self.decode_rounds += R
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            self._slot_emitted[i] = out_len[i]
            if not active[i]:
                # designed drain of a finished request's tokens
                req.out_tokens = self._state["out_buf"][i, : out_len[i]].tolist()
                req.done_at = now
                self.completed.append(req)
                self._slots[i] = None

    # -- executed partition (stage-parallel streaming runtime) ---------------
    def execute_partition(self, n_microbatches: Optional[int] = None):
        """Run the partitioned plan through the stage-parallel executor
        (``runtime.pipeline_exec``): K stage threads, per-stage prefetch
        workers honoring issue order, double-buffered handoffs, with
        functional tiles (no weights move).

        ``n_microbatches=None`` (the default) auto-tunes the microbatch
        depth and handoff queue depth against
        ``ServeConfig.target_bubble`` on the *executed* bubble
        (``runtime.autotune``); an integer pins M.  The measured pipeline
        throughput and fill bubble land in :meth:`stats` beside the
        analytic numbers."""
        if self.partitioned_plan is None:
            raise ValueError("engine has no partitioned plan "
                             "(ServeConfig.stream_pus not set or K=1)")
        if n_microbatches is None:
            from repro_torch.runtime.autotune import AutotuneConfig, tune_pipeline

            result = tune_pipeline(
                self.partitioned_plan,
                AutotuneConfig(target_bubble=self.serve_cfg.target_bubble),
            )
            self.last_autotune = result
            self.last_pipeline_report = result.report
            return result.report
        from repro_torch.runtime.pipeline_exec import execute_partitioned_plan

        report = execute_partitioned_plan(
            self.partitioned_plan, n_microbatches=n_microbatches
        )
        self.last_autotune = None     # pinned M supersedes any prior tune
        self.last_pipeline_report = report
        return report

    # -- metrics --------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        done = self.completed
        toks = sum(len(r.out_tokens) for r in done)
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        total = (
            max(r.done_at for r in done) - min(r.submitted_at for r in done)
            if done
            else 0.0
        )
        out = {
            "completed": float(len(done)),
            "tokens": float(toks),
            "rounds": float(self.rounds),
            "tokens_per_s": toks / total if total > 0 else 0.0,
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "device_resident": 1.0,
            "decode_rounds": float(self.decode_rounds),
            "mean_decode_round_s": (
                self.decode_s / self.decode_rounds if self.decode_rounds else 0.0
            ),
            "kernel_launches_qkv": float(kdecode.fused_qkv.launches),
            "kernel_launches_attn": float(kdecode.fused_decode_attention.launches),
            "kernel_launches_mlp": float(kdecode.fused_mlp.launches),
            "cuda_graphs": float(self.cuda_graphs),
            "decode_traces": float(self.trace_counts["decode"]),
            "prefill_traces": float(self.trace_counts["prefill"]),
            "aimc_refreshes": float(self.aimc_refreshes),
        }
        for b, times in sorted(self.prefill_bucket_s.items()):
            out[f"prefill_s_bucket{b}"] = float(np.mean(times))
        if self.streaming_plan is not None:
            out.update(
                {f"stream_{k}": v for k, v in self.streaming_plan.summary().items()}
            )
            out["plan_time_s"] = self.plan_s
        if self.partitioned_plan is not None:
            out.update(self._partition_stats())
        return out

    def _partition_stats(self) -> Dict[str, float]:
        """The reference's ``partition_*`` and ``stage_decode*`` keys."""
        p = self.partitioned_plan
        out = {
            "plan_time_s": self.plan_s,
            "partition_stages": float(len(p.stages)),
            "partition_fps": p.fps,
            "partition_latency_s": p.latency_s,
            "partition_bottleneck_s": p.bottleneck_s,
            "partition_stall_s": sum(s.plan.total_stall for s in p.stages),
        }
        r = self.last_pipeline_report
        if r is not None:
            out.update({
                "partition_executed_fps": r.measured_fps,
                # vs the steady-state analytic fps: < 1 by the fill bubble
                "partition_executed_vs_analytic": (
                    r.measured_fps / r.steady_fps if r.steady_fps > 0 else 0.0
                ),
                "partition_bubble_measured": r.bubble_measured,
                "partition_bubble_predicted": r.bubble_predicted,
                "partition_executed_wall_s": r.wall_s,
                "partition_microbatches": float(r.n_microbatches),
            })
        a = self.last_autotune
        if a is not None:
            out.update({
                "partition_autotuned_m": float(a.n_microbatches),
                "partition_autotuned_queue_depth": float(a.queue_depth),
                "partition_autotune_target_bubble": a.target_bubble,
                "partition_autotune_within_tolerance": float(a.within_tolerance),
                "partition_autotune_trials": float(len(a.trials)),
            })
        if self.stage_device_groups is not None:
            groups = self.stage_device_groups
            out["partition_stage_devices"] = float(
                len(groups[0]) if self.stage_devices_shared
                else sum(len(g) for g in groups)
            )
        runner = self._staged
        if runner is not None:
            # fold any open overlapped session into the virtual account
            # so the reported bubble covers every block
            runner.flush()
            out.update({
                "stage_decode": 1.0,
                "stage_decode_rounds": float(runner.rounds_executed),
                "stage_decode_clock_ok": float(runner.clock_ok),
                "stage_decode_coalesced": float(runner.coalesce),
                "stage_decode_microbatches": float(runner.n_groups),
                "stage_decode_queue_depth": float(runner.queue_depth),
                "stage_decode_bubble": runner.bubble_fraction,
            })
            for k, (a0, b0) in enumerate(runner.ranges):
                out[f"stage{k}_decode_layers"] = float(b0 - a0)
            t = self.staged_tune
            if t is not None:
                out.update({
                    "stage_decode_autotuned": 1.0,
                    "stage_decode_autotune_target_bubble": t.target_bubble,
                    "stage_decode_autotune_within_tolerance": float(t.within_tolerance),
                    "stage_decode_autotune_trials": float(len(t.trials)),
                })
        return out


# -------------------------------------------------------------------------
# cache scatter + streaming-plan construction
# -------------------------------------------------------------------------


def scatter_cache_lanes(batched_cache, group_cache, slots: torch.Tensor):
    """Write the first ``len(slots)`` prefilled sequences of
    ``group_cache`` into cache lanes ``slots``, in place.

    Each leaf is (L, B, S, ...) with the batch on axis 1.  A written lane
    is zero-padded past the prefill, so stale state never survives.  Rows
    of ``group_cache`` beyond ``len(slots)`` (bucket padding) are not
    written."""
    n = slots.shape[0]
    if n == 0:
        return batched_cache
    idx = slots.to(torch.int64)
    for full, one in zip(batched_cache, group_cache):
        s = min(one.shape[2], full.shape[2])
        patch = torch.zeros(
            (full.shape[0], n) + tuple(full.shape[2:]), dtype=full.dtype, device=full.device
        )
        patch[:, :, :s] = one[:, :n, :s].to(full.dtype)
        full.index_copy_(1, idx, patch)
    return batched_cache


def model_gemms(cfg: ModelConfig, batch_tokens: int) -> List[Tuple[str, int, int, int]]:
    """(name, N, M, P) for every weight GEMM of one decode round, in
    inference order -- the schedulable tile sequence of the paper (SS III)
    applied to an LM.  P = tokens per round (the decode batch).
    """
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.head_dim
    gemms: List[Tuple[str, int, int, int]] = []
    p = batch_tokens
    for layer in range(cfg.n_layers):
        pre = f"L{layer}"
        if cfg.family not in ("ssm",):
            gemms.append((f"{pre}/q", cfg.n_heads * hd, d, p))
            gemms.append((f"{pre}/k", cfg.n_kv_heads * hd, d, p))
            gemms.append((f"{pre}/v", cfg.n_kv_heads * hd, d, p))
            gemms.append((f"{pre}/o", d, cfg.n_heads * hd, p))
        if cfg.family in ("ssm", "hybrid"):
            din = cfg.d_inner
            ns, nh = cfg.ssm_state, cfg.ssm_heads
            gemms.append((f"{pre}/ssm_in", 2 * din + 2 * ns + nh, d, p))
            gemms.append((f"{pre}/ssm_out", d, din, p))
        if cfg.is_moe:
            # only routed-to experts need residency: top_k of n_experts
            for e in range(cfg.top_k):
                gemms.append((f"{pre}/expert{e}/up", f, d, p))
                gemms.append((f"{pre}/expert{e}/gate", f, d, p))
                gemms.append((f"{pre}/expert{e}/down", d, f, p))
        elif cfg.d_ff > 0 and cfg.family != "ssm":
            n_mats = 3 if cfg.mlp == "swiglu" else 2
            gemms.append((f"{pre}/mlp_up", f * (n_mats - 1), d, p))
            gemms.append((f"{pre}/mlp_down", d, f, p))
    gemms.append(("unembed", cfg.vocab, d, p))
    return gemms


def plan_model_streaming(
    cfg: ModelConfig,
    pu: Optional[PUConfig] = None,
    batch_tokens: int = 8,
    search: Optional[SearchConfig] = None,
) -> StreamingPlan:
    """Two-phase streaming plan for one decode round of ``cfg``.

    Layer-level granularity (not R_SA rows): at this scale a schedulable
    tile is one weight matrix; the scheduler math is identical.  ``pu``
    defaults to :func:`~repro_torch.core.pu.h100_host_offload_config`
    (the reference defaults to its TPU host-offload profile).
    """
    pu = pu or h100_host_offload_config()
    tiles = [
        WeightTile(name=name, layer_index=i, n=n, m=m, p=p)
        for i, (name, n, m, p) in enumerate(model_gemms(cfg, batch_tokens))
    ]
    return plan_streaming(tiles, pu, search=search)


def _gemm_layer(name: str, n_layers: int) -> int:
    """Model-layer index of a ``model_gemms`` entry (``L{i}/...``);
    layer-less tails (unembed) count as past the last layer."""
    if name.startswith("L"):
        head = name.split("/", 1)[0]
        try:
            return int(head[1:])
        except ValueError:
            pass
    return n_layers


def attach_decode_ranges(
    cfg: ModelConfig,
    gemms: Sequence[Tuple[str, int, int, int]],
    pplan: PartitionedPlan,
) -> PartitionedPlan:
    """Derive each stage's *model-layer* decode range from its GEMM range.

    A model layer belongs to the stage that owns its first GEMM; the
    resulting boundaries are snapped to the family's allowed slice
    points (``ModelAPI.decode_slice_points``) and kept monotone, so the
    ranges tile ``[0, n_layers)`` exactly.  Snapping is
    non-empty-preserving (:func:`repro_torch.plan.partition.
    snap_boundaries_nonempty`): whenever the slice grid has at least K-1
    interior points, every stage owns >= 1 layer.  Only when K exceeds
    what the grid can host does a stage go empty and pass hidden states
    through untouched.  Families the port does not serve yet raise in
    ``get_api``."""
    api = model_api.get_api(cfg)
    pts = sorted(api.decode_slice_points(cfg))
    L = cfg.n_layers
    first_gemm: Dict[int, int] = {}
    for gi, (name, *_rest) in enumerate(gemms):
        first_gemm.setdefault(_gemm_layer(name, L), gi)
    bounds = [0]
    for st in pplan.stages[1:]:
        gs = st.layer_start            # gemm-sequence index
        bounds.append(
            sum(1 for l in range(L) if first_gemm.get(l, 1 << 60) < gs)
        )
    bounds.append(L)
    snapped = [0] + snap_boundaries_nonempty(bounds[1:-1], pts, L) + [L]
    stages = tuple(
        dataclasses.replace(
            s,
            decode_layer_start=snapped[k],
            decode_layer_stop=snapped[k + 1],
        )
        for k, s in enumerate(pplan.stages)
    )
    return PartitionedPlan(stages=stages)


def plan_partitioned_streaming(
    cfg: ModelConfig,
    pus: Sequence[PUConfig],
    batch_tokens: int = 8,
    search: Optional[SearchConfig] = None,
) -> PartitionedPlan:
    """Split one decode round's GEMM sequence across several PU profiles.

    Contiguous GEMM ranges are balanced on each profile's exec-time model
    and each stage gets its own two-phase schedule (capacity + load
    channel per PU).  ``search`` selects each stage's schedule-search
    strategy.  Each stage also carries the model-layer decode range
    (:func:`attach_decode_ranges`) that ``runtime.stage_decode`` runs.
    """
    gemms = model_gemms(cfg, batch_tokens)
    pplan = partition_gemms(gemms, list(pus), search=search)
    return attach_decode_ranges(cfg, gemms, pplan)
