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

Not in this slice (ROADMAP queue 1): the host-sampling path, weight
streaming (``--stream``), multi-PU staged decode, and CUDA-graph capture
of the bucketed prefill (it runs eagerly).
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
from repro_torch.kernels import decode as kdecode
from repro_torch.kernels.common import capture_graph, resolve_device
from repro_torch.models import api as model_api


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
        advances like a live one when ``temperature > 0``."""
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
        R = 1
        while R <= sc.max_decode_block:
            if R not in self._graphs:
                self._decode_block(R)
            R *= 2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(self):
        """One engine round: the NIU's refresh when it is due, admission,
        then one decode block."""
        sc = self.serve_cfg
        if self.niu is not None and self.rounds % sc.aimc_refresh_every == 0:
            self.niu.refresh()
            self.aimc_refreshes += 1
        self._step_device()

    # ======================================================================
    # device-resident path
    # ======================================================================

    def _sample_device(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy argmax (first maximum, as ``jnp.argmax``), or a
        temperature draw from the engine's generator."""
        sc = self.serve_cfg
        if sc.temperature > 0:
            # torch.multinomial's own draw for one sample (argmax of p / q,
            # q ~ Exp(1)), without its check that reads the probabilities
            # back to the host, which a CUDA graph cannot capture
            probs = torch.softmax(logits.float() / sc.temperature, dim=-1)
            q = torch.empty_like(probs).exponential_(1, generator=self._gen)
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
        where the reference drops an out-of-bounds scatter."""
        sc = self.serve_cfg
        tok = self._sample_device(logits)
        act = state["active"]
        acti = act.to(torch.int32)
        tok = torch.where(act, tok, sc.pad_token)
        col = state["out_len"].clamp(max=sc.max_len - 1).to(torch.int64)
        buf = state["out_buf"]
        buf[self._lanes, col] = torch.where(act, tok, buf[self._lanes, col])
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
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self.tracing.bump("decode")
        sampled = (self._gen,) if self.serve_cfg.temperature > 0 else ()
        self._graphs[n_rounds], _ = capture_graph(
            lambda: self._decode_block_impl(self.params, self._cache, self._state, n_rounds),
            pool=self._pool, generators=sampled,
        )

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
        return out


# -------------------------------------------------------------------------
# cache scatter
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
