#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for sm_90a, one
   ``nvcc`` per source, all started together.
2. Kernel phase: each decode kernel against its plain PyTorch version on
   the card at olmo-1b shapes (B=8, d 2048, 16 heads x 128, d_ff 8192,
   Sk 584), every attention mask case and a lane with no slot to attend;
   each decode kernel called twice must give equal bits; then CUDA-event
   times of the kernel, the plain version and one PyTorch library call
   computing the same function, with the L2 flushed before each timed
   call (``Timer``), the kernel also with ``graph_ms`` (over
   ``GRAPH_COPIES`` copies of its weights), and of each launch alone with
   its grid and TB/s (the
   QKV GEMV, the split attention, the MLP's two GEMVs, the attention's
   output projection).
2a. PU kernel phase, on a seeded full-width ResNet-50 (224x224x3 int8
   image): ``int8_gemm`` and ``im2col`` against their plain versions bit
   for bit at the operands of every call of one forward (53 GEMMs on the
   patch matrix with the weights as the forward's (M, N) view and as
   (N, M), each called twice for equal bits; the 19 the forward sends to
   the GEMM's conv mode, on the map itself, twice; the 17 patch matrices,
   also in bf16 and float32), plus the GEMM epilogue cases (bias on/off,
   shift -3/0/7/16, ReLU, residual) and split-K cases (``SPLIT_K_CASES``:
   P = 1, 7, 49, a bias that wraps the int32 sum, both layouts);
   ``niu_refresh`` on every weight matrix with three seeds, |diff| <= 1
   on at most ``NIU_MAX_RATE`` of the elements; one ``niu_plan`` over all
   of them: its max |q| equal to the plain version's, and its rounds
   (three shared seeds, one seed per matrix) bit for bit.  Times of
   kernel, plain version and library yardstick (``torch._int_mm`` + the
   epilogue in torch ops; the ``unfold`` chain; none for the NIU's RNG),
   each distinct call timed cold and summed over one forward (one NIU
   round), and with ``graph_ms``; one line per distinct GEMM shape with
   its tile, split, time, ``torch._int_mm`` time and bound.  The NIU's
   bound counts the instructions per element in the SASS of its fast path
   (``tools/niu_sass.py``) at the SM issue rate.
2b. ResNet phase: launch counts zeroed just before one forward and read
   just after (53 GEMMs, 1 im2col: conv1); the int8 trunk equal bit for bit
   to the CPU's plain forward on the same weights, logits within
   ``RESNET_RTOL`` / ``RESNET_ATOL`` with the same top-5; the float
   reference correlating above 0.7; median ms per image over
   ``FORWARDS`` forwards; a torch.profiler trace of one forward (device
   busy, idle share, top device ops, fewer copy kernels than GEMMs: the
   weights are not re-laid out); the NIU path: one ``niu_plan`` over every
   weight matrix and one round, its launches counted (1 each), the host
   clock of a round (median of ``ROUNDS``) and a profiled round.
2c. ``[graph] resnet``: the same forward captured as one CUDA graph
   (``resnet.capture_forward_int8``): launches zeroed just before one
   call and read just after (53 GEMMs, 1 im2col, added per replay); its
   trunk equal bit for bit to the eager forward's on the card and to the
   CPU's; its logits equal to the eager forward's; ms per image eager and
   captured (median of ``FORWARDS``); the split-K counters and sums left
   at zero by the replays; the idle share of one captured forward.
2d. ``[aimc]`` ResNet: a ``core.aimc.NoiseInjectionUnit`` over the
   ResNet-50's weights (one NIU launch a round through its plan) and the
   forward captured once on its output tensors; ``AIMC_ROUNDS`` rounds of
   refresh + replay: the output buffer at the same address every round,
   the first round's logits equal to an eager forward on the refreshed
   weights, top-1 flips, logit SNR and ms a round (refresh, forward).
2e. ``[stream] resnet``: the paper's weight streaming on the card.  The
   53 convolutions of one forward and the fc (its weights as the PU's
   int8 GEMM over the trunk's last map: the forward's own fc is a float32
   product after the pool) are row-tiled under ``PU_2X`` (64-row tiles,
   ``core.streaming.gemm_sequence_tiles``); the tile list is printed
   against the simulator's (``simulator.model_tiles``), with each
   difference explained; the tiles are planned at ``PU_2X``'s 2 MiB
   (``plan_streaming``) and run through ``StreamingExecutor``
   (``runtime.resnet_streaming``): each tile copied from pinned host
   memory into a 2 MiB device arena on a copy stream, its GEMM through
   ``int8_gemm`` (the conv mode where the main path takes it).  A first
   run, then the timed one with launch counts zeroed just before: every
   call's joined output equal to the resident call's bit for bit, peak
   residency within the capacity, fetches in the plan's issue order, one
   ``int8_gemm`` launch a tile and no im2col.  Tiles, bytes, wall time,
   one pinned copy of the same bytes beside the profiles' link rates, the
   resident calls' wall time, the executor's walk of the plan alone (no
   copy, no GEMM), a profile of one streamed run (device busy; the
   copies' device time and rate; the GEMMs'), and the plan's stall
   reduction and utilization.
2f. ``[pipeline] resnet``: the 54 calls of ``[stream] resnet`` split into
   two stages over PU_1x and PU_2x (``resnet_streaming.partition_calls``,
   the simulator's per-layer latency), 4 images (numpy seeds 0-3) run
   through ``StagePipelineExecutor`` as 4 microbatches
   (``resnet_streaming.stream_partitioned``): each stage streams its tiles
   from pinned host memory into its own arena of its profile's capacity on
   its own copy stream, its GEMMs on its own stream through ``int8_gemm``.
   A first run, then the timed one with launch counts zeroed just before:
   every call of every image equal to its resident run bit for bit, each
   stage's peak residency within its capacity, each stage's fetches in its
   plan's issue order every frame, ``int8_gemm`` launches = tiles x 4;
   the wall time, the measured and predicted bubble, the stages' highest
   overlap.
2g. ``[fleet]``: ``FleetSim(pipelines=[("k2", simulate_partitioned([PU_1X,
   PU_2X], resnet_gemm_layers(50)), 1)]).execute_pipelines(8)`` (host
   side; the CPU tests hold it to the JAX package's).
3. Model step: full-width olmo-1b prefill + one decode step with and
   without the kernels; logits finite and within ``LOGIT_ATOL``.
4. Serve phase (``[serve]``, ``[graph] serve``): ``repro_torch.launch.serve``'s
   engine at full width, ``--requests 16 --prompt-len 512 --max-new 64
   --max-batch 8``, with and without ``--decode-kernels``, each run eager
   and with its decode blocks replayed as CUDA graphs (the default, the
   main path), timed with nothing hooked in.  Launch counts are zeroed
   just before each run and must equal 16 x its decode rounds; the
   captured runs capture nothing after warmup (``retrace_guard``) and
   leave every split-K counter at zero; the greedy streams of the eager
   and captured runs are equal on each path.
   A temperature run eager and captured: equal streams, so each replay
   drew fresh numbers from the engine's generator, as the eager rounds do.
   ``[aimc]`` serve: ``--aimc`` at full width (``AIMC_SERVE_ARGV``),
   captured: no capture after warmup, the weights at the same addresses,
   streams other than the clean run's, tokens/s and the refresh's ms.
4a. ``[stream] serve``: the serve phase's kernel run again with
   ``--stream`` (captured): its greedy streams equal the run without it;
   its ``stream_*`` stats and the planning time, under
   ``core.pu.h100_host_offload_config`` (asserted).
4b. ``[plan] paper``: ``repro_torch.examples.resnet_paper --variant 50
   --plan-only`` (steps 3-4: the two-phase schedule against PU_2x's and
   PU_1x's URAM, and the simulated Table I row; host-side numpy).
4c. ``[multi-pu] serve``: the serve phase's kernel run with ``--multi-pu
   2`` (one decode round's GEMMs split over two copies of the H100
   host-offload profile, every round through the stage pipeline, each
   stage running its own layer slice with the decode kernels): (a) the
   serial schedule, ``--microbatches 1``, eager (stage threads on their
   own streams): its greedy streams equal the single-PU kernel run's; (b)
   the default, M auto-tuned on the executed bubble, the lane-group blocks
   coalesced on the engine's thread and replayed as CUDA graphs: no
   capture after warmup, the split-K counters zero after the replays, and
   its logits held teacher-forced to the single-PU kernel path's within
   ``LOGIT_ATOL`` (an eager staged run fed the single-PU run's tokens
   against an eager single-PU run fed the same), with the count of
   streams that are equal; then ``execute_partition`` (the partition
   through the stage-parallel runtime with functional tiles); (c) with
   two or more cards, the stages on their own devices (the threaded
   executor); with one, a line that says the stages share it.  Tokens/s,
   the round time, ``partition_*`` and ``stage_decode*`` stats, the tuned
   M and queue depth, and each run's launches (16 a layer slice a lane
   group a round).
5. Teacher-forced check: both paths serve the requests again (eager,
   untimed),
   keeping every round's logits; the kernel run is fed the composed
   run's tokens, so at every step of every request the two score the
   same prefix, and their logits must agree within ``LOGIT_ATOL``.
   Each step where the argmax differs is printed with its top-2 gap in
   bf16 ulps.  The timed kernel run's tokens must equal the checked
   run's up to and including their first divergence from the composed
   stream, which ties the served tokens to the checked logits.
6. Fault probes: the teacher-forced check once more with a fault put
   into the kernel path's wiring (RoPE one position late; the current
   token left out of attention); each must move the logits past
   ``LOGIT_ATOL``, so the limit is shown to catch a faulty path.
7. Profile: ``torch.profiler`` over the kernel path's first engine step,
   eager and captured; device time per decode round by kernel (the QKV
   GEMV, ``qkv_gemv_kernel``, apart from the MLP's and ``@ wo``'s
   ``gemv_kernel``), the device's idle share inside the 32-round block,
   and (captured) the launches counted by ``stats()`` against the
   kernels the profiler saw.
8. Print the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

B, D, HQ, HKV, HD, FF, SK, VOCAB, LAYERS = 8, 2048, 16, 16, 128, 8192, 584, 50304, 16
ATOL = RTOL = 2e-2          # bf16 kernel vs plain version, the JAX kernel tests' bar
# Full-model logits, kernel vs composed path on the same tokens.  On an
# H100 the 1008 teacher-forced steps of the serve phase differed by at
# most 0.1445 (median 0.109); the two fault probes moved them by a median
# of 0.48 and 2.08 (max 1.52 and 3.07).  The limit sits between.
LOGIT_ATOL = 0.2
REQUESTS, MAX_NEW = 16, 64
SERVE_ARGV = ["--arch", "olmo-1b", "--requests", str(REQUESTS), "--prompt-len", "512",
              "--max-new", str(MAX_NEW), "--max-batch", "8", "--seed", "0"]
TIMED_CALLS = 30            # CUDA-event timings per kernel; the median is kept
TEMP_ARGV = ["--temperature", "0.8", "--requests", "8", "--max-new", "32"]
# serve --aimc: a few requests at full width, one decode round a block
AIMC_SERVE_ARGV = ["--arch", "olmo-1b", "--requests", "4", "--prompt-len", "128",
                   "--max-new", "16", "--max-batch", "4", "--seed", "0", "--decode-kernels"]
AIMC_ROUNDS = 8             # ResNet-50 NIU rounds (refresh + captured forward)
PIPELINE_IMAGES = 4         # [pipeline] resnet: images, one microbatch each
MULTI_PU = ["--multi-pu", "2"]   # [multi-pu] serve: two stages
AIMC_REFRESHES = 5          # timed LM NIU refreshes; the median is kept
SOURCES = {
    "fused_qkv": "src/repro_torch/kernels/csrc/decode.cu",
    "fused_decode_attention": "src/repro_torch/kernels/csrc/decode.cu",
    "fused_mlp": "src/repro_torch/kernels/csrc/decode.cu",
    "int8_gemm": "src/repro_torch/kernels/csrc/pu.cu",
    "im2col": "src/repro_torch/kernels/csrc/pu.cu",
    "niu_refresh": "src/repro_torch/kernels/csrc/niu.cu",
}
REPLACES = {
    "fused_qkv": "src/repro/kernels/decode.py:210",
    "fused_decode_attention": "src/repro/kernels/decode.py:416",
    "fused_mlp": "src/repro/kernels/decode.py:550",
    "int8_gemm": "src/repro/kernels/int8_gemm.py:147",
    "im2col": "src/repro/kernels/im2col.py:65",
    "niu_refresh": "src/repro/kernels/niu.py:132",
}
# The paper's INT8 ResNet-50 at full width: 224x224x3 int8 image, 1000
# classes, seeded weights; 53 convolutions, 17 of them with a patch matrix
# (k > 1), of which the GEMM's conv mode gathers 16 itself: im2col runs
# once a forward (conv1), and the conv mode 19 times (the 16 3x3 convs and
# the 3 strided 1x1 convs).
RESNET, IMAGE, N_GEMM, N_IM2COL, N_IM2COL_LAUNCHES, N_CONV_MODE = 50, 224, 53, 17, 1, 19
FORWARDS = 30               # timed forwards; the median is kept
ROUNDS = 10                 # timed NIU rounds; the median is kept
# split-K int8_gemm shapes (P, N, M) beside the forward's: P = 1, 7, 49
SPLIT_K_CASES = ((1, 512, 4608), (7, 2048, 512), (49, 512, 4608), (49, 2048, 1024), (7, 100, 2304))
NIU_SEEDS = (0, 12345, -987654321)
NIU_MAX_RATE = 1e-4         # NIU kernel vs plain: |diff| <= 1 on at most this share
# The NIU's work per element, as PR 12 counted it: float32 operations of
# the two Gaussians and the noise model, at the float32 rate.  The bound
# now counts the kernel's SASS instructions per element (tools/niu_sass.py)
# at the SM issue rate; this count is printed beside it.
NIU_OPS_OLD = 43
# ResNet-50 logits, card against the CPU (same torch code, plain versions
# on the CPU): the int8 trunk is equal bit for bit, the float32 fc product
# differs only in summation order.  On an H100 the logits (|logit| up to
# 2.9e5, whose float32 ulp is 0.031) differed by at most 0.0742, i.e.
# 2.4 ulp; the limit allows 8 ulp.
RESNET_RTOL, RESNET_ATOL = 1e-5, 0.25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> dict:
    """HBM bytes/s and dense peak operations/s by type, from the data
    sheets; ``issue``: thread instructions/s the SMs can issue (4 warp
    instructions a cycle per SM, 128 threads, at the boost clock)."""
    if "PCIe" in name:
        return dict(bytes=2.0e12, bf16=756e12, int8=1513e12, f32=51e12, issue=114 * 128 * 1.755e9)
    if "NVL" in name:
        return dict(bytes=3.9e12, bf16=835e12, int8=1671e12, f32=60e12, issue=132 * 128 * 1.785e9)
    from repro_torch.core import pu     # the H100 SXM's data-sheet values, shared with its profiles

    return dict(bytes=pu.H100_HBM_BW, bf16=pu.H100_BF16_FLOPS, int8=pu.H100_INT8_OPS,
                f32=pu.H100_F32_FLOPS, issue=132 * 128 * 1.98e9)


def bound(rates: dict, nb: float, ops: float = 0.0, kind: str = "bf16"):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes, t_ops = nb / rates["bytes"] * 1e3, ops / rates[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each."""

    def __init__(self, torch, iters: int):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


GRAPH_COPIES = 4     # operand copies a timed graph cycles through (> the 50 MB L2 together)
GRAPH_PASSES = 3     # passes over the copies in one graph
GRAPH_REPLAYS = 7    # graph replays timed; the median is kept


def graph_ms(torch, calls) -> float:
    """Median ms per call of ``calls`` (each launching on the current
    stream), captured back to back in one CUDA graph and replayed.  Given
    one call per copy of its operands (``GRAPH_COPIES``, repeated
    ``GRAPH_PASSES`` times), every call reads its operands from HBM and
    finds the L2 clean, and no host time enters, unlike ``Timer``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    side.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for c in calls:
            c()
    times = []
    for _ in range(GRAPH_REPLAYS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / len(calls))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return nbytes(tree)


def kernel_phase(torch, timer, rates):
    import torch.nn.functional as F

    from repro_torch.kernels import decode, ref

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    def close(got, want, what):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL, msg=lambda m: f"{what}: {m}")
        torch.cuda.synchronize()
        return (got.float() - want.float()).abs().max().item()

    rows = {}
    x = rnd(B, D)

    # --- fused_qkv ---------------------------------------------------------
    wq, wk, wv = rnd(D, HQ * HD, scale=0.02), rnd(D, HKV * HD, scale=0.02), rnd(D, HKV * HD, scale=0.02)
    bq, bk, bv = rnd(HQ * HD, scale=0.02), rnd(HKV * HD, scale=0.02), rnd(HKV * HD, scale=0.02)
    pos = torch.randint(0, SK, (B,), generator=g, device="cuda", dtype=torch.int32)
    kw = dict(n_heads=HQ, n_kv_heads=HKV, head_dim=HD, theta=1e4)
    err = 0.0
    for bias in (True, False):
        for rope in (True, False):
            bs = (bq, bk, bv) if bias else (None, None, None)
            got = decode.fused_qkv(x, wq, wk, wv, *bs, pos, rope=rope, **kw)
            want = ref.fused_qkv_ref(x, wq, wk, wv, *bs, pos, rope=rope, **kw)
            for a, b_, n in zip(got, want, "qkv"):
                err = max(err, close(a, b_, f"fused_qkv {n} bias={bias} rope={rope}"))
            again = decode.fused_qkv(x, wq, wk, wv, *bs, pos, rope=rope, **kw)
            assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), \
                f"fused_qkv bias={bias} rope={rope}: two calls differ"
    print("[kernel] fused_qkv: two calls give equal bits in all four (bias, rope) cases", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = decode.qkv_plan(HQ, HKV, HD, D, sms)
    nb = nbytes(x, wq, wk, wv, bq, bk, bv, pos) + 2 * B * (HQ + 2 * HKV) * HD
    t = timer(lambda: decode.fused_qkv(x, wq, wk, wv, bq, bk, bv, pos, **kw))
    print(f"[kernel] fused_qkv launch (qkv_gemv_kernel, bias + rope): kernel_ms={t} "
          f"bound_ms={bound(rates, nb)[0]} ({nb / t / 1e9} TB/s) grid {plan.tiles} column tiles "
          f"{decode.qkv_tiles(HQ, HKV, HD)} x {plan.split} splits of {plan.kt_per} k-tiles",
          flush=True)
    wqkv = torch.cat([wq, wk, wv], dim=1)

    def qkv_library():
        y = (x @ wqkv).reshape(B, HQ + 2 * HKV, HD)
        ang = ref.rope_angles(pos, HD, 1e4)[:, None]
        return ref.rotate_half_split(y[:, : HQ + HKV], torch.cos(ang), torch.sin(ang)), y[:, HQ + HKV:]

    out_bytes = 2 * B * (HQ + 2 * HKV) * HD
    t_bound, by = bound(rates, nbytes(x, wq, wk, wv, pos) + out_bytes, 2 * B * D * (HQ + 2 * HKV) * HD)
    copies = [(wq, wk, wv)] + [tuple(w.clone() for w in (wq, wk, wv)) for _ in range(GRAPH_COPIES - 1)]
    rows["fused_qkv"] = dict(
        max_abs_err=err,
        ms=timer(lambda: decode.fused_qkv(x, wq, wk, wv, None, None, None, pos, **kw)),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_qkv(x, *c, None, None, None, pos, **kw)
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.fused_qkv_ref(x, wq, wk, wv, None, None, None, pos, **kw)),
        library_ms=timer(qkv_library), bound_ms=t_bound, bound_by=by,
    )
    del copies

    # --- fused_decode_attention ----------------------------------------------
    q = rnd(B, HQ, HD)
    k, v = rnd(B, SK, HKV, HD), rnd(B, SK, HKV, HD)
    wo, bo = rnd(HQ * HD, D, scale=0.02), rnd(D, scale=0.02)
    vlen = torch.tensor([520 + 8 * i for i in range(B)], dtype=torch.int32, device="cuda")
    qpos = vlen - 1
    ring = torch.randint(-1, SK + 40, (B, SK), generator=g, device="cuda", dtype=torch.int32)
    cases = {
        "full": dict(q_positions=torch.full((B,), SK - 1, dtype=torch.int32, device="cuda")),
        "valid_len": dict(q_positions=qpos, kv_valid_len=vlen),
        "window_static": dict(q_positions=qpos, kv_valid_len=vlen, window=97),
        "window_dynamic": dict(q_positions=qpos, kv_valid_len=vlen,
                               window_arr=torch.tensor(129, dtype=torch.int32, device="cuda")),
        "ring_lane": dict(q_positions=qpos + 40, kv_positions=ring),
        "ring_shared": dict(q_positions=qpos + 40, kv_positions=ring[0].contiguous()),
        "ring_window": dict(q_positions=qpos + 40, kv_positions=ring,
                            window_arr=torch.tensor(200, dtype=torch.int32, device="cuda")),
        "noncausal": dict(q_positions=qpos, kv_valid_len=vlen, causal=False),
        # lane 0 may attend no slot: the plain version attends all Sk uniformly
        "no_valid_slot": dict(q_positions=qpos, kv_valid_len=torch.cat([vlen[:1] * 0, vlen[1:]])),
    }
    err = 0.0
    for name, ckw in cases.items():
        for bias in (bo, None):
            got = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
            want = ref.decode_attention_ref(q, k, v, wo, bias, **ckw)
            err = max(err, close(got, want, f"fused_decode_attention {name} bias={bias is not None}"))
            again = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
            assert torch.equal(got, again), f"fused_decode_attention {name}: two calls differ"
    print(f"[kernel] fused_decode_attention: two calls give equal bits in all {len(cases)} mask "
          f"cases, with and without bo", flush=True)
    tkw = cases["valid_len"]
    mask = ref.decode_mask(B, SK, q.device, **tkw)                     # (B, Sk)
    used = int(mask.sum().item())                                        # slots this run needs
    kv_bytes = 2 * used * HKV * HD * k.element_size()
    plan = decode.attn_plan(B, HKV, SK, HD, sms)
    nb = nbytes(q, vlen, qpos) + kv_bytes + 2 * B * HQ * HD
    t = timer(lambda: decode._attention_ctx(q, k, v, **tkw))
    print(f"[kernel] fused_decode_attention launch 1 (attn_kernel, valid_len): kernel_ms={t} "
          f"bound_ms={bound(rates, nb)[0]} ({nb / t / 1e9} TB/s of the {used} of {B * SK} slots "
          f"the lanes may attend) grid {B * HKV} (lane, kv-head) x {plan.splits} chunks of "
          f"{plan.chunk} slots", flush=True)
    att_flops = 4 * used * HQ * HD + 2 * B * HQ * HD * D
    t_bound, by = bound(rates, nbytes(q, wo, bo, vlen, qpos) + kv_bytes + 2 * B * D, att_flops)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)                       # (B, H, Sk, hd)
    sdpa_mask = mask[:, None, None, :]

    def attn_library():
        ctx = F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=sdpa_mask)
        return ctx.reshape(B, HQ * HD) @ wo + bo

    copies = [(k, v, wo)] + [tuple(t.clone() for t in (k, v, wo)) for _ in range(GRAPH_COPIES - 1)]
    rows["fused_decode_attention"] = dict(
        max_abs_err=err,
        ms=timer(lambda: decode.fused_decode_attention(q, k, v, wo, bo, **tkw)),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_decode_attention(q, *c, bo, **tkw)
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.decode_attention_ref(q, k, v, wo, bo, **tkw)),
        library_ms=timer(attn_library), bound_ms=t_bound, bound_by=by,
    )
    del copies

    # --- fused_mlp -------------------------------------------------------------
    wu, wg, wd = rnd(D, FF, scale=0.02), rnd(D, FF, scale=0.02), rnd(FF, D, scale=0.02)
    bu, bd = rnd(FF, scale=0.02), rnd(D, scale=0.02)
    err = 0.0
    for act, gate, bias in (("swiglu", wg, True), ("swiglu", wg, False),
                            ("gelu", None, True), ("sq_relu", None, False)):
        bs = (bu, bd) if bias else (None, None)
        got = decode.fused_mlp(x, wu, gate, bs[0], wd, bs[1], act=act)
        want = ref.fused_mlp_ref(x, wu, gate, bs[0], wd, bs[1], act=act)
        err = max(err, close(got, want, f"fused_mlp {act} bias={bias}"))
        again = decode.fused_mlp(x, wu, gate, bs[0], wd, bs[1], act=act)
        assert torch.equal(got, again), f"fused_mlp {act} bias={bias}: two calls differ"
    print("[kernel] fused_mlp: two calls give equal bits in all four (act, bias) cases", flush=True)
    # each of its two launches alone, and the attention's output projection
    h = torch.empty((B, FF), dtype=bf, device="cuda")
    y = torch.empty((B, D), dtype=bf, device="cuda")
    ctx = rnd(B, HQ * HD)
    for what, args, nb in (
        ("fused_mlp launch 1 (gate/up + swiglu)", (x, wg, wu, bu, h, 0), nbytes(x, wg, wu, bu, h)),
        ("fused_mlp launch 2 (down + bias)", (h, wd, None, bd, y, -1), nbytes(h, wd, bd, y)),
        ("fused_decode_attention launch 2 (ctx @ wo + bo)", (ctx, wo, None, bo, y, -1),
         nbytes(ctx, wo, bo, y)),
    ):
        plan = decode.gemv_plan(args[4].shape[1], args[0].shape[1], sms)
        t = timer(lambda a=args, w=what: decode._gemv(*a, w))
        b_ms = bound(rates, nb)[0]
        print(f"[kernel] {what}: kernel_ms={t} bound_ms={b_ms} ({nb / t / 1e9} TB/s) "
              f"grid {plan.tiles} column tiles x {plan.split} splits of {plan.kt_per} k-tiles",
              flush=True)
    t_bound, by = bound(rates, nbytes(x, wu, wg, wd) + 2 * B * D, 2 * B * D * FF * 3)
    copies = [(wu, wg, wd)] + [tuple(w.clone() for w in (wu, wg, wd)) for _ in range(GRAPH_COPIES - 1)]
    rows["fused_mlp"] = dict(
        max_abs_err=err,
        ms=timer(lambda: decode.fused_mlp(x, wu, wg, None, wd, None, act="swiglu")),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_mlp(x, c[0], c[1], None, c[2], None,
                                                               act="swiglu")
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.fused_mlp_ref(x, wu, wg, None, wd, None, act="swiglu")),
        library_ms=timer(lambda: (F.silu(x @ wg) * (x @ wu)) @ wd),
        bound_ms=t_bound, bound_by=by,
    )
    for name, r in rows.items():
        print(f"[kernel] {name}: max_abs_err={r['max_abs_err']} kernel_ms={r['ms']} "
              f"graph_ms={r['graph_ms']} plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']} ({r['bound_by']})", flush=True)
    return rows


def resnet_setup(torch):
    """Full-width seeded ResNet-50 on the card and the image of
    ``repro_torch.examples.resnet_paper`` (numpy seed 0)."""
    import numpy as np

    from repro_torch.models import resnet

    params = resnet.init_params(RESNET, 0, "cuda")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(-100, 100, (IMAGE, IMAGE, 3), dtype=np.int8)).cuda()
    return params, img


def capture_pu_calls(torch, params, img):
    """One forward with ``ops.conv2d_int8`` wrapped: the operands that each
    convolution hands to the GEMM (the patch matrix, the weights as their
    (k*k*Cin, Cout) view, the residual as a (P, N) map), the convolution's
    own arguments and whether the main path sends it to the GEMM's conv
    mode (``conv``), and the operands of each im2col with a patch matrix."""
    from repro_torch.kernels import ops
    from repro_torch.models import resnet

    conv = ops.conv2d_int8
    gemms, cols = [], []

    def rec_conv(x, w4d, bias=None, *, k, stride=1, pad=0, shift=0, relu=False, residual=None):
        if not (k == 1 and pad == 0):
            cols.append(dict(img=x, k=k, stride=stride, pad=pad,
                             conv_mode=ops.takes_conv_mode(x, w4d, k, stride, pad)))
        cout = w4d.shape[-1]
        gemms.append(dict(a=ops.im2col(x, k, stride, pad), w=w4d.reshape(-1, cout), layout="mn",
                          bias=bias, shift=shift, relu=relu,
                          residual=None if residual is None else residual.reshape(-1, cout),
                          conv=dict(img=x, w4d=w4d, k=k, stride=stride, pad=pad, residual=residual),
                          conv_mode=ops.takes_conv_mode(x, w4d, k, stride, pad)))
        return conv(x, w4d, bias, k=k, stride=stride, pad=pad, shift=shift, relu=relu,
                    residual=residual)

    ops.conv2d_int8 = rec_conv
    try:
        resnet.forward_int8(RESNET, params, img)
    finally:
        ops.conv2d_int8 = conv
    torch.cuda.synchronize()
    assert len(gemms) == N_GEMM and len(cols) == N_IM2COL, (len(gemms), len(cols))
    assert sum(c["conv_mode"] for c in gemms) == N_CONV_MODE
    return gemms, cols


def per_call_times(timer, calls, key, fns):
    """Median ms of each function in ``fns`` for each distinct ``key`` of
    ``calls``, summed over all calls (every call timed cold, alone); and
    the times of each distinct key."""
    seen, totals = {}, {name: 0.0 for name in fns}
    for c in calls:
        k = key(c)
        if k not in seen:
            seen[k] = {name: timer(lambda f=f: f(c)) for name, f in fns.items()}
            print(f"[pu]   {k}: " + " ".join(f"{n}={t}" for n, t in seen[k].items()), flush=True)
        for name in fns:
            totals[name] += seen[k][name]
    return totals, seen


def pu_kernel_phase(torch, timer, rates, params, img):
    """int8_gemm and im2col held bit for bit to their plain versions at
    every call of a ResNet-50 forward (and the GEMM's epilogue cases),
    niu_refresh on every weight matrix under the mismatch gate; times of
    kernel, plain version and library yardstick; bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")
    kniu = importlib.import_module("repro_torch.kernels.niu")
    kim = importlib.import_module("repro_torch.kernels.im2col")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gemms, cols = capture_pu_calls(torch, params, img)
    rows = {}

    # --- int8_gemm -----------------------------------------------------------
    def kernel(c, **over):
        c = {**c, **over}
        return kgemm.int8_gemm_pn(c["a"], c["w"], c["bias"], c["shift"], c["residual"],
                                  relu=c["relu"], w_layout=c["layout"])

    def plain(c, **over):
        c = {**c, **over}
        res = None if c["residual"] is None else c["residual"].T
        w = c["w"].T if c["layout"] == "mn" else c["w"]
        return ref.int8_gemm_ref(w, c["a"].T, c["bias"], c["shift"], c["relu"], res).T

    def exact(got, want, what):
        d = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
        assert d == 0 and got.dtype == want.dtype and got.shape == want.shape, f"{what}: differs by {d}"
        return d

    err = 0
    for i, c in enumerate(gemms):
        what = f"int8_gemm call {i} {tuple(c['a'].shape)}x{tuple(c['w'].shape)}"
        got = kernel(c)
        err = max(err, exact(got, plain(c), what))
        assert torch.equal(got, kernel(c)), f"{what}: two calls differ"
        nm = dict(w=c["w"].T.contiguous(), layout="nm")          # the public (N, M) layout
        err = max(err, exact(kernel(c, **nm), got, f"{what} with (N, M) weights"))
    print(f"[pu] int8_gemm: the {len(gemms)} forward calls equal the plain version bit for bit "
          f"with the weights as the main path's (M, N) view and as (N, M), and a second call "
          f"gives equal bits", flush=True)

    def conv(c):       # the conv mode, on the convolution's own arguments
        v = c["conv"]
        return kgemm.int8_conv_gemm(v["img"], v["w4d"], c["bias"], c["shift"], v["residual"],
                                    k=v["k"], stride=v["stride"], pad=v["pad"],
                                    relu=c["relu"]).reshape(-1, c["w"].shape[1])

    def main(c):       # the GEMM as the main path launches it
        return conv(c) if c["conv_mode"] else kernel(c)

    conv_calls = [c for c in gemms if c["conv_mode"]]
    for i, c in enumerate(conv_calls):
        v = c["conv"]
        what = f"int8_gemm conv mode call {i} map {tuple(v['img'].shape)} k={v['k']} s={v['stride']}"
        got = conv(c)
        err = max(err, exact(got, plain(c), what))
        assert torch.equal(got, conv(c)), f"{what}: two calls differ"
    print(f"[pu] int8_gemm conv mode: the {len(conv_calls)} calls the main path sends to it "
          f"({sum(c['conv']['k'] == 3 for c in conv_calls)} 3x3, "
          f"{sum(c['conv']['k'] == 1 for c in conv_calls)} strided 1x1) equal the plain "
          f"version (im2col + GEMM) bit for bit, and a second call gives equal bits", flush=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = 0
    for c in (gemms[1], next(c for c in gemms if c["residual"] is not None)):
        p, n = c["a"].shape[0], c["w"].shape[1]
        bias = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=g, device="cuda", dtype=torch.int32)
        res = torch.randint(-128, 128, (p, n), generator=g, device="cuda", dtype=torch.int8)
        for b in (None, bias):
            for shift in (-3, 0, 7, 16):
                for relu in (False, True):
                    for r in (None, res):
                        over = dict(bias=b, shift=shift, relu=relu, residual=r)
                        err = max(err, exact(kernel(c, **over), plain(c, **over), f"int8_gemm epilogue {over}"))
                        cases += 1
    c = gemms[0]
    w, x = c["w"].T.contiguous(), c["a"].T.contiguous()
    err = max(err, exact(ops.int8_gemm(w, x, c["bias"], c["shift"], relu=True),
                         ref.int8_gemm_ref(w, x, c["bias"], c["shift"], True), "public int8_gemm"))
    print(f"[pu] int8_gemm: {cases} epilogue cases equal the plain version bit for bit", flush=True)
    # split-K, P in {1, 7, 49}, a bias that wraps the int32 sum, both layouts
    split_cases = 0
    for p, n, m in SPLIT_K_CASES:
        a = torch.randint(-128, 128, (p, m), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-128, 128, (m, n), generator=g, device="cuda", dtype=torch.int8)
        bias = torch.randint(2 ** 31 - 2 ** 22, 2 ** 31 - 1, (n,), generator=g, device="cuda",
                             dtype=torch.int32)
        bias[1::2] *= -1
        res = torch.randint(-128, 128, (p, n), generator=g, device="cuda", dtype=torch.int8)
        plan = kgemm.gemm_plan(p, n, m, sms)
        assert plan.split > 1, (p, n, m, plan)
        for shift, r, relu in ((0, None, False), (16, res, True), (-3, res, False)):
            c = dict(a=a, w=w, layout="mn", bias=bias, shift=shift, residual=r, relu=relu)
            got, want = kernel(c), plain(c)
            err = max(err, exact(got, want, f"int8_gemm split-K {(p, n, m)} {plan} shift={shift}"))
            assert torch.equal(got, kernel(c)), f"split-K {(p, n, m)}: two calls differ"
            err = max(err, exact(kernel(c, w=w.T.contiguous(), layout="nm"), want,
                                 f"int8_gemm split-K {(p, n, m)} (N, M) weights"))
            split_cases += 1
    ps = sorted({p for p, _, _ in SPLIT_K_CASES})
    print(f"[pu] int8_gemm: {split_cases} split-K cases (P in {ps}, "
          f"a bias that wraps the int32 sum, both weight layouts) equal the plain version bit for "
          f"bit, two calls equal", flush=True)

    def library(c):
        a, w = c["a"], (c["w"].T if c["layout"] == "mn" else c["w"])
        p, m = a.shape
        ap = torch.zeros((max(p, 17), -(-m // 8) * 8), dtype=torch.int8, device="cuda")
        wp = torch.zeros((w.shape[0], ap.shape[1]), dtype=torch.int8, device="cuda")
        ap[:p, :m], wp[:, :m] = a, w
        bias, shift, res, relu = c["bias"], c["shift"], c["residual"], c["relu"]

        def run():     # cuBLASLt int8 GEMM on operands padded to its shape rules
            acc = torch._int_mm(ap, wp.t())[:p]
            if bias is not None:
                acc = acc + bias
            return ref._epilogue(acc, shift, relu, res)
        run.int_mm = lambda: torch._int_mm(ap, wp.t())
        return run

    libs = [library(c) for c in gemms]
    exact(libs[1](), kernel(gemms[1]), "torch._int_mm yardstick")
    lib_of = {id(c): f for c, f in zip(gemms, libs)}
    def gemm_key(c):
        return (tuple(c["a"].shape), tuple(c["w"].shape), c["residual"] is not None, c["relu"],
                c["conv_mode"])

    times, seen = per_call_times(
        timer, gemms, gemm_key,
        dict(ms=main, plain_ms=plain, library_ms=lambda c: lib_of[id(c)](),
             int_mm_alone_ms=lambda c: lib_of[id(c)].int_mm()),
    )
    times["graph_ms"] = graph_ms(torch, [lambda c=c: main(c) for c in gemms]) * len(gemms)
    print(f"[pu] int8_gemm: torch._int_mm alone (no epilogue) {times.pop('int_mm_alone_ms')} ms "
          f"over the forward's calls", flush=True)

    def gemm_bytes(c):     # the conv mode reads the map, not a patch matrix
        p, n = c["a"].shape[0], c["bias"].shape[0]
        a = c["conv"]["img"] if c["conv_mode"] else c["a"]
        return nbytes(a, c["w"], c["bias"], c["residual"]) + p * n

    for k, t in seen.items():      # one line per distinct GEMM of the forward
        c = next(c for c in gemms if gemm_key(c) == k)
        (p, m), n = c["a"].shape, c["bias"].shape[0]
        plan = kgemm.gemm_plan(p, n, m, sms)
        b_ms, b_by = bound(rates, gemm_bytes(c), 2 * p * n * m, "int8")
        print(f"[pu] int8_gemm shape P={p} N={n} M={m} residual={k[2]} conv_mode={k[4]} calls="
              f"{sum(gemm_key(x) == k for x in gemms)}: tile {kgemm.GEMM_TILE} split {plan.split} "
              f"({plan.kt_per} k-tiles each, {plan.blocks} blocks) kernel_ms={t['ms']} "
              f"int_mm_alone_ms={t['int_mm_alone_ms']} bound_ms={b_ms} ({b_by})", flush=True)
    nb = sum(gemm_bytes(c) for c in gemms)
    ops_ = sum(2 * c["a"].shape[0] * c["bias"].shape[0] * c["a"].shape[1] for c in gemms)
    t_bound, by = bound(rates, nb, ops_, "int8")
    rows["int8_gemm"] = dict(max_abs_err=err, bound_ms=t_bound, bound_by=by, **times)
    print(f"[pu] int8_gemm over one forward's {len(gemms)} calls: {nb} bytes, {ops_} int8 operations", flush=True)

    # --- im2col --------------------------------------------------------------
    err = 0
    for i, c in enumerate(cols):
        for dt in (torch.int8, torch.bfloat16, torch.float32):
            x = c["img"].to(dt)
            got, want = kim.im2col(x, c["k"], c["stride"], c["pad"]), ref.im2col_ref(x, c["k"], c["stride"], c["pad"])
            assert got.dtype == dt and torch.equal(got, want), f"im2col call {i} {tuple(x.shape)} {dt}"
    print(f"[pu] im2col: {len(cols)} forward calls equal the plain version bit for bit in int8, "
          f"bf16 and float32", flush=True)

    def unfold(c):     # the unfold-view chain, made contiguous
        x, k, st, pd = c["img"], c["k"], c["stride"], c["pad"]
        xp = F.pad(x, (0, 0, pd, pd, pd, pd))
        return xp.unfold(0, k, st).unfold(1, k, st).permute(0, 1, 3, 4, 2).reshape(-1, k * k * x.shape[2])

    assert torch.equal(unfold(cols[1]), kim.im2col(cols[1]["img"], cols[1]["k"], cols[1]["stride"], cols[1]["pad"]))

    def im2col_times(calls):
        return per_call_times(
            timer, calls, lambda c: (tuple(c["img"].shape), c["k"], c["stride"], c["pad"]),
            dict(ms=lambda c: kim.im2col(c["img"], c["k"], c["stride"], c["pad"]),
                 plain_ms=lambda c: ref.im2col_ref(c["img"], c["k"], c["stride"], c["pad"]),
                 library_ms=unfold),
        )[0]

    print(f"[pu] im2col alone over all {len(cols)} patch matrices of a forward (PR 16's row): "
          f"{im2col_times(cols)}", flush=True)
    # the main path's calls: the convolutions the GEMM's conv mode does not gather
    cols = [c for c in cols if not c["conv_mode"]]
    assert len(cols) == N_IM2COL_LAUNCHES, len(cols)
    times = im2col_times(cols)
    copies = [dict(c, img=c["img"].clone()) for c in cols for _ in range(GRAPH_COPIES)]
    times["graph_ms"] = graph_ms(torch, [
        lambda c=c: kim.im2col(c["img"], c["k"], c["stride"], c["pad"]) for c in copies
    ] * GRAPH_PASSES) * len(cols)
    nb = 0
    for c in cols:
        h, w_, ch = c["img"].shape
        oh = (h + 2 * c["pad"] - c["k"]) // c["stride"] + 1
        ow = (w_ + 2 * c["pad"] - c["k"]) // c["stride"] + 1
        nb += h * w_ * ch + oh * ow * c["k"] ** 2 * ch
    t_bound, by = bound(rates, nb)
    rows["im2col"] = dict(max_abs_err=0, bound_ms=t_bound, bound_by=by, **times)

    # --- niu_refresh -----------------------------------------------------------
    mats = niu_matrices(params)
    worst, bad, total = 0, 0, 0
    for q, e in mats:
        for seed in NIU_SEEDS:
            d = (ops.niu_refresh(q, e, seed).to(torch.int32) - ops.niu_refresh_ref(q, e, seed).to(torch.int32)).abs()
            worst, bad, total = max(worst, d.max().item()), bad + (d > 0).sum().item(), total + d.numel()
    rate = bad / total
    print(f"[pu] niu_refresh: {len(mats)} weight matrices x {len(NIU_SEEDS)} seeds, {total} elements: "
          f"{'bit for bit equal' if bad == 0 else f'{bad} differ (rate {rate})'}, max |diff| {worst} "
          f"(gate: <= 1 on at most {NIU_MAX_RATE})", flush=True)
    assert worst <= 1 and rate <= NIU_MAX_RATE, (worst, rate)
    # the round's main path: one plan over every matrix, one launch a round
    plan = kniu.niu_plan(mats)
    amax = torch.stack([q.to(torch.int32).abs().amax() for q, _ in mats])
    assert torch.equal(plan.amax, amax), "niu_plan: max |q| differs from the plain version"
    seeds = torch.tensor([NIU_SEEDS[i % len(NIU_SEEDS)] + i for i in range(len(mats))],
                         dtype=torch.int32, device="cuda")
    plan_worst = 0
    for seed in (*NIU_SEEDS, seeds):
        outs = plan.refresh(seed)
        for m, ((q, e), got) in enumerate(zip(mats, outs)):
            s = seed[m] if isinstance(seed, torch.Tensor) else seed
            d = (got.to(torch.int32) - ops.niu_refresh_ref(q, e, s).to(torch.int32)).abs().max()
            plan_worst = max(plan_worst, d.item())
    print(f"[pu] niu_plan: max |q| of the {len(mats)} matrices equal to the plain version; "
          f"refresh over all of them, {len(NIU_SEEDS)} shared seeds and one seed per matrix: "
          f"max |diff| {plan_worst} against the plain version (bit for bit)", flush=True)
    assert plan_worst == 0, plan_worst
    n_el = sum(q.numel() for q, _ in mats)
    sass = niu_sass_count()
    t_bound, by = bound(rates, 2 * n_el, sass["fast_path"] * n_el, "issue")
    print(f"[pu] niu_refresh bound: {sass['fast_path']} SASS instructions per element on the fast "
          f"path ({sass['mufu']} MUFU; {sass['total']} in the probe with its slow paths) at "
          f"{rates['issue']} instructions/s: {t_bound} ms ({by}; the bytes alone "
          f"{bound(rates, 2 * n_el)[0]} ms); PR 12's count, {NIU_OPS_OLD} float32 operations per "
          f"element at the float32 rate: {bound(rates, 2 * n_el, NIU_OPS_OLD * n_el, 'f32')[0]} ms",
          flush=True)
    copies = [kniu.niu_plan([(q.clone(), e) for q, e in mats]) for _ in range(GRAPH_COPIES)]
    rows["niu_refresh"] = dict(
        max_abs_err=max(worst, plan_worst), bound_ms=t_bound, bound_by=by,
        ms=timer(lambda: plan.refresh(1)),
        graph_ms=graph_ms(torch, [lambda p=p: p.refresh(1) for p in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: [ops.niu_refresh_ref(q, e, 1) for q, e in mats]),
        library_ms=None,       # no PyTorch call computes the counter-hash RNG
    )
    del copies
    what = {"int8_gemm": f"the {N_GEMM} calls of one forward", "im2col": f"the {N_IM2COL_LAUNCHES} "
            f"call of one forward", "niu_refresh": f"one round over {len(mats)} matrices"}
    for name, r in rows.items():
        print(f"[pu] {name} ({what[name]}): max_abs_err={r['max_abs_err']} kernel_ms={r['ms']} "
              f"graph_ms={r['graph_ms']} plain_ms={r['plain_ms']} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} ({r['bound_by']})", flush=True)
    return rows


def niu_sass_count() -> dict:
    """``tools/niu_sass.py``'s count of the NIU kernel's SASS instructions
    per element (loaded from its file: ``tools`` is no package)."""
    import importlib.util

    from repro_torch.kernels import build

    spec = importlib.util.spec_from_file_location("niu_sass", ROOT / "tools" / "niu_sass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count(build)


def niu_matrices(params):
    """Every weight matrix of the model as (k*k*cin, cout) int8 and its exponent."""
    return [(p["w"].q.reshape(-1, p["w"].q.shape[-1]), p["w"].exp) for p in params.values()]


def resnet_phase(torch, rates, params, img):
    """Full-width ResNet-50 on the card: launches of the main path, the
    trunk and logits against the CPU's plain forward, the float reference,
    ms per image, a profile of one forward, and one NIU round."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import common
    from repro_torch.models import resnet

    kniu = importlib.import_module("repro_torch.kernels.niu")
    resnet.forward_int8(RESNET, params, img)
    torch.cuda.synchronize()
    common.reset_launches()                     # count the main path's run only
    logits = resnet.forward_int8(RESNET, params, img)
    torch.cuda.synchronize()
    launches = common.launch_counts()
    print(f"[resnet] launches in one forward: {launches}", flush=True)
    assert launches["int8_gemm"] == N_GEMM and launches["im2col"] == N_IM2COL_LAUNCHES, launches
    assert logits.shape == (1000,) and logits.dtype == torch.float32 and torch.isfinite(logits).all().item()

    cpu = {name: {k: v.to("cpu") for k, v in layer.items()} for name, layer in params.items()}
    trunk_card = resnet._trunk_int8(RESNET, params, img)
    trunk = trunk_card.cpu()
    trunk_cpu = resnet._trunk_int8(RESNET, cpu, img.cpu())
    assert trunk.dtype == torch.int8 and torch.equal(trunk, trunk_cpu), "trunk differs from the CPU's"
    want = resnet.forward_int8(RESNET, cpu, img.cpu())
    got = logits.cpu()
    diff = (got - want).abs()
    top5, top5_cpu = torch.topk(got, 5).indices.tolist(), torch.topk(want, 5).indices.tolist()
    print(f"[resnet] trunk {tuple(trunk.shape)} int8 equal to the CPU's bit for bit; logits "
          f"|card - cpu| max {diff.max().item()}, max relative {(diff / want.abs()).max().item()} "
          f"(|logit| up to {want.abs().max().item()}; rtol {RESNET_RTOL}, atol {RESNET_ATOL}); "
          f"top-5 {top5} (cpu {top5_cpu})", flush=True)
    torch.testing.assert_close(got, want, rtol=RESNET_RTOL, atol=RESNET_ATOL)
    assert top5 == top5_cpu
    lf = resnet.forward_float(RESNET, params, img).cpu()
    corr = torch.corrcoef(torch.stack([got, lf]))[0, 1].item()
    print(f"[resnet] forward_float on the card: corr(int8, float) = {corr} (bar 0.7)", flush=True)
    assert torch.isfinite(lf).all().item() and corr > 0.7, corr

    times = []
    for _ in range(FORWARDS):
        t0 = time.perf_counter()
        resnet.forward_int8(RESNET, params, img)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"[resnet] forward_int8 {IMAGE}x{IMAGE}, batch 1: median {ms} ms per image over "
          f"{FORWARDS} forwards (min {min(times) * 1e3}, max {max(times) * 1e3}) = "
          f"{1e3 / ms} images/s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("resnet_forward"):
            resnet.forward_int8(RESNET, params, img)
            torch.cuda.synchronize()
    window, busy, by_name = device_busy(torch, prof, "resnet_forward")
    print(f"[profile] one ResNet-50 forward: {window / 1e3} ms under the profiler, device busy "
          f"{busy / 1e3} ms, idle share {1 - busy / window}; busy / unprofiled forward "
          f"({ms} ms) = {busy / 1e3 / ms}", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   {us / 1e3} ms  {name[:110]}", flush=True)
    # the GEMM reads the weights as they lie: no re-layout copy per conv
    cuda = torch.autograd.DeviceType.CUDA
    copies = [e.name for e in prof.events() if e.device_type == cuda and "copy" in e.name.lower()]
    print(f"[profile] copy kernels in the forward: {len(copies)} launches, "
          f"{sum(us for n, us in by_name.items() if 'copy' in n.lower()) / 1e3} ms "
          f"(the weight re-layout took {N_GEMM} of them before the GEMM read the (M, N) view)",
          flush=True)
    assert len(copies) < N_GEMM, copies

    # the NIU path: a plan over every weight matrix (once per pristine
    # weight set), then one launch a round
    mats = niu_matrices(params)
    common.reset_launches()
    plan = kniu.niu_plan(mats)
    noisy = plan.refresh(7)
    torch.cuda.synchronize()
    counts = common.launch_counts()
    niu_launches = counts["niu_refresh"]
    assert niu_launches == 1 and counts["niu_plan"] == 1, counts
    assert all(n.shape == q.shape and n.dtype == torch.int8 for n, (q, _) in zip(noisy, mats))
    rounds = []
    for seed in range(ROUNDS):
        t0 = time.perf_counter()
        plan.refresh(seed)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) * 1e3)
    round_ms = statistics.median(rounds)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("niu_round"):
            plan.refresh(8)
            torch.cuda.synchronize()
    window, busy, by_name = device_busy(torch, prof, "niu_round")
    kernel_us = sum(us for n, us in by_name.items() if "niu_refresh_kernel" in n)
    print(f"[niu] one NIU round over {len(mats)} weight matrices ({sum(q.numel() for q, _ in mats)} "
          f"int8 weights) through one plan: {round_ms} ms on the host clock (median of {ROUNDS} "
          f"rounds, min {min(rounds)}, max {max(rounds)}), launches {niu_launches} a round (the "
          f"plan's max |q|: {counts['niu_plan']} launch, once); under the profiler {window / 1e3} "
          f"ms, device busy {busy / 1e3} ms, of it niu_refresh_kernel {kernel_us / 1e3} ms; device "
          f"ops {sorted(by_name)}", flush=True)
    return dict(launches={**launches, "niu_refresh": niu_launches}, ms=ms, trunk=trunk_card,
                trunk_cpu=trunk_cpu, logits=logits)


def model_step_phase(torch):
    """Full-width prefill + one decode step, kernels against composed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("olmo-1b")
    params = transformer.init_params(cfg, 0, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g, device="cuda")
    logits, pcache = transformer.prefill(cfg, params, tokens)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all().item()
    out = {}
    for use in (False, True):
        c = dataclasses.replace(cfg, decode_kernels=use)
        # per-lane (B,) write positions, as serving passes, and a shared ()
        for shared in (False, True):
            cache = transformer.init_cache(c, 2, 128, "cuda")
            for full, part in zip(cache, pcache):
                full[:, :, :64] = part
            step_tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = torch.tensor(64, dtype=torch.int32, device="cuda")
            out[use, shared], _ = transformer.decode_step(
                c, params, cache, step_tok, pos if shared else pos.expand(2).clone()
            )
    torch.cuda.synchronize()
    for lg in out.values():
        assert lg.shape == (2, cfg.vocab) and torch.isfinite(lg).all().item()
    for shared in (False, True):
        diff = (out[True, shared] - out[False, shared]).abs().max().item()
        print(f"[model] decode-step logits |kernel - composed| max {diff} "
              f"({'shared' if shared else 'per-lane'} position; atol {LOGIT_ATOL})", flush=True)
        assert diff <= LOGIT_ATOL, diff
    del params


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def serve_engine(serve, kernels: bool, eager: bool = False, extra=()):
    """The launcher's engine for the serve phase's requests (``extra``
    arguments after them), warmed up, with the requests queued; its
    decode blocks replay CUDA graphs unless ``eager``."""
    argv = SERVE_ARGV + (["--decode-kernels"] if kernels else []) + list(extra)
    args = serve.build_parser().parse_args(argv)
    engine = serve.make_engine(args, eager=eager)
    engine.warmup()
    serve.submit_requests(engine, args)
    return engine


def served(torch, engine):
    """Serve the queued requests with nothing hooked in, launch counts
    zeroed just before and read just after; no capture may happen."""
    from repro_torch.analysis.sanitize import retrace_guard
    from repro_torch.kernels import decode

    captures = engine.tracing.total()
    decode.reset_launches()                 # count this run only
    with retrace_guard(engine.tracing):
        engine.run_until_drained()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in decode.KERNELS}
    return engine.stats(), launches, captures


def scratch_left_zero(torch, graphs, what: str) -> int:
    """The split-K kernels' tile counters (and the GEMM's int32 sums) are
    zero after ``what``: every scratch in ``common`` and every one the
    ``graphs`` keep.  A kernel that left one non-zero would corrupt the
    next call, eager or replayed.  Returns how many were checked."""
    from repro_torch.kernels import common

    torch.cuda.synchronize()
    pairs = [((k[0],), p) for k, p in common._SCRATCH.items()]
    pairs += [(("pinned",), p) for g in graphs for p in g._keep]
    for (kernel,), (ws, cnt) in pairs:
        assert not cnt.any().item(), f"{what}: {kernel} tile counters left non-zero"
        assert ws.dtype != torch.int32 or not ws.any().item(), f"{what}: GEMM sums left non-zero"
    print(f"[graph] after {what}: the split-K counters and the GEMM's sums of {len(pairs)} "
          f"scratch pairs are zero", flush=True)
    return len(pairs)


def serve_phase(torch, rates):
    """Timed runs of both paths, each eager and captured (the main path),
    nothing hooked in: stats, launch counts of each run, the greedy
    streams, equal between eager and captured; then a temperature run
    eager and captured."""
    from repro_torch.launch import serve

    runs = {}
    for kernels in (False, True):
        for eager in (True, False):
            engine = serve_engine(serve, kernels, eager)
            st, launches, captures = served(torch, engine)
            streams = {r.uid: r.out_tokens for r in engine.completed}
            label = ("kernels" if kernels else "composed") + ("_eager" if eager else "")
            tag = "[serve]" if eager else "[graph] serve"
            print(f"{tag} {label}: tokens_per_s={st['tokens_per_s']} mean_ttft_s={st['mean_ttft_s']} "
                  f"mean_decode_round_s={st['mean_decode_round_s']} decode_rounds={st['decode_rounds']} "
                  f"launches={launches} graphs captured at warmup={captures} after=0", flush=True)
            assert st["completed"] == REQUESTS and len(streams) == REQUESTS, st
            assert all(len(s) == MAX_NEW and all(0 <= t < VOCAB for t in s) for s in streams.values())
            assert st["cuda_graphs"] == float(not eager) and captures == (0 if eager else 6), (st, captures)
            want = LAYERS * engine.decode_rounds if kernels else 0
            assert all(n == want for n in launches.values()), (launches, want)
            assert not kernels or want > 0
            assert (st["kernel_launches_qkv"], st["kernel_launches_attn"],
                    st["kernel_launches_mlp"]) == tuple(float(n) for n in launches.values())
            if kernels and not eager:
                # least time a round could take: every weight and the whole
                # KV cache read once at the card's memory rate
                wb, kvb = tree_bytes(engine.params), tree_bytes(engine._cache)
                bound_s = (wb + kvb) / rates["bytes"]
                print(f"[serve] round bound {bound_s * 1e3} ms (weights {wb} B + KV cache {kvb} B "
                      f"at {rates['bytes']} B/s); kernel-path round / bound = "
                      f"{st['mean_decode_round_s'] / bound_s}", flush=True)
            if not eager:
                scratch_left_zero(torch, engine._graphs.values(), f"the {label} run's replays")
            runs[label] = dict(streams=streams, launches=launches,
                               round_s=st["mean_decode_round_s"], tokens_per_s=st["tokens_per_s"])
            del engine
            torch.cuda.empty_cache()
        path = "kernels" if kernels else "composed"
        eq = runs[path]["streams"] == runs[path + "_eager"]["streams"]
        print(f"[graph] serve {path}: greedy streams of the captured run "
              f"{'equal' if eq else 'DIFFER from'} the eager run's ({REQUESTS} requests); round "
              f"{runs[path + '_eager']['round_s'] * 1e3} -> {runs[path]['round_s'] * 1e3} ms, "
              f"{runs[path + '_eager']['tokens_per_s']} -> {runs[path]['tokens_per_s']} tokens/s",
              flush=True)
        assert eq, f"{path}: the captured decode blocks changed the greedy streams"
    same = sum(runs["kernels"]["streams"][u] == s for u, s in runs["composed"]["streams"].items())
    print(f"[serve] greedy streams: {same}/{REQUESTS} identical between the paths", flush=True)
    temp = {}
    for eager in (True, False):
        engine = serve_engine(serve, True, eager, TEMP_ARGV)
        served(torch, engine)
        temp[eager] = ({r.uid: r.out_tokens for r in engine.completed}, engine._gen.get_offset())
        del engine
    print(f"[graph] serve temperature 0.8 (kernels): the captured run's streams "
          f"{'equal' if temp[True][0] == temp[False][0] else 'DIFFER from'} the eager run's; "
          f"the sampling generator's offset after the run: eager {temp[True][1]}, captured "
          f"{temp[False][1]}", flush=True)
    assert temp[True] == temp[False], "the replayed rounds did not draw as the eager rounds do"
    return runs


def stream_serve_phase(torch, runs):
    """``[stream] serve``: the kernel path's captured run with
    ``--stream``: the same greedy streams, the plan's stats."""
    from repro_torch.core.pu import h100_host_offload_config
    from repro_torch.launch import serve

    engine = serve_engine(serve, True, False, ["--stream"])
    st, launches, _ = served(torch, engine)
    streams = {r.uid: r.out_tokens for r in engine.completed}
    stream_stats = {k: v for k, v in st.items() if k.startswith("stream_")}
    print(f"[stream] serve --stream (kernels, captured): {stream_stats} plan_time_s="
          f"{st['plan_time_s']} tokens_per_s={st['tokens_per_s']}", flush=True)
    same = streams == runs["kernels"]["streams"]
    print(f"[stream] serve: greedy streams {'equal' if same else 'DIFFER from'} the run without "
          f"--stream ({len(streams)} requests)", flush=True)
    assert same, "planning the weight streaming changed what was served"
    assert st["stream_capacity_bytes"] == float(h100_host_offload_config().fast_mem_bytes)
    assert engine.streaming_plan.pu == h100_host_offload_config()
    del engine


def multi_pu_report(want, label, engine, st, launches, captures):
    """Print a staged run's numbers and check its streams, clock and
    launches (16 a layer, a lane group, a round); returns (streams, how
    many equal ``want``)."""
    streams = {r.uid: r.out_tokens for r in engine.completed}
    keys = {k: v for k, v in st.items() if k.startswith(("partition_", "stage"))}
    same = sum(streams[u] == s for u, s in want.items())
    m = engine._staged.n_groups
    print(f"[multi-pu] serve {label}: tokens_per_s={st['tokens_per_s']} mean_decode_round_s="
          f"{st['mean_decode_round_s']} decode_rounds={st['decode_rounds']} M={m} queue_depth="
          f"{engine._staged.queue_depth} coalesced={engine._staged.coalesce} graphs captured at "
          f"warmup {captures}, after 0; launches {launches}; greedy streams equal to the "
          f"single-PU kernel run's: {same}/{REQUESTS}; {keys}", flush=True)
    assert st["completed"] == REQUESTS and st["stage_decode_clock_ok"] == 1.0, st
    assert all(len(s) == MAX_NEW and all(0 <= t < VOCAB for t in s) for s in streams.values())
    assert all(n == LAYERS * m * engine.decode_rounds for n in launches.values()), launches
    return streams, same


def multi_pu_serve_phase(torch, runs):
    """``[multi-pu] serve``: olmo-1b at full width through two stages,
    serial and eager, then auto-tuned and captured, then (with two or more
    cards) on per-stage devices."""
    from repro_torch.launch import serve

    want = runs["kernels"]["streams"]
    # (a) the serial reference schedule, eager: the single-PU bits
    engine = serve_engine(serve, True, True, MULTI_PU + ["--microbatches", "1"])
    st, launches, captures = served(torch, engine)
    streams, same = multi_pu_report(want, "(a) --microbatches 1, eager", engine, st, launches,
                                    captures)
    assert engine._staged.n_groups == 1 and captures == 0
    assert streams == want, "the serial staged schedule changed the greedy streams"
    del engine
    torch.cuda.empty_cache()
    # (b) auto-tuned M, coalesced blocks replayed as CUDA graphs
    engine = serve_engine(serve, True, False, MULTI_PU)
    st, launches, captures = served(torch, engine)
    streams, same = multi_pu_report(want, "(b) M auto-tuned, captured", engine, st, launches,
                                    captures)
    m = engine._staged.n_groups
    assert engine._staged.coalesce and st["stage_decode_autotuned"] == 1.0
    assert captures == (len(engine._staged.graphs) if m > 1 else 0), captures
    scratch_left_zero(torch, engine._staged.graphs, "the multi-pu run's replays")
    tune = engine.staged_tune
    print(f"[multi-pu] serve (b) tuner trials {tune.trials} depth trials {tune.depth_trials}",
          flush=True)
    engine.execute_partition()
    pst = {k: v for k, v in engine.stats().items() if k.startswith("partition_")}
    print(f"[multi-pu] execute_partition (functional tiles, M auto-tuned): {pst}", flush=True)
    del engine
    torch.cuda.empty_cache()
    # the same engine run eagerly: the captured blocks must give its bits
    engine = serve_engine(serve, True, True, MULTI_PU)
    st, launches, _ = served(torch, engine)
    eager, _ = multi_pu_report(want, "(b) the same, eager", engine, st, launches, 0)
    assert engine._staged.n_groups == m and engine._staged.coalesce and not engine._staged.graphs
    print(f"[multi-pu] serve (b): captured greedy streams "
          f"{'equal' if eager == streams else 'DIFFER from'} the eager run's", flush=True)
    assert eager == streams, "the captured staged blocks served other tokens than the eager ones"
    del engine
    torch.cuda.empty_cache()
    _, want_rounds, _ = logged_run(torch, kernels=True, feed=want)
    staged_forced(torch, "(b)", streams, m, want, want_rounds)
    per_stage_devices_phase(torch, want, want_rounds)


def per_stage_devices_phase(torch, want, want_rounds):
    """``[multi-pu] serve`` (c): with the visible cards split two ways, a
    device per stage and the threaded executor; its logits held
    teacher-forced to the single-PU kernel path's (``want``,
    ``want_rounds``: its streams and its rounds fed its own streams)."""
    from repro_torch.launch import serve

    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        print(f"[multi-pu] serve (c): {n} card(s) visible, which do not split two ways, so the "
              f"stages share them (stage_devices shared); per-stage devices not run", flush=True)
        return
    engine = serve_engine(serve, True, False, MULTI_PU)
    assert not engine.stage_devices_shared and not engine._staged.coalesce
    assert len(set(engine._staged.devices)) == 2, engine._staged.devices
    st, launches, captures = served(torch, engine)
    streams, _ = multi_pu_report(want, f"(c) per-stage devices {engine._staged.devices}", engine,
                                 st, launches, captures)
    m = engine._staged.n_groups
    del engine
    staged_forced(torch, "(c)", streams, m, want, want_rounds)


def staged_forced(torch, label, streams, m, want, want_rounds):
    """Hold a staged engine's logits (``--multi-pu 2``, M = ``m``) to the
    single-PU kernel path's at every step of every request, teacher-forced
    on ``want``, and tie the timed staged run's ``streams`` to them."""
    got_streams, got_rounds, m_forced = logged_run(torch, True, feed=want, extra=MULTI_PU)
    assert m_forced == m, (m_forced, m)
    diffs, flips = compare_rounds(torch, want_rounds, got_rounds)
    d = sorted(diffs.values())
    same = sum(streams[u] == s for u, s in want.items())
    print(f"[multi-pu] {label} teacher-forced, staged M={m} vs single-PU, kernels on both, on "
          f"the same tokens: {len(d)} (request, step) logit vectors, max |diff| {d[-1]}, median "
          f"{statistics.median(d)}, argmax differs at {len(flips)} steps (limit {LOGIT_ATOL}); "
          f"greedy streams equal: {same}/{REQUESTS}", flush=True)
    assert len(d) == REQUESTS * (MAX_NEW - 1) and d[-1] <= LOGIT_ATOL, d[-1]
    tie_streams(streams, want, got_streams)
    print(f"[multi-pu] {label}: the timed run's tokens up to each request's first divergence "
          f"from the single-PU streams are the teacher-forced run's", flush=True)


def pipeline_resnet_phase(torch, params):
    """``[pipeline] resnet``: 4 images through the two-stage pipeline over
    PU_1x and PU_2x, every tile streamed into its stage's arena and run
    through ``int8_gemm``, held bit for bit against the resident calls."""
    import numpy as np

    from repro_torch.core.pu import PU_1X, PU_2X
    from repro_torch.kernels import common
    from repro_torch.runtime import resnet_streaming as rs

    pus = [PU_1X, PU_2X]
    calls = []
    for m in range(PIPELINE_IMAGES):
        img = torch.from_numpy(np.random.default_rng(m).integers(
            -100, 100, (IMAGE, IMAGE, 3), dtype=np.int8)).cuda()
        calls.append(rs.forward_calls(RESNET, params, img))
    plan = rs.partition_calls(calls[0], pus)
    tiles = sum(s.plan.n for s in plan.stages)
    for attempt in ("first", "timed"):
        common.reset_launches()                 # count this run only
        run = rs.stream_partitioned(calls, pus)
        launches = common.launch_counts()
        rep = run.report
        same = sum(torch.equal(o, c.out) for per, outs in zip(calls, run.outputs)
                   for c, o in zip(per, outs))
        orders = [rep.stages[k].fetch_orders == [[s.tile_names[i] for i in s.plan.issue_order()]]
                  * PIPELINE_IMAGES for k, s in enumerate(run.plan.stages)]
        print(f"[pipeline] resnet {attempt} run: {same}/{PIPELINE_IMAGES * len(calls[0])} calls "
              f"equal to the resident calls bit for bit; launches {launches}; stages "
              f"{[(s.pu.name, s.layer_start, s.layer_stop, s.plan.n) for s in run.plan.stages]} "
              f"(pu, first call, end, tiles); peak residency {[t.peak_resident_bytes for t in rep.stages]}"
              f" B, arena high water {run.arena_high_water} B, of "
              f"{[s.pu.fast_mem_bytes for s in run.plan.stages]} B; fetches in each stage's "
              f"issue order every image: {orders}", flush=True)
        assert same == PIPELINE_IMAGES * len(calls[0])
        assert all(orders) and rep.outputs == list(range(PIPELINE_IMAGES))
        for t, hw, s in zip(rep.stages, run.arena_high_water, run.plan.stages):
            assert t.peak_resident_bytes <= s.pu.fast_mem_bytes and hw <= s.pu.fast_mem_bytes
        assert launches["int8_gemm"] == tiles * PIPELINE_IMAGES and launches["im2col"] == 0, launches
    print(f"[pipeline] resnet: {PIPELINE_IMAGES} images x {tiles} tiles, {run.bytes_streamed} B "
          f"streamed, wall {run.wall_s * 1e3} ms ({run.wall_s * 1e3 / PIPELINE_IMAGES} ms an "
          f"image); bubble measured {rep.bubble_measured} (virtual clock) vs predicted "
          f"{rep.bubble_predicted}; max_concurrent_stages {rep.max_concurrent_stages}; virtual "
          f"makespan {rep.makespan_s} s = {rep.measured_fps} FPS vs the plan's {rep.predicted_fps} "
          f"FPS at M={PIPELINE_IMAGES} (steady {rep.steady_fps})", flush=True)


def fleet_phase():
    """``[fleet]``: the executed mode of the simulator's fleet (host side)."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.pu import PU_1X, PU_2X

    fleet = sim.FleetSim(pipelines=[
        ("k2", sim.simulate_partitioned([PU_1X, PU_2X], sim.resnet_gemm_layers(RESNET)), 1)])
    rec = fleet.execute_pipelines(8)
    print(f"[fleet] FleetSim k2 (ResNet-{RESNET} over PU_1x + PU_2x), execute_pipelines(8): "
          f"{rec['k2']}", flush=True)
    assert rec["k2"]["measured_fps"] > 0 and 0.0 <= rec["k2"]["bubble_measured"] < 1.0


def plan_paper_phase():
    """``[plan] paper``: steps 3-4 of the ResNet example (host-side)."""
    from repro_torch.examples import resnet_paper

    print("[plan] paper: python -m repro_torch.examples.resnet_paper --variant 50 --plan-only",
          flush=True)
    resnet_paper.main(["--variant", str(RESNET), "--plan-only"])


def logged_run(torch, kernels: bool, feed=None, extra=()):
    """An untimed, eager run of the serve phase's requests (``extra``
    launcher arguments after them) that keeps every round's logits on the
    card; returns (streams, rounds, M).  With ``feed`` (uid -> stream)
    each active lane is fed that stream's tokens in place of its own
    samples, so the run scores exactly the prefixes ``feed`` scored
    (teacher forcing); the run's own samples still land in its streams.
    The single-PU hook wraps ``decode_step`` and feeds its input; the
    staged path calls no ``decode_step``, so there the hook wraps the
    post-decode transition, which sees each lane group's logits (the
    groups are views of the engine's state, so a group's first lane is
    its offset there) and feeds the group's next input."""
    from repro_torch.launch import serve

    engine = serve_engine(serve, kernels, eager=True, extra=extra)     # the hook runs every round
    state, lanes, B = engine._state, engine._lanes, len(engine._slots)
    table = torch.zeros_like(state["out_buf"])
    loaded = [None] * B
    rounds, pending = [], {}

    def load_feed():
        uids = [None if r is None else r.uid for r in engine._slots]
        for lane, uid in enumerate(uids):
            if feed is not None and uid is not None and loaded[lane] != uid:
                table[lane, :MAX_NEW] = torch.tensor(feed[uid], dtype=torch.int32)
                loaded[lane] = uid
        return uids

    def fed(st, rows, tokens):
        """``tokens`` (n, 1), each active lane's the fed stream's at its position."""
        if feed is None:
            return tokens
        col = (st["out_len"] - 1).clamp(min=0).long()
        return torch.where(st["active"][:, None], table[rows, col][:, None], tokens)

    def decode_step(cfg, params, cache, tokens, pos):
        uids = load_feed()
        logits, cache = inner(cfg, params, cache, fed(state, lanes, tokens), pos)
        rounds.append((uids, state["active"].clone(), state["out_len"].clone(), logits))
        return logits, cache

    def postdecode(st, logits):
        n = st["active"].shape[0]
        g0 = st["active"].data_ptr() - state["active"].data_ptr()
        if not pending:
            pending.update(uids=load_feed(), seen=0, active=state["active"].clone(),
                           out_len=state["out_len"].clone(),
                           logits=torch.empty((B, logits.shape[1]), dtype=logits.dtype,
                                              device=logits.device))
        pending["logits"][g0:g0 + n] = logits
        pending["seen"] += n
        inner(st, logits)
        st["tokens"].copy_(fed(st, lanes[g0:g0 + n], st["tokens"]))
        if pending["seen"] == B:
            rounds.append((pending["uids"], pending["active"], pending["out_len"],
                           pending["logits"]))
            pending.clear()

    if engine._staged is None:
        inner = engine.api.decode_step
        engine.api = dataclasses.replace(engine.api, decode_step=decode_step)
    else:
        assert engine._staged.n_groups > 1, "M = 1 rounds run no lane-group transition"
        inner, engine._staged._postdecode = engine._staged._postdecode, postdecode
    engine.run_until_drained()
    assert not pending, "a round's lane groups did not all arrive"
    streams = {r.uid: r.out_tokens for r in engine.completed}
    m = 1 if engine._staged is None else engine._staged.n_groups
    del engine
    return streams, rounds, m


def tie_streams(served, want, checked):
    """A timed run that served ``served`` scored ``want``'s prefix up to
    its first divergence from it, so up to and including that token its
    tokens must be those of the run teacher-forced on ``want``
    (``checked``), whose logits were held."""
    for uid, w in want.items():
        s = served[uid]
        t = next((i for i, (a, b) in enumerate(zip(s, w)) if a != b), len(w) - 1)
        assert s[: t + 1] == checked[uid][: t + 1], f"request {uid}: served tokens unchecked"


def compare_rounds(torch, want_rounds, got_rounds):
    """Per (request, step) of two runs that scored the same prefixes: the
    largest |logit difference| over the vocabulary, and each step where
    the argmax differs, with the first run's top-2 gap."""
    assert len(want_rounds) == len(got_rounds), "the runs served different rounds"
    diff, flip, gap, cross, top = [], [], [], [], []
    keys = []
    for (u1, a1, n1, l1), (u2, a2, n2, l2) in zip(want_rounds, got_rounds):
        assert u1 == u2 and torch.equal(a1, a2) and torch.equal(n1, n2), "the runs diverged in schedule"
        keys += [(u, step) for u, step, act in zip(u1, n1.tolist(), a1.tolist()) if act]
        i1, i2 = l1.argmax(-1, keepdim=True), l2.argmax(-1, keepdim=True)
        diff.append((l1 - l2).abs().amax(-1)[a1])
        flip.append((i1 != i2)[:, 0][a1])
        gap.append((l1.gather(1, i1) - l1.gather(1, i2))[:, 0][a1])
        cross.append(torch.maximum((l1 - l2).abs().gather(1, i1), (l1 - l2).abs().gather(1, i2))[:, 0][a1])
        top.append(l1.gather(1, i1)[:, 0][a1])
    diff, flip, gap, cross, top = (torch.cat(t).tolist() for t in (diff, flip, gap, cross, top))
    flips = [(k, g, g / bf16_ulp(t), c) for k, f, g, t, c in zip(keys, flip, gap, top, cross) if f]
    return dict(zip(keys, diff)), flips


def forced_phase(torch, runs):
    """Hold the kernel path's logits to the composed path's at every step
    of every request, on the same tokens, and tie the timed kernel run's
    streams to those checked logits."""
    want_streams, want_rounds, _ = logged_run(torch, kernels=False)
    assert want_streams == runs["composed"]["streams"], "the composed path is not deterministic"
    got_streams, got_rounds, _ = logged_run(torch, kernels=True, feed=want_streams)
    diffs, flips = compare_rounds(torch, want_rounds, got_rounds)
    assert len(diffs) == REQUESTS * (MAX_NEW - 1), len(diffs)
    d = sorted(diffs.values())
    print(f"[forced] {len(d)} (request, step) logit vectors, kernel vs composed on the same "
          f"tokens: max |diff| {d[-1]}, median {statistics.median(d)}, "
          f"p99 {d[int(0.99 * (len(d) - 1))]} (limit {LOGIT_ATOL})", flush=True)
    for (uid, step), g, ulps, c in flips:
        print(f"[forced] request {uid} step {step}: argmax differs; composed top-2 gap {g} "
              f"= {ulps} bf16 ulp; the two tokens' logits differ between the paths by {c}",
              flush=True)
    print(f"[forced] argmax differs at {len(flips)} of {len(d)} steps", flush=True)
    assert d[-1] <= LOGIT_ATOL, f"logits differ by {d[-1]} > {LOGIT_ATOL}"
    # the timed kernel run scored the composed prefix up to its first
    # divergence, so up to and including it its tokens are the checked ones
    tie_streams(runs["kernels"]["streams"], runs["composed"]["streams"], got_streams)
    return want_streams, want_rounds


def fault_phase(torch, want_streams, want_rounds):
    """Run the teacher-forced comparison with a fault put into the kernel
    path's wiring (not into the kernels, which the kernel phase holds):
    each must move the logits past ``LOGIT_ATOL``, or the check is blind
    to it."""
    from repro_torch.kernels import dispatch

    qkv, attn = dispatch.decode_qkv, dispatch.decode_attention

    def rope_late(cfg, p, x, positions, *, rope):
        return qkv(cfg, p, x, positions + 1, rope=rope)

    def own_token_dropped(cfg, p, q, k, v, *, kv_valid_len, **kw):
        return attn(cfg, p, q, k, v, kv_valid_len=kv_valid_len - 1, **kw)

    for name, fn, patch in (("rope one position late", rope_late, "decode_qkv"),
                            ("current token left out of attention", own_token_dropped,
                             "decode_attention")):
        setattr(dispatch, patch, fn)
        try:
            _, rounds, _ = logged_run(torch, kernels=True, feed=want_streams)
        finally:
            dispatch.decode_qkv, dispatch.decode_attention = qkv, attn
        diffs, flips = compare_rounds(torch, want_rounds, rounds)
        d = sorted(diffs.values())
        print(f"[fault] {name}: max |diff| {d[-1]}, median {statistics.median(d)}, "
              f"argmax differs at {len(flips)} of {len(d)} steps (limit {LOGIT_ATOL})", flush=True)
        assert d[-1] > LOGIT_ATOL, f"the teacher-forced check does not see the fault '{name}'"
        del rounds
        torch.cuda.empty_cache()


def kernel_name(name: str) -> str:
    """A device op's function name: ``void (anonymous namespace)::
    attn_kernel<1, 128>(...)`` -> ``attn_kernel``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<", 1)[0].split("(", 1)[0].rsplit("::", 1)[-1]


def device_busy(torch, prof, window_name: str):
    """(window us, device-busy us, {device op: us}) inside the host span
    ``window_name`` of a torch.profiler run; the span's own annotation is
    mirrored on the device timeline and is not work."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    (w0, w1), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == window_name and e.device_type != cuda]
    dev = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
                 for e in events
                 if e.device_type == cuda and e.name != window_name
                 and e.time_range.end > w0 and e.time_range.start < w1)
    assert dev, f"the profiler recorded no device activity in {window_name}"
    busy, end, by_name = 0.0, w0, {}
    for s, e, name in dev:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return w1 - w0, busy, by_name


def decode_block_profile(torch, eager: bool):
    """torch.profiler over the kernel path's first engine step (the first
    wave's prefill and a 32-round decode block, replayed from its CUDA
    graph unless ``eager``): (rounds, window us, device-busy us, {device
    op: us}, {device op: launches}, the wrappers' launch counts) of the
    block."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import decode
    from repro_torch.launch import serve

    engine = serve_engine(serve, kernels=True, eager=eager)
    inner = engine._decode_block

    def block(n_rounds):
        decode.reset_launches()             # count the block's launches only
        with record_function("decode_block"):
            inner(n_rounds)
            torch.cuda.synchronize()

    engine._decode_block = block
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.step()
    launches = {k.__name__: k.launches for k in decode.KERNELS}
    rounds = engine.decode_rounds
    window, busy, by_name = device_busy(torch, prof, "decode_block")
    del engine
    cuda = torch.autograd.DeviceType.CUDA
    (w0, w1), = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name == "decode_block" and e.device_type != cuda]
    calls = {}
    for e in prof.events():
        if e.device_type == cuda and w0 <= e.time_range.start < w1:
            calls[e.name] = calls.get(e.name, 0) + 1
    return rounds, window, busy, by_name, calls, launches


def profile_phase(torch, runs):
    """Device time per decode round by kernel, the device's idle share
    inside a traced decode block (``decode_block_profile``), eager and
    captured, and the captured block's launch counts against the
    profiler's."""
    out = {}
    for eager in (True, False):
        label = "eager" if eager else "captured"
        round_s = runs["kernels_eager" if eager else "kernels"]["round_s"]
        rounds, window, busy, by_name, calls, launches = decode_block_profile(torch, eager)
        window_ms, busy_ms = window / 1e3 / rounds, busy / 1e3 / rounds
        tag = "[profile]" if eager else "[graph] profile"
        print(f"{tag} {label}: {rounds} rounds traced: block {window_ms} ms a round, device "
              f"busy {busy_ms} ms a round, idle share {1 - busy_ms / window_ms} under the "
              f"profiler; busy / unprofiled round ({round_s * 1e3} ms) = "
              f"{busy_ms / (round_s * 1e3)}", flush=True)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"{tag}   {us / 1e3 / rounds} ms a round  {name[:110]}", flush=True)

        def seen(kernel):
            return sum(n for name, n in calls.items() if kernel_name(name) == kernel)

        want = dict(qkv_gemv_kernel=launches["fused_qkv"],
                    attn_kernel=launches["fused_decode_attention"],
                    gemv_kernel=launches["fused_decode_attention"] + 2 * launches["fused_mlp"])
        got = {k: seen(k) for k in want}
        print(f"{tag} {label}: launches counted by the wrappers {launches} -> kernels expected "
              f"{want}, seen by the profiler {got}; device ops in the block "
              f"{sum(calls.values())}", flush=True)
        assert launches["fused_qkv"] == LAYERS * rounds and got == want, (launches, want, got)
        out[label] = dict(busy_ms=busy_ms, window_ms=window_ms)
    return out


def graph_resnet_phase(torch, params, img, eager):
    """The ResNet-50 forward captured as one CUDA graph: launches of one
    call, its trunk and logits against the eager forward (and the trunk
    against the CPU's), ms per image, and the idle share of one call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import common
    from repro_torch.models import resnet

    fwd = resnet.capture_forward_int8(RESNET, params, img.shape)
    common.reset_launches()                     # count one captured call only
    logits = fwd(img)
    torch.cuda.synchronize()
    launches = common.launch_counts()
    print(f"[graph] resnet launches in one captured forward (added per replay): {launches}",
          flush=True)
    assert launches["int8_gemm"] == N_GEMM and launches["im2col"] == N_IM2COL_LAUNCHES, launches
    trunk = fwd.trunk.cpu()
    same_trunk = torch.equal(fwd.trunk, eager["trunk"]) and torch.equal(trunk, eager["trunk_cpu"])
    same_logits = torch.equal(logits, eager["logits"])
    print(f"[graph] resnet trunk {tuple(trunk.shape)} {'equal' if same_trunk else 'NOT equal'} "
          f"bit for bit to the eager forward's on the card and to the CPU's; logits "
          f"{'equal' if same_logits else 'NOT equal'} to the eager forward's on the card", flush=True)
    assert same_trunk and same_logits
    times = []
    for _ in range(FORWARDS):
        t0 = time.perf_counter()
        fwd(img)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"[graph] resnet forward_int8 {IMAGE}x{IMAGE}, batch 1: eager {eager['ms']} ms -> "
          f"captured {ms} ms per image (median of {FORWARDS}; min {min(times) * 1e3}, max "
          f"{max(times) * 1e3}) = {1e3 / eager['ms']} -> {1e3 / ms} images/s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("resnet_forward"):
            fwd(img)
            torch.cuda.synchronize()
    scratch_left_zero(torch, [fwd.graph], f"{FORWARDS + 2} replays of the ResNet-50 forward")
    window, busy, by_name = device_busy(torch, prof, "resnet_forward")
    print(f"[graph] profile one captured ResNet-50 forward: {window / 1e3} ms under the profiler, "
          f"device busy {busy / 1e3} ms, idle share {1 - busy / window}; busy / unprofiled "
          f"forward ({ms} ms) = {busy / 1e3 / ms}", flush=True)
    return dict(launches=launches, ms=ms)


def stream_resnet_phase(torch, params, img):
    """``[stream] resnet``: the forward's weight GEMMs streamed tile by
    tile under the two-phase plan at PU_2x's capacity, each tile's GEMM on
    the card, held bit for bit against the resident calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.pu import PU_2X, h100_host_offload_config
    from repro_torch.core.streaming import StreamingExecutor
    from repro_torch.kernels import common
    from repro_torch.runtime import resnet_streaming as rs

    calls = rs.forward_calls(RESNET, params, img)
    assert len(calls) == N_GEMM + 1 and sum(c.conv_mode for c in calls) == N_CONV_MODE
    tiles = rs.call_tiles(calls, PU_2X)
    for line in rs.simulator_differences(calls, RESNET, PU_2X):
        print(f"[stream] resnet tiles vs the simulator's: {line}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in calls:
        c.resident()
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    for attempt in ("first", "timed"):
        common.reset_launches()                 # count this run only
        run = rs.stream_calls(calls, PU_2X)
        launches = common.launch_counts()
        same = [torch.equal(o, c.out) for o, c in zip(run.outputs, calls)]
        order = [name for name, _ in run.plan.prefetch_order()]
        print(f"[stream] resnet {attempt} run: {sum(same)}/{len(calls)} calls equal to the "
              f"resident calls bit for bit; launches {launches}; peak residency "
              f"{run.executor.peak_resident_bytes} B (arena high water {run.arena_high_water} B) "
              f"of {PU_2X.fast_mem_bytes} B; fetches in the plan's issue order: "
              f"{run.executor.fetches == order}", flush=True)
        assert all(same), [c.name for c, ok in zip(calls, same) if not ok]
        assert run.executor.peak_resident_bytes <= PU_2X.fast_mem_bytes
        assert run.arena_high_water <= PU_2X.fast_mem_bytes
        assert run.executor.fetches == order
        assert launches["int8_gemm"] == len(tiles) and launches["im2col"] == 0, launches
    summ = run.plan.summary()
    # the same bytes as one pinned copy: the link's rate without per-copy costs
    host = torch.empty(run.bytes_streamed, dtype=torch.int8).pin_memory()
    dev = torch.empty(run.bytes_streamed, dtype=torch.int8, device="cuda")
    bulk = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        bulk.append(start.elapsed_time(end))
    bulk_rate = run.bytes_streamed / (statistics.median(bulk) * 1e-3)
    # the executor's own walk of the plan: no copy, no GEMM
    t0 = time.perf_counter()
    StreamingExecutor(run.plan, fetch=lambda name: name).run([lambda w: w] * len(tiles))
    walk_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("stream_resnet"):
            rs.stream_calls(calls, PU_2X)
    window, busy, by_name = device_busy(torch, prof, "stream_resnet")
    copies = sum(us for n, us in by_name.items() if "Memcpy" in n or "memcpy" in n)
    gemms = sum(us for n, us in by_name.items() if "int8_gemm" in n)
    print(f"[stream] resnet profile of one streamed run: {window / 1e3} ms under the profiler, "
          f"device busy {busy / 1e3} ms (idle share {1 - busy / window}): copies {copies / 1e3} "
          f"ms = {run.bytes_streamed / copies / 1e3} GB/s, int8_gemm kernels {gemms / 1e3} ms",
          flush=True)
    print(f"[stream] resnet: {len(tiles)} tiles, {run.bytes_streamed} B streamed from pinned host "
          f"memory, wall {run.wall_s * 1e3} ms to the last GEMM (resident calls {resident_s * 1e3} "
          f"ms; the executor's walk of the plan alone, no copy and no GEMM, {walk_ms} ms); one "
          f"{run.bytes_streamed}-byte pinned copy {statistics.median(bulk)} ms = {bulk_rate / 1e9} "
          f"GB/s (median of 5; the PU_2x profile's HBM->URAM link "
          f"{PU_2X.weight_bw_bytes_per_s / 1e9} GB/s, the H100 host-offload profile's PCIe link "
          f"{h100_host_offload_config().weight_bw_bytes_per_s / 1e9} GB/s); plan "
          f"stall_reduction={summ['stall_reduction']} adaptive_util={summ['adaptive_util']} "
          f"baseline_util={summ['baseline_util']}", flush=True)


def aimc_resnet_phase(torch, params, img):
    """AIMC rounds on ResNet-50: the NIU (one launch a round over every
    weight matrix) rewrites the weights a captured forward reads."""
    from repro_torch.core.aimc import AIMCNoiseModel, NoiseInjectionUnit, snr_db
    from repro_torch.kernels import common
    from repro_torch.models import resnet

    clean = resnet.forward_int8(RESNET, params, img)
    niu = NoiseInjectionUnit(params, AIMCNoiseModel(), target_filter=lambda p, leaf: p[-1] == "w")
    fwd = resnet.capture_forward_int8(RESNET, niu.params, img.shape)
    buf = niu.plan.outs[0].data_ptr()
    niu.refresh()
    assert torch.equal(fwd(img), resnet.forward_int8(RESNET, niu.params, img)), \
        "the captured forward did not read the refreshed weights"
    torch.cuda.synchronize()
    common.reset_launches()                     # count the rounds only
    refresh_ms, forward_ms, flips, snrs, outs = [], [], 0, [], []
    for r in range(AIMC_ROUNDS):
        t0 = time.perf_counter()
        niu.refresh()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fwd(img)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        refresh_ms.append((t1 - t0) * 1e3)
        forward_ms.append((t2 - t1) * 1e3)
        assert niu.plan.outs[0].data_ptr() == buf, "the NIU's output buffer moved"
        flips += int(out.argmax().item() != clean.argmax().item())
        snrs.append(snr_db(clean, out).item())
        outs.append(out)
    assert all(not torch.equal(a, b) for a, b in zip(outs, outs[1:])), "a round repeated its noise"
    launches = common.launch_counts()
    n = sum(o.numel() for o in niu.plan.outs)
    print(f"[aimc] ResNet-50 {IMAGE}x{IMAGE}: {AIMC_ROUNDS} rounds of NIU refresh ({n} int8 weights, "
          f"{len(niu.plan.outs)} matrices, one launch) + captured forward: top-1 flips "
          f"{flips}/{AIMC_ROUNDS}, logit SNR {statistics.mean(snrs)} dB (min {min(snrs)}); ms a "
          f"round: refresh {statistics.median(refresh_ms)} + forward {statistics.median(forward_ms)} "
          f"(medians); the output buffer at the same address every round; launches in the "
          f"rounds {launches}", flush=True)
    assert launches["niu_refresh"] == AIMC_ROUNDS and launches["int8_gemm"] == AIMC_ROUNDS * N_GEMM, \
        launches
    return dict(launches=launches)


def aimc_serve_phase(torch):
    """serve --aimc at full width, captured: no capture after warmup, the
    NIU writing the tensors the graphs read, streams other than the clean
    run's, tokens/s and the refresh's ms a round."""
    from repro_torch.launch import serve

    def run(aimc: bool):
        args = serve.build_parser().parse_args(AIMC_SERVE_ARGV + (["--aimc"] if aimc else []))
        engine = serve.make_engine(args)
        engine.warmup()
        serve.submit_requests(engine, args)
        return engine, args

    engine, args = run(False)
    served(torch, engine)
    clean = {r.uid: r.out_tokens for r in engine.completed}
    del engine
    engine, args = run(True)
    wq = engine.params["layers"]["attn"]["wq"]
    ptr = wq.data_ptr()
    st, launches, captures = served(torch, engine)
    noisy = {r.uid: r.out_tokens for r in engine.completed}
    assert engine.params["layers"]["attn"]["wq"].data_ptr() == ptr and wq.data_ptr() == ptr
    assert st["aimc_refreshes"] == st["decode_rounds"] and st["decode_rounds"] > 0, st
    assert not torch.equal(wq, engine.niu.pristine["layers"]["attn"]["wq"])
    times = []
    for _ in range(AIMC_REFRESHES):
        t0 = time.perf_counter()
        engine.niu.refresh()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n = sum(w.numel() for w, _ in engine.niu._floats)
    differ = sum(noisy[u] != s for u, s in clean.items())
    print(f"[aimc] serve --aimc olmo-1b ({' '.join(AIMC_SERVE_ARGV)}), captured: tokens_per_s="
          f"{st['tokens_per_s']} mean_decode_round_s={st['mean_decode_round_s']} "
          f"decode_rounds={st['decode_rounds']} refreshes={st['aimc_refreshes']} graphs captured "
          f"at warmup {captures}, after 0; refresh of {n} bf16 weights {statistics.median(times)} "
          f"ms (median of {AIMC_REFRESHES}); streams differ from the clean run's in {differ} of "
          f"{len(clean)} requests; launches {launches}", flush=True)
    assert len(noisy) == len(clean) and differ > 0
    del engine


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}", flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)", flush=True)
    for src in libs:
        print(build.ptxas_report(src).read_text()[-4000:], flush=True)

    rates = card_rates(name)
    timer = Timer(torch, TIMED_CALLS)
    rows = kernel_phase(torch, timer, rates)
    params, img = resnet_setup(torch)
    rows.update(pu_kernel_phase(torch, timer, rates, params, img))
    resnet = resnet_phase(torch, rates, params, img)
    graph = graph_resnet_phase(torch, params, img, resnet)
    aimc = aimc_resnet_phase(torch, params, img)
    stream_resnet_phase(torch, params, img)
    pipeline_resnet_phase(torch, params)
    fleet_phase()
    del params, img, timer, resnet
    torch.cuda.empty_cache()
    model_step_phase(torch)
    torch.cuda.empty_cache()
    runs = serve_phase(torch, rates)
    stream_serve_phase(torch, runs)
    multi_pu_serve_phase(torch, runs)
    torch.cuda.empty_cache()
    plan_paper_phase()
    aimc_serve_phase(torch)
    torch.cuda.empty_cache()
    want_streams, want_rounds = forced_phase(torch, runs)
    fault_phase(torch, want_streams, want_rounds)
    del want_rounds
    torch.cuda.empty_cache()
    profile_phase(torch, runs)
    # each kernel's launches on its main path: the captured serve run, the
    # captured ResNet-50 forward, the AIMC rounds
    launches = {**runs["kernels"]["launches"], "niu_refresh": aimc["launches"]["niu_refresh"],
                **{k: graph["launches"][k] for k in ("int8_gemm", "im2col")}}
    kernels = [
        dict(name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
             launches=launches[n], kernel_ms=r["ms"], **r)
        for n, r in rows.items()
    ]
    assert len(kernels) == len(SOURCES)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
