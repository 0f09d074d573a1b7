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
   output projection).  The attention also at the query groups of
   nemotron-4-15b (48 heads over 8, G = 6) and starcoder2-15b (48 over 4,
   G = 12) with d 6144: every mask case, equal bits twice, ``Timer`` and
   ``graph_ms`` times, SDPA + ``@ wo``, the bound; and at gemma3-12b's
   (16 heads over 8, G = 2, head_dim 256, d 3840) over its serve phase's
   cache (Sk 1608): every mask case with its local window of 1024 static
   and dynamic, a window starting mid-chunk in every lane and one on a
   chunk's first slot, equal bits twice, the same times at a local
   layer, launch 1 alone at a local and a global layer; and at
   mixtral-8x7b's (32 heads over 8, G = 4, d 4096) over its ring's 4096
   slots with the positions its decode computes
   (``transformer.ring_positions``): past the wrap, before it, shared by
   every lane and with no window, equal bits twice, the same times, SDPA
   with the ring mask + ``@ wo``, launch 1 alone; with its QKV GEMV
   (RoPE theta 1e6 at the ring's decode positions, with and without
   bias) and SwiGLU MLP (4096 x 14336 and back, with and without bias)
   at the same widths, each against its plain version, equal bits twice,
   the same times; the attention's int8-K/V variant (``kv_quant``, rows
   2e-2g: olmo-1b's widths over ``[serve] olmo-1b-kvq``'s 2120 slots,
   gemma3-12b's hd 256 with a local window, mixtral-8x7b-ring's G = 4 over
   its ring positions): equal bits to the bf16 kernel on the dequantized
   cache and on a second call, within ``ATOL`` of the plain version,
   ``Timer`` and ``graph_ms`` times, ``kv_dequantize`` + SDPA + ``@ wo``,
   launch 1 alone, the bf16 kernel's graph time beside it; after the
   build, the registers and spill bytes of every ``attn_kernel``
   instantiation (hd 32 to 256, bf16 and int8 K/V) from the ptxas report.
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
   host-offload profile, each stage running its own layer slice with the
   decode kernels; the stages share the card, so each block runs on the
   engine's thread): (a) ``--microbatches 1``, eager: its greedy streams
   equal the single-PU kernel run's; (b) the default, M = 1 on the shared
   card (no tuner), the whole batch through both stages in one CUDA graph
   per block length: no capture after warmup, the split-K counters zero
   after the replays, the single-PU kernel run's greedy streams, and its
   round beside the single-PU captured round; then ``execute_partition``
   (the partition through the stage-parallel runtime with functional
   tiles); (b2) ``--microbatches 2``, two lane groups, captured: no
   capture after warmup, its streams equal to the same engine run
   eagerly and to the single-PU kernel run's (each lane group's
   attention split as the whole batch's, ``plan_lanes``), and its logits
   held teacher-forced to the single-PU kernel path's within
   ``LOGIT_ATOL`` (an eager staged run fed the single-PU run's tokens
   against an eager single-PU run fed the same); (c) with two or more
   cards, the stages on their own devices (the threaded executor, M
   tuned), held the same way; with one, a line that says the stages
   share it.  Tokens/s,
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
8. ``[serve] starcoder2-15b``, ``[serve] nemotron-4-15b`` and ``[serve]
   gemma3-12b``: each model at its published widths (40, 32 and 48
   layers, gemma3's cut to 24, ``GEMMA_LAYERS``; d_model 6144, 6144 and
   3840, d_ff 24576, 24576 and 15360, vocab 49152, 256000 and 262144; 48
   query heads over 4 and 8 KV heads, 16 over 8 at head_dim 256; gemma3's
   five local layers of window 1024 to one global, RMSNorm, tied
   embeddings), seeded random bf16 weights, no width cut, served with
   ``SERVE_ARGV``'s requests (gemma3's prompts
   1536 tokens long, past its window: ``FAMILY_PROMPT_LEN``): both paths
   eager and captured as in 4 (launches, no capture after warmup,
   captured streams equal eager, the round against its bound), a
   profiled captured block (device busy share), the teacher-forced check
   of 5 and the fault probes of 6 at the model's bar
   (``FAMILY_LOGIT_ATOL``), for gemma3 a third probe that drops every
   layer's window; the phase's wall time; each model freed before the
   next is made.  Then ``[serve] internvl2-26b`` (the vlm family) at its
   published widths and all 48 layers (d_model 6144, 48 query heads over
   8, d_ff 16384 SwiGLU, RMSNorm, RoPE theta 1e6, vocab 92553 untied,
   256 vision patches), served with ``SERVE_ARGV``'s 512-token prompts,
   whose first 256 slots take the (zero) patch embeddings as the
   reference's engine feeds them: the same checks at its bar, each
   path's distance to float32 at 16 of its layers (``VLM_F32``; 48
   layers' float32 weights do not fit), a fourth fault probe that drops
   the patches (the first 256 slots keep their token embeddings), and
   beside the round, tokens/s and TTFT the
   attention's and the unembedding's in-situ times, peak memory and the
   card's name and power limit.
8a. ``[serve] mixtral-8x7b-ring``: the reference's ring construction
   (``dataclasses.replace(mixtral-8x7b, n_experts=0, top_k=0,
   kv_ring=True)``) at its published widths (d_model 4096, 32 heads over
   8, d_ff 14336 SwiGLU, RMSNorm, vocab 32000 untied, window 4096), 16 of
   its 32 layers (``RING_LAYERS``), seeded random bf16 weights; 16 requests of 64 new
   tokens on 8 slots, prompts alternating 4064 and 4160 tokens
   (``RING_PROMPTS``: below the window, the decode wrapping the ring at
   round 33; past it, through the prefill's re-layout), each wave two
   exact-length prefill calls of 4 lanes.  (a) both paths eager and
   captured as in 4, and a profiled captured block; (b) the
   teacher-forced check of 5 within ``RING_LOGIT_ATOL``; (c) the same
   model with a full cache (``RING_FULL``: max_len slots, the window mask
   alone) teacher-forced on the same tokens on the kernel path over the
   first wave (``RING_FULL_STEPS``, past both lengths' wraps), within
   ``RING_LOGIT_ATOL`` of the ring; each run's distance over the first
   engine step to the same weights served in float32 on those tokens
   (each bf16 path within the bar); (d) the fault probes above the bar: RoPE one position
   late, the ring's positions linear (each slot's index); (e)
   ``--multi-pu 2`` on the shared card (M = 1, captured): the single-PU
   captured kernel run's streams.  The round against its
   bound, tokens/s, TTFT, the busy share, the attention's in-situ µs a
   layer and the ring's cache bytes against a full cache's, beside the
   card's name and power limit; the phase's wall time.
8b. ``[serve] olmo-1b-kvq``: olmo-1b at full width (as in 4) with the int8
   KV cache (``kv_quant``: int8 payloads and one int8 exponent a slot and
   kv head, read by the attention kernel as int8), 16 requests of
   2048-token prompts and 64 new tokens on 8 slots (2120-slot cache),
   beside the same traffic over the bf16 cache (``KVQ_BF16``).  (a) both
   paths eager and captured as in 4, and a profiled captured block of
   each cache; (b) the teacher-forced check of 5 within ``LOGIT_ATOL``;
   (c) the int8 cache's kernel path against the bf16 cache's on the same
   tokens, max |diff| and argmax agreement reported against
   ``KVQ_CACHE_BAR``, and each path's distance over the first engine
   step to the bf16-cache model served in float32 on those tokens; (d)
   fault probes above the bar: layer 0's exponents one too large, the
   payloads read as uint8; (e) ``--multi-pu 2`` on the shared card (M =
   1, captured): the single-PU captured kernel run's streams.  Both
   caches' round, tokens/s, TTFT, busy share, the attention's in-situ µs
   a layer and the cache's bytes; the phase's wall time.
9. Print the ``{"kernels": [...]}`` line (``fused_decode_attention_int8``:
   the int8 variant, its launches those of 8b's captured kernel run),
   then the ``{"ok": true, ...}`` line last.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

B, D, HQ, HKV, HD, FF, SK, VOCAB, LAYERS = 8, 2048, 16, 16, 128, 8192, 584, 50304, 16
# the attention's query groups of nemotron-4-15b (48 heads over 8, G = 6)
# and starcoder2-15b (48 over 4, G = 12), both at d_model 6144
WIDE_GROUPS, WIDE_D = ((48, 8), (48, 4)), 6144
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
PROBE_STEPS = 1             # engine steps a fault probe serves: a prefill and a 32-round block
# [serve] <arch>: the step 9 dense decoders served at their published
# widths, and the teacher-forced bar of each, set as LOGIT_ATOL was.  On
# an H100 the kernel path differed from the composed path by at most
# 0.1719 (starcoder2-15b; probes 2.73 and 1.45) and 0.2554
# (nemotron-4-15b, whose 256000 logits a step give the maximum more
# entries; probes 6.58 and 4.47): 0.2 still sits between for starcoder2,
# nemotron takes 0.35.  gemma3-12b (48 layers, 262144 logits a step)
# differed by at most 0.4844 (median 0.367; over the first block the
# probes moved it by 8.56 and 5.53, and a third, every window dropped,
# by 10.02): it takes 0.6.  internvl2-26b (48 layers, 92553 logits a
# step; nemotron-4-15b's query groups and head_dim) was given nemotron's
# 0.35 before its first card run, and differed by 0.75 (median 0.52; the
# probes 10.91, 8.94 and, the patches dropped, 11.66).  At 16 of its
# layers (VLM_F32) the kernel path sat 0.5479 from the same weights
# served in float32, the composed path 0.5592, and the two 0.3359 apart:
# the kernel path is the nearer, so the gap is rounding, compounded over
# depth.  It takes 1.0; the phase reads the float32 distances every run.
FAMILY_LOGIT_ATOL = {"starcoder2-15b": LOGIT_ATOL, "nemotron-4-15b": 0.35, "gemma3-12b": 0.6,
                     "internvl2-26b": 1.0}
# internvl2-26b's kernel rows: the QKV GEMV and the SwiGLU MLP at its
# widths, at the lanes' positions at round VLM_ROUND of a wave of its
# 512-token prompts (its attention is row 2a's shape, G = 6, hd 128, d
# 6144); the unembedding (6144 x 92553, a plain product) timed beside them
VLM, VLM_ROUND = "internvl2-26b", 40

# gemma3-12b's prompts: its local layers attend the last 1024 positions,
# so only a context longer than that reaches their window
FAMILY_PROMPT_LEN = {"gemma3-12b": 1536}
# [serve] mixtral-8x7b-ring: the reference's own ring construction
# (tests/test_kv_ring.py builds it at smoke size) at full width:
# mixtral-8x7b's dense widths (d_model 4096, 32 heads over 8, d_ff 14336,
# vocab 32000) with its 4096-token window and a ring KV cache of 4096
# slots; "-full" is the same model with a max_len-slot cache, masked by
# the window alone, against which the ring is held.
# Depth cuts that keep the script within its time (every width, window
# and request kept): the ring model serves 16 of mixtral-8x7b's 32
# layers, gemma3-12b 24 of its 48 (four of its groups of five local
# layers and one global).
RING_LAYERS, GEMMA_LAYERS = 16, 24
RING, RING_FULL = "mixtral-8x7b-ring", "mixtral-8x7b-full"
VARIANTS = {
    RING: ("mixtral-8x7b", dict(n_experts=0, top_k=0, kv_ring=True, n_layers=RING_LAYERS)),
    RING_FULL: ("mixtral-8x7b", dict(n_experts=0, top_k=0, n_layers=RING_LAYERS)),
    "gemma3-12b": ("gemma3-12b", dict(n_layers=GEMMA_LAYERS)),
}
# internvl2-26b's float32 reference: 48 layers' float32 weights (79.4 GB)
# do not fit the card beside the bf16 ones, so each bf16 path's distance
# to float32 is read at 16 of its 48 layers, all widths kept (VLM_F32)
VLM_F32 = f"{VLM}-16"
VARIANTS[VLM_F32] = (VLM, dict(n_layers=16))
FAMILY_F32_DEPTH = {VLM: VLM_F32}
# its prompts alternate below and past the window: a 4064-token prompt
# prefills under it and its decode wraps the ring at round 33; a 4160-token
# one goes through the prefill's re-layout, which drops 64 positions
RING_PROMPTS = (4064, 4160)
# Its teacher-forced bar.  On an H100 the kernel path differed from the
# composed path by at most 0.3730 (median 0.2656) and the ring from a full
# cache by 0.3184 (kernels on both), past 0.2; served in float32 on the
# same tokens, the same weights sat 0.5284 from the composed path and
# 0.4832 from the kernel path: the kernel path is the nearer, so its gap
# is rounding, which in this model reaches the composed path's own
# distance to float32.  The bar sits there; the probes read 6.41 and 8.33.
# The phase checks each path's float32 distance over the first step.
RING_LOGIT_ATOL = 0.55
# engine steps the full-cache run serves: the first wave's prefill and its
# decode blocks, past the 4064-token lanes' wrap at round 33
RING_FULL_STEPS = 2
FAMILY_PROMPT_LEN.update({v: max(RING_PROMPTS) for v in (RING, RING_FULL)})
# its attention in the kernel phase: 32 query heads over 8 (G = 4), hd 128,
# d_model 4096, the ring's 4096 slots, at round 40 of a wave (past the wrap)
RING_HEADS, RING_D, RING_SK, RING_ROUND = (32, 8), 4096, 4096, 40
# gemma3-12b's attention: 16 query heads over 8 (G = 2), head_dim 256, d_model
# 3840, over its serve phase's cache (1536 + 64 + 8 slots), local window 1024
GEMMA_HEADS, GEMMA_HD, GEMMA_D, GEMMA_SK, GEMMA_WINDOW = (16, 8), 256, 3840, 1608, 1024
# [serve] olmo-1b-kvq: olmo-1b at full width with the int8 KV cache
# (kv_quant), 2048-token prompts (at 512 the cache is a fifth of a round's
# bytes; at 2048 the bf16 cache is as large as the weights), beside the
# same model and traffic with the bf16 cache ("olmo-1b-2048").  Its cache
# holds 2048 + 64 + 8 slots (the launcher's max_len), the kernel phase's
# row 2e the same.
VARIANTS.update({"olmo-1b-kvq": ("olmo-1b", dict(kv_quant=True)), "olmo-1b-2048": ("olmo-1b", {})})
KVQ, KVQ_BF16 = "olmo-1b-kvq", "olmo-1b-2048"
KVQ_PROMPT = 2048
KVQ_SK = KVQ_PROMPT + MAX_NEW + 8
FAMILY_PROMPT_LEN.update({KVQ: KVQ_PROMPT, KVQ_BF16: KVQ_PROMPT})
# The int8 cache's kernel path against the bf16 cache's on the same tokens:
# a bar fixed before the first card run, reported and not moved (the float32
# distances beside it say whether a gap is the quantization's).
KVQ_CACHE_BAR = 0.5
AIMC_REFRESHES = 5          # timed LM NIU refreshes; the median is kept
SOURCES = {
    "fused_qkv": "src/repro_torch/kernels/csrc/decode.cu",
    "fused_decode_attention": "src/repro_torch/kernels/csrc/decode.cu",
    "fused_decode_attention_int8": "src/repro_torch/kernels/csrc/decode.cu",
    "fused_mlp": "src/repro_torch/kernels/csrc/decode.cu",
    "int8_gemm": "src/repro_torch/kernels/csrc/pu.cu",
    "im2col": "src/repro_torch/kernels/csrc/pu.cu",
    "niu_refresh": "src/repro_torch/kernels/csrc/niu.cu",
}
REPLACES = {
    "fused_qkv": "src/repro/kernels/decode.py:210",
    "fused_decode_attention": "src/repro/kernels/decode.py:416",
    "fused_decode_attention_int8": "src/repro/kernels/decode.py:416",
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


def attn_registers(report: str) -> dict:
    """{(G, hd, int8): (registers, spill store bytes, spill load bytes)} of
    each ``attn_kernel`` instantiation (``int8``: the int8-K/V variant) in
    an ``nvcc -Xptxas -v`` report."""
    out, cur, spills = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(r"attn_kernelILi(\d+)ELi(\d+)ELb([01])E", m.group(1))
            cur = (int(k.group(1)), int(k.group(2)), k.group(3) == "1") if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)),) + spills
            cur, spills = None, (0, 0)
    return out


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

    # --- the attention at the query groups of nemotron-4-15b (6) and
    # starcoder2-15b (12): every mask case, equal bits, times
    wide = {}
    for hq, hkv in WIDE_GROUPS:
        G = hq // hkv
        qg, kg, vg = rnd(B, hq, HD), rnd(B, SK, hkv, HD), rnd(B, SK, hkv, HD)
        wog, bog = rnd(hq * HD, WIDE_D, scale=0.02), rnd(WIDE_D, scale=0.02)
        gerr = 0.0
        for name, ckw in cases.items():
            for bias in (bog, None):
                got = decode.fused_decode_attention(qg, kg, vg, wog, bias, **ckw)
                want = ref.decode_attention_ref(qg, kg, vg, wog, bias, **ckw)
                gerr = max(gerr, close(got, want, f"fused_decode_attention G={G} {name} "
                                                  f"bias={bias is not None}"))
                again = decode.fused_decode_attention(qg, kg, vg, wog, bias, **ckw)
                assert torch.equal(got, again), f"fused_decode_attention G={G} {name}: two calls differ"
        gplan = decode.attn_plan(B, hkv, SK, HD, sms)
        kvg_bytes = 2 * used * hkv * HD * kg.element_size()
        nb1 = nbytes(qg, vlen, qpos) + kvg_bytes + 2 * B * hq * HD
        t1 = timer(lambda: decode._attention_ctx(qg, kg, vg, **tkw))
        t_bound, by = bound(rates, nbytes(qg, wog, bog, vlen, qpos) + kvg_bytes + 2 * B * WIDE_D,
                            4 * used * hq * HD + 2 * B * hq * HD * WIDE_D)
        ktg, vtg = kg.transpose(1, 2), vg.transpose(1, 2)

        def wide_library(qg=qg, ktg=ktg, vtg=vtg, wog=wog, bog=bog, hq=hq):
            ctx = F.scaled_dot_product_attention(qg[:, :, None], ktg, vtg, attn_mask=sdpa_mask,
                                                 enable_gqa=True)
            return ctx.reshape(B, hq * HD) @ wog + bog

        copies = [(kg, vg, wog)] + [tuple(t.clone() for t in (kg, vg, wog))
                                    for _ in range(GRAPH_COPIES - 1)]
        wide[G] = dict(
            heads=hq, kv_heads=hkv, d_model=WIDE_D, max_abs_err=gerr,
            ms=timer(lambda: decode.fused_decode_attention(qg, kg, vg, wog, bog, **tkw)),
            graph_ms=graph_ms(torch, [lambda c=c: decode.fused_decode_attention(qg, *c, bog, **tkw)
                                      for c in copies] * GRAPH_PASSES),
            plain_ms=timer(lambda: ref.decode_attention_ref(qg, kg, vg, wog, bog, **tkw)),
            library_ms=timer(wide_library), bound_ms=t_bound, bound_by=by,
            launch1_ms=t1, launch1_bound_ms=bound(rates, nb1)[0],
        )
        del copies
        r = wide[G]
        print(f"[kernel] fused_decode_attention G={G} ({hq} heads over {hkv}, hd {HD}, d {WIDE_D}): "
              f"two calls give equal bits in all {len(cases)} mask cases, with and without bo; "
              f"max_abs_err={gerr} kernel_ms={r['ms']} graph_ms={r['graph_ms']} "
              f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} (SDPA + @ wo) "
              f"bound_ms={t_bound} ({by}); launch 1 (attn_kernel<{G}, {HD}>) kernel_ms={t1} "
              f"bound_ms={r['launch1_bound_ms']} ({nb1 / t1 / 1e9} TB/s) grid {B * hkv} (lane, "
              f"kv-head) x {gplan.splits} chunks of {gplan.chunk} slots", flush=True)
    rows["fused_decode_attention"]["wide_groups"] = wide
    rows["fused_decode_attention"]["head_dim_256"] = head_dim_256_attention(
        torch, timer, rates, rnd, close)
    rows["fused_decode_attention"]["ring"] = ring_attention(torch, timer, rates, rnd, close)
    q8 = int8_attention(torch, timer, rates, rnd, close)
    rows["fused_decode_attention_int8"] = dict(q8["2e"], head_dim_256=q8["2f"], ring=q8["2g"])

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
    # mixtral-8x7b-ring's QKV GEMV (32 heads over 8, hd 128, RoPE theta 1e6)
    # and SwiGLU MLP (4096 x 14336 and back) at its widths
    rows["fused_qkv"]["ring"], rows["fused_mlp"]["ring"] = model_projections(
        torch, timer, rates, rnd, close, RING, RING_PROMPTS, RING_ROUND)
    rows["fused_qkv"]["vlm"], rows["fused_mlp"]["vlm"] = vlm_projections(
        torch, timer, rates, rnd, close)
    for name, r in rows.items():
        print(f"[kernel] {name}: max_abs_err={r['max_abs_err']} kernel_ms={r['ms']} "
              f"graph_ms={r['graph_ms']} plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']} ({r['bound_by']})", flush=True)
    return rows


def head_dim_256_attention(torch, timer, rates, rnd, close):
    """gemma3-12b's attention (G = 2, hd 256, d 3840, B = 8, Sk 1608): the
    kernel against its plain version in every mask case, the local
    layers' window static, dynamic, starting mid-chunk in every lane and
    on a chunk's first slot in some; equal bits on a second call; times
    of a local layer's call (window 1024, the main path's 40 of 48
    layers) and launch 1 alone at a local and a global layer."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode, ref

    hq, hkv = GEMMA_HEADS
    G, hd, d, sk = hq // hkv, GEMMA_HD, GEMMA_D, GEMMA_SK
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(24)
    q, k, v = rnd(B, hq, hd), rnd(B, sk, hkv, hd), rnd(B, sk, hkv, hd)
    wo, bo = rnd(hq * hd, d, scale=0.02), rnd(d, scale=0.02)
    # the serve phase's decode positions: past the prompt's 1536 tokens
    vlen = torch.tensor([1540 + 8 * i for i in range(B)], dtype=torch.int32, device=dev)
    qpos = vlen - 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = decode.attn_plan(B, hkv, sk, hd, sms)
    win = lambda w: torch.tensor(w, dtype=torch.int32, device=dev)  # noqa: E731
    # first attended slot qpos - w + 1: mid-chunk in every lane at w = 1000;
    # on a chunk's first slot in lanes 0 and 4 at w = 1028
    mid, edge = 1000, 1540 - 16 * plan.chunk
    firsts = lambda w: (qpos - w + 1).remainder(plan.chunk)  # noqa: E731
    assert bool((firsts(mid) != 0).all()) and int((firsts(edge) == 0).sum()) == 2, plan
    ring = torch.randint(-1, sk + 40, (B, sk), generator=g, device=dev, dtype=torch.int32)
    cases = {
        "full": dict(q_positions=torch.full((B,), sk - 1, dtype=torch.int32, device=dev)),
        "valid_len": dict(q_positions=qpos, kv_valid_len=vlen),
        "window_static": dict(q_positions=qpos, kv_valid_len=vlen, window=GEMMA_WINDOW),
        "window_dynamic": dict(q_positions=qpos, kv_valid_len=vlen, window_arr=win(GEMMA_WINDOW)),
        "window_mid_chunk": dict(q_positions=qpos, kv_valid_len=vlen, window_arr=win(mid)),
        "window_chunk_edge": dict(q_positions=qpos, kv_valid_len=vlen, window_arr=win(edge)),
        "ring_lane": dict(q_positions=qpos + 40, kv_positions=ring),
        "ring_window": dict(q_positions=qpos + 40, kv_positions=ring, window_arr=win(GEMMA_WINDOW)),
        "noncausal": dict(q_positions=qpos, kv_valid_len=vlen, causal=False),
        "no_valid_slot": dict(q_positions=qpos, kv_valid_len=torch.cat([vlen[:1] * 0, vlen[1:]])),
    }
    err = 0.0
    for name, ckw in cases.items():
        for bias in (bo, None):
            got = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
            want = ref.decode_attention_ref(q, k, v, wo, bias, **ckw)
            err = max(err, close(got, want, f"fused_decode_attention hd={hd} {name} "
                                            f"bias={bias is not None}"))
            again = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
            assert torch.equal(got, again), f"fused_decode_attention hd={hd} {name}: two calls differ"
    print(f"[kernel] fused_decode_attention hd={hd} G={G} ({hq} heads over {hkv}, d {d}, Sk {sk}): "
          f"two calls give equal bits in all {len(cases)} mask cases, with and without bo; "
          f"max_abs_err={err}", flush=True)
    tkw = cases["window_dynamic"]

    def need(kw):
        """Slots the lanes may attend, and their K and V bytes."""
        used = int(ref.decode_mask(B, sk, dev, **kw).sum().item())
        return used, 2 * used * hkv * hd * k.element_size()

    for name in ("window_dynamic", "valid_len"):
        used, kvb = need(cases[name])
        nb1 = nbytes(q, vlen, qpos) + kvb + 2 * B * hq * hd
        t1 = timer(lambda n=name: decode._attention_ctx(q, k, v, **cases[n]))
        print(f"[kernel] fused_decode_attention hd={hd} launch 1 (attn_kernel<{G}, {hd}>, {name}): "
              f"kernel_ms={t1} bound_ms={bound(rates, nb1)[0]} ({nb1 / t1 / 1e9} TB/s of the {used} "
              f"of {B * sk} slots the lanes may attend) grid {B * hkv} (lane, kv-head) x "
              f"{plan.splits} chunks of {plan.chunk} slots", flush=True)
    used, kvb = need(tkw)
    t_bound, by = bound(rates, nbytes(q, wo, bo, vlen, qpos) + kvb + 2 * B * d,
                        4 * used * hq * hd + 2 * B * hq * hd * d)
    mask = ref.decode_mask(B, sk, dev, **tkw)[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def library():
        ctx = F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
        return ctx.reshape(B, hq * hd) @ wo + bo

    copies = [(k, v, wo)] + [tuple(t.clone() for t in (k, v, wo)) for _ in range(GRAPH_COPIES - 1)]
    row = dict(
        heads=hq, kv_heads=hkv, head_dim=hd, d_model=d, cache_slots=sk, window=GEMMA_WINDOW,
        max_abs_err=err,
        ms=timer(lambda: decode.fused_decode_attention(q, k, v, wo, bo, **tkw)),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_decode_attention(q, *c, bo, **tkw)
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.decode_attention_ref(q, k, v, wo, bo, **tkw)),
        library_ms=timer(library), bound_ms=t_bound, bound_by=by,
    )
    del copies
    print(f"[kernel] fused_decode_attention hd={hd} G={G} (a local layer: window {GEMMA_WINDOW}): "
          f"kernel_ms={row['ms']} graph_ms={row['graph_ms']} plain_ms={row['plain_ms']} "
          f"library_ms={row['library_ms']} (SDPA + @ wo) bound_ms={t_bound} ({by})", flush=True)
    return row


def ring_attention(torch, timer, rates, rnd, close):
    """mixtral-8x7b-ring's attention (G = 4, hd 128, d 4096, B = 8, the
    ring's 4096 slots) with the slot positions its decode computes
    (``transformer.ring_positions``): the serve path's arguments (valid
    length, the layer's window, the positions) with the lanes at round
    ``RING_ROUND`` of a wave (past the 4064-token lanes' wrap) and at its
    first round (their slots past the query never written), positions
    shared by every lane, and no window; each against the plain version,
    equal bits on a second call; times of the path's call past the wrap
    and of launch 1 alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode, ref
    from repro_torch.models import transformer

    hq, hkv = RING_HEADS
    G, hd, d, sk = hq // hkv, HD, RING_D, RING_SK
    q, k, v = rnd(B, hq, hd), rnd(B, sk, hkv, hd), rnd(B, sk, hkv, hd)
    dev = q.device
    wo, bo = rnd(hq * hd, d, scale=0.02), rnd(d, scale=0.02)
    win = torch.tensor(RING_SK, dtype=torch.int32, device=dev)     # every layer's window

    def at(r):
        """The lanes' decode positions at round r of a wave."""
        return torch.tensor([RING_PROMPTS[i % 2] + r - 1 for i in range(B)], dtype=torch.int32,
                            device=dev)

    def path(pos):
        return dict(q_positions=pos, kv_valid_len=pos + 1, window_arr=win,
                    kv_positions=transformer.ring_positions(pos, sk))

    after = at(RING_ROUND)
    cases = {
        "path_past_wrap": path(after),
        "path_first_round": path(at(1)),
        "shared_positions": dict(q_positions=after[:1].expand(B).contiguous(), window_arr=win,
                                 kv_positions=transformer.ring_positions(after[0], sk)),
        "no_window": dict(q_positions=after, kv_positions=transformer.ring_positions(after, sk)),
    }
    err = 0.0
    for name, ckw in cases.items():
        for bias in (bo, None):
            got = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
            want = ref.decode_attention_ref(q, k, v, wo, bias, **ckw)
            err = max(err, close(got, want, f"fused_decode_attention ring G={G} {name} "
                                            f"bias={bias is not None}"))
            again = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
            assert torch.equal(got, again), f"fused_decode_attention ring {name}: two calls differ"
    tkw = cases["path_past_wrap"]
    used = int(ref.decode_mask(B, sk, dev, **tkw).sum().item())
    kv_bytes = 2 * used * hkv * hd * k.element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = decode.attn_plan(B, hkv, sk, hd, sms)
    nb1 = nbytes(q, after, tkw["kv_positions"]) + kv_bytes + 2 * B * hq * hd
    t1 = timer(lambda: decode._attention_ctx(q, k, v, **tkw))
    t_bound, by = bound(rates, nbytes(q, wo, after, tkw["kv_positions"]) + kv_bytes + 2 * B * d,
                        4 * used * hq * hd + 2 * B * hq * hd * d)
    mask = ref.decode_mask(B, sk, dev, **tkw)[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def library():
        ctx = F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)
        return ctx.reshape(B, hq * hd) @ wo

    copies = [(k, v, wo)] + [tuple(t.clone() for t in (k, v, wo)) for _ in range(GRAPH_COPIES - 1)]
    row = dict(
        heads=hq, kv_heads=hkv, head_dim=hd, d_model=d, cache_slots=sk, max_abs_err=err,
        ms=timer(lambda: decode.fused_decode_attention(q, k, v, wo, None, **tkw)),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_decode_attention(q, *c, None, **tkw)
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.decode_attention_ref(q, k, v, wo, None, **tkw)),
        library_ms=timer(library), bound_ms=t_bound, bound_by=by,
        launch1_ms=t1, launch1_bound_ms=bound(rates, nb1)[0],
    )
    del copies
    print(f"[kernel] fused_decode_attention ring G={G} ({hq} heads over {hkv}, hd {hd}, d {d}, "
          f"{sk} ring slots, positions from transformer.ring_positions): two calls give equal bits "
          f"in all {len(cases)} cases, with and without bo; max_abs_err={err} kernel_ms={row['ms']} "
          f"graph_ms={row['graph_ms']} plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
          f"(SDPA with the ring mask + @ wo) bound_ms={t_bound} ({by}); launch 1 "
          f"(attn_kernel<{G}, {hd}>) kernel_ms={t1} bound_ms={row['launch1_bound_ms']} "
          f"({nb1 / t1 / 1e9} TB/s of the {used} of {B * sk} slots the lanes may attend) grid "
          f"{B * hkv} (lane, kv-head) x {plan.splits} chunks of {plan.chunk} slots", flush=True)
    return row


def int8_attention(torch, timer, rates, rnd, close):
    """Rows 2e-2g: the attention kernel's int8-K/V variant (``kv_quant``)
    at olmo-1b's widths over ``[serve] olmo-1b-kvq``'s cache (2e: G = 1,
    hd 128, d 2048, ``KVQ_SK`` slots, the lanes past their 2048-token
    prompts), at gemma3-12b's (2f: G = 2, hd 256, d 3840, Sk 1608, a local
    layer's window) and at mixtral-8x7b-ring's (2g: G = 4, hd 128, d 4096,
    the ring's 4096 slots at its decode's positions, past the wrap).  The
    cache is ``kv_quantize`` of random rows, its slots past each lane's
    length as ``init_cache`` leaves them (payload 0, exponent -126).  In
    every case: equal bits to the bf16 kernel on ``kv_dequantize`` of the
    same cache, within ``ATOL`` of the plain version, equal bits on a
    second call.  Times of the first case: ``Timer``, ``graph_ms`` (over
    copies of the int8 cache, its exponents and wo), the plain version,
    the library (``kv_dequantize`` + SDPA + ``@ wo``), launch 1 alone, and
    the bf16 kernel's ``graph_ms`` on the dequantized cache beside it; the
    bound counts the int8 K/V and exponents of the attended slots, wo,
    q and the output."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode, ref
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf = torch.bfloat16

    def at(base, step=8):
        return torch.tensor([base + step * i for i in range(B)], dtype=torch.int32, device=dev)

    def win(w):
        return torch.tensor(w, dtype=torch.int32, device=dev)

    ring_pos = torch.tensor([RING_PROMPTS[i % 2] + RING_ROUND - 1 for i in range(B)],
                            dtype=torch.int32, device=dev)
    vlen = {"2e": at(KVQ_PROMPT + 1), "2f": at(1540), "2g": ring_pos + 1}
    specs = {
        "2e": ((HQ, HKV), HD, D, KVQ_SK, {
            "path": dict(q_positions=vlen["2e"] - 1, kv_valid_len=vlen["2e"],
                         window_arr=win(ref.BIG_WINDOW)),
            "no_valid_slot": dict(q_positions=vlen["2e"] - 1,
                                  kv_valid_len=torch.cat([vlen["2e"][:1] * 0, vlen["2e"][1:]])),
        }),
        "2f": (GEMMA_HEADS, GEMMA_HD, GEMMA_D, GEMMA_SK, {
            "local": dict(q_positions=vlen["2f"] - 1, kv_valid_len=vlen["2f"],
                          window_arr=win(GEMMA_WINDOW)),
            "global": dict(q_positions=vlen["2f"] - 1, kv_valid_len=vlen["2f"],
                           window_arr=win(ref.BIG_WINDOW)),
        }),
        "2g": (RING_HEADS, HD, RING_D, RING_SK, {
            "path_past_wrap": dict(q_positions=ring_pos, kv_valid_len=ring_pos + 1,
                                   window_arr=win(RING_SK),
                                   kv_positions=transformer.ring_positions(ring_pos, RING_SK)),
            "first_round": dict(q_positions=ring_pos - RING_ROUND + 1,
                                kv_valid_len=ring_pos - RING_ROUND + 2, window_arr=win(RING_SK),
                                kv_positions=transformer.ring_positions(
                                    ring_pos - RING_ROUND + 1, RING_SK)),
        }),
    }
    rows = {}
    for row, ((hq, hkv), hd, d, sk, cases) in specs.items():
        G = hq // hkv
        q = rnd(B, hq, hd)
        wo, bo = rnd(hq * hd, d, scale=0.02), rnd(d, scale=0.02)
        written = (torch.arange(sk, device=dev)[None] < vlen[row][:, None])[:, :, None]
        if row == "2g":                                 # past the wrap every slot is written
            written = torch.ones_like(written)
        (kq, ke), (vq, ve) = (ref.kv_quantize(rnd(B, sk, hkv, hd)) for _ in range(2))
        for t, fill in ((kq, 0), (vq, 0), (ke, -126), (ve, -126)):
            t.masked_fill_(~written if t.dim() == 3 else ~written[..., None], fill)
        k, v = ref.kv_dequantize(kq, ke, bf), ref.kv_dequantize(vq, ve, bf)
        ex = dict(k_exp=ke, v_exp=ve)
        err = 0.0
        for name, ckw in cases.items():
            for bias in (bo, None):
                got = decode.fused_decode_attention(q, kq, vq, wo, bias, **ex, **ckw)
                want = decode.fused_decode_attention(q, k, v, wo, bias, **ckw)
                assert torch.equal(got, want), \
                    f"int8 attention {row} {name}: not the bf16 kernel's bits on the dequantized cache"
                err = max(err, close(got, ref.decode_attention_ref(q, kq, vq, wo, bias, **ex, **ckw),
                                     f"int8 attention {row} {name} bias={bias is not None}"))
                again = decode.fused_decode_attention(q, kq, vq, wo, bias, **ex, **ckw)
                assert torch.equal(got, again), f"int8 attention {row} {name}: two calls differ"
        tkw = next(iter(cases.values()))
        mask = ref.decode_mask(B, sk, dev, **tkw)
        used = int(mask.sum().item())
        kv_bytes = 2 * used * hkv * (hd + 1)            # int8 payloads and one exponent a row
        plan = decode.attn_plan(B, hkv, sk, hd, sms)
        nb1 = nbytes(q, vlen[row]) + kv_bytes + 2 * B * hq * hd
        t1 = timer(lambda: decode._attention_ctx(q, kq, vq, **ex, **tkw))
        t_bound, by = bound(rates, nbytes(q, wo, bo, vlen[row]) + kv_bytes + 2 * B * d,
                            4 * used * hq * hd + 2 * B * hq * hd * d)
        bf16_bound = bound(rates, nbytes(q, wo, bo, vlen[row]) + 2 * used * hkv * hd * 2 + 2 * B * d,
                           4 * used * hq * hd + 2 * B * hq * hd * d)[0]
        smask = mask[:, None, None, :]

        def library(q=q, kq=kq, vq=vq, ke=ke, ve=ve, wo=wo, bo=bo, smask=smask, hq=hq, hd=hd):
            kt = ref.kv_dequantize(kq, ke, bf).transpose(1, 2)
            vt = ref.kv_dequantize(vq, ve, bf).transpose(1, 2)
            ctx = F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=smask,
                                                 enable_gqa=True)
            return ctx.reshape(B, hq * hd) @ wo + bo

        copies = [(kq, vq, ke, ve, wo)] + [tuple(t.clone() for t in (kq, vq, ke, ve, wo))
                                           for _ in range(GRAPH_COPIES - 1)]
        bcopies = [(k, v, wo)] + [tuple(t.clone() for t in (k, v, wo)) for _ in range(GRAPH_COPIES - 1)]
        r = dict(
            heads=hq, kv_heads=hkv, head_dim=hd, d_model=d, cache_slots=sk, max_abs_err=err,
            ms=timer(lambda: decode.fused_decode_attention(q, kq, vq, wo, bo, **ex, **tkw)),
            graph_ms=graph_ms(torch, [
                lambda c=c: decode.fused_decode_attention(q, c[0], c[1], c[4], bo, k_exp=c[2],
                                                          v_exp=c[3], **tkw)
                for c in copies] * GRAPH_PASSES),
            plain_ms=timer(lambda: ref.decode_attention_ref(q, kq, vq, wo, bo, **ex, **tkw)),
            library_ms=timer(library), bound_ms=t_bound, bound_by=by,
            launch1_ms=t1, launch1_bound_ms=bound(rates, nb1)[0],
            bf16_graph_ms=graph_ms(torch, [lambda c=c: decode.fused_decode_attention(q, *c, bo, **tkw)
                                           for c in bcopies] * GRAPH_PASSES),
            bf16_bound_ms=bf16_bound,
        )
        del copies, bcopies
        rows[row] = r
        print(f"[kernel] fused_decode_attention int8 K/V row {row} (G={G}: {hq} heads over {hkv}, hd "
              f"{hd}, d {d}, Sk {sk}): equal bits to the bf16 kernel on the dequantized cache and on "
              f"a second call in all {len(cases)} cases ({', '.join(cases)}), with and without bo; "
              f"max_abs_err={err} (plain version) kernel_ms={r['ms']} graph_ms={r['graph_ms']} "
              f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} (kv_dequantize + SDPA + @ wo) "
              f"bound_ms={t_bound} ({by}; {kv_bytes} B of int8 K/V and exponents of the {used} of "
              f"{B * sk} slots the lanes may attend); launch 1 (attn_kernel<{G}, {hd}, true>) "
              f"kernel_ms={t1} bound_ms={r['launch1_bound_ms']} ({nb1 / t1 / 1e9} TB/s) grid "
              f"{B * hkv} (lane, kv-head) x {plan.splits} chunks of {plan.chunk} slots; the bf16 "
              f"kernel on the dequantized cache graph_ms={r['bf16_graph_ms']} bound_ms={bf16_bound}",
              flush=True)
    return rows


def vlm_projections(torch, timer, rates, rnd, close):
    """internvl2-26b's QKV GEMV (48 heads over 8, hd 128, RoPE theta 1e6)
    and SwiGLU MLP (6144 x 16384 and back) at its widths, at the lanes'
    positions in a wave of 512-token prompts (``model_projections``), and
    the unembedding of a decode round, ``h (8, 6144) @ unembed (6144,
    92553)``, a plain product (the JAX package's is no Pallas kernel)
    timed against its bound.  Returns the two rows."""
    cfg = model_cfg(VLM)
    prompt = int(SERVE_ARGV[SERVE_ARGV.index("--prompt-len") + 1])
    qkv, mlp = model_projections(torch, timer, rates, rnd, close, VLM, (prompt,), VLM_ROUND)
    h, w = rnd(B, cfg.d_model), rnd(cfg.d_model, cfg.vocab, scale=0.02)
    t_bound, by = bound(rates, nbytes(h, w) + 4 * B * cfg.vocab, 2 * B * cfg.d_model * cfg.vocab)
    ms = timer(lambda: (h @ w).float())
    print(f"[kernel] unembedding at {VLM}'s widths (h ({B}, {cfg.d_model}) @ unembed "
          f"({cfg.d_model}, {cfg.vocab}), bf16, float32 logits; torch.matmul, rows of "
          f"{w.stride(0) * w.element_size()} B): ms={ms} bound_ms={t_bound} ({by})", flush=True)
    del h, w
    return qkv, mlp


def model_projections(torch, timer, rates, rnd, close, arch, prompts, round_):
    """``arch``'s QKV GEMV and SwiGLU MLP at its widths (B = 8): the QKV at
    the lanes' decode positions at round ``round_`` of a wave and at its
    first round (lane i's prompt ``prompts[i % len(prompts)]`` tokens
    long), each kernel with and without bias (the path's has none) against
    its plain version, equal bits on a second call; times of the path's
    call.  Returns the two rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode, ref

    cfg = model_cfg(arch)
    hq, hkv, hd, d, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
    dev = torch.device("cuda", 0)
    x = rnd(B, d)

    def at(r):
        return torch.tensor([prompts[i % len(prompts)] + r - 1 for i in range(B)],
                            dtype=torch.int32, device=dev)

    # --- fused_qkv
    wq, wk, wv = rnd(d, hq * hd, scale=0.02), rnd(d, hkv * hd, scale=0.02), rnd(d, hkv * hd, scale=0.02)
    biases = (rnd(hq * hd, scale=0.02), rnd(hkv * hd, scale=0.02), rnd(hkv * hd, scale=0.02))
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, theta=cfg.rope_theta)
    err = 0.0
    for r in (round_, 1):
        pos = at(r)
        for bs in (biases, (None, None, None)):
            got = decode.fused_qkv(x, wq, wk, wv, *bs, pos, **kw)
            want = ref.fused_qkv_ref(x, wq, wk, wv, *bs, pos, **kw)
            for a, b_, n in zip(got, want, "qkv"):
                err = max(err, close(a, b_, f"fused_qkv {arch} {n} round {r} "
                                            f"bias={bs[0] is not None}"))
            again = decode.fused_qkv(x, wq, wk, wv, *bs, pos, **kw)
            assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), \
                f"fused_qkv {arch} round {r}: two calls differ"
    pos = at(round_)
    wqkv = torch.cat([wq, wk, wv], dim=1)

    def qkv_library():
        y = (x @ wqkv).reshape(B, hq + 2 * hkv, hd)
        ang = ref.rope_angles(pos, hd, cfg.rope_theta)[:, None]
        return ref.rotate_half_split(y[:, : hq + hkv], torch.cos(ang), torch.sin(ang)), y[:, hq + hkv:]

    t_bound, by = bound(rates, nbytes(x, wq, wk, wv, pos) + 2 * B * (hq + 2 * hkv) * hd,
                        2 * B * d * (hq + 2 * hkv) * hd)
    copies = [(wq, wk, wv)] + [tuple(w.clone() for w in (wq, wk, wv)) for _ in range(GRAPH_COPIES - 1)]
    qkv = dict(
        heads=hq, kv_heads=hkv, head_dim=hd, d_model=d, max_abs_err=err,
        ms=timer(lambda: decode.fused_qkv(x, wq, wk, wv, None, None, None, pos, **kw)),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_qkv(x, *c, None, None, None, pos, **kw)
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.fused_qkv_ref(x, wq, wk, wv, None, None, None, pos, **kw)),
        library_ms=timer(qkv_library), bound_ms=t_bound, bound_by=by,
    )
    del copies, wqkv

    # --- fused_mlp
    wu, wg, wd = rnd(d, ff, scale=0.02), rnd(d, ff, scale=0.02), rnd(ff, d, scale=0.02)
    bu, bd = rnd(ff, scale=0.02), rnd(d, scale=0.02)
    merr = 0.0
    for bs in ((bu, bd), (None, None)):
        got = decode.fused_mlp(x, wu, wg, bs[0], wd, bs[1], act="swiglu")
        want = ref.fused_mlp_ref(x, wu, wg, bs[0], wd, bs[1], act="swiglu")
        merr = max(merr, close(got, want, f"fused_mlp {arch} swiglu bias={bs[0] is not None}"))
        again = decode.fused_mlp(x, wu, wg, bs[0], wd, bs[1], act="swiglu")
        assert torch.equal(got, again), f"fused_mlp {arch}: two calls differ"
    t_bound, by = bound(rates, nbytes(x, wu, wg, wd) + 2 * B * d, 2 * B * d * ff * 3)
    copies = [(wu, wg, wd)] + [tuple(w.clone() for w in (wu, wg, wd)) for _ in range(GRAPH_COPIES - 1)]
    mlp = dict(
        d_model=d, d_ff=ff, max_abs_err=merr,
        ms=timer(lambda: decode.fused_mlp(x, wu, wg, None, wd, None, act="swiglu")),
        graph_ms=graph_ms(torch, [lambda c=c: decode.fused_mlp(x, c[0], c[1], None, c[2], None,
                                                               act="swiglu")
                                  for c in copies] * GRAPH_PASSES),
        plain_ms=timer(lambda: ref.fused_mlp_ref(x, wu, wg, None, wd, None, act="swiglu")),
        library_ms=timer(lambda: (F.silu(x @ wg) * (x @ wu)) @ wd),
        bound_ms=t_bound, bound_by=by,
    )
    del copies
    for name, what, row in (
            ("fused_qkv", f"{hq} heads over {hkv}, hd {hd}, RoPE theta {cfg.rope_theta} at the "
                          f"lanes' decode positions", qkv),
            ("fused_mlp", f"SwiGLU {d} x {ff} and back", mlp)):
        tag = "ring" if arch == RING else arch
        print(f"[kernel] {name} {tag} ({arch}'s widths: B {B}, d {d}, {what}): two "
              f"calls give equal bits in every case; max_abs_err={row['max_abs_err']} "
              f"kernel_ms={row['ms']} graph_ms={row['graph_ms']} plain_ms={row['plain_ms']} "
              f"library_ms={row['library_ms']} bound_ms={row['bound_ms']} ({row['bound_by']})",
              flush=True)
    return qkv, mlp


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


def free(torch):
    """Give back an engine's memory: its graphs and lambdas hold it in
    reference cycles, which only the collector breaks."""
    gc.collect()
    torch.cuda.empty_cache()


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def model_cfg(arch: str):
    """``arch``'s config: the registry's, or a variant's (``VARIANTS``)."""
    from repro_torch.configs import get_config

    base, changes = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(get_config(base), **changes)


def serve_argv(arch: str) -> list:
    """The serve phase's requests to ``arch`` (a variant: to its base
    arch): ``SERVE_ARGV``'s, with the arch's own prompt length where it
    has one (``FAMILY_PROMPT_LEN``; a variant's longest)."""
    argv = ["--arch", VARIANTS.get(arch, (arch,))[0]] + SERVE_ARGV[2:]
    if arch in FAMILY_PROMPT_LEN:
        argv[argv.index("--prompt-len") + 1] = str(FAMILY_PROMPT_LEN[arch])
    return argv


def serve_engine(serve, kernels: bool, eager: bool = False, extra=(), arch="olmo-1b",
                 warm: bool = True, f32: bool = False):
    """The launcher's engine for the serve phase's requests to ``arch``
    (``extra`` arguments after them), warmed up unless not ``warm``, with
    the requests queued; its decode blocks replay CUDA graphs unless
    ``eager``.  ``f32``: the same weights widened to float32 and served
    in float32 (the composed path's float32 reference)."""
    from repro_torch.runtime.serving import ServingEngine

    argv = serve_argv(arch) + (["--decode-kernels"] if kernels else []) + list(extra)
    gc.collect()        # an engine left in a reference cycle still holds its weights
    args = serve.build_parser().parse_args(argv)
    if arch in VARIANTS:
        # a config the registry does not name, with the launcher's settings
        from repro_torch.kernels.common import resolve_device
        from repro_torch.models.api import get_api

        cfg, dev = model_cfg(arch), resolve_device(args.device)
        engine = ServingEngine(cfg, get_api(cfg).init_params(cfg, args.seed, dev),
                               serve.serve_config(args), dev, eager=eager)
    else:
        engine = serve.make_engine(args, eager=eager)
    if f32:
        def widen(tree):
            return {k: widen(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.float()

        cfg, sc, params = engine.cfg, engine.serve_cfg, widen(engine.params)
        del engine
        gc.collect()
        engine = ServingEngine(dataclasses.replace(cfg, dtype="float32"), params, sc,
                               params["embed"].device, eager=eager)
    if warm:
        engine.warmup()
    if arch in (RING, RING_FULL):
        # the ring's traffic: prompts alternating in length
        import numpy as np

        rng = np.random.default_rng(args.seed)
        for i in range(args.requests):
            n = RING_PROMPTS[i % len(RING_PROMPTS)]
            engine.submit(rng.integers(0, engine.cfg.vocab, size=n).astype(np.int32))
    else:
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


def round_bytes(engine) -> tuple:
    """(weight bytes, KV-cache bytes) a decode round reads at least: every
    layer weight, the final norm and the unembedding once (of an untied
    embedding only the batch's rows, left out), and the whole cache."""
    p = engine.params
    wb = tree_bytes(p) - (0 if engine.cfg.tie_embeddings else nbytes(p["embed"]))
    return wb, tree_bytes(engine._cache)


def serve_runs(torch, rates, arch="olmo-1b"):
    """Timed runs of both paths of ``arch``, each eager and captured (the
    main path), nothing hooked in: stats, launch counts of each run, the
    greedy streams, equal between eager and captured; the captured kernel
    round against its bound."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    pre = "" if arch == "olmo-1b" else f"{arch} "
    runs = {}
    for kernels in (False, True):
        for eager in (True, False):
            engine = serve_engine(serve, kernels, eager, arch=arch)
            cfg = engine.cfg
            st, launches, captures = served(torch, engine)
            streams = {r.uid: r.out_tokens for r in engine.completed}
            label = ("kernels" if kernels else "composed") + ("_eager" if eager else "")
            head = "[serve]" if eager else "[graph] serve"
            print(f"{head} {pre}{label}: tokens_per_s={st['tokens_per_s']} mean_ttft_s={st['mean_ttft_s']} "
                  f"mean_decode_round_s={st['mean_decode_round_s']} decode_rounds={st['decode_rounds']} "
                  f"launches={launches} graphs captured at warmup={captures} after=0", flush=True)
            assert st["completed"] == REQUESTS and len(streams) == REQUESTS, st
            assert all(len(s) == MAX_NEW and all(0 <= t < cfg.vocab for t in s)
                       for s in streams.values())
            assert st["cuda_graphs"] == float(not eager) and captures == (0 if eager else 6), (st, captures)
            want = cfg.n_layers * engine.decode_rounds if kernels else 0
            assert all(n == want for n in launches.values()), (launches, want)
            assert not kernels or want > 0
            assert (st["kernel_launches_qkv"], st["kernel_launches_attn"],
                    st["kernel_launches_mlp"]) == tuple(float(n) for n in launches.values())
            if kernels and not eager:
                # least time a round could take: the weights it uses and the
                # whole KV cache read once at the card's memory rate
                wb, kvb = round_bytes(engine)
                bound_s = (wb + kvb) / rates["bytes"]
                print(f"[serve] {pre}round bound {bound_s * 1e3} ms (weights {wb} B + KV cache {kvb} B "
                      f"at {rates['bytes']} B/s); kernel-path round / bound = "
                      f"{st['mean_decode_round_s'] / bound_s}", flush=True)
                if cfg.window:
                    # a local layer attends at most its window of the cache
                    slots = engine._cache[0].shape[2]
                    kv_win = kvb * sum(min(w, slots) for w in transformer.window_list(cfg)) / (
                        cfg.n_layers * slots)
                    print(f"[serve] {pre}of the KV cache the layers' windows let a round read at "
                          f"most {kv_win} B: bound {(wb + kv_win) / rates['bytes'] * 1e3} ms",
                          flush=True)
            if not eager:
                scratch_left_zero(torch, engine._graphs.values(), f"the {label} run's replays")
            runs[label] = dict(streams=streams, launches=launches, ttft_s=st["mean_ttft_s"],
                               round_s=st["mean_decode_round_s"], tokens_per_s=st["tokens_per_s"],
                               cache_bytes=tree_bytes(engine._cache),
                               max_len=engine.serve_cfg.max_len)
            del engine
            free(torch)
        path = "kernels" if kernels else "composed"
        eq = runs[path]["streams"] == runs[path + "_eager"]["streams"]
        print(f"[graph] serve {pre}{path}: greedy streams of the captured run "
              f"{'equal' if eq else 'DIFFER from'} the eager run's ({REQUESTS} requests); round "
              f"{runs[path + '_eager']['round_s'] * 1e3} -> {runs[path]['round_s'] * 1e3} ms, "
              f"{runs[path + '_eager']['tokens_per_s']} -> {runs[path]['tokens_per_s']} tokens/s",
              flush=True)
        assert eq, f"{arch} {path}: the captured decode blocks changed the greedy streams"
    same = sum(runs["kernels"]["streams"][u] == s for u, s in runs["composed"]["streams"].items())
    print(f"[serve] {pre}greedy streams: {same}/{REQUESTS} identical between the paths", flush=True)
    return runs


def serve_phase(torch, rates):
    """olmo-1b's timed runs (``serve_runs``), then a temperature run eager
    and captured."""
    from repro_torch.launch import serve

    runs = serve_runs(torch, rates)
    temp = {}
    for eager in (True, False):
        engine = serve_engine(serve, True, eager, TEMP_ARGV)
        served(torch, engine)
        temp[eager] = ({r.uid: r.out_tokens for r in engine.completed}, engine._gen.get_offset())
        del engine
        free(torch)
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
    """``[multi-pu] serve``: olmo-1b at full width through two stages on
    the shared card: (a) ``--microbatches 1``, eager; (b) the default, M =
    1 as one captured pass of the whole batch; (b2) ``--microbatches 2``,
    captured and eager, teacher-forced to the single-PU kernel path; then
    (c), with two or more cards, on per-stage devices."""
    from repro_torch.launch import serve

    want = runs["kernels"]["streams"]
    # (a) one lane group, eager: the single-PU bits
    engine = serve_engine(serve, True, True, MULTI_PU + ["--microbatches", "1"])
    st, launches, captures = served(torch, engine)
    streams, same = multi_pu_report(want, "(a) --microbatches 1, eager", engine, st, launches,
                                    captures)
    assert engine._staged.n_groups == 1 and captures == 0
    assert streams == want, "the serial staged schedule changed the greedy streams"
    del engine
    free(torch)
    # (b) the default on a shared card: M = 1, no tuner, the whole batch
    # through every stage in one CUDA graph per block length
    engine = serve_engine(serve, True, False, MULTI_PU)
    st, launches, captures = served(torch, engine)
    streams, same = multi_pu_report(want, "(b) default (M = 1 on the shared card), captured",
                                    engine, st, launches, captures)
    assert engine.stages_share_card and engine._staged.coalesce and engine._staged.n_groups == 1
    assert engine.staged_tune is None and "stage_decode_autotuned" not in st, st
    assert captures == len(engine._staged.graphs) == 6, captures
    assert streams == want, "the captured M = 1 staged pass changed the greedy streams"
    scratch_left_zero(torch, engine._staged.graphs, "the multi-pu run's replays")
    print(f"[multi-pu] serve (b): round {st['mean_decode_round_s'] * 1e3} ms captured at M = 1 "
          f"against the single-PU captured round {runs['kernels']['round_s'] * 1e3} ms of this "
          f"run (ratio {st['mean_decode_round_s'] / runs['kernels']['round_s']}); greedy streams "
          f"{same}/{REQUESTS} equal to the single-PU kernel run's", flush=True)
    engine.execute_partition()
    pst = {k: v for k, v in engine.stats().items() if k.startswith("partition_")}
    print(f"[multi-pu] execute_partition (functional tiles, M auto-tuned): {pst}", flush=True)
    del engine
    free(torch)
    # (b2) M = 2 pinned: two lane groups, coalesced and captured
    m2 = MULTI_PU + ["--microbatches", "2"]
    engine = serve_engine(serve, True, False, m2)
    st, launches, captures = served(torch, engine)
    streams, same = multi_pu_report(want, "(b2) --microbatches 2, captured", engine, st, launches,
                                    captures)
    assert engine._staged.coalesce and engine._staged.n_groups == 2 and engine.staged_tune is None
    assert captures == len(engine._staged.graphs) == 6, captures
    scratch_left_zero(torch, engine._staged.graphs, "the multi-pu M = 2 run's replays")
    del engine
    free(torch)
    # the same engine run eagerly: the captured blocks must give its bits
    engine = serve_engine(serve, True, True, m2)
    st, launches, _ = served(torch, engine)
    eager, _ = multi_pu_report(want, "(b2) the same, eager", engine, st, launches, 0)
    assert engine._staged.n_groups == 2 and engine._staged.coalesce and not engine._staged.graphs
    print(f"[multi-pu] serve (b2): captured greedy streams "
          f"{'equal' if eager == streams else 'DIFFER from'} the eager run's", flush=True)
    assert eager == streams, "the captured staged blocks served other tokens than the eager ones"
    del engine
    free(torch)
    _, want_rounds, _ = logged_run(torch, kernels=True, feed=want)
    staged_forced(torch, "(b2)", streams, 2, want, want_rounds, m2)
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
    free(torch)
    staged_forced(torch, "(c)", streams, m, want, want_rounds)


def staged_forced(torch, label, streams, m, want, want_rounds, extra=MULTI_PU):
    """Hold a staged engine's logits (launcher arguments ``extra``, M =
    ``m``) to the single-PU kernel path's at every step of every request,
    teacher-forced on ``want``, and the timed staged run's ``streams`` to
    ``want``: every lane group's attention is split as the whole batch's
    (``plan_lanes``), so each lane's sums run in the single-PU order and
    the streams are equal."""
    got_streams, got_rounds, m_forced = logged_run(torch, True, feed=want, extra=extra)
    assert m_forced == m, (m_forced, m)
    diffs, flips = compare_rounds(torch, want_rounds, got_rounds)
    d = sorted(diffs.values())
    same = sum(streams[u] == s for u, s in want.items())
    print(f"[multi-pu] {label} teacher-forced, staged M={m} vs single-PU, kernels on both, on "
          f"the same tokens: {len(d)} (request, step) logit vectors, max |diff| {d[-1]}, median "
          f"{statistics.median(d)}, argmax differs at {len(flips)} steps (limit {LOGIT_ATOL}); "
          f"greedy streams equal: {same}/{REQUESTS}", flush=True)
    assert len(d) == REQUESTS * (MAX_NEW - 1) and d[-1] <= LOGIT_ATOL, d[-1]
    assert streams == want and got_streams == want, \
        f"{label}: staged M={m} served {same}/{REQUESTS} of the single-PU greedy streams"


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


def logged_run(torch, kernels: bool, feed=None, extra=(), arch="olmo-1b", steps=None,
               f32: bool = False):
    """An untimed, eager run of the serve phase's requests (``extra``
    launcher arguments after them; all of them, or the first ``steps``
    engine steps) that keeps every round's logits on the card; returns
    (streams, rounds, M).  Being eager and untimed, a single-PU run skips
    the warmup, which changes nothing served (it scatters no row); a
    staged engine's warmup also sets up its runner, and is kept.  With ``feed`` (uid -> stream)
    each active lane is fed that stream's tokens in place of its own
    samples, so the run scores exactly the prefixes ``feed`` scored
    (teacher forcing); the run's own samples still land in its streams.
    The single-PU hook wraps ``decode_step`` and feeds its input; the
    staged path calls no ``decode_step``, so there the hook wraps the
    post-decode transition, which sees each lane group's logits (the
    groups are views of the engine's state, so a group's first lane is
    its offset there) and feeds the group's next input."""
    from repro_torch.launch import serve

    # eager: the hook runs every round
    engine = serve_engine(serve, kernels, eager=True, extra=extra, arch=arch,
                          warm="--multi-pu" in extra, f32=f32)
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
    if steps is None:
        engine.run_until_drained()
    else:
        for _ in range(steps):
            engine.step()
    assert not pending, "a round's lane groups did not all arrive"
    streams = {r.uid: r.out_tokens for r in engine.completed}
    m = 1 if engine._staged is None else engine._staged.n_groups
    del engine
    free(torch)
    return streams, rounds, m


def float32_distance(torch, arch, feed, steps=PROBE_STEPS) -> dict:
    """``arch`` teacher-forced on ``feed``'s tokens over its first
    ``steps`` engine steps on both bf16 paths and served in float32 (the
    composed path, the same bf16 weights widened): each bf16 path's
    largest |logit difference| to float32, and the two paths' to each
    other.  The kernel path no farther from float32 than the composed
    path says its distance to the composed path is rounding."""
    rounds = {name: logged_run(torch, kernels, feed=feed, arch=arch, steps=steps, f32=f32)[1]
              for name, kernels, f32 in (("float32", False, True), ("composed", False, False),
                                         ("kernel", True, False))}
    n = len(rounds["float32"])
    out = {}
    for a, b in (("float32", "composed"), ("float32", "kernel"), ("composed", "kernel")):
        d = sorted(compare_rounds(torch, rounds[a], rounds[b][:n])[0].values())
        out[f"{b} vs {a}"] = d[-1]
        print(f"[forced] {arch} ({model_cfg(arch).n_layers} layers), over the first {steps} "
              f"engine step ({len(d)} (request, step) logit vectors): the {b} path against the "
              f"{a} run on the same tokens: max |diff| {d[-1]}, median {statistics.median(d)}, "
              f"p99 {d[int(0.99 * (len(d) - 1))]}", flush=True)
    del rounds
    free(torch)
    return out


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


def forced_phase(torch, runs, arch="olmo-1b", bar=LOGIT_ATOL):
    """Hold the kernel path's logits to the composed path's at every step
    of every request, on the same tokens, within ``bar``, and tie the
    timed kernel run's streams to those checked logits.  Returns the
    composed run's streams and rounds and the kernel run's rounds."""
    pre = "" if arch == "olmo-1b" else f"{arch} "
    want_streams, want_rounds, _ = logged_run(torch, kernels=False, arch=arch)
    assert want_streams == runs["composed"]["streams"], "the composed path is not deterministic"
    got_streams, got_rounds, _ = logged_run(torch, kernels=True, feed=want_streams, arch=arch)
    diffs, flips = compare_rounds(torch, want_rounds, got_rounds)
    assert len(diffs) == REQUESTS * (MAX_NEW - 1), len(diffs)
    d = sorted(diffs.values())
    print(f"[forced] {pre}{len(d)} (request, step) logit vectors, kernel vs composed on the same "
          f"tokens: max |diff| {d[-1]}, median {statistics.median(d)}, "
          f"p99 {d[int(0.99 * (len(d) - 1))]} (limit {bar})", flush=True)
    if arch == "olmo-1b":
        for (uid, step), g, ulps, c in flips:
            print(f"[forced] request {uid} step {step}: argmax differs; composed top-2 gap {g} "
                  f"= {ulps} bf16 ulp; the two tokens' logits differ between the paths by {c}",
                  flush=True)
    gaps = sorted(ulps for _, _, ulps, _ in flips) or [0.0]
    print(f"[forced] {pre}argmax differs at {len(flips)} of {len(d)} steps; the composed top-2 "
          f"gap there: median {statistics.median(gaps)}, max {gaps[-1]} bf16 ulp", flush=True)
    assert d[-1] <= bar, f"{arch}: logits differ by {d[-1]} > {bar}"
    # the timed kernel run scored the composed prefix up to its first
    # divergence, so up to and including it its tokens are the checked ones
    tie_streams(runs["kernels"]["streams"], runs["composed"]["streams"], got_streams)
    return want_streams, want_rounds, got_rounds


def fault_phase(torch, want_streams, want_rounds, arch="olmo-1b", bar=LOGIT_ATOL):
    """Run the teacher-forced comparison with a fault put into the kernel
    path's wiring (not into the kernels, which the kernel phase holds):
    each must move the logits past ``bar``, or the check is blind to it.
    A probe serves the first ``PROBE_STEPS`` engine steps (the first
    wave's prefill and decode block) and is held to the same steps of the
    checked run.  A ring config's attention masks by the ring's slot
    positions, not by ``kv_valid_len``: its probe makes them linear.  An
    int8 cache's probes break what the int8 cache adds: one layer's
    exponents, and the payloads' sign.  A vlm adds one in its prefill:
    the patch embeddings dropped, so the first ``vision_patches`` slots
    keep their token embeddings."""
    from repro_torch.kernels import common, dispatch, ref
    from repro_torch.models import transformer

    cfg = model_cfg(arch)
    qkv, attn = dispatch.decode_qkv, dispatch.decode_attention
    ring_positions, embed = transformer.ring_positions, transformer._embed
    no_window = common.device_int(ref.BIG_WINDOW, "window", torch.device("cuda", 0))

    def rope_late(cfg, p, x, positions, *, rope):
        return qkv(cfg, p, x, positions + 1, rope=rope)

    def own_token_dropped(cfg, p, q, k, v, *, kv_valid_len, **kw):
        return attn(cfg, p, q, k, v, kv_valid_len=kv_valid_len - 1, **kw)

    def windows_dropped(cfg, p, q, k, v, *, window_arr, **kw):
        return attn(cfg, p, q, k, v, window_arr=no_window, **kw)

    def patches_dropped(cfg, params, tokens, patch_embeds=None):
        return embed(cfg, params, tokens)

    def linear_positions(pos, slots):
        s = torch.arange(slots, dtype=torch.int32, device=pos.device)
        return s.expand(*pos.shape, slots).contiguous()

    calls = [0]

    def exponents_off(cfg, p, q, k, v, *, k_exp, v_exp, **kw):
        """Layer 0's exponents one too large (its K and V read doubled)."""
        if calls[0] % cfg.n_layers == 0:
            k_exp, v_exp = k_exp + 1, v_exp + 1
        calls[0] += 1
        return attn(cfg, p, q, k, v, k_exp=k_exp, v_exp=v_exp, **kw)

    def payloads_unsigned(cfg, p, q, k, v, *, k_exp, v_exp, **kw):
        """The int8 payloads' bytes read as uint8, dequantized exactly (a
        value up to 255 takes 8 bits), through the bf16 kernel."""
        k, v = (ref.kv_dequantize(t.view(torch.uint8), e, q.dtype) for t, e in ((k, k_exp), (v, v_exp)))
        return attn(cfg, p, q, k, v, **kw)

    probes = [("rope one position late", dispatch, "decode_qkv", rope_late)]
    if cfg.kv_quant:
        probes = [("layer 0's K and V exponents one too large", dispatch, "decode_attention",
                   exponents_off),
                  ("the int8 payloads read as uint8", dispatch, "decode_attention",
                   payloads_unsigned)]
    elif transformer.ring_applies(cfg):
        probes.append(("ring positions linear (each slot's index)", transformer, "ring_positions",
                       linear_positions))
    else:
        probes.append(("current token left out of attention", dispatch, "decode_attention",
                       own_token_dropped))
        if cfg.window:
            probes.append(("every layer's window BIG_WINDOW", dispatch, "decode_attention",
                           windows_dropped))
        if cfg.family == "vlm":
            probes.append((f"the patches dropped (slots 0-{cfg.vision_patches - 1} keep their "
                           f"token embeddings)", transformer, "_embed", patches_dropped))
    pre = "" if arch == "olmo-1b" else f"{arch} "
    for name, module, attr, fn in probes:
        calls[0] = 0
        setattr(module, attr, fn)
        try:
            _, rounds, _ = logged_run(torch, kernels=True, feed=want_streams, arch=arch,
                                      steps=PROBE_STEPS)
        finally:
            dispatch.decode_qkv, dispatch.decode_attention = qkv, attn
            transformer.ring_positions, transformer._embed = ring_positions, embed
        diffs, flips = compare_rounds(torch, want_rounds[:len(rounds)], rounds)
        d = sorted(diffs.values())
        print(f"[fault] {pre}{name}: max |diff| {d[-1]}, median {statistics.median(d)}, "
              f"argmax differs at {len(flips)} of {len(d)} steps (limit {bar})", flush=True)
        assert d[-1] > bar, f"{arch}: the teacher-forced check does not see the fault '{name}'"
        del rounds
        torch.cuda.empty_cache()


def family_phase(torch, rates, arch: str) -> dict:
    """``[serve] <arch>``: a dense decoder of step 9 at its published
    widths with seeded random bf16 weights (gemma3-12b's depth cut,
    ``GEMMA_LAYERS``), served with the olmo-1b phase's requests
    (gemma3-12b's prompts 1536 tokens long, ``FAMILY_PROMPT_LEN``; a
    vlm's first 256 slots the zero patches): both paths eager and
    captured (``serve_runs``), a profiled captured block, the kernel path
    teacher-forced to the composed path within the arch's bar (for
    internvl2-26b each path's float32 distance at a depth its float32
    weights fit, ``FAMILY_F32_DEPTH``), and the fault probes above it (a
    windowed model's includes every window dropped, a vlm's the patches
    dropped).  Prints the round, tokens/s, TTFT, busy share, the
    attention's and the unembedding's in-situ times, peak memory and the
    card.  Returns the captured kernel run's launches."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bar = FAMILY_LOGIT_ATOL[arch]
    runs = serve_runs(torch, rates, arch)
    walls = [time.perf_counter()]
    prof = profile_phase(torch, runs, arch, modes=(False,))[f"{arch} captured"]
    walls.append(time.perf_counter())
    want_streams, want_rounds = forced_phase(torch, runs, arch, bar)[:2]
    walls.append(time.perf_counter())
    if arch in FAMILY_F32_DEPTH:
        # each bf16 path's distance to float32 where float32 weights fit
        dist = float32_distance(torch, FAMILY_F32_DEPTH[arch], want_streams)
        near = dist["kernel vs float32"] <= dist["composed vs float32"]
        print(f"[forced] {arch}: at {model_cfg(FAMILY_F32_DEPTH[arch]).n_layers} layers the kernel "
              f"path is {'no farther from' if near else 'FARTHER from'} float32 than the composed "
              f"path ({dist['kernel vs float32']} against {dist['composed vs float32']})",
              flush=True)
        assert max(dist.values()) <= bar, dist
        walls.append(time.perf_counter())
    fault_phase(torch, want_streams, want_rounds, arch, bar)
    del want_rounds
    free(torch)
    walls.append(time.perf_counter())
    print(f"[serve] {arch}: wall s of the timed runs, profile, teacher-forced runs, "
          f"{'float32 distance, ' if arch in FAMILY_F32_DEPTH else ''}probes: "
          f"{[b - a for a, b in zip([t0] + walls, walls)]}", flush=True)
    k, cfg = runs["kernels"], model_cfg(arch)
    attn_us = prof["kernel_ms"].get("attn_kernel", 0.0) * 1e3 / cfg.n_layers
    # the decode block's one product outside the port's kernels is the
    # unembedding, a cuBLAS GEMM
    gemms = {n: ms for n, ms in prof["kernel_ms"].items()
             if CUBLAS_OP.search(n) and n not in PORT_KERNELS}
    print(f"[serve] {arch} ({cfg.n_layers} layers): captured kernel path "
          f"{k['round_s'] * 1e3} ms a round, "
          f"{k['tokens_per_s']} tokens/s, mean TTFT {k['ttft_s']} s, device busy share of a "
          f"captured block {prof['busy_ms'] / prof['window_ms']} (composed path captured "
          f"{runs['composed']['round_s'] * 1e3} ms); attention in situ {attn_us} us a layer "
          f"(attn_kernel<{cfg.n_heads // cfg.n_kv_heads}, {cfg.head_dim}>); unembedding in situ "
          f"{sum(gemms.values())} ms a round ({sorted(gemms)}); peak memory "
          f"{torch.cuda.max_memory_allocated()} B; teacher-forced bar {bar}; phase wall "
          f"{time.perf_counter() - t0} s; {card_line()}", flush=True)
    return k["launches"]


def ring_phase(torch, rates) -> dict:
    """``[serve] mixtral-8x7b-ring``: mixtral-8x7b's dense widths with its
    4096-token window and a ring KV cache, seeded random bf16 weights,
    nothing cut, 16 requests of 64 new tokens on 8 slots, prompts
    alternating 4064 and 4160 tokens (``RING_PROMPTS``; each wave two
    exact-length prefill calls of 4 lanes).  (a) both paths eager and
    captured (``serve_runs``): captured streams equal eager, no capture
    after warmup; a profiled captured block; (b) the kernel path
    teacher-forced to the composed path within ``RING_LOGIT_ATOL``; (c)
    the same model with a full cache (``RING_FULL``), teacher-forced on
    the same tokens on the kernel path over the first wave
    (``RING_FULL_STEPS``, past both prompt lengths' wraps), within
    ``RING_LOGIT_ATOL`` of the ring; the same weights served in float32
    on those tokens over the first ``PROBE_STEPS``: each bf16 path (the
    composed, the kernel, the full cache) within the bar of it; (d) the fault probes, the ring positions made linear; (e)
    ``--multi-pu 2`` on the shared card (M = 1, captured): the single-PU
    captured kernel run's streams.  Returns the captured kernel run's
    launches."""
    t0 = time.perf_counter()
    bar = RING_LOGIT_ATOL
    cfg = model_cfg(RING)
    runs = serve_runs(torch, rates, RING)
    walls = [time.perf_counter()]
    prof = profile_phase(torch, runs, RING, modes=(False,))[f"{RING} captured"]
    walls.append(time.perf_counter())
    want_streams, want_rounds, ring_rounds = forced_phase(torch, runs, RING, bar)
    walls.append(time.perf_counter())
    # (c) the ring against a full cache, the kernel path on both
    _, full_rounds, _ = logged_run(torch, True, feed=want_streams, arch=RING_FULL,
                                   steps=RING_FULL_STEPS)
    diffs, flips = compare_rounds(torch, ring_rounds[:len(full_rounds)], full_rounds)
    d = sorted(diffs.values())
    wrapped = max(step for (uid, step) in diffs if RING_PROMPTS[uid % 2] < cfg.window)
    k = runs["kernels"]
    print(f"[ring] (c) ring ({cfg.window} slots) against a full cache ({k['max_len']} slots, the "
          f"window mask alone), kernels on both, on the composed run's tokens over the first "
          f"{RING_FULL_STEPS} engine steps (the {RING_PROMPTS[0]}-token lanes to step {wrapped}): "
          f"{len(d)} (request, step) logit vectors, max |diff| {d[-1]}, median "
          f"{statistics.median(d)}, argmax differs at {len(flips)} steps (limit {bar})", flush=True)
    assert wrapped >= RING_ROUND and d[-1] <= bar, (wrapped, d[-1])
    walls.append(time.perf_counter())
    # each bf16 run's distance to the same weights served in float32 on
    # the same tokens: the bar must cover the rounding of every bf16 path
    # (the composed path's own included), and a full cache within it of
    # the float32 ring attends what the ring attends
    _, f32_rounds, _ = logged_run(torch, False, feed=want_streams, arch=RING, f32=True,
                                  steps=PROBE_STEPS)
    n = len(f32_rounds)
    dist = {}
    for path, rounds in (("composed", want_rounds), ("kernel", ring_rounds),
                         ("kernel full-cache", full_rounds)):
        d = sorted(compare_rounds(torch, f32_rounds, rounds[:n])[0].values())
        dist[path] = d[-1]
        print(f"[ring] float32 distance over the first {PROBE_STEPS} engine step ({len(d)} "
              f"(request, step) logit vectors): the {path} path's logits against the float32 "
              f"composed ring run's on the same tokens: max |diff| {d[-1]}, median "
              f"{statistics.median(d)}, p99 {d[int(0.99 * (len(d) - 1))]}", flush=True)
    assert max(dist.values()) <= bar, dist
    del f32_rounds, full_rounds, ring_rounds
    free(torch)
    walls.append(time.perf_counter())
    # (d) the ring positions broken
    fault_phase(torch, want_streams, want_rounds, RING, bar)
    del want_rounds
    free(torch)
    walls.append(time.perf_counter())
    # (e) two stages on the shared card: M = 1, captured
    staged_shared_card(torch, RING, k, "[ring] (e)")
    walls.append(time.perf_counter())
    kv_layer = k["cache_bytes"] // cfg.n_layers             # a layer's ring K and V
    attn_us = prof["kernel_ms"].get("attn_kernel", 0.0) * 1e3 / cfg.n_layers
    print(f"[serve] {RING}: wall s of the timed runs, profile, teacher-forced runs, ring vs full "
          f"cache, float32 distance, probes, multi-pu: "
          f"{[b - a for a, b in zip([t0] + walls, walls)]}", flush=True)
    print(f"[serve] {RING} ({cfg.n_layers} layers): captured kernel path {k['round_s'] * 1e3} ms a round, "
          f"{k['tokens_per_s']} tokens/s, mean TTFT {k['ttft_s']} s, device busy share of a "
          f"captured block {prof['busy_ms'] / prof['window_ms']} (composed path captured "
          f"{runs['composed']['round_s'] * 1e3} ms); attention in situ {attn_us} us a layer "
          f"(attn_kernel<{cfg.n_heads // cfg.n_kv_heads}, {cfg.head_dim}>; a layer's ring K/V "
          f"{kv_layer} B take {kv_layer / rates['bytes'] * 1e6} us at {rates['bytes']} B/s); KV "
          f"cache {k['cache_bytes']} B as a ring against "
          f"{k['cache_bytes'] * k['max_len'] // cfg.window} B as a full cache; teacher-forced "
          f"bar {bar}; phase wall {time.perf_counter() - t0} s; {card_line()}", flush=True)
    return k["launches"]


def staged_shared_card(torch, arch, k, tag):
    """``--multi-pu 2`` on the shared card (M = 1, captured) for ``arch``:
    no capture after warmup, 16 launches a layer a round, and the greedy
    streams of ``k``, the single-PU captured kernel run."""
    from repro_torch.launch import serve

    cfg = model_cfg(arch)
    engine = serve_engine(serve, True, False, MULTI_PU, arch=arch)
    st, launches, captures = served(torch, engine)
    staged = engine._staged
    streams = {r.uid: r.out_tokens for r in engine.completed}
    same = sum(streams[u] == s for u, s in k["streams"].items())
    print(f"{tag} --multi-pu 2 (M = {staged.n_groups} on the shared card, captured): round "
          f"{st['mean_decode_round_s'] * 1e3} ms against the single-PU captured round "
          f"{k['round_s'] * 1e3} ms, tokens_per_s={st['tokens_per_s']}, graphs captured at "
          f"warmup {captures}, after 0; greedy streams {same}/{REQUESTS} equal to the single-PU "
          f"captured kernel run's", flush=True)
    assert engine.stages_share_card and staged.coalesce and staged.n_groups == 1, staged.n_groups
    assert captures == len(staged.graphs) == 6, captures
    assert all(n == cfg.n_layers * engine.decode_rounds for n in launches.values()), launches
    assert streams == k["streams"], f"{arch}: the staged run served other tokens than the single-PU run"
    del engine, staged
    free(torch)


def kvq_phase(torch, rates) -> dict:
    """``[serve] olmo-1b-kvq``: olmo-1b at full width with the int8 KV cache
    (``kv_quant``), seeded random bf16 weights, nothing cut, 16 requests of
    2048-token prompts and 64 new tokens on 8 slots, beside the same
    traffic with the bf16 cache (``KVQ_BF16``, captured kernel path).  (a)
    both paths eager and captured (``serve_runs``): captured streams equal
    eager, no capture after warmup; a profiled captured block of each
    cache; (b) the kernel path teacher-forced to the composed path within
    ``LOGIT_ATOL``; (c) the int8 cache's kernel path against the bf16
    cache's on the same tokens, reported against ``KVQ_CACHE_BAR``, with
    the greedy agreement; each path's distance over the first engine step
    to the bf16-cache model served in float32 on those tokens (the bf16
    cache's kernel and composed paths, the int8 cache's kernel and
    composed paths); (d) the fault probes above the bar: one layer's
    exponents one too large, the payloads read as uint8; (e) ``--multi-pu
    2`` on the shared card (M = 1, captured): the single-PU captured
    kernel run's streams.  Returns the captured kernel run's launches."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    bar = LOGIT_ATOL
    cfg = model_cfg(KVQ)
    runs = serve_runs(torch, rates, KVQ)
    k = runs["kernels"]
    # the bf16 cache, same model and traffic: the captured kernel path
    engine = serve_engine(serve, True, arch=KVQ_BF16)
    st, launches, captures = served(torch, engine)
    wb, kvb = round_bytes(engine)
    plain = dict(streams={r.uid: r.out_tokens for r in engine.completed}, launches=launches,
                 ttft_s=st["mean_ttft_s"], round_s=st["mean_decode_round_s"],
                 tokens_per_s=st["tokens_per_s"], cache_bytes=kvb)
    assert captures == 6 and all(n == cfg.n_layers * engine.decode_rounds for n in launches.values())
    del engine
    free(torch)
    same = sum(plain["streams"][u] == s for u, s in k["streams"].items())
    print(f"[kvq] bf16 cache, kernels, captured: tokens_per_s={plain['tokens_per_s']} mean_ttft_s="
          f"{plain['ttft_s']} mean_decode_round_s={plain['round_s']} (bound "
          f"{(wb + kvb) / rates['bytes'] * 1e3} ms: weights {wb} B + KV cache {kvb} B); the int8 "
          f"cache's captured kernel run serves {same}/{REQUESTS} of its greedy streams", flush=True)
    walls = [time.perf_counter()]
    prof = profile_phase(torch, runs, KVQ, modes=(False,))[f"{KVQ} captured"]
    prof_plain = profile_phase(torch, {"kernels": plain}, KVQ_BF16, modes=(False,))[
        f"{KVQ_BF16} captured"]
    walls.append(time.perf_counter())
    # (b) kernel vs composed, both over the int8 cache
    want_streams, want_rounds, got_rounds = forced_phase(torch, runs, KVQ, bar)
    walls.append(time.perf_counter())
    # (c) the int8 cache's kernel path against the bf16 cache's
    _, plain_rounds, _ = logged_run(torch, True, feed=want_streams, arch=KVQ_BF16)
    diffs, flips = compare_rounds(torch, plain_rounds, got_rounds)
    d = sorted(diffs.values())
    print(f"[kvq] (c) int8 cache against bf16 cache, kernel path on both, on the composed int8 "
          f"run's tokens: {len(d)} (request, step) logit vectors, max |diff| {d[-1]}, median "
          f"{statistics.median(d)}, p99 {d[int(0.99 * (len(d) - 1))]}; argmax equal at "
          f"{len(d) - len(flips)} of {len(d)} steps; bar {KVQ_CACHE_BAR} (fixed before the first "
          f"card run): {'met' if d[-1] <= KVQ_CACHE_BAR else 'MISSED'}", flush=True)
    walls.append(time.perf_counter())
    # each path's distance to the bf16-cache model served in float32
    _, f32_rounds, _ = logged_run(torch, False, feed=want_streams, arch=KVQ_BF16, f32=True,
                                  steps=PROBE_STEPS)
    _, plain_composed, _ = logged_run(torch, False, feed=want_streams, arch=KVQ_BF16,
                                      steps=PROBE_STEPS)
    n = len(f32_rounds)
    dist = {}
    for path, rounds in (("bf16 cache composed", plain_composed), ("bf16 cache kernel", plain_rounds),
                         ("int8 cache composed", want_rounds), ("int8 cache kernel", got_rounds)):
        dd = sorted(compare_rounds(torch, f32_rounds, rounds[:n])[0].values())
        dist[path] = dd[-1]
        print(f"[kvq] float32 distance over the first {PROBE_STEPS} engine step ({len(dd)} "
              f"(request, step) logit vectors): the {path} path against the float32 composed run "
              f"(bf16 cache model widened) on the same tokens: max |diff| {dd[-1]}, median "
              f"{statistics.median(dd)}, p99 {dd[int(0.99 * (len(dd) - 1))]}", flush=True)
    print(f"[kvq] float32 distance: the bf16 cache's kernel path is "
          f"{'no farther' if dist['bf16 cache kernel'] <= dist['bf16 cache composed'] else 'FARTHER'}"
          f" than its composed path ({dist['bf16 cache kernel']} against "
          f"{dist['bf16 cache composed']}); the int8 cache's kernel path "
          f"{dist['int8 cache kernel']}", flush=True)
    del f32_rounds, plain_composed, plain_rounds, got_rounds
    free(torch)
    walls.append(time.perf_counter())
    # (d) the int8 cache's exponents and payloads broken
    fault_phase(torch, want_streams, want_rounds, KVQ, bar)
    del want_rounds
    free(torch)
    walls.append(time.perf_counter())
    # (e) two stages on the shared card: M = 1, captured
    staged_shared_card(torch, KVQ, k, "[kvq] (e)")
    walls.append(time.perf_counter())
    attn_us = {c: p["kernel_ms"].get("attn_kernel", 0.0) * 1e3 / cfg.n_layers
               for c, p in (("int8", prof), ("bf16", prof_plain))}
    print(f"[serve] {KVQ}: wall s of the timed runs, profiles, teacher-forced runs, int8 vs bf16 "
          f"cache, float32 distance, probes, multi-pu: "
          f"{[b - a for a, b in zip([t0] + walls, walls)]}", flush=True)
    for c, r, p in (("int8", k, prof), ("bf16", plain, prof_plain)):
        print(f"[serve] {KVQ}: {c} cache, captured kernel path {r['round_s'] * 1e3} ms a round, "
              f"{r['tokens_per_s']} tokens/s, mean TTFT {r['ttft_s']} s, device busy share of a "
              f"captured block {p['busy_ms'] / p['window_ms']}, attention in situ {attn_us[c]} us a "
              f"layer, KV cache {r['cache_bytes']} B", flush=True)
    print(f"[serve] {KVQ}: composed path over the int8 cache captured {runs['composed']['round_s'] * 1e3}"
          f" ms a round; teacher-forced bar {bar}; phase wall {time.perf_counter() - t0} s; "
          f"{card_line()}", flush=True)
    return k["launches"]


# cuBLAS's GEMM and GEMV kernels by name (sm90_xmma_gemm_*, nvjet_*,
# cutlass::Kernel2<...>, gemv2T_kernel...), the port's own left out
CUBLAS_OP = re.compile(r"gemm|gemv|nvjet|cutlass|xmma|Kernel2|splitK", re.I)
PORT_KERNELS = ("qkv_gemv_kernel", "gemv_kernel", "attn_kernel")


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


def decode_block_profile(torch, eager: bool, arch="olmo-1b"):
    """torch.profiler over the kernel path's first engine step (the first
    wave's prefill and a 32-round decode block, replayed from its CUDA
    graph unless ``eager``): (rounds, window us, device-busy us, {device
    op: us}, {device op: launches}, the wrappers' launch counts) of the
    block.  The launches are counted over the whole step: the prefill
    (composed) launches none of the decode kernels, and the host span's
    edges, against which the device times are placed, can be off by
    milliseconds (on an H100 the profiler once left nine layers' kernels
    of a captured starcoder2-15b block outside it); those inside it are
    counted apart."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import decode
    from repro_torch.launch import serve

    engine = serve_engine(serve, kernels=True, eager=eager, arch=arch)
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
    free(torch)
    cuda = torch.autograd.DeviceType.CUDA
    (w0, w1), = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name == "decode_block" and e.device_type != cuda]
    calls, inside = {}, {}
    for e in prof.events():
        if e.device_type == cuda:
            calls[e.name] = calls.get(e.name, 0) + 1
            if w0 <= e.time_range.start < w1:
                inside[e.name] = inside.get(e.name, 0) + 1
    return rounds, window, busy, by_name, calls, inside, launches


def profile_phase(torch, runs, arch="olmo-1b", modes=(True, False)):
    """Device time per decode round by kernel, the device's idle share
    inside a traced decode block (``decode_block_profile``) of ``arch``,
    eager and captured (``modes``: eager or not), and the block's launch
    counts against the profiler's."""
    n_layers = model_cfg(arch).n_layers
    pre = "" if arch == "olmo-1b" else f"{arch} "
    out = {}
    for eager in modes:
        label = pre + ("eager" if eager else "captured")
        round_s = runs["kernels_eager" if eager else "kernels"]["round_s"]
        rounds, window, busy, by_name, calls, inside, launches = decode_block_profile(
            torch, eager, arch)
        window_ms, busy_ms = window / 1e3 / rounds, busy / 1e3 / rounds
        tag = "[profile]" if eager else "[graph] profile"
        print(f"{tag} {label}: {rounds} rounds traced: block {window_ms} ms a round, device "
              f"busy {busy_ms} ms a round, idle share {1 - busy_ms / window_ms} under the "
              f"profiler; busy / unprofiled round ({round_s * 1e3} ms) = "
              f"{busy_ms / (round_s * 1e3)}", flush=True)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"{tag}   {us / 1e3 / rounds} ms a round  {name[:110]}", flush=True)

        def seen(kernel, counts):
            return sum(n for name, n in counts.items() if kernel_name(name) == kernel)

        want = dict(qkv_gemv_kernel=launches["fused_qkv"],
                    attn_kernel=launches["fused_decode_attention"],
                    gemv_kernel=launches["fused_decode_attention"] + 2 * launches["fused_mlp"])
        got = {k: seen(k, calls) for k in want}
        print(f"{tag} {label}: launches counted by the wrappers {launches} -> kernels expected "
              f"{want}, seen by the profiler {got} (inside the block's host span "
              f"{ {k: seen(k, inside) for k in want} }); device ops in the block's host span "
              f"{sum(inside.values())}", flush=True)
        assert launches["fused_qkv"] == n_layers * rounds and got == want, (launches, want, got)
        kernel_ms = {}
        for name, us in by_name.items():
            kernel_ms[kernel_name(name)] = kernel_ms.get(kernel_name(name), 0.0) + us / 1e3 / rounds
        out[label] = dict(busy_ms=busy_ms, window_ms=window_ms, kernel_ms=kernel_ms)
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
    regs = attn_registers(build.ptxas_report("decode").read_text())
    for (g, hd, q8), (n, st, ld) in sorted(regs.items()):
        print(f"[build] attn_kernel<{g}, {hd}, {str(q8).lower()}>: {n} registers, {st} bytes spill "
              f"stores, {ld} bytes spill loads", flush=True)
    assert {(g, hd, q8) for g in (1, 2, 4, 6, 8, 12) for hd in (32, 64, 128, 256)
            for q8 in (False, True)} <= set(regs), regs

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
    want_streams, want_rounds = forced_phase(torch, runs)[:2]
    fault_phase(torch, want_streams, want_rounds)
    del want_rounds
    torch.cuda.empty_cache()
    profile_phase(torch, runs)
    free(torch)
    family_launches = {arch: family_phase(torch, rates, arch) for arch in FAMILY_LOGIT_ATOL}
    rows["fused_decode_attention"]["head_dim_256"]["launches"] = \
        family_launches["gemma3-12b"]["fused_decode_attention"]
    # internvl2-26b's launches: its QKV and MLP rows, and row 2a (G = 6, hd
    # 128, d 6144: its attention's shape and nemotron-4-15b's)
    for kernel in ("fused_qkv", "fused_mlp"):
        rows[kernel]["vlm"]["launches"] = family_launches[VLM][kernel]
    rows["fused_decode_attention"]["wide_groups"][6]["launches"] = {
        a: family_launches[a]["fused_decode_attention"] for a in ("nemotron-4-15b", VLM)}
    ring_launches = ring_phase(torch, rates)
    for kernel in ("fused_qkv", "fused_decode_attention", "fused_mlp"):
        rows[kernel]["ring"]["launches"] = ring_launches[kernel]
    kvq_launches = kvq_phase(torch, rates)
    # each kernel's launches on its main path: the captured serve run, the
    # captured ResNet-50 forward, the AIMC rounds, the int8 cache's captured
    # serve run
    launches = {**runs["kernels"]["launches"], "niu_refresh": aimc["launches"]["niu_refresh"],
                **{k: graph["launches"][k] for k in ("int8_gemm", "im2col")},
                "fused_decode_attention_int8": kvq_launches["fused_decode_attention"]}
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
