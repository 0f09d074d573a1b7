"""Serving launcher of the port: batched requests against olmo-1b.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        [--smoke] [--decode-kernels] [--aimc] [--stream] [--multi-pu K] \
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it fails.  Weights are made from ``--seed`` by the
port's own init.  ``--decode-kernels`` puts the hand-written CUDA decode
kernels on the per-token hot path; the default composed PyTorch path is
the A/B reference.  On the card the decode blocks replay CUDA graphs
captured at warmup.  ``--aimc`` serves through the SS VI noise-injection
unit: fresh AIMC noise in the weights every round.  ``--stream`` plans
the host->HBM weight streaming of one decode round with the paper's
two-phase scheduler under the H100 host-offload profile
(``core.pu.h100_host_offload_config``) and adds the plan's summary to the
stats (``stream_*``, and ``plan_time_s``); ``--plan-search beam|anneal``
searches the schedule instead (seeded by ``--plan-search-seed``).
Planning changes nothing that is served.  ``--multi-pu K`` splits one
decode round across K copies of the H100 host-offload profile (the
reference alternates its TPU profiles) and serves through true per-stage
decode: every round runs each stage's model-layer slice through the stage
pipeline (``runtime.stage_decode``), ``--microbatches M`` lane groups at
a time (0, the default, tunes M on the executed bubble against
``--target-bubble``; 1 is the serial reference); after the requests
drain, the partition also runs through the stage-parallel runtime with
functional tiles (``execute_partition``), and the stats gain
``partition_*`` and ``stage_decode*`` keys.  ``--no-stage-decode`` keeps
the single-PU decode loop.  Prints a JSON stats blob.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.core.aimc import AIMCNoiseModel
from repro_torch.core.pu import h100_host_offload_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import api as model_api
from repro_torch.plan import SearchConfig
from repro_torch.runtime.serving import ServeConfig, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefill-buckets", default=None, metavar="N,N,...",
                    help="comma-separated prompt-length buckets for "
                         "batched prefill (default: power-of-two ladder "
                         "16,32,... capped at max_len)")
    ap.add_argument("--decode-block", type=int, default=32, metavar="R",
                    help="max decode rounds per host sync "
                         "(power-of-two blocks up to R; default 32)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass over the prefill-bucket/"
                         "decode-block grid at startup")
    ap.add_argument("--decode-kernels", action="store_true",
                    help="hand-written CUDA decode kernels (QKV+RoPE, GQA "
                         "attention + out-projection, gated MLP) on the "
                         "per-token hot path")
    ap.add_argument("--aimc", action="store_true",
                    help="AIMC noise emulation (SS VI NIU)")
    ap.add_argument("--stream", action="store_true",
                    help="plan host->HBM weight streaming (two-phase "
                         "scheduler, H100 host-offload profile)")
    ap.add_argument("--multi-pu", type=int, default=0, metavar="K",
                    help="partition the model across K H100 host-offload "
                         "profiles and run true per-stage decode; K=1 "
                         "plans the single-PU streaming path")
    ap.add_argument("--no-stage-decode", action="store_true",
                    help="with --multi-pu, keep the single-PU decode loop "
                         "and only attach the partition analytically")
    ap.add_argument("--microbatches", type=int, default=0, metavar="M",
                    help="lane groups of the overlapped staged decode with "
                         "--multi-pu (and the depth of the executed tile "
                         "pipeline): 1 = serial reference, 0 (default) "
                         "auto-tunes M and the handoff queue depth against "
                         "--target-bubble on the executed bubble")
    ap.add_argument("--target-bubble", type=float, default=0.10,
                    help="target fill/drain bubble of the microbatch "
                         "auto-tuner (default 0.10)")
    ap.add_argument("--plan-search", default="heuristic",
                    choices=["heuristic", "beam", "anneal"],
                    help="schedule-search strategy for the streaming planner")
    ap.add_argument("--plan-search-seed", type=int, default=0,
                    help="deterministic seed for --plan-search anneal")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the plain "
                         "PyTorch versions of the kernels")
    return ap


def make_engine(args, eager: bool = False) -> ServingEngine:
    """Config, seeded weights and engine for parsed launcher arguments
    (``eager``: the engine's decode blocks run as a Python loop on the
    card, not as CUDA graphs)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    api = model_api.get_api(cfg)
    params = api.init_params(cfg, args.seed, device)
    serve_cfg = ServeConfig(
        max_batch=args.max_batch,
        max_len=args.prompt_len + args.max_new + 8,
        max_new_tokens=args.max_new,
        temperature=args.temperature,
        seed=args.seed,
        prefill_buckets=(
            tuple(int(b) for b in args.prefill_buckets.split(","))
            if args.prefill_buckets
            else None
        ),
        max_decode_block=args.decode_block,
        decode_kernels=args.decode_kernels,
        aimc=AIMCNoiseModel() if args.aimc else None,
        stream_pu=h100_host_offload_config() if args.stream else None,
        stream_pus=(
            [h100_host_offload_config() for _ in range(args.multi_pu)]
            if args.multi_pu else None
        ),
        stage_decode=not args.no_stage_decode,
        decode_microbatches=args.microbatches,
        target_bubble=args.target_bubble,
        plan_search=(
            SearchConfig(strategy=args.plan_search, seed=args.plan_search_seed)
            if args.plan_search != "heuristic"
            else None
        ),
    )
    return ServingEngine(cfg, params, serve_cfg, device, eager=eager)


def submit_requests(engine: ServingEngine, args) -> None:
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, engine.cfg.vocab, size=args.prompt_len).astype(np.int32)
        engine.submit(prompt)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    engine = make_engine(args)
    if not args.no_warmup:
        engine.warmup()
    submit_requests(engine, args)
    engine.run_until_drained()
    if engine.partitioned_plan is not None:
        # the partition through the stage-parallel runtime: every stage's
        # tiles in plan issue order, the pipeline's throughput and fill
        # bubble measured (M = 0 auto-tunes the depth)
        engine.execute_partition(n_microbatches=args.microbatches or None)
    print(json.dumps(engine.stats(), indent=1, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
