"""Paper-faithful reproduction driver: INT8 ResNet inference through the
systolic-array dataflow + the two-phase weight-transfer schedule
(counterpart of ``examples/resnet_paper.py``).

    PYTHONPATH=src python -m repro_torch.examples.resnet_paper [--variant 18|50] \\
        [--image-size N] [--device cpu] [--plan-only]

Steps, mirroring the paper's SS IV-V evaluation:
  1. Build the quantized (power-of-two scales) ResNet from a seed.
  2. Run one INT8 inference through the im2col + int8 GEMM kernels (on the
     CUDA card by default; ``--device cpu`` runs their plain versions) and
     print its time and top-5 classes; on the card, also the forward
     captured as one CUDA graph (median of 30 calls).
  3. Tile all conv/FC weights into R_SA x M_v tiles and run the two-phase
     scheduler against the PU's URAM capacity -- Fig. 5(b,c).
  4. Report the simulated Table I row (FPS / FPS-per-TOPS for 5x PU_1x +
     5x PU_2x on the Alveo U50) next to the paper's measured values.

Steps 3-4 are host-side numpy (the port's scheduler and simulator, which
give the JAX package's numbers bit for bit); they simulate the paper's
FPGA, they do not measure the card.  ``--plan-only`` runs just them.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.core import scheduler as sched
from repro_torch.core import simulator as sim
from repro_torch.core.pu import PU_1X, PU_2X
from repro_torch.kernels.common import resolve_device
from repro_torch.models import resnet

# The paper's Table I: (FPS, FPS per TOPS) of 5x PU_1x + 5x PU_2x
PAPER_TABLE_I = {18: (1237.7, 268.6), 50: (584.9, 126.9)}


def schedule_rows(variant: int) -> list:
    """Step 3: the two-phase schedule of the ResNet's tiles against each
    PU's URAM (PU_2x, then PU_1x)."""
    layers = sim.resnet_gemm_layers(variant)
    rows = []
    for pu in (PU_2X, PU_1X):
        tiles = sim.model_tiles(pu, layers)
        res = sched.two_phase(tiles, capacity=pu.fast_mem_bytes)
        rows.append(dict(
            pu=pu.name, tiles=len(tiles), weight_bytes=sum(t.mem_bytes for t in tiles),
            capacity_bytes=pu.fast_mem_bytes, baseline_stall_s=res.baseline.total_stall,
            adaptive_stall_s=res.adaptive.total_stall, stall_reduction=res.stall_reduction,
            utilization=res.adaptive.utilization,
        ))
    return rows


def table_row(variant: int) -> dict:
    """Step 4: the simulated Table I row (5x PU_1x + 5x PU_2x)."""
    layers = sim.resnet_gemm_layers(variant)
    fleet = sim.FleetSim(sims=[
        ("pu1x", sim.simulate_model(PU_1X, layers), 5),
        ("pu2x", sim.simulate_model(PU_2X, layers), 5),
    ])
    return dict(fps=fleet.fps, fps_per_tops=fleet.fps_per_tops, tops=fleet.tops)


def print_plan(variant: int) -> None:
    """Print steps 3 and 4."""
    for r in schedule_rows(variant):
        print(
            f"{r['pu']}: {r['tiles']} tiles, weights {r['weight_bytes'] / 2**20:.1f} MiB vs "
            f"URAM {r['capacity_bytes'] / 2**20:.1f} MiB -> baseline stall "
            f"{r['baseline_stall_s'] * 1e3:.3f} ms, adaptive "
            f"{r['adaptive_stall_s'] * 1e3:.3f} ms "
            f"(hidden {r['stall_reduction']:.0%}); "
            f"utilization {r['utilization']:.1%}"
        )
    row = table_row(variant)
    paper = PAPER_TABLE_I[variant]
    print(
        f"\nTable I (5x PU_1x + 5x PU_2x, {row['tops']:.3f} TOPS), simulated FPGA:\n"
        f"  simulated  {row['fps']:8.2f} FPS   {row['fps_per_tops']:6.2f} FPS/TOPS\n"
        f"  paper      {paper[0]:8.2f} FPS   {paper[1]:6.2f} FPS/TOPS\n"
        f"  deviation  {abs(row['fps'] - paper[0]) / paper[0]:8.1%}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=int, default=18, choices=(18, 50))
    ap.add_argument("--image-size", type=int, default=56,
                    help="reduced from 224 by default; the dataflow is identical")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--plan-only", action="store_true",
                    help="only steps 3-4 (host-side schedule and Table I simulation)")
    args = ap.parse_args(argv)
    if args.plan_only:
        print_plan(args.variant)
        return None
    dev = resolve_device(args.device)

    # 1. quantized model ---------------------------------------------------
    params = resnet.init_params(args.variant, 0, dev)
    n_params = sum(p["w"].q.numel() for p in params.values())
    print(f"ResNet-{args.variant}: {n_params / 1e6:.1f}M int8 weights "
          f"(power-of-two scales)")

    # 2. one INT8 inference through the kernels -----------------------------
    rng = np.random.default_rng(0)
    img = torch.from_numpy(
        rng.integers(-100, 100, (args.image_size, args.image_size, 3), dtype=np.int8)
    ).to(dev)
    resnet.forward_int8(args.variant, params, img)          # builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits = resnet.forward_int8(args.variant, params, img)
    top5 = torch.argsort(logits, descending=True)[:5].tolist()   # waits for the device
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU (plain versions)"
    print(f"int8 forward ({args.image_size}x{args.image_size}): "
          f"{dt * 1e3:.1f} ms on {where}, top-5 classes {top5}")
    if dev.type == "cuda":
        fwd = resnet.capture_forward_int8(args.variant, params, img.shape)
        times = []
        for _ in range(30):
            t0 = time.perf_counter()
            graph_logits = fwd(img)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        same = torch.equal(graph_logits, logits)
        print(f"captured int8 forward (one CUDA graph): {statistics.median(times) * 1e3:.3f} ms "
              f"(median of 30), logits {'equal to' if same else 'DIFFERENT from'} the eager "
              f"forward's")
        if not same:
            raise RuntimeError("the captured forward differs from the eager one")

    # 3-4. weight-transfer schedule (Fig. 5b,c) and the Table I row --------
    print_plan(args.variant)
    return top5


if __name__ == "__main__":
    main()
