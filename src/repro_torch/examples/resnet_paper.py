"""Paper-faithful INT8 ResNet inference through the systolic-array dataflow
(counterpart of ``examples/resnet_paper.py``, steps 1-2).

    PYTHONPATH=src python -m repro_torch.examples.resnet_paper [--variant 18|50] \\
        [--image-size N] [--device cpu]

Steps, mirroring the paper's SS IV-V evaluation:
  1. Build the quantized (power-of-two scales) ResNet from a seed.
  2. Run one INT8 inference through the im2col + int8 GEMM kernels (on the
     CUDA card by default; ``--device cpu`` runs their plain versions) and
     print its time and top-5 classes; on the card, also the forward
     captured as one CUDA graph (median of 30 calls).

The JAX example's steps 3-4 -- the two-phase weight-transfer schedule
against the PU's URAM (Fig. 5(b,c)) and the simulated Table I row -- need
``core/scheduler.py`` and ``core/simulator.py``, which call into the
planner (``repro.plan``); they come with the planner's port (ROADMAP
queue 1, step 10).
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import resnet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=int, default=18, choices=(18, 50))
    ap.add_argument("--image-size", type=int, default=56,
                    help="reduced from 224 by default; the dataflow is identical")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
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
    return top5


if __name__ == "__main__":
    main()
