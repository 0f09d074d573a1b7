"""Quickstart: the paper's machinery in five minutes (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. INT8 GEMM through the systolic-array kernel (the PU datapath).
2. A conv layer executed as im2col + GEMM (the paper's unified dataflow).
3. The two-phase weight-transfer scheduler hiding load stalls.
4. olmo-1b (smoke size) doing a prefill + decode step.

Steps 1-2 and 4 run on the CUDA card (the hand-written kernels) unless
``--device cpu`` is given (their plain versions); step 3 is host-side
numpy.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import scheduler
from repro_torch.core.pu import TileCost
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.models import api as model_api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)

    # 1. INT8 GEMM with fused bias + power-of-two shift + ReLU ------------
    w = t(rng.integers(-127, 128, (64, 128), dtype=np.int8))
    x = t(rng.integers(-127, 128, (128, 32), dtype=np.int8))
    bias = t(rng.integers(-500, 500, (64,)).astype(np.int32))
    y = ops.int8_gemm(w, x, bias, shift=7, relu=True)
    lo, hi = torch.aminmax(y.to(torch.int32))
    print(f"1. int8_gemm: {tuple(w.shape)} @ {tuple(x.shape)} -> {tuple(y.shape)} {y.dtype}, "
          f"range [{int(lo)}, {int(hi)}]")

    # 2. Conv-as-GEMM (paper Fig. 3) --------------------------------------
    img = t(rng.integers(-64, 64, (16, 16, 8), dtype=np.int8))
    k = t(rng.integers(-64, 64, (3, 3, 8, 16), dtype=np.int8))
    out = ops.conv2d_int8(img, k, k=3, stride=1, pad=1, shift=8, relu=True)
    print(f"2. conv-as-GEMM: img {tuple(img.shape)} * w {tuple(k.shape)} -> {tuple(out.shape)}")

    # 3. Two-phase weight-transfer scheduling (paper SS III) --------------
    # three tiles; tile2's load is too slow for tile1's short window but
    # fits tile0's long one -> the adaptive phase relocates it.
    tiles = [
        TileCost(load_s=1.0, exec_s=6.0, mem_bytes=10),
        TileCost(load_s=1.0, exec_s=1.0, mem_bytes=10),
        TileCost(load_s=4.0, exec_s=1.0, mem_bytes=10),
    ]
    res = scheduler.two_phase(tiles, capacity=100)
    print(f"3. scheduler: baseline stall {res.baseline.total_stall:.1f}s -> "
          f"adaptive {res.adaptive.total_stall:.1f}s "
          f"(reduction {res.stall_reduction:.0%}, "
          f"utilization {res.adaptive.utilization:.0%})")

    # 4. olmo-1b (smoke size): prefill + one decode step -------------------
    cfg = smoke_variant(get_config("olmo-1b"))
    api = model_api.get_api(cfg)
    params = api.init_params(cfg, 0, dev)
    # a 16-token prompt right-padded to a 32-slot bucket: the cache keeps
    # room for the decode step's key and value
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :16] = rng.integers(0, cfg.vocab, 16)
    lengths = torch.full((1,), 16, dtype=torch.int32, device=dev)
    logits, cache = api.prefill(cfg, params, {"tokens": t(prompt), "lengths": lengths})
    next_tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    pos = torch.full((1,), 16, dtype=torch.int32, device=dev)
    logits2, cache = api.decode_step(cfg, params, cache, next_tok, pos)
    print(f"4. olmo-1b (smoke): prefill logits {tuple(logits.shape)}, "
          f"greedy next token {int(next_tok[0, 0])}, decode logits {tuple(logits2.shape)}")

    print("\nquickstart OK")
    return res


if __name__ == "__main__":
    main()
