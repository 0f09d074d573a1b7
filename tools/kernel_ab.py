#!/usr/bin/env python3
"""Time one tree's int8_gemm and fused_mlp kernels on a CUDA card, so two
trees can be compared in one run on one card.

    python3 tools/kernel_ab.py --src path/to/checkout/src

Imports ``repro_torch`` from ``--src``, builds its kernels, and prints one
JSON line:

- ``int8_gemm_ms``: the GEMM kernel's time summed over the 53 calls of one
  seeded full-width ResNet-50 forward (224x224x3), each call re-issued
  with the arguments the forward gave ``int8_gemm_pn`` and timed alone
  with ``chip_smoke.Timer``;
- ``forward_busy_ms``, ``forward_gemm_ms``, ``forward_copy_ms``: device
  busy time of one profiled forward, and of it the GEMM kernel and the
  copy kernels;
- ``fused_mlp_ms`` and ``matmuls_ms``: one ``fused_mlp`` call at olmo-1b
  widths (B=8, d 2048, d_ff 8192, swiglu), and the three plain matmuls
  that compute it, each timed the same way.

The timer, the model and the trace reader are ``chip_smoke.py``'s, so the
numbers are comparable with its own.  Run it on a tree and its parent in
turns (parent, change, change, parent) in one call on the card; compare
times only within one run.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def resnet50_gemm_calls(torch, kgemm, resnet):
    """Weights, image and the (args, kwargs) of each ``int8_gemm_pn`` call
    of one forward of ``chip_smoke.py``'s ResNet-50."""
    params, img = chip_smoke.resnet_setup(torch)
    calls, inner = [], kgemm.int8_gemm_pn

    def record(*a, **kw):
        calls.append((a, kw))
        return inner(*a, **kw)

    kgemm.int8_gemm_pn = record
    try:
        resnet.forward_int8(chip_smoke.RESNET, params, img)
    finally:
        kgemm.int8_gemm_pn = inner
    torch.cuda.synchronize()
    assert len(calls) == chip_smoke.N_GEMM, len(calls)
    return params, img, calls


def forward_profile(torch, resnet, params, img) -> dict:
    """Device time of one ResNet-50 forward (after a warm-up one): busy,
    and of it the GEMM kernel and the copy kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    resnet.forward_int8(chip_smoke.RESNET, params, img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("resnet_forward"):
            resnet.forward_int8(chip_smoke.RESNET, params, img)
            torch.cuda.synchronize()
    _, busy, by_name = chip_smoke.device_busy(torch, prof, "resnet_forward")
    cuda = torch.autograd.DeviceType.CUDA
    return dict(forward_busy_ms=busy / 1e3,
                forward_gemm_ms=sum(us for n, us in by_name.items() if "int8_gemm" in n) / 1e3,
                forward_copy_ms=sum(us for n, us in by_name.items() if "copy" in n.lower()) / 1e3,
                forward_copy_launches=sum(e.device_type == cuda and "copy" in e.name.lower()
                                          for e in prof.events()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src directory of the tree to time")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, decode
    from repro_torch.models import resnet

    build.build_all()
    kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")
    timer = chip_smoke.Timer(torch, chip_smoke.TIMED_CALLS)
    out = {"label": args.label, "src": args.src, "card": torch.cuda.get_device_name(0)}

    # --- int8_gemm over one ResNet-50 forward ---------------------------------
    params, img, calls = resnet50_gemm_calls(torch, kgemm, resnet)
    gemm = kgemm.int8_gemm_pn
    out["int8_gemm_ms"] = sum(timer(lambda a=a, kw=kw: gemm(*a, **kw)) for a, kw in calls)
    out.update(forward_profile(torch, resnet, params, img))
    del params, calls

    # --- fused_mlp at olmo-1b widths --------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    b, d, ff = chip_smoke.B, chip_smoke.D, chip_smoke.FF
    x = rnd(b, d)
    wu, wg, wd = rnd(d, ff, scale=0.02), rnd(d, ff, scale=0.02), rnd(ff, d, scale=0.02)
    out["fused_mlp_ms"] = timer(lambda: decode.fused_mlp(x, wu, wg, None, wd, None, act="swiglu"))
    out["matmuls_ms"] = timer(lambda: (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
