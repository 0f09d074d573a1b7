#!/usr/bin/env python3
"""Time one tree's int8_gemm and decode kernels on a CUDA card, so two
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
  that compute it, each timed the same way;
- ``fused_qkv_ms`` and ``qkv_library_ms``: one ``fused_qkv`` call at
  olmo-1b widths (bias, RoPE), and ``x @ cat(wq, wk, wv)`` + RoPE;
- ``attention_ms`` and ``attention_library_ms``: one
  ``fused_decode_attention`` call at olmo-1b widths (Sk 584, the valid
  lengths of ``chip_smoke.py``'s kernel phase), and SDPA + ``@ wo``;
- the same four as ``*_graph_ms``, timed with ``chip_smoke.graph_ms``
  (back-to-back calls from a CUDA graph over copies of the operands: no
  host time and a clean L2, where ``Timer`` has both);
- ``decode_busy_ms`` and ``decode_kernel_ms``: device busy time of one
  round of a profiled olmo-1b decode block (``chip_smoke.decode_block_profile``),
  and of it each kernel's time by name.

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


def qkv_and_attention(torch, timer, decode, ref, rnd, x) -> dict:
    """``fused_qkv`` and ``fused_decode_attention`` at olmo-1b widths and
    ``chip_smoke.py``'s kernel-phase shapes, each beside one PyTorch call
    computing the same function; timed with ``timer`` on the first copy
    of the operands, and with ``chip_smoke.graph_ms`` over
    ``chip_smoke.GRAPH_COPIES`` copies (``*_graph_ms``)."""
    import torch.nn.functional as F

    b, d, hq, hkv, hd, sk = (chip_smoke.B, chip_smoke.D, chip_smoke.HQ, chip_smoke.HKV,
                             chip_smoke.HD, chip_smoke.SK)
    copies = range(chip_smoke.GRAPH_COPIES)
    qkv = [[rnd(d, h * hd, scale=0.02) for h in (hq, hkv, hkv)] for _ in copies]
    bq, bk, bv = rnd(hq * hd, scale=0.02), rnd(hkv * hd, scale=0.02), rnd(hkv * hd, scale=0.02)
    pos = torch.arange(b, dtype=torch.int32, device="cuda") * 61 + 7
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, theta=1e4)
    cat, bqkv = [torch.cat(w, dim=1) for w in qkv], torch.cat([bq, bk, bv])

    def qkv_library(wqkv):
        y = (x @ wqkv + bqkv).reshape(b, hq + 2 * hkv, hd)
        ang = ref.rope_angles(pos, hd, 1e4)[:, None]
        return ref.rotate_half_split(y[:, : hq + hkv], torch.cos(ang), torch.sin(ang)), y[:, hq + hkv:]

    q = rnd(b, hq, hd)
    caches = [(rnd(b, sk, hkv, hd), rnd(b, sk, hkv, hd)) for _ in copies]
    wo = [rnd(hq * hd, d, scale=0.02) for _ in copies]
    bo = rnd(d, scale=0.02)
    vlen = torch.tensor([520 + 8 * i for i in range(b)], dtype=torch.int32, device="cuda")
    akw = dict(q_positions=vlen - 1, kv_valid_len=vlen)
    mask = ref.decode_mask(b, sk, q.device, **akw)[:, None, None, :]

    def attn_library(k, v, wo):
        ctx = F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                             attn_mask=mask)
        return ctx.reshape(b, hq * hd) @ wo + bo

    out = {}
    for name, calls in (
        ("fused_qkv", [lambda w=w: decode.fused_qkv(x, *w, bq, bk, bv, pos, **kw) for w in qkv]),
        ("qkv_library", [lambda c=c: qkv_library(c) for c in cat]),
        ("attention", [lambda c=c, w=w: decode.fused_decode_attention(q, *c, w, bo, **akw)
                       for c, w in zip(caches, wo)]),
        ("attention_library", [lambda c=c, w=w: attn_library(*c, w) for c, w in zip(caches, wo)]),
    ):
        out[f"{name}_ms"] = timer(calls[0])
        out[f"{name}_graph_ms"] = chip_smoke.graph_ms(torch, calls * chip_smoke.GRAPH_PASSES)
    return out


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
    from repro_torch.kernels import build, decode, ref
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
    del wu, wg, wd
    out.update(qkv_and_attention(torch, timer, decode, ref, rnd, x))

    # --- the decode round, in situ -------------------------------------------------
    rounds, _, busy, by_name = chip_smoke.decode_block_profile(torch)
    out["decode_busy_ms"] = busy / 1e3 / rounds
    out["decode_kernel_ms"] = {n[:80]: us / 1e3 / rounds for n, us in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
