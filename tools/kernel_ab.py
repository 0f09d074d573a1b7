#!/usr/bin/env python3
"""Time one tree's PU, NIU and decode kernels on a CUDA card, so two
trees can be compared in one run on one card.

    python3 tools/kernel_ab.py --src path/to/checkout/src

Imports ``repro_torch`` from ``--src``, builds its kernels, and prints one
JSON line:

- for the convolutions of one seeded full-width ResNet-50 forward
  (224x224x3), each re-issued through ``ops.conv2d_int8`` with the
  arguments the forward gave it, in two groups, ``conv3x3`` (its 16 3x3
  convolutions) and ``conv_other`` (the other 37): ``*_ms``, each call
  timed alone with ``chip_smoke.Timer`` and summed; ``*_graph_ms``, the
  group's calls back to back from a CUDA graph (``chip_smoke.graph_ms``,
  over ``chip_smoke.GRAPH_COPIES`` copies of the maps and weights), summed
  over the group; ``*_busy_ms`` and ``*_kernel_ms``, device busy time of
  the group's calls run eagerly back to back under the profiler, and of it
  each kernel's time by name (in situ);
- ``forward_busy_ms``, ``forward_gemm_ms``, ``forward_copy_ms``,
  ``forward_im2col_ms`` and their launches: device busy time of one
  profiled forward, and of it the GEMM kernel, the copy kernels and the
  im2col kernels;
- for one NIU round over the forward's 54 weight matrices (one
  ``niu_plan(...).refresh`` where the tree has it, else one
  ``niu_refresh`` per matrix): ``niu_round_ms`` (``Timer``),
  ``niu_round_graph_ms``, ``niu_round_host_ms`` (host clock to
  ``synchronize``, median of 10), ``niu_round_busy_ms`` and
  ``niu_kernel_ms`` (device busy and the NIU kernel's time in one profiled
  round) and ``niu_round_launches`` (device kernels in that round);
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
  round of a profiled olmo-1b decode block, replayed from its CUDA graph
  (``chip_smoke.decode_block_profile``; a tree from before the graphs has
  no such block), and of it each kernel's time by name.

The timer, the model and the trace reader are ``chip_smoke.py``'s, so the
numbers are comparable with its own.  Run it on a tree and its parent in
turns (parent, change, change, parent) in one call on the card; compare
times only within one run.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def resnet50_conv_calls(torch, ops, resnet):
    """Weights, image and the keyword arguments of each ``ops.conv2d_int8``
    call of one forward of ``chip_smoke.py``'s ResNet-50."""
    params, img = chip_smoke.resnet_setup(torch)
    calls, inner = [], ops.conv2d_int8

    def record(x, w4d, bias=None, **kw):
        calls.append(dict(img=x, w4d=w4d, bias=bias, **kw))
        return inner(x, w4d, bias, **kw)

    ops.conv2d_int8 = record
    try:
        resnet.forward_int8(chip_smoke.RESNET, params, img)
    finally:
        ops.conv2d_int8 = inner
    torch.cuda.synchronize()
    assert len(calls) == chip_smoke.N_GEMM, len(calls)
    return params, img, calls


def profiled(torch, fn, name: str):
    """(device busy ms, {device op: ms}, device launches) of ``fn()`` run once
    under the profiler, after one run outside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            fn()
            torch.cuda.synchronize()
    _, busy, by_name = chip_smoke.device_busy(torch, prof, name)
    cuda = torch.autograd.DeviceType.CUDA
    launches = sum(e.device_type == cuda and e.name != name for e in prof.events())
    return busy / 1e3, {n: us / 1e3 for n, us in by_name.items()}, launches


def short(by_name: dict) -> dict:
    """``{device op: ms}`` with the names cut short for the JSON line; the
    names that then coincide are summed."""
    out = {}
    for n, ms in by_name.items():
        out[n[:100]] = out.get(n[:100], 0.0) + ms
    return out


def conv_groups(torch, timer, ops, calls) -> dict:
    """The forward's 3x3 convolutions and the others, each group timed
    three ways (see the module docstring)."""
    out = {}
    for group, members in (("conv3x3", [c for c in calls if c["k"] == 3]),
                           ("conv_other", [c for c in calls if c["k"] != 3])):
        def run(c):
            c = dict(c)
            return ops.conv2d_int8(c.pop("img"), c.pop("w4d"), c.pop("bias"), **c)

        out[f"{group}_calls"] = len(members)
        out[f"{group}_ms"] = sum(timer(lambda c=c: run(c)) for c in members)
        copies = [dict(c, img=c["img"].clone(), w4d=c["w4d"].clone())
                  for _ in range(chip_smoke.GRAPH_COPIES) for c in members]
        out[f"{group}_graph_ms"] = chip_smoke.graph_ms(
            torch, [lambda c=c: run(c) for c in copies] * chip_smoke.GRAPH_PASSES) * len(members)
        del copies
        busy, by_name, launches = profiled(torch, lambda: [run(c) for c in members], group)
        out[f"{group}_busy_ms"], out[f"{group}_kernel_ms"] = busy, short(by_name)
        out[f"{group}_launches"] = launches
    return out


def forward_profile(torch, resnet, params, img) -> dict:
    """Device time of one ResNet-50 forward (after a warm-up one): busy,
    and of it the GEMM kernel, the copy kernels and im2col."""
    busy, by_name, launches = profiled(
        torch, lambda: resnet.forward_int8(chip_smoke.RESNET, params, img), "resnet_forward")
    out = dict(forward_busy_ms=busy, forward_launches=launches)
    for key, part in (("gemm", "int8_gemm"), ("copy", "copy"), ("im2col", "im2col")):
        out[f"forward_{key}_ms"] = sum(ms for n, ms in by_name.items() if part in n.lower())
    return out


def niu_round(torch, timer, kniu, params) -> dict:
    """One NIU round over every weight matrix, as the tree draws one."""
    mats = chip_smoke.niu_matrices(params)
    if hasattr(kniu, "niu_plan"):
        def rounds(ms):
            plan = kniu.niu_plan(ms)
            return lambda seed: plan.refresh(seed)
    else:
        def rounds(ms):
            return lambda seed: [kniu.niu_refresh(q, e, seed) for q, e in ms]
    draw = rounds(mats)
    out = dict(niu_round_ms=timer(lambda: draw(1)))
    copies = [rounds([(q.clone(), e) for q, e in mats]) for _ in range(chip_smoke.GRAPH_COPIES)]
    out["niu_round_graph_ms"] = chip_smoke.graph_ms(
        torch, [lambda d=d: d(1) for d in copies] * chip_smoke.GRAPH_PASSES)
    del copies
    host = []
    for seed in range(10):
        t0 = time.perf_counter()
        draw(seed)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    out["niu_round_host_ms"] = statistics.median(host)
    busy, by_name, launches = profiled(torch, lambda: draw(8), "niu_round")
    out.update(niu_round_busy_ms=busy, niu_round_launches=launches,
               niu_kernel_ms=sum(ms for n, ms in by_name.items() if "niu" in n))
    return out


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
    from repro_torch.kernels import build, decode, ops, ref
    from repro_torch.models import resnet

    build.build_all()
    kniu = importlib.import_module("repro_torch.kernels.niu")
    timer = chip_smoke.Timer(torch, chip_smoke.TIMED_CALLS)
    out = {"label": args.label, "src": args.src, "card": torch.cuda.get_device_name(0)}

    # --- the convolutions of one ResNet-50 forward, and one NIU round ----------
    params, img, calls = resnet50_conv_calls(torch, ops, resnet)
    out.update(conv_groups(torch, timer, ops, calls))
    out.update(forward_profile(torch, resnet, params, img))
    out.update(niu_round(torch, timer, kniu, params))
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
    rounds, _, busy, by_name, _, _ = chip_smoke.decode_block_profile(torch, eager=False)
    out["decode_busy_ms"] = busy / 1e3 / rounds
    out["decode_kernel_ms"] = {n[:80]: us / 1e3 / rounds for n, us in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
