#!/usr/bin/env python3
"""Time the splits the two split decode kernels could take, at olmo-1b
shapes on a CUDA card.

    python3 tools/decode_sweep.py

- ``fused_qkv``'s GEMV (48 column tiles over wq, wk and wv; bias and
  RoPE) at every split of d_model's 32 k-tiles into 1 to 8 pieces;
- the attention's launch 1 (``valid_len`` mask of ``chip_smoke.py``'s
  kernel phase) at chunks of 16 to 64 slots;
- the whole ``fused_qkv`` and ``fused_decode_attention`` calls, each
  beside one PyTorch call computing the same function
  (``x @ cat(wq, wk, wv)`` + RoPE; SDPA + ``@ wo``);
- for reference, the MLP's two GEMV launches and the attention's
  ``@ wo`` at their planned splits.

Each choice is checked against the plain version first, then timed two
ways: ``timer_ms``, ``chip_smoke.Timer`` (a 256 MiB buffer zeroed before
each call, so the call also writes the dirty L2 lines back); and
``graph_ms`` (``chip_smoke.graph_ms``: back-to-back calls replayed from a
CUDA graph, each on its own copy of the operands, together larger than
the L2, so every call reads its weights or cache from HBM, finds the L2
clean, and no host time enters: the conditions of a decode round).  One
line each, with grid, both times and the TB/s of ``graph_ms``; the
planner's own choice is marked.  Compare choices only within one run.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common, decode, ref

    timer = chip_smoke.Timer(torch, chip_smoke.TIMED_CALLS)
    print(f"[sweep] {chip_smoke.card_line()}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    def report(what, calls, nb, mark):
        t_timer, t_graph = timer(calls[0]), chip_smoke.graph_ms(torch, calls * chip_smoke.GRAPH_PASSES)
        print(f"[sweep] {what}: timer_ms={t_timer} graph_ms={t_graph} "
              f"({nb / t_graph / 1e9} TB/s){' (planned)' if mark else ''}", flush=True)

    b, d, hq, hkv, hd, sk, ff = (chip_smoke.B, chip_smoke.D, chip_smoke.HQ, chip_smoke.HKV,
                                 chip_smoke.HD, chip_smoke.SK, chip_smoke.FF)
    lib = decode._lib()

    # --- fused_qkv: the split of k -------------------------------------------
    x = rnd(b, d)
    sets = [([rnd(d, h * hd, scale=0.02) for h in (hq, hkv, hkv)],
             [rnd(h * hd, scale=0.02) for h in (hq, hkv, hkv)]) for _ in range(chip_smoke.GRAPH_COPIES)]
    pos = torch.arange(b, dtype=torch.int32, device="cuda") * 61 + 7
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, theta=1e4)
    want = ref.fused_qkv_ref(x, *sets[0][0], *sets[0][1], pos, **kw)
    tiles = sum(decode.qkv_tiles(hq, hkv, hd))
    kt = -(-d // decode.GEMV_K)
    planned = decode.qkv_plan(hq, hkv, hd, d, sms)
    nb = chip_smoke.nbytes(x, *sets[0][0], *sets[0][1], pos) + 2 * b * (hq + 2 * hkv) * hd
    out = [torch.empty_like(t) for t in want]
    for per in sorted({-(-kt // pieces) for pieces in range(1, 9)}, reverse=True):
        split = -(-kt // per)
        ws = torch.zeros(tiles * split * decode.GEMV_N * 8, device="cuda")
        cnt = torch.zeros(tiles, dtype=torch.int32, device="cuda")

        def call(w, bias, per=per, split=split, ws=ws, cnt=cnt):
            err = lib.repro_fused_qkv(
                x.data_ptr(), *(t.data_ptr() for t in w), *(t.data_ptr() for t in bias),
                pos.data_ptr(), *(t.data_ptr() for t in out), b, d, hq, hkv, hd, 1, 1e4,
                per, split, ws.data_ptr(), cnt.data_ptr(), common.cuda_stream())
            common.raise_on(err, "fused_qkv")

        call(*sets[0])
        for o, t in zip(out, want):
            torch.testing.assert_close(o, t, atol=chip_smoke.ATOL, rtol=chip_smoke.RTOL)
        report(f"fused_qkv {tiles} tiles x {split} splits of {per} k-tiles ({tiles * split} blocks)",
               [lambda s=s, c=call: c(*s) for s in sets], nb, split == planned.split)

    # --- attention launch 1: the chunk ---------------------------------------
    q = rnd(b, hq, hd)
    caches = [(rnd(b, sk, hkv, hd), rnd(b, sk, hkv, hd)) for _ in range(chip_smoke.GRAPH_COPIES)]
    vlen = torch.tensor([520 + 8 * i for i in range(b)], dtype=torch.int32, device="cuda")
    qpos = vlen - 1
    used = int(ref.decode_mask(b, sk, q.device, q_positions=qpos, kv_valid_len=vlen).sum().item())
    nb = chip_smoke.nbytes(q, vlen, qpos) + 2 * used * hkv * hd * 2 + 2 * b * hq * hd
    k, v = caches[0]
    eye = torch.eye(hq * hd, dtype=torch.bfloat16, device="cuda")
    want = ref.decode_attention_ref(q, k, v, eye, q_positions=qpos, kv_valid_len=vlen)
    planned = decode.attn_plan(b, hkv, sk, hd, sms)
    scale = ref.dtype_scalar(1.0 / hd ** 0.5, q.dtype)
    ctx = torch.empty((b, hq * hd), dtype=torch.bfloat16, device="cuda")
    for chunk in (16, 32, 48, 64):
        splits = -(-sk // chunk)
        ws = torch.zeros(b * hkv * splits * (hd + 2), device="cuda")
        cnt = torch.zeros(b * hkv, dtype=torch.int32, device="cuda")

        def call(k, v, chunk=chunk, splits=splits, ws=ws, cnt=cnt):
            err = lib.repro_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0, vlen.data_ptr(), 1,
                qpos.data_ptr(), None, ref.BIG_WINDOW, 1, scale, ctx.data_ptr(), b, sk, hq, hkv,
                hd, chunk, splits, ws.data_ptr(), cnt.data_ptr(), common.cuda_stream())
            common.raise_on(err, "attention")

        call(k, v)
        torch.testing.assert_close(ctx, want, atol=chip_smoke.ATOL, rtol=chip_smoke.RTOL)
        report(f"attention launch 1: {b * hkv} x {splits} chunks of {chunk} slots "
               f"({b * hkv * splits} blocks)", [lambda c=c, f=call: f(*c) for c in caches], nb,
               chunk == planned.chunk)

    # --- whole calls, each beside one PyTorch call computing the same function ---
    import torch.nn.functional as F

    wo = [rnd(hq * hd, d, scale=0.02) for _ in range(chip_smoke.GRAPH_COPIES)]
    bo = rnd(d, scale=0.02)
    akw = dict(q_positions=qpos, kv_valid_len=vlen)
    mask = ref.decode_mask(b, sk, q.device, **akw)[:, None, None, :]
    cat = [torch.cat(w, dim=1) for w, _ in sets]

    def qkv_library(wqkv):
        y = (x @ wqkv).reshape(b, hq + 2 * hkv, hd)
        ang = ref.rope_angles(pos, hd, 1e4)[:, None]
        return ref.rotate_half_split(y[:, : hq + hkv], torch.cos(ang), torch.sin(ang)), y[:, hq + hkv:]

    def attn_library(k, v, wo):
        ctx = F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                             attn_mask=mask)
        return ctx.reshape(b, hq * hd) @ wo + bo

    for what, calls in (
        ("fused_qkv (rope, no bias)",
         [lambda w=w: decode.fused_qkv(x, *w, None, None, None, pos, **kw) for w, _ in sets]),
        ("x @ cat(wq, wk, wv) + rope", [lambda c=c: qkv_library(c) for c in cat]),
        ("fused_decode_attention (valid_len, bo)",
         [lambda c=c, w=w: decode.fused_decode_attention(q, *c, w, bo, **akw)
          for c, w in zip(caches, wo)]),
        ("SDPA + @ wo + bo", [lambda c=c, w=w: attn_library(*c, w) for c, w in zip(caches, wo)]),
    ):
        print(f"[sweep] whole call {what}: timer_ms={timer(calls[0])} "
              f"graph_ms={chip_smoke.graph_ms(torch, calls * chip_smoke.GRAPH_PASSES)}", flush=True)

    # --- the GEMV launches of fused_mlp and the attention's @ wo ---------------
    del sets, caches, cat
    xs = {d: x, ff: rnd(b, ff), hq * hd: rnd(b, hq * hd)}
    for what, k_, n, nmat, act in (("fused_mlp launch 1 (gate/up + swiglu)", d, ff, 2, 0),
                                   ("fused_mlp launch 2 (down + bias)", ff, d, 1, -1),
                                   ("fused_decode_attention launch 2 (@ wo + bo)", hq * hd, d, 1, -1)):
        plan = decode.gemv_plan(n, k_, sms)
        ws = torch.zeros(max(1, plan.ws_floats(nmat)), device="cuda")
        cnt = torch.zeros(max(1, plan.counters), dtype=torch.int32, device="cuda")
        y = torch.empty((b, n), dtype=torch.bfloat16, device="cuda")
        mats = [([rnd(k_, n, scale=0.02) for _ in range(nmat)], rnd(n, scale=0.02))
                for _ in range(chip_smoke.GRAPH_COPIES)]

        def call(ws_, bias, k_=k_, n=n, plan=plan, ws=ws, cnt=cnt, y=y, act=act):
            err = lib.repro_gemv(xs[k_].data_ptr(), ws_[0].data_ptr(),
                                 ws_[1].data_ptr() if len(ws_) > 1 else None, bias.data_ptr(),
                                 y.data_ptr(), b, k_, n, plan.kt_per, plan.split, ws.data_ptr(),
                                 cnt.data_ptr(), act, common.cuda_stream())
            common.raise_on(err, "gemv")

        nb = chip_smoke.nbytes(xs[k_], *mats[0][0], mats[0][1], y)
        report(f"{what}: {plan.tiles} column tiles x {plan.split} splits",
               [lambda m=m, c=call: c(*m) for m in mats], nb, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
