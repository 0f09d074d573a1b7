#!/usr/bin/env python3
"""Each decode kernel's share of the kernel path's teacher-forced logit
difference, on a CUDA card.

    python3 tools/forced_share.py --parent path/to/parent/checkout

Builds the parent's ``csrc/decode.cu`` into ``build/`` beside this tree's
kernels, then runs ``chip_smoke.py``'s teacher-forced check (the 16
olmo-1b requests of its serve phase; the kernel path fed the composed
path's tokens) with the kernel path made of:

- ``parent``: the parent's QKV and attention;
- ``attention``: this tree's attention, the parent's QKV;
- ``qkv``: this tree's QKV, the parent's attention;
- ``both``: this tree's kernels.

The MLP and the output projection are this tree's in every run.  One
line each: the max and median |logit difference| against the composed
path, and the count of argmax flips.  The parent's entry points are
called with the parent's C signatures (``repro_fused_qkv`` without the
split arguments, ``repro_decode_attention`` without the chunk
arguments).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def parent_library(parent: Path):
    """The parent's decode.cu, built with this tree's flags, its two
    entry points declared with the parent's signatures."""
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "libdecode_parent.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = parent / "src/repro_torch/kernels/csrc/decode.cu"
    subprocess.run([build._nvcc(), *build._flags("decode"), "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_fused_qkv.argtypes = [_P] * 11 + [_I] * 6 + [_F, _P]
    lib.repro_decode_attention.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _F, _P,
                                           _I, _I, _I, _I, _I, _P]
    for fn in (lib.repro_fused_qkv, lib.repro_decode_attention):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path, help="the parent tree's checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("forced_share: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, common, decode, ref

    build.build_all()
    old = parent_library(args.parent)
    print(f"[share] {chip_smoke.card_line()}", flush=True)
    new_qkv, new_ctx = decode.fused_qkv, decode._attention_ctx

    def parent_qkv(x, wq, wk, wv, bq=None, bk=None, bv=None, positions=None, *, n_heads,
                   n_kv_heads, head_dim, rope=True, theta=1e4):
        b, d = x.shape
        out = [torch.empty((b, h, head_dim), dtype=x.dtype, device=x.device)
               for h in (n_heads, n_kv_heads, n_kv_heads)]
        ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
        err = old.repro_fused_qkv(x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                                  ptr(bq), ptr(bk), ptr(bv), ptr(positions),
                                  *(t.data_ptr() for t in out), b, d, n_heads, n_kv_heads,
                                  head_dim, int(rope), float(theta), common.cuda_stream())
        common.raise_on(err, "parent fused_qkv")
        return tuple(out)

    def parent_ctx(q, k, v, *, q_positions, kv_valid_len=None, window=None, window_arr=None,
                   kv_positions=None, causal=True):
        assert kv_positions is None and window is None     # olmo-1b's decode path
        b, hq, hd = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        ctx = torch.empty((b, hq * hd), dtype=q.dtype, device=q.device)
        lim, stride = (None, 0) if kv_valid_len is None else \
            (kv_valid_len.data_ptr(), int(kv_valid_len.dim() == 1))
        err = old.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0, lim, stride,
            q_positions.data_ptr(), None if window_arr is None else window_arr.data_ptr(),
            ref.BIG_WINDOW, int(causal),
            ref.dtype_scalar(1.0 / hd ** 0.5, q.dtype), ctx.data_ptr(), b, sk, hq, hkv, hd,
            common.cuda_stream())
        common.raise_on(err, "parent attention")
        return ctx

    want_streams, want_rounds = chip_smoke.logged_run(torch, kernels=False)
    for label, qkv, ctx in (("parent", parent_qkv, parent_ctx), ("attention", parent_qkv, new_ctx),
                            ("qkv", new_qkv, parent_ctx), ("both", new_qkv, new_ctx)):
        decode.fused_qkv, decode._attention_ctx = qkv, ctx
        try:
            _, rounds = chip_smoke.logged_run(torch, kernels=True, feed=want_streams)
        finally:
            decode.fused_qkv, decode._attention_ctx = new_qkv, new_ctx
        diffs, flips = chip_smoke.compare_rounds(torch, want_rounds, rounds)
        d = sorted(diffs.values())
        print(f"[share] {label}: max |diff| {d[-1]}, median {statistics.median(d)}, argmax "
              f"differs at {len(flips)} of {len(d)} steps (limit {chip_smoke.LOGIT_ATOL})",
              flush=True)
        del rounds
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
