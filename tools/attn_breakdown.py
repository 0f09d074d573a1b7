#!/usr/bin/env python3
"""Where the split attention's time goes, at olmo-1b shapes on a CUDA card.

    python3 tools/attn_breakdown.py

Builds three variants of ``csrc/decode.cu::attn_kernel`` beside the
kernel itself, each with one part cut out, and times all four the same
way (``chip_smoke.graph_ms``: back-to-back calls replayed from a CUDA
graph over four copies of the cache, ``valid_len`` mask of
``chip_smoke.py``'s kernel phase), at the planned chunk and at 32 and 64
slots:

- ``kernel``: as built;
- ``loads_only``: each block copies its chunk's K and V rows into shared
  memory and writes a constant partial; no score, softmax or PV;
- ``no_merge``: every block writes its partial and exits, with no fence,
  no counter and no merge;
- ``loads_only_no_merge``: both cuts, so what is left is the grid, the
  mask check and the copies.

The variants compute nothing meaningful; only their times are printed.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402

# the merge: fence, counter and the last block's combination of the partials
_MERGE = "  __threadfence();\n  __syncthreads();\n  if (S > 1) {"
_COMPUTE_FROM = "    // (q * scale) rounded to bf16 before the score product"
_COMPUTE_TO = "  } else if (tid < G) {   // no slot to attend: an empty partial"
_CONSTANT_PARTIAL = """    cp_async_wait<0>();
    __syncthreads();
    if (tid < G) {
      __stcg(part + tid, 0.f);
      __stcg(part + G + tid, 1.f);
    }
    for (int i = tid; i < G * HD; i += kAtThreads) __stcg(part + 2 * G + i, 0.f);
"""


def variants(src: str) -> dict:
    """The kernel's source and the three cut-down sources."""
    for anchor in (_MERGE, _COMPUTE_FROM, _COMPUTE_TO):
        if src.count(anchor) != 1:
            raise RuntimeError(f"decode.cu no longer has one {anchor.strip()!r}: update the cuts")
    a, b = src.index(_COMPUTE_FROM), src.index(_COMPUTE_TO)
    loads_only = src[:a] + _CONSTANT_PARTIAL + src[b:]
    no_merge = src.replace(_MERGE, "  return;\n" + _MERGE)
    return {"kernel": src, "loads_only": loads_only, "no_merge": no_merge,
            "loads_only_no_merge": loads_only.replace(_MERGE, "  return;\n" + _MERGE)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, common, decode, ref

    out = build.BUILD_DIR / "attn_breakdown"
    out.mkdir(parents=True, exist_ok=True)

    def compile_(item):
        name, text = item
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(text)
        subprocess.run([build._nvcc(), *build._flags("decode"), "-o", str(lib), str(src)],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib)).repro_decode_attention
        fn.argtypes = list(build.SOURCES["decode"][1]["repro_decode_attention"])
        fn.restype = ctypes.c_int
        return name, fn

    text = build.source_path("decode").read_text()
    with ThreadPoolExecutor(max_workers=4) as pool:
        fns = dict(pool.map(compile_, variants(text).items()))
    print(f"[breakdown] {chip_smoke.card_line()}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    b, hq, hkv, hd, sk = chip_smoke.B, chip_smoke.HQ, chip_smoke.HKV, chip_smoke.HD, chip_smoke.SK
    q = rnd(b, hq, hd)
    caches = [(rnd(b, sk, hkv, hd), rnd(b, sk, hkv, hd)) for _ in range(chip_smoke.GRAPH_COPIES)]
    vlen = torch.tensor([520 + 8 * i for i in range(b)], dtype=torch.int32, device="cuda")
    qpos = vlen - 1
    scale = ref.dtype_scalar(1.0 / hd ** 0.5, q.dtype)
    ctx = torch.empty((b, hq * hd), dtype=torch.bfloat16, device="cuda")
    planned = decode.attn_plan(b, hkv, sk, hd, torch.cuda.get_device_properties(0).multi_processor_count)
    for chunk in sorted({32, planned.chunk, 64}):
        splits = -(-sk // chunk)
        ws = torch.zeros(b * hkv * splits * (hd + 2), device="cuda")
        cnt = torch.zeros(b * hkv, dtype=torch.int32, device="cuda")
        for name, fn in fns.items():
            def call(k, v, fn=fn, chunk=chunk, splits=splits):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0, vlen.data_ptr(), 1,
                         qpos.data_ptr(), None, ref.BIG_WINDOW, 1, scale, ctx.data_ptr(), b, sk,
                         hq, hkv, hd, chunk, splits, ws.data_ptr(), cnt.data_ptr(),
                         common.cuda_stream())
                common.raise_on(err, name)

            cnt.zero_()      # the cut variants may leave counters behind
            t = chip_smoke.graph_ms(torch, [lambda c=c: call(*c) for c in caches] *
                                    chip_smoke.GRAPH_PASSES)
            print(f"[breakdown] chunk {chunk}{' (planned)' if chunk == planned.chunk else ''} "
                  f"{name}: graph_ms={t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
