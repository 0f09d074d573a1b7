#!/usr/bin/env python3
"""Where a staged lane group's decode parts from the whole batch's, on a
CUDA card.

    python3 tools/lane_group_parity.py [--microbatches M]

Serves the first engine step of ``chip_smoke.py``'s olmo-1b requests
(the first wave's prefill and a decode block) twice, eagerly with the
decode kernels: single-PU, and through ``--multi-pu 2`` with M lane
groups (default 2).  It records the inputs and outputs of every
``kernels.dispatch`` call (QKV, attention, MLP) of the first decode
round and prints, layer by layer, whether the last lane group's are
the batch's rows bit for bit, stopping at the first output that is
not.  Inputs equal and an output not: that op depends on the row count.
An input not equal where the previous op's output was: what lies
between them (the norms, the residual add) does.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

OPS = ("decode_qkv", "decode_attention", "decode_mlp")
CALLS = 3 * 16          # dispatch calls of one olmo-1b round (16 layers)


def record(torch, cs, serve, dispatch, extra, warm):
    """The dispatch calls of the first engine step: (op, tensor args,
    tensor kwargs, outputs), clones."""
    inner = {n: getattr(dispatch, n) for n in OPS}
    calls = []

    def wrap(name):
        def fn(cfg, p, *a, **kw):
            out = inner[name](cfg, p, *a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((name, [t.clone() for t in a if isinstance(t, torch.Tensor)],
                          {k: v.clone() for k, v in kw.items() if isinstance(v, torch.Tensor)},
                          [o.clone() for o in outs]))
            return out
        return fn

    for name in OPS:
        setattr(dispatch, name, wrap(name))
    try:
        engine = cs.serve_engine(serve, True, eager=True, extra=extra, warm=warm)
        calls.clear()                       # the warmup's
        engine.step()
    finally:
        for name in OPS:
            setattr(dispatch, name, inner[name])
    del engine
    cs.free(torch)
    return calls


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--microbatches", type=int, default=2)
    m = ap.parse_args(argv).microbatches
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    single = record(torch, cs, serve, dispatch, (), False)[:CALLS]
    staged = record(torch, cs, serve, dispatch, cs.MULTI_PU + ["--microbatches", str(m)], True)
    group = staged[(m - 1) * CALLS:m * CALLS]           # the last lane group's first round
    b = single[0][1][0].shape[0]
    lo = b - b // m
    for i, ((name, a1, k1, o1), (_, a2, k2, o2)) in enumerate(zip(single, group)):
        ins = [torch.equal(x[lo:], y) for x, y in zip(a1, a2)]
        kins = {k: torch.equal(v[lo:] if v.dim() else v, k2[k]) for k, v in k1.items() if k in k2}
        outs = [torch.equal(x[lo:], y) for x, y in zip(o1, o2)]
        diff = [(x[lo:].float() - y.float()).abs().max().item() for x, y in zip(o1, o2)]
        print(f"layer {i // 3} {name}: inputs equal {ins} {kins}, outputs equal {outs}, "
              f"max |diff| {diff}", flush=True)
        if not all(outs):
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
