#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on a CUDA card.

    python3 tools/smoke_phases.py [int8] [multi] [kvq] [vlm] [per-stage]

Builds the kernels, prints the card's name and power limit, then runs the
named phases (all five when none is named) with ``chip_smoke.py``'s own
functions and checks:

- ``int8``: the kernel phase's rows 2e-2g, the attention's int8-K/V
  variant against the bf16 kernel on the dequantized cache
  (``chip_smoke.int8_attention``);
- ``multi``: olmo-1b's timed serve runs, then ``[multi-pu] serve``
  ((a), (b), (b2) and, with two or more cards, (c));
- ``kvq``: ``[serve] olmo-1b-kvq``;
- ``vlm``: internvl2-26b's kernel rows (the QKV GEMV and the SwiGLU MLP
  at its widths, the unembedding timed; ``chip_smoke.vlm_projections``),
  then ``[serve] internvl2-26b`` at all 48 layers;
- ``per-stage``: ``[multi-pu] serve`` (c) alone, olmo-1b's two stages on
  cards of their own, held to a single-PU captured kernel run (needs two
  or more cards).

Each phase prints its wall time.  ``chip_smoke.py`` itself always runs
every phase on one card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("int8", "multi", "kvq", "vlm", "per-stage")


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    phases = argv or list(PHASES)
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), f"({torch.cuda.device_count()} visible)", flush=True)
    build.build_all()
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    for phase in phases:
        t0 = time.perf_counter()
        if phase in ("int8", "vlm"):
            g = torch.Generator(device="cuda").manual_seed(0)

            def rnd(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

            def close(got, want, what):
                torch.testing.assert_close(got, want, atol=cs.ATOL, rtol=cs.RTOL,
                                           msg=lambda m: f"{what}: {m}")
                return (got.float() - want.float()).abs().max().item()

            timer = cs.Timer(torch, cs.TIMED_CALLS)
            if phase == "int8":
                cs.int8_attention(torch, timer, rates, rnd, close)
            else:
                cs.vlm_projections(torch, timer, rates, rnd, close)
                del timer
                cs.free(torch)
                cs.family_phase(torch, rates, cs.VLM)
        elif phase == "multi":
            cs.multi_pu_serve_phase(torch, cs.serve_runs(torch, rates))
        elif phase == "kvq":
            cs.kvq_phase(torch, rates)
        else:
            engine = cs.serve_engine(serve, True, False)
            cs.served(torch, engine)
            want = {r.uid: r.out_tokens for r in engine.completed}
            del engine
            cs.free(torch)
            _, want_rounds, _ = cs.logged_run(torch, kernels=True, feed=want)
            cs.per_stage_devices_phase(torch, want, want_rounds)
        cs.free(torch)
        print(f"[phases] {phase}: wall {time.perf_counter() - t0} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
