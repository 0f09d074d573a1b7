"""The paper's scheduler across three memory hierarchies (counterpart of
``examples/weight_streaming.py``).

    PYTHONPATH=src python -m repro_torch.examples.weight_streaming [--arch mixtral-8x7b]

The two-phase heuristic is hierarchy-agnostic: the same code plans

  1. URAM @ FPGA    -- the paper's setting (ResNet tiles vs 2 MiB URAM),
  2. shared memory @ H100 -- GEMV-block granularity, HBM feeding the SMs
                       (``core.pu.h100_config``),
  3. host->HBM @ H100 -- models larger than device HBM, over PCIe
                       (``core.pu.h100_host_offload_config``).

For each level we print capacity pressure, baseline vs adaptive stalls and
the achieved compute utilization.  All of it is host-side numpy: the
profiles are data-sheet values, nothing here is measured on the card.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import scheduler as sched
from repro_torch.core import simulator as sim
from repro_torch.core.pu import PU_2X, h100_config, h100_host_offload_config
from repro_torch.core.streaming import gemm_sequence_tiles, plan_streaming
from repro_torch.runtime.serving import model_gemms, plan_model_streaming


def show(name, plan_summary):
    s = plan_summary
    if s["weight_bytes"] == 0:
        print(f"  {name:18s} INFEASIBLE: a single tile exceeds this "
              f"memory level's capacity (sub-tile first)")
        return
    pressure = s["weight_bytes"] / s["capacity_bytes"]
    print(
        f"  {name:18s} tiles={s['tiles']:5.0f}  "
        f"weights/capacity={pressure:7.2f}x  "
        f"stall: base {s['baseline_stall_s']*1e3:9.3f} ms -> "
        f"adaptive {s['adaptive_stall_s']*1e3:9.3f} ms  "
        f"util {s['adaptive_util']:6.1%}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b", choices=ARCH_IDS)
    ap.add_argument("--batch-tokens", type=int, default=64)
    args = ap.parse_args(argv)

    # 1. the paper's own level: ResNet tiles vs URAM ------------------------
    print("level 1: URAM @ FPGA (paper SS III-V, ResNet-50 on PU_2x)")
    layers = sim.resnet_gemm_layers(50)
    tiles = sim.model_tiles(PU_2X, layers)
    res = sched.two_phase(tiles, capacity=PU_2X.fast_mem_bytes)
    print(
        f"  resnet50/pu2x      tiles={len(tiles):5d}  "
        f"weights/capacity={sum(t.mem_bytes for t in tiles)/PU_2X.fast_mem_bytes:7.2f}x  "
        f"stall: base {res.baseline.total_stall*1e3:9.3f} ms -> "
        f"adaptive {res.adaptive.total_stall*1e3:9.3f} ms  "
        f"util {res.adaptive.utilization:6.1%}"
    )

    # 2. shared memory @ H100 ---------------------------------------------
    # At this scale the schedulable tile is a GEMV block (R_SA = 128
    # output columns), not a whole weight matrix: whole matrices exceed
    # the SMs' shared memory, which is why the kernels tile them.
    pu_smem = h100_config()
    print(f"\nlevel 2: shared memory @ H100 ({args.arch}, decode round, "
          f"{args.batch_tokens} tokens, {pu_smem.r_sa}-row GEMV-block tiles)")
    cfg = get_config(args.arch)
    gemms = model_gemms(cfg, args.batch_tokens)
    per_layer = len(gemms) // cfg.n_layers
    block_tiles = gemm_sequence_tiles(gemms[:per_layer], pu_smem)[:400]
    # one layer of blocks; the plan repeats per layer
    show(f"{args.arch} (1 layer)", plan_streaming(block_tiles, pu_smem).summary())

    # 3. host offload ---------------------------------------------------------
    pu_host = h100_host_offload_config()
    print(f"\nlevel 3: host->HBM offload over PCIe (H100, "
          f"{pu_host.fast_mem_bytes / 1e9:.0f} GB HBM)")
    for arch in dict.fromkeys((args.arch, "internvl2-26b")):
        cfg = get_config(arch)
        gb = cfg.param_count() / 1e9
        plan = plan_model_streaming(cfg, pu_host, args.batch_tokens)
        print(f"  [{arch}: {gb:.1f} GB int8 weights vs "
              f"{pu_host.fast_mem_bytes / 1e9:.0f} GB HBM]")
        show(arch, plan.summary())


if __name__ == "__main__":
    main()
