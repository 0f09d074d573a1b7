"""Wave Reorder Buffer (WRB) model (paper SS II-A).

The SA emits one R_SA-byte systolic wave every ceil(M/C_SA) cycles, split
into R_SA/R_g row-block chunks that arrive at the aggregator at staggered
times.  Chunks are written to the WRB *tagged* with (wave, row-block), so a
new wave can begin draining into the buffer before earlier waves fully
retire -- out-of-order writes with strict in-order reads.  The paper credits
this for "minimizing the idle state of the pipeline" (up to 98% measured
efficiency).

A copy of ``repro.core.wrb``.  The card needs no WRB: each CUDA kernel
writes its output tiles from registers in one epilogue.  We keep this
cycle-level model to *quantify* the paper's claim (the benchmark compares
in-order vs. out-of-order write admission); DESIGN.md documents the
non-transfer.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class WRBConfig:
    r_sa: int = 64          # wave size in bytes (one byte per SA row)
    r_g: int = 8            # row-block granularity (aggregator lanes)
    capacity_waves: int = 4  # WRB depth in waves
    read_bytes_per_cycle: int = 8   # R_g bytes per cycle on the read side

    @property
    def blocks_per_wave(self) -> int:
        return self.r_sa // self.r_g


@dataclasses.dataclass
class WRBStats:
    cycles: int
    producer_stall_cycles: int   # aggregate chunk-wait cycles (can exceed
                                 # `cycles`: chunks wait concurrently)
    waves: int
    wave_interval: int = 1

    @property
    def efficiency(self) -> float:
        """Fraction of the ideal production rate sustained: the SA wants to
        emit one wave every `wave_interval` cycles; `cycles` is what the
        pipeline actually took."""
        ideal = self.waves * self.wave_interval
        return ideal / self.cycles if self.cycles else 1.0


def _simulate(cfg: WRBConfig, n_waves: int, wave_interval: int, out_of_order: bool) -> WRBStats:
    """Simulate producer (SA) vs consumer (post-processing read side).

    Producer: every ``wave_interval`` cycles a full wave's chunks become
    ready (row-blocks staggered by one cycle each, modeling the aggregator
    shift-up chain).  A chunk is admitted iff the WRB has space; with
    ``out_of_order=False`` it additionally requires all previous waves to be
    fully admitted *and drained* past it (head-of-line blocking).  When a
    chunk cannot be admitted the producer stalls (the SA pipeline halts).

    Consumer: drains strictly in wave order at ``read_bytes_per_cycle``.
    """
    bpw = cfg.blocks_per_wave
    buf_occupancy = 0               # in chunks
    capacity = cfg.capacity_waves * bpw
    drain_cycles_per_wave = max(1, cfg.r_sa // cfg.read_bytes_per_cycle)

    t = 0
    stall = 0
    drained_waves = 0
    admitted: List[int] = [0] * n_waves     # chunks admitted per wave
    consumer_free_at = 0

    for w in range(n_waves):
        ready_t = max(t, w * wave_interval)
        for b in range(bpw):
            chunk_t = ready_t + b
            # wait for space
            while True:
                # drain completed waves up to chunk_t
                while (
                    drained_waves < w
                    and admitted[drained_waves] == bpw
                    and consumer_free_at <= chunk_t
                ):
                    consumer_free_at = max(consumer_free_at, chunk_t) + drain_cycles_per_wave
                    buf_occupancy -= bpw
                    drained_waves += 1
                in_order_ok = out_of_order or drained_waves >= w
                if buf_occupancy < capacity and in_order_ok:
                    break
                stall += 1
                chunk_t += 1
            admitted[w] += 1
            buf_occupancy += 1
            t = chunk_t
    # drain the tail
    while drained_waves < n_waves:
        consumer_free_at = max(consumer_free_at, t) + drain_cycles_per_wave
        buf_occupancy -= bpw
        drained_waves += 1
        t = consumer_free_at
    return WRBStats(cycles=t, producer_stall_cycles=stall, waves=n_waves,
                    wave_interval=wave_interval)


def simulate_wrb(
    cfg: WRBConfig, n_waves: int, wave_interval: int, out_of_order: bool = True
) -> WRBStats:
    if n_waves <= 0:
        return WRBStats(cycles=0, producer_stall_cycles=0, waves=0,
                        wave_interval=wave_interval)
    return _simulate(cfg, n_waves, wave_interval, out_of_order)


def ooo_benefit(cfg: WRBConfig, n_waves: int, wave_interval: int) -> Tuple[WRBStats, WRBStats]:
    """(in-order, out-of-order) stats for the same workload."""
    return (
        simulate_wrb(cfg, n_waves, wave_interval, out_of_order=False),
        simulate_wrb(cfg, n_waves, wave_interval, out_of_order=True),
    )
