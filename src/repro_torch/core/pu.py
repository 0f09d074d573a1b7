"""Processing-unit cost model (a copy of ``repro.core.pu``, plus the H100
profiles).

The paper's PU (SS II, SS IV) is parameterized by the systolic array shape
(R_SA x C_SA), its clock, the URAM capacity available for weights, and the
HBM link feeding it.  The weight-transfer scheduler (SS III) only needs three
quantities per tile: load time, execution time, and fast-memory usage --
all derived here.

The same cost model is reused, with different constants, for other
memory hierarchies, so the scheduler is memory-hierarchy-agnostic (DESIGN.md
SS2).  The port's card is the H100: :func:`h100_config` (HBM feeding the
SMs' shared memory, the tensor cores as the "systolic array") and
:func:`h100_host_offload_config` (host memory feeding HBM over PCIe) carry
its data-sheet values.  :func:`tpu_v5e_config` and
:func:`host_offload_config` are the JAX package's TPU profiles, kept as they
are so the port plans bit for bit what the reference plans; nothing the port
runs on the card plans with them by default.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PUConfig:
    """Cost-model parameters of one processing unit.

    Defaults model the paper's PU_2x on the Alveo U50.
    """

    name: str = "pu2x"
    r_sa: int = 64                  # systolic array rows (PEs)
    c_sa: int = 8                   # systolic array columns (dot-product width)
    fast_clock_hz: float = 600e6    # SA + on-chip memory clock (SS IV)
    # Weight fast-memory capacity in bytes.  One URAM column = 64 blocks
    # x 288 Kb = 2.25 MiB usable for weights (8-bit payload of the 72-bit
    # word; the spare byte holds biases, SS II-A).
    fast_mem_bytes: int = 64 * 4096 * 8   # 64 URAMs x 4096 entries x 8 B
    # Sustained HBM->URAM weight bandwidth: 128 bit @ 600 MHz (SS IV).
    weight_bw_bytes_per_s: float = 16 * 600e6
    # Activation stream bandwidth: 256 bit AXI @ 300 MHz (SS IV).
    act_bw_bytes_per_s: float = 32 * 300e6

    @property
    def macs_per_cycle(self) -> int:
        return self.r_sa * self.c_sa

    @property
    def peak_ops_per_s(self) -> float:
        # 2 ops (mul+add) per MAC per fast-clock cycle.
        return 2.0 * self.macs_per_cycle * self.fast_clock_hz

    # ---- tile-level quantities used by the scheduler -------------------

    def tile_bytes(self, m: int, rows: int | None = None) -> int:
        """Fast-memory bytes used by an (rows x m) int8 weight tile.

        Weight storage is allocated in URAM *entries* of C_SA elements
        across R_SA parallel blocks (SS II-B): a tile occupies
        ceil(m / c_sa) entries per R_SA row-block.  The paper's tiles are
        exactly R_SA rows; LM-scale tiles (whole weight matrices under the
        TPU profiles) span ceil(rows / r_sa) row-blocks.
        """
        rows = self.r_sa if rows is None else rows
        entries = math.ceil(m / self.c_sa)
        row_blocks = max(1, math.ceil(rows / self.r_sa))
        return entries * self.c_sa * self.r_sa * row_blocks  # int8: 1 B/elem

    def load_time(self, m: int, rows: int | None = None) -> float:
        """HBM -> fast-memory transfer time of one weight tile (seconds)."""
        return self.tile_bytes(m, rows) / self.weight_bw_bytes_per_s

    def exec_time(self, m: int, p: int, rows: int | None = None) -> float:
        """Steady-state execution time of one tile against P activation

        columns.  Each MVM wave takes ceil(M/C_SA) fast cycles and the SA
        processes one wave per round (SS II-B): P waves per R_SA row-block
        round.
        """
        rows = self.r_sa if rows is None else rows
        rounds = max(1, math.ceil(rows / self.r_sa))
        waves = p
        cycles_per_wave = math.ceil(m / self.c_sa)
        return rounds * waves * cycles_per_wave / self.fast_clock_hz

    def gemm_tiles(self, n: int, m: int, p: int) -> List["TileCost"]:
        """Partition an (N x M) weight matrix GEMM (against M x P acts)

        into the paper's R_SA x M tiles and cost each one.
        """
        n_tiles = math.ceil(n / self.r_sa)
        out = []
        for t in range(n_tiles):
            rows = min(self.r_sa, n - t * self.r_sa)
            out.append(
                TileCost(
                    load_s=self.load_time(m, rows),
                    exec_s=self.exec_time(m, p, rows),
                    mem_bytes=self.tile_bytes(m, rows),
                )
            )
        return out


@dataclasses.dataclass(frozen=True)
class TileCost:
    """Scheduler-facing view of one weight tile (paper SS III)."""

    load_s: float
    exec_s: float
    mem_bytes: int


# Paper configurations (SS IV): both use one URAM column (64 blocks), R_g=8.
PU_2X = PUConfig(name="pu2x", r_sa=64, c_sa=8)
PU_1X = PUConfig(
    name="pu1x",
    r_sa=64,
    c_sa=4,
    # PU_1x splits each URAM into two sub-regions matching the 32-bit weight
    # read path; capacity seen by the scheduler is unchanged, load path is
    # the same stream-width-adapted 128b @ 600MHz.
)


def tpu_v5e_config(
    fast_mem_bytes: int = 96 * 1024 * 1024,   # VMEM budget reserved for weights
    hbm_bw: float = 819e9,
    peak_flops: float = 197e12 * 2 / 2,       # bf16 MACs/s equivalent
) -> PUConfig:
    """The TPU adaptation: VMEM plays URAM, HBM feeds it, MXU is the SA.

    The scheduler consumes only (load_s, exec_s, mem_bytes), so expressing a
    v5e core in the same dataclass lets the identical two-phase heuristic
    plan HBM->VMEM weight streaming.  We encode the MXU as a 128x128 "SA" at
    a virtual clock chosen so peak_ops matches the chip.
    """
    r, c = 128, 128
    clock = peak_flops / (2.0 * r * c)
    return PUConfig(
        name="tpu_v5e",
        r_sa=r,
        c_sa=c,
        fast_clock_hz=clock,
        fast_mem_bytes=fast_mem_bytes,
        weight_bw_bytes_per_s=hbm_bw,
        act_bw_bytes_per_s=hbm_bw,
    )


def host_offload_config(
    hbm_bytes: int = 16 * 1024**3,
    pcie_bw: float = 32e9,            # host->device interconnect
    peak_flops: float = 197e12,
) -> PUConfig:
    """Second-level streaming: device HBM plays URAM, host memory plays HBM.

    This is the generalization the paper points at in SS V ("naturally
    supports larger models by dynamically allocating weights"): models whose
    weights exceed device HBM stream layer tiles host->device, scheduled by
    the same heuristic.
    """
    r, c = 128, 128
    clock = peak_flops / (2.0 * r * c)
    return PUConfig(
        name="tpu_v5e_host_offload",
        r_sa=r,
        c_sa=c,
        fast_clock_hz=clock,
        fast_mem_bytes=hbm_bytes,
        weight_bw_bytes_per_s=pcie_bw,
        act_bw_bytes_per_s=pcie_bw,
    )


# H100 SXM5 data-sheet values (chip_smoke.py's card_rates reads these for
# the SXM card, so the repo keeps one source).
H100_HBM_BYTES = 80 * 10**9          # 80 GB of HBM3
H100_HBM_BW = 3.35e12                # HBM3 bytes/s
H100_BF16_FLOPS = 989e12             # dense bf16 tensor-core FLOP/s
H100_INT8_OPS = 1979e12              # dense int8 tensor-core OP/s
H100_F32_FLOPS = 67e12               # float32 FLOP/s off the tensor cores
H100_SMEM_BYTES = 132 * 228 * 1024   # 132 SMs x 228 KiB of shared memory
PCIE5_X16_BW = 64e9                  # PCIe Gen5 x16 host link, one direction
# The "systolic array" of the H100 profiles is the decode GEMV's block tile
# (kernels/decode.py: GEMV_N = 128 output columns, GEMV_K = 64 weight rows
# a stage), at a virtual clock that gives the tensor cores' peak.
_H100_R_SA, _H100_C_SA = 128, 64


def h100_config(
    fast_mem_bytes: int = H100_SMEM_BYTES,
    hbm_bw: float = H100_HBM_BW,
    peak_flops: float = H100_BF16_FLOPS,
) -> PUConfig:
    """The H100 counterpart of :func:`tpu_v5e_config`: the SMs' shared
    memory plays URAM, HBM feeds it, the tensor cores are the SA."""
    r, c = _H100_R_SA, _H100_C_SA
    return PUConfig(
        name="h100",
        r_sa=r,
        c_sa=c,
        fast_clock_hz=peak_flops / (2.0 * r * c),
        fast_mem_bytes=fast_mem_bytes,
        weight_bw_bytes_per_s=hbm_bw,
        act_bw_bytes_per_s=hbm_bw,
    )


def h100_host_offload_config(
    hbm_bytes: int = H100_HBM_BYTES,
    pcie_bw: float = PCIE5_X16_BW,
    peak_flops: float = H100_BF16_FLOPS,
) -> PUConfig:
    """The H100 counterpart of :func:`host_offload_config`: device HBM
    plays URAM, host memory plays HBM, the PCIe link is the load channel."""
    r, c = _H100_R_SA, _H100_C_SA
    return PUConfig(
        name="h100_host_offload",
        r_sa=r,
        c_sa=c,
        fast_clock_hz=peak_flops / (2.0 * r * c),
        fast_mem_bytes=hbm_bytes,
        weight_bw_bytes_per_s=pcie_bw,
        act_bw_bytes_per_s=pcie_bw,
    )
