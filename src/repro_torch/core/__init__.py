"""Core library: the paper's contribution (counterpart of ``repro.core``).

- quant:      INT8 + power-of-two scaling (the PU's arithmetic)
- pu:         processing-unit cost model (FPGA PU_1x/PU_2x, H100 and the
              JAX package's TPU profiles)
- scheduler:  two-phase weight-transfer scheduling heuristic (SS III)
- streaming:  scheduler -> executable prefetch plans for real models
- simulator:  cycle-approximate PU pipeline (reproduces Fig. 5 / Table I)
- wrb:        wave-reorder-buffer model (SS II-A claim quantification)
- aimc:       AIMC noise-injection unit (SS VI; imported from its module,
              it reaches the kernels)

The numpy modules (pu, scheduler, streaming, simulator, wrb) are copies of
the reference's and give its results bit for bit.
"""
from repro_torch.core.pu import (
    PU_1X,
    PU_2X,
    PUConfig,
    TileCost,
    h100_config,
    h100_host_offload_config,
    host_offload_config,
    tpu_v5e_config,
)
from repro_torch.core.quant import (
    INT8_MAX,
    INT8_MIN,
    QTensor,
    dequantize,
    fake_quant,
    pow2_exponent,
    quantize,
    quantized_linear_exponents,
    requantize_i32,
    shift_round,
)
from repro_torch.core.scheduler import (
    Schedule,
    TwoPhaseResult,
    adaptive_schedule,
    baseline_schedule,
    reference_adaptive_schedule,
    reference_two_phase,
    simulate,
    two_phase,
)
from repro_torch.core.streaming import (
    StreamingExecutor,
    StreamingPlan,
    WeightTile,
    gemm_sequence_tiles,
    plan_streaming,
)

__all__ = [
    "PUConfig", "TileCost", "PU_1X", "PU_2X", "tpu_v5e_config",
    "host_offload_config", "h100_config", "h100_host_offload_config",
    "INT8_MIN", "INT8_MAX", "QTensor", "pow2_exponent", "quantize",
    "dequantize", "shift_round", "requantize_i32",
    "quantized_linear_exponents", "fake_quant",
    "Schedule", "TwoPhaseResult", "adaptive_schedule", "baseline_schedule",
    "reference_adaptive_schedule", "reference_two_phase",
    "simulate", "two_phase", "StreamingExecutor", "StreamingPlan",
    "WeightTile", "gemm_sequence_tiles", "plan_streaming",
]
