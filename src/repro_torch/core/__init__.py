"""The paper's core arithmetic, as far as the port has it: INT8
power-of-two quantization (``core.quant``) and AIMC noise emulation
(``core.aimc``, imported from its module: it reaches the kernels).  The
planner half of the JAX ``repro.core`` (scheduler, simulator, streaming)
is not ported yet."""
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

__all__ = [
    "INT8_MIN",
    "INT8_MAX",
    "QTensor",
    "pow2_exponent",
    "quantize",
    "dequantize",
    "shift_round",
    "requantize_i32",
    "quantized_linear_exponents",
    "fake_quant",
]
