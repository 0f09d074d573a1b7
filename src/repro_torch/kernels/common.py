"""Device resolution for the port (counterpart of ``repro.kernels.common``).

The JAX package decides between a compiled and an interpreted kernel from
the backend.  Here the tensor decides: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version.  There is
no switch that sends a CUDA tensor to the plain version, and no entry
point falls back to the CPU on its own: the CPU is used only when the
caller asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (the kernel path)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
