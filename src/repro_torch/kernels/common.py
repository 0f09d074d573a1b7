"""Device resolution for the port (counterpart of ``repro.kernels.common``).

The JAX package decides between a compiled and an interpreted kernel from
the backend.  Here the tensor decides: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version.  There is
no switch that sends a CUDA tensor to the plain version, and no entry
point falls back to the CPU on its own: the CPU is used only when the
caller asks for it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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


def device_int(v: Union[int, torch.Tensor], name: str, dev: torch.device) -> torch.Tensor:
    """A scalar integer argument as the () int32 tensor on ``dev`` that a
    kernel reads through a pointer.  A Python int is filled on the device,
    so no call syncs to the host; a tensor must already be there."""
    if not isinstance(v, torch.Tensor):
        return torch.full((), int(v), dtype=torch.int32, device=dev)
    if v.device != dev or v.numel() != 1 or v.is_floating_point():
        raise ValueError(f"{name} must be one integer on {dev}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")
    return v.reshape(()).to(torch.int32)


def raise_on(err: int, name: str):
    """Raise if a C entry point returned a CUDA error (its launch failed)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def cuda_stream() -> int:
    """The current CUDA stream as the pointer a C entry point takes."""
    return torch.cuda.current_stream().cuda_stream


# Split-K kernels' scratch, by (kernel, device, stream): a workspace for
# the split partials and one counter per output tile.
_SCRATCH: Dict[Tuple[str, torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def split_k_scratch(kernel: str, dev: torch.device, stream: int, numel: int,
                    dtype: torch.dtype, counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel``'s workspace (at least ``numel`` of ``dtype``) and tile
    counters (at least ``counters`` int32) on ``dev`` for launches on
    ``stream``: zeroed when allocated, grown when a call needs more, else
    reused.  The kernels leave the counters (and the GEMM its int32 sums)
    at zero, so no call pays for a memset; calls on one stream run in
    order, so they can share them."""
    ws, cnt = _SCRATCH.get((kernel, dev, stream), (None, None))
    if ws is None or ws.numel() < numel:
        ws = torch.zeros(max(numel, 1), dtype=dtype, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1), dtype=torch.int32, device=dev)
    _SCRATCH[kernel, dev, stream] = ws, cnt
    return ws, cnt


# Every kernel wrapper carries ``launches``, a plain integer that counts
# the calls that went to its kernel (never a call that took the plain
# version), so a run can show that its path went through the kernels.
_COUNTED = []


def count_launches(*fns):
    """Give each wrapper a ``launches`` count of 0 and register it with
    :func:`reset_launches`."""
    for fn in fns:
        fn.launches = 0
        _COUNTED.append(fn)


def reset_launches():
    """Set every wrapper's launch count back to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """Every registered wrapper's launch count, by the wrapper's name."""
    return {fn.__name__: fn.launches for fn in _COUNTED}
