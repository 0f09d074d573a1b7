"""Device resolution for the port (counterpart of ``repro.kernels.common``).

The JAX package decides between a compiled and an interpreted kernel from
the backend.  Here the tensor decides: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version.  There is
no switch that sends a CUDA tensor to the plain version, and no entry
point falls back to the CPU on its own: the CPU is used only when the
caller asks for it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

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


# Scalar arguments the kernels read through a pointer, one () int32
# tensor per (value, device), made once.
_SCALARS: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def device_int(v: Union[int, torch.Tensor], name: str, dev: torch.device) -> torch.Tensor:
    """A scalar integer argument as the () int32 tensor on ``dev`` that a
    kernel reads through a pointer.  A Python int gets a static tensor,
    filled once (so no call syncs to the host, and a captured CUDA graph
    holds no fill kernel); a tensor must already be there."""
    if not isinstance(v, torch.Tensor):
        key = (int(v), dev)
        t = _SCALARS.get(key)
        if t is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{name}={v}: no static scalar yet while a CUDA graph is "
                                   f"captured; run the call once before capturing it")
            t = torch.full((), int(v), dtype=torch.int32, device=dev)
            if dev.type == "cuda":
                # filled on this thread's stream, read later from any
                # stream (the stage threads each launch on their own)
                torch.cuda.current_stream(dev).synchronize()
            _SCALARS[key] = t
        return t
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
# While a CUDA graph is captured: the scratch it reads, kept alive with it.
_PINNED: List[list] = []


def split_k_scratch(kernel: str, dev: torch.device, stream: int, numel: int,
                    dtype: torch.dtype, counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel``'s workspace (at least ``numel`` of ``dtype``) and tile
    counters (at least ``counters`` int32) on ``dev`` for launches on
    ``stream``: zeroed when allocated, grown when a call needs more, else
    reused.  The kernels leave the counters (and the GEMM its int32 sums)
    at zero, so no call pays for a memset; calls on one stream run in
    order, so they can share them.  A graph being captured must find its
    scratch made (:func:`capture_graph` runs the work once first) and
    keeps it alive: growing it later makes new tensors for later calls."""
    ws, cnt = _SCRATCH.get((kernel, dev, stream), (None, None))
    grow = ws is None or ws.numel() < numel or cnt.numel() < counters
    if grow and _PINNED:
        raise RuntimeError(f"{kernel}: its scratch would grow while a CUDA graph is captured; "
                           f"run the call once on the capture stream first")
    if ws is None or ws.numel() < numel:
        ws = torch.zeros(max(numel, 1), dtype=dtype, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1), dtype=torch.int32, device=dev)
    _SCRATCH[kernel, dev, stream] = ws, cnt
    if _PINNED and all(w is not ws for w, _ in _PINNED[-1]):
        _PINNED[-1].append((ws, cnt))
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


def launch_snapshot() -> dict:
    """Every registered wrapper's launch count, by the wrapper."""
    return {fn: fn.launches for fn in _COUNTED}


# ------------------------------------------------------------ CUDA graphs --

_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def graph_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The side stream on which the port captures its CUDA graphs on
    ``dev`` (one, so the split-K scratch a graph reads is that stream's)."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


class CapturedGraph:
    """A captured CUDA graph, the kernel launches each replay makes, and
    the scratch it reads (kept alive as long as the graph)."""

    def __init__(self, graph, launches: dict, keep: Sequence = ()):
        self.graph = graph
        self.launches = {fn: n for fn, n in launches.items() if n}
        self._keep = list(keep)

    def replay(self):
        """Replay the graph on the current stream; each wrapper's count
        grows by the launches the graph holds."""
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n


def capture_graph(fn: Callable, *, pool=None, generators: Sequence = ()):
    """Run ``fn`` once on the capture stream, eagerly (it builds and
    configures the kernels it reaches and makes their scratch and static
    scalars; its launches count as launches), then capture it into one
    CUDA graph on the same stream.  ``generators`` are registered with the
    graph, so each replay advances them.  Returns ``(CapturedGraph,
    fn's output from the capture)``: the capture launches nothing, so the
    wrappers' counts are set back, and each replay adds what the capture
    counted.  A capture that fails raises."""
    dev = torch.device("cuda", torch.cuda.current_device())
    side, main = graph_stream(dev), torch.cuda.current_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = launch_snapshot()
    _PINNED.append([])
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side):
            out = fn()
    finally:
        keep = _PINNED.pop()
        after = launch_snapshot()
        for f, n in before.items():
            f.launches = n
    return CapturedGraph(graph, {f: after[f] - before[f] for f in before}, keep), out
