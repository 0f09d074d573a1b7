"""Per-stage devices for the stage-parallel runtime (counterpart of
``repro.launch.mesh.stage_submeshes``).

The reference splits a JAX mesh into one submesh per pipeline stage.  The
port has no mesh yet (tensor sharding inside a stage waits for ROADMAP
step 15), so a stage is given a group of CUDA devices and runs on the
first of them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def stage_devices(
    n_stages: int, devices: Optional[Sequence[torch.device]] = None
) -> Tuple[List[List[torch.device]], bool]:
    """Split ``devices`` (default: every visible CUDA device) into
    ``n_stages`` groups, one per pipeline stage, in order.

    The devices are divided when they split evenly ``n_stages`` ways
    (four cards into two stages of two).  Otherwise -- notably one card
    -- every stage *shares* all of them: the result is ``n_stages``
    references to the one group with ``shared=True``, so callers place
    per-stage work without special-casing, as the reference does on one
    device.

    Returns ``(groups, shared)``.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to split into stages")
    if n_stages <= 1:
        return [devices] * max(n_stages, 1), False
    if len(devices) % n_stages == 0:
        per = len(devices) // n_stages
        return [devices[k * per:(k + 1) * per] for k in range(n_stages)], False
    return [devices] * n_stages, True
