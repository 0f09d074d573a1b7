#!/usr/bin/env python3
"""Count the instructions the NIU kernel issues per element, from SASS.

    python3 tools/niu_sass.py

Compiles a probe beside ``src/repro_torch/kernels/csrc/niu.cu``, with the
library's own flags (``build._flags("niu")``): a kernel that runs the
per-element noise model (``niu_element``, with read noise and without
drift, as a default round runs it) on one element per thread with no
bounds check, so its SASS is the element's code and a load and store.
``cuobjdump -sass`` prints it.  The fast path is the shortest path
through the probe's instructions from the entry to ``EXIT`` that touches
no local memory (``STL`` / ``LDL``: the Payne-Hanek reduction of ``cosf``
for large arguments, never taken for arguments in [0, 2 pi)) and makes no
``CALL`` (the out-of-line slow paths of ``sqrtf`` and the division);
the compiler branches around each of those, so that path is the one a
thread takes.  Prints one JSON line: the fast path's instructions, the
probe's total, and the fast path's MUFU (quarter-rate special-function)
instructions.

``chip_smoke.py`` calls :func:`count` for the NIU's bound: the fast path's
instructions per element over the card's issue rate.
"""
from __future__ import annotations

import heapq
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROBE = """#include "{src}"
extern "C" __global__ void niu_probe_kernel(const int8_t* q, int8_t* out, uint32_t mixed,
                                            float scale, float w_max, float prog, float read) {{
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = niu_element<false, true>(q[i], i, mixed, scale, w_max, prog, read, 1.0f);
}}
"""
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SLOW = ("STL", "LDL", "CALL")


def _tool(name: str, nvcc: str) -> str:
    path = Path(nvcc).with_name(name)
    return str(path) if path.exists() else (shutil.which(name) or name)


def fast_path(insns) -> list:
    """The instructions on the shortest path from the first of ``insns``
    ((address, text) pairs) to an unpredicated ``EXIT`` that avoids
    ``_SLOW`` instructions; a predicated branch may go either way."""
    index = {addr: i for i, (addr, _) in enumerate(insns)}
    best, prev = {0: 1}, {}
    heap = [(1, 0)]
    while heap:
        cost, i = heapq.heappop(heap)
        if cost > best.get(i, 1 << 30):
            continue
        text = insns[i][1]
        pred = text.startswith("@")
        op = (text.split()[1] if pred else text.split()[0]).split(".")[0]
        if op == "EXIT" and not pred:
            path = [i]
            while path[-1] in prev:
                path.append(prev[path[-1]])
            return [insns[j][1] for j in reversed(path)]
        succ = []
        if op == "BRA":
            succ.append(index[int(text.split()[-1].rstrip(";"), 16)])
        if not (op == "BRA" and not pred) and i + 1 < len(insns):
            succ.append(i + 1)
        for j in succ:
            nop = insns[j][1].lstrip("@!P0123456789T ").split()
            if nop and nop[0].split(".")[0] in _SLOW:
                continue
            if cost + 1 < best.get(j, 1 << 30):
                best[j], prev[j] = cost + 1, i
                heapq.heappush(heap, (cost + 1, j))
    raise ValueError("no path to EXIT avoids the slow paths")


def count(build) -> dict:
    """Build the probe with ``build``'s nvcc and the NIU flags (less
    ``-shared``: a cubin) and count its SASS."""
    nvcc = build._nvcc()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "niu_probe.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(PROBE.format(src=build.source_path("niu").resolve()))
    flags = [f for f in build._flags("niu") if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run([_tool("cuobjdump", nvcc), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    probe = sass[sass.index("Function : niu_probe_kernel"):].split("Function :")[1]
    insns = [(int(m.group(1), 16), m.group(2).strip())
             for m in map(_INSN.match, probe.splitlines()) if m]
    fast = fast_path(insns)
    return dict(fast_path=len(fast), total=len(insns),
                mufu=sum("MUFU." in op for op in fast))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    print(json.dumps(count(build)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
