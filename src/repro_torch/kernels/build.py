"""Build and load the hand-written CUDA kernels (``csrc/decode.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded through ``ctypes`` -- no PyTorch
headers, so a build takes seconds.  The build happens at first use (never
at import: the CPU tests import every module), goes into ``build/`` at the
repository root, and is keyed by a hash of the source and the flags, so an
edited source is never served by a stale library.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept beside the
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "decode.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each C entry point; every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
SIGNATURES = {
    "repro_fused_qkv": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    "repro_gemv_bias": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_decode_attention": (
        _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _F, _P,
        _I, _I, _I, _I, _I, _P,
    ),
    "repro_mlp_up": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libdecode_{digest}.so"


def build() -> Path:
    """Compile ``decode.cu`` unless a library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
