"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on its own with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded through ``ctypes`` --
no PyTorch headers, so a build takes seconds.  A build happens at first
use (never at import: the CPU tests import every module), goes into
``build/`` at the repository root, and is keyed by a hash of the source
and its flags, so an edited source is never served by a stale library.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside each library as ``<library>.ptxas.txt``.

``niu.cu`` is built with ``-fmad=false``: its Box-Muller arithmetic must
round after every multiply and add, as XLA's does, so that no
multiply-add is contracted into an FMA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# per source: (extra nvcc flags, argument types of each C entry point);
# every pointer and the stream are c_void_p, or ctypes would pass them as
# 32-bit ints
SOURCES: Dict[str, Tuple[tuple, dict]] = {
    "decode": ((), {
        "repro_fused_qkv": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P,
        ),
        "repro_gemv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P),
        "repro_decode_attention": (
            _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _F, _P,
            _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ),
        "repro_decode_attention_q8": (
            _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _F, _P,
            _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ),
    }),
    "pu": ((), {
        "repro_int8_gemm": (
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ),
        "repro_int8_conv_gemm": (
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ),
        "repro_im2col": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    }),
    "niu": (("-fmad=false",), {
        "repro_niu_absmax": (_P, _P, _I, _I, _P),
        "repro_niu_refresh": (
            _P, _P, _P, _P, ctypes.c_uint, _I, _I, _F, _F, _F, _I, _I, _P,
        ),
    }),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCES[name][0]


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        source_path(name).read_bytes() + " ".join(_flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def ptxas_report(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src = source_path(name)
    proc = subprocess.run(
        [_nvcc(), *_flags(name), "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    ptxas_report(name).write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, Path]:
    """Build every source at once, one ``nvcc`` each, in parallel."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with every entry point's
    signature declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, argtypes in SOURCES[name][1].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]
