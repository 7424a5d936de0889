"""Build and bind the packing kernels (``csrc/pack_solve.cu``).

The source is compiled with nvcc for ``sm_90a`` into a shared library with a
plain C interface, at first use, into ``build/kernels/<hash>/`` at the root of
the checkout; the hash covers the sources and the flags, so an edit rebuilds.
The library is loaded with ``ctypes``; the wrappers in ``torch_solver`` pass
``data_ptr()`` pointers and the current stream. Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("pack_solve.cu",)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: seconds the last build took in this process (None: the library was cached)
BUILD_SECONDS: Optional[float] = None
_LIB: Optional[ctypes.CDLL] = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # 19 pointers, G O E R Z S, stream
    "kts_shared_precompute": [_P] * 19 + [_I] * 6 + [_P],
    # 43 pointers, K G O E R Z S, stream
    "kts_pack_member": [_P] * 43 + [_I] * 7 + [_P],
    # 13 pointers, K T NS S, stream
    "kts_pack_epilogue": [_P] * 13 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit's nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libpack_solve.so"


def build() -> Path:
    """Compile the kernels unless this source's library exists. The
    compiler's resource report (``-Xptxas -v``) lands in ``ptxas.log``
    beside the library."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    (out.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument types on a loaded library."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kts_error_string.argtypes = [ctypes.c_int]
    lib.kts_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB
