"""Build and bind the kernels (``csrc/pack_solve.cu``, ``csrc/staging.cu``,
``csrc/probe.cu``).

The sources are compiled for ``sm_90a`` at first use, one nvcc per source,
all started together, and linked into one shared library with a plain C
interface in ``build/kernels/<hash>/`` at the root of the checkout; the hash
covers the sources and the flags, so an edit rebuilds. The library is loaded
with ``ctypes``; the wrappers in ``torch_solver`` and ``staging`` pass
``data_ptr()`` pointers and the current stream. Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("pack_solve.cu", "staging.cu", "probe.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds the last build took in this process (None: the library was cached)
BUILD_SECONDS: Optional[float] = None
_LIB: Optional[ctypes.CDLL] = None
# solvers are constructed, and wrappers called, from several host threads
_LOCK = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # 21 pointers, B G O E R Z S, stream
    "kts_shared_precompute": [_P] * 21 + [_I] * 7 + [_P],
    # 40 pointers, B K G O E R Z S smem_limit, stream
    "kts_pack_member": [_P] * 40 + [_I] * 9 + [_P],
    # 13 pointers, B K T NS S, stream
    "kts_pack_epilogue": [_P] * 13 + [_I] * 5 + [_P],
    # dst, src, idx, n, row_bytes, stream
    "kts_stage_patch": [_P] * 3 + [_L] * 2 + [_P],
    # table, n, max_bytes, stream
    "kts_fleet_stack": [_P, _I, _L, _P],
    # x, y, n, stream
    "kts_rtt_probe": [_P, _P, _L, _P],
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
    return BUILD_ROOT / h.hexdigest()[:16] / "libkts.so"


def build() -> Path:
    """Compile the kernels unless these sources' library exists. The
    compiler's resource report (``-Xptxas -v``) lands in ``ptxas.log``
    beside the library."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{Path(s).stem}.{os.getpid()}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    (out.parent / "ptxas.log").write_text(log)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument types on a loaded library."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kts_error_string.argtypes = [ctypes.c_int]
    lib.kts_error_string.restype = ctypes.c_char_p
    # G O R Z NS smem_limit -> bytes of scratch a member
    lib.kts_pack_member_scratch.argtypes = [_I] * 6
    lib.kts_pack_member_scratch.restype = _L
    # B G O -> bytes of K1's scratch
    lib.kts_shared_precompute_scratch.argtypes = [_I] * 3
    lib.kts_shared_precompute_scratch.restype = _L
    return lib


def load_kernels() -> ctypes.CDLL:
    """The bound kernel library, built at first use; one build and one load
    whatever the number of threads that ask at once."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB
