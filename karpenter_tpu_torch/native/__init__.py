"""Native (C) runtime components, built on demand with the host C compiler.

The solver's device work is the CUDA kernels under ``solver/csrc``; the
control plane's hot host loops (pod signature hashing and group bucketing
for the encoder, and the name blob of ``problem_digest``) are C
(``encoder.c``). The extension is compiled at first use into
``build/native/<source hash>/`` at the root of the checkout, so an edit of
the source builds a new file and a stale one is never loaded. Any failure
(no compiler, no Python headers) falls back to the pure-Python loops.

``load_encoder()`` returns the compiled module or None; ``BUILD_SECONDS``
says how long the build took in this process (None: it was built before).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().with_name("encoder.c")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"

#: seconds the build took in this process (None: the module was built before)
BUILD_SECONDS: Optional[float] = None

_lock = threading.Lock()
_encoder = None
_tried = False


def module_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_ROOT / digest / f"_encoder{suffix}"


def _build_and_load():
    global BUILD_SECONDS
    so = module_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        # compile to a private name and rename: concurrent first uses (test
        # workers) never load a half-written file
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cc = sysconfig.get_config_var("CC") or "cc"
        include = sysconfig.get_paths()["include"]
        t0 = time.perf_counter()
        subprocess.run(
            cc.split() + ["-O2", "-shared", "-fPIC", f"-I{include}", str(SOURCE), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120, cwd=so.parent,
        )
        os.replace(tmp, so)
        BUILD_SECONDS = time.perf_counter() - t0
    spec = importlib.util.spec_from_file_location("karpenter_tpu_torch.native._encoder", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_encoder():
    """The compiled encoder module, or None when it cannot be built here."""
    global _encoder, _tried
    if _tried:
        return _encoder
    with _lock:
        if _tried:
            return _encoder
        try:
            _encoder = _build_and_load()
        except Exception:
            _encoder = None
        _tried = True
    return _encoder
