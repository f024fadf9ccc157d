"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``csrc/gr_matmul.cu`` (plain C interface, no PyTorch
headers) for ``sm_90a`` into ``build/kernels/`` at the repository root.  The
library's file name carries a hash of the source and flags, so an edited
source is never served by a stale build.  ``-Xptxas -v`` output (registers,
shared memory, spills) is kept beside the library as ``<name>.ptxas.txt``.

Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc``.
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "load_library", "build_info"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gr_matmul_planar_u32.argtypes = [
        vp, vp, vp, ci, ci, ci, ci, ci, ci,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, vp,
    ]
    lib.gr_matmul_planar_u32.restype = ci
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gr_matmul_tile.argtypes = [ci, ci, ip, ip, ip]
    lib.gr_matmul_tile.restype = ci


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load ``csrc/gr_matmul.cu``."""
    name = "gr_matmul"
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC_DIR / f"{name}.cu"
        nvcc = _nvcc()
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            (BUILD_DIR / f"{name}.ptxas.txt").write_text(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) for {src}:\n{res.stderr[-4000:]}"
                )
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
            built = True
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _libs[name] = lib
        _info[name] = {
            "path": str(so),
            "built": built,
            "seconds": time.perf_counter() - t0,
        }
        return lib


def build_info() -> dict:
    """Where the library came from and how long loading (and building) took."""
    return dict(_info.get("gr_matmul", {}))
