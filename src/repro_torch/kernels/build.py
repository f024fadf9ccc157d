"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every source in ``SOURCES`` (plain C interface, no
PyTorch headers) for ``sm_90a``, all at once in parallel, and links them
into one library in ``build/kernels/`` at the repository root.  The
library's file name carries a hash of every source, every header they
share (``csrc/*.cuh``) and every flag, so an edited source is never served
by a stale build.  ``-Xptxas -v`` output (registers,
shared memory, spills) is kept beside the library as
``<source>.ptxas.txt``, one file per source.

Several processes may load the library at once (the workers of a pool,
the agents of a multi-host launch on one machine), so compile-and-load
runs under an inter-process lock, ``fcntl.flock`` on ``BUILD_DIR /
"build.lock"``: the first process compiles, the others wait and then load
its library.  The kernel advisory lock dies with its holder, so a run cut
off mid-build leaves no stale lock behind.

Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "load_library", "build_info", "library_configs"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the general (simt), tensor-core (tc; tc_left and its pre-passes), bandwidth
# (skinny) and tower routes
SOURCES = ("gr_matmul", "gr_matmul_tc", "gr_matmul_tc_left", "gr_matmul_skinny", "gr_matmul_tower")
LIB_NAME = "gr_matmul"

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
    vp, ci, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    fold = ctypes.POINTER(ctypes.c_uint32)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gr_matmul_simt_u32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, fold, u32, ci, ci,
                                       ci, vp]
    lib.gr_matmul_tile.argtypes = [ci, ci, ci, ip, ip, ip]
    lib.gr_matmul_simt_grid.argtypes = [ci, ci, ci, ci, ci, ci, ci,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.gr_matmul_tc_limbs.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.gr_matmul_tc_u32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                     fold, u32, vp]
    lib.gr_matmul_tc_left_u32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, u32, vp]
    lib.gr_matmul_tc_left_lift.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.gr_matmul_tc_left_configs.argtypes = [ip, ci]
    lib.gr_matmul_tc_left_layout.argtypes = [ci, ci, ci, ip]
    lib.gr_matmul_tc_left_grid.argtypes = [ci, ci, ci, ci, ci, ci, ci, ci,
                                           ctypes.POINTER(ctypes.c_int64)]
    lib.gr_matmul_tc_left_depth.argtypes = []
    lib.gr_matmul_tc_lift.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, fold, vp]
    lib.gr_matmul_tc_stack.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.gr_matmul_tc_configs.argtypes = [ci, ci, ip, ci]
    lib.gr_matmul_tc_smem.argtypes = [ci, ci, ci, ci, ci]
    lib.gr_matmul_tc_depth.argtypes = []
    lib.gr_matmul_skinny_u32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, fold, u32, vp]
    lib.gr_matmul_skinny_cols.argtypes = [ci, ci]
    lib.gr_matmul_skinny_configs.argtypes = [ci, ci, ip, ci]
    lib.gr_matmul_skinny_smem.argtypes = [ci, ci, ci, ci, ci, ci, ip, ip]
    lib.gr_matmul_skinny_smem.restype = ctypes.c_int64
    lib.gr_matmul_tower_u32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, fold, u32,
                                        vp]
    lib.gr_matmul_tower_configs.argtypes = [ci, ci, ip, ci]
    lib.gr_matmul_tower_smem.argtypes = [ci, ci, ci, ci]
    lib.gr_matmul_tower_smem.restype = ctypes.c_int64
    for fn in ("gr_matmul_simt_u32", "gr_matmul_tile", "gr_matmul_simt_grid",
               "gr_matmul_tc_limbs", "gr_matmul_tc_lift", "gr_matmul_tc_stack", "gr_matmul_tc_u32",
               "gr_matmul_tc_configs", "gr_matmul_tc_smem", "gr_matmul_tc_depth",
               "gr_matmul_tc_left_u32",
               "gr_matmul_tc_left_lift", "gr_matmul_tc_left_configs", "gr_matmul_tc_left_layout",
               "gr_matmul_tc_left_grid", "gr_matmul_tc_left_depth",
               "gr_matmul_skinny_u32", "gr_matmul_skinny_cols", "gr_matmul_skinny_configs",
               "gr_matmul_tower_u32", "gr_matmul_tower_configs"):
        getattr(lib, fn).restype = ci


def _compile(nvcc: str, so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs, procs = [], []
    for name in SOURCES:
        obj = tmp.with_name(f"{name}.{os.getpid()}.o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {name}.cu:\n{out[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


@contextlib.contextmanager
def _build_lock():
    """Exclusive inter-process lock on ``BUILD_DIR / "build.lock"``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash, in one process of all that ask at
    once) and load the kernels of ``SOURCES``."""
    lib = _libs.get(LIB_NAME)
    if lib is not None:
        return lib
    with _lock:
        if LIB_NAME in _libs:
            return _libs[LIB_NAME]
        h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        for name in SOURCES:
            h.update((CSRC_DIR / f"{name}.cu").read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        so = BUILD_DIR / f"lib{LIB_NAME}-{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        with _build_lock():
            built = not so.exists()
            if built:
                _compile(_nvcc(), so)
            lib = ctypes.CDLL(str(so))
        _declare(lib)
        _libs[LIB_NAME] = lib
        _info[LIB_NAME] = {
            "path": str(so),
            "built": built,
            "seconds": time.perf_counter() - t0,
            "sources": [f"{name}.cu" for name in SOURCES],
        }
        return lib


def library_configs(route: str, d0: int, d1: int) -> tuple:
    """The instantiations the built library has for ``route`` (``tc``:
    (bn, stages); ``tc_left``: (bn,), the same on every ring; ``skinny``:
    (threads, cm); ``tower``: (threads, tc, cpt)) on the tower (d0, d1),
    default first, as the library itself reports them."""
    lib = load_library()
    if route == "tc_left":
        n = lib.gr_matmul_tc_left_configs(None, 0)
        out = (ctypes.c_int * max(n, 1))()
        lib.gr_matmul_tc_left_configs(out, n)
        return tuple((out[i],) for i in range(n))
    fn, width = {"tc": (lib.gr_matmul_tc_configs, 2),
                 "skinny": (lib.gr_matmul_skinny_configs, 2),
                 "tower": (lib.gr_matmul_tower_configs, 3)}[route]
    n = fn(d0, d1, None, 0)
    out = (ctypes.c_int * (width * max(n, 1)))()
    fn(d0, d1, out, n)
    return tuple(tuple(out[width * i: width * (i + 1)]) for i in range(n))


def build_info() -> dict:
    """Where the library came from and how long loading (and building) took."""
    return dict(_info.get(LIB_NAME, {}))
