#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases (any mismatch fails the run with a non-zero exit):

1. environment and build: torch/CUDA versions, the card's name and power
   limit, the kernels built from ``src/repro_torch/kernels/csrc`` with nvcc
   (``-Xptxas -v`` registers and spills per instantiation of every route),
   and the Python mirrors of each route's tiles and instantiations held
   against the library;
2. every route of ``gr_matmul`` (``simt``, ``tc``, ``skinny``) and the tc
   route's limb pre-pass against their plain PyTorch versions on the card,
   bit for bit, on seven rings (K up to 45) at the shapes each route takes,
   batched and unbatched, and at every shape the main path hands the
   kernels; there each shape's route is timed in turns with ``simt``
   (replayed from CUDA graphs, so without the wrappers' host time), and
   every route at the edges of the dispatch rule is held and timed the same
   way.  The int8 yardstick (``torch._int_mm``, never called by the port) is
   timed from a CUDA graph too;
3. the main path through the user entry points: ``batch_ep_rmfe`` (n = 2,
   N = 8, u = v = 2, w = 1) over Z_2^32 at t = r = s = 2048 with two
   non-prefix stragglers, then ``ep``, ``plain``, ``ep_rmfe1`` and
   ``ep_rmfe2`` at 1024^3 through ``plan``, and a small ``ep`` request at
   96^3; then the GCSA and secure families over GR(2^32, 4) through
   ``plan(spec, schemes=[name])``: ``gcsa`` (n = 2) and ``ep_rmfe_secure``
   (n = 2, privacy_t = 1) at 2048^3, ``ep_secure`` (privacy_t = 1) and
   ``gcsa_general`` (n = 4) at 1024^3.  Every output must equal the direct
   product computed by the plain version.  Launch counts per route are
   zeroed before each path, read after it and held against the expected
   ones.  Stage device times are kept per run (5 warm runs each).  For the
   secure paths the keyed encode is checked on the card: a worker's own
   share equals its row of the master encode, a second key gives other
   shares and the same product, and the top bit of the drawn mask words is
   set in 50% +- 1% of them;
4. every route at every distinct (ring, shape) that phase 3 handed it,
   recorded as the paths ran, against the plain version on fresh operands of
   that shape, bit for bit (all batch slices of a worker launch included);
   the shapes of the GR(2^32, 4) paths are also timed as phase 2 times the
   main path's: the route in turns with ``simt`` from CUDA graphs, beside
   its bound, the plain version and, for ``tc``, the int8 yardstick.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  The full report (ptxas usage, every
timing) goes to ``--report`` (default ``build/chip_smoke.json``).  Without
a CUDA device, or without the repository around this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# dense int8 tensor-core operations, and uint32 multiply-adds on the CUDA
# cores (INT32 is half of the 128 FP32 lanes per SM: 132 SMs * 64 * 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
INT32_MAD_PER_S = 132 * 64 * 1.98e9

SEED = 0
MAIN_SIZE = 2048
SINGLE_SIZE = 1024
SMALL_SIZE = 96
# dead workers 2 and 5: the first R = 4 live workers are (0, 1, 3, 4), not a prefix
MASK = [True, True, False, True, True, False, True, True]
ROUTES = ("simt", "tc", "skinny")
# launches per route for one coded_matmul of each path (limbs: the tc
# route's pre-pass, two per tc launch); the ring matmuls of a round are the
# phi/psi packs, two encodes, one batched worker launch and one decode
EXPECTED_LAUNCHES = {
    # phi(A), phi(B), encode a/b, decode, psi -> skinny; workers -> tc
    "batch_ep_rmfe": {"simt": 0, "tc": 1, "skinny": 6, "limbs": 2},
    "ep": {"simt": 0, "tc": 1, "skinny": 3, "limbs": 2},
    "plain": {"simt": 0, "tc": 1, "skinny": 3, "limbs": 2},  # embedding is a copy
    "ep_rmfe1": {"simt": 0, "tc": 1, "skinny": 6, "limbs": 2},
    "ep_rmfe2": {"simt": 0, "tc": 1, "skinny": 5, "limbs": 2},  # A embedded, not packed
    # 96^3: worker blocks of 48 rows are below the tc threshold
    "ep_small": {"simt": 1, "tc": 0, "skinny": 3, "limbs": 0},
    # over GR(2^32, 4): encode a/b (one batched launch each for the kappa
    # groups of gcsa_general) and the one-matrix decode on skinny; masks are
    # drawn by torch.randint, not a ring matmul; embedding is a copy
    "gcsa": {"simt": 0, "tc": 1, "skinny": 3, "limbs": 2},
    "ep_rmfe_secure": {"simt": 0, "tc": 1, "skinny": 6, "limbs": 2},
    "ep_secure": {"simt": 0, "tc": 1, "skinny": 3, "limbs": 2},
    "gcsa_general": {"simt": 0, "tc": 1, "skinny": 3, "limbs": 2},
}
# the paths of the GCSA and secure families: (name, batch n, size,
# privacy_t), each planned with plan(spec, schemes=[name]); their kernel
# shapes are timed in phase 4
SLICE3_PATHS = [("gcsa", 2, MAIN_SIZE, 0), ("ep_rmfe_secure", 2, MAIN_SIZE, 1),
                ("ep_secure", 1, SINGLE_SIZE, 1), ("gcsa_general", 4, SINGLE_SIZE, 0)]
KEY = 20251017  # the secure paths' mask key; KEY + 1 is the second key
RING_SPECS = [(2, 32, ()), (2, 32, (3,)), (2, 32, (4,)), (2, 16, (5,)), (2, 8, (2, 3)),
              (2, 32, (16,)), (2, 32, (3, 5))]
# the shapes of tests/test_kernels.py, then extra shapes for the new routes:
# t, s >= 64 and an r that crosses the tc route's 256-deep flush chunk; and
# t, r <= 16 with ragged s for the skinny route
SHAPES = [(8, 8, 8), (16, 32, 8), (128, 128, 128), (7, 13, 5), (1, 64, 1), (130, 17, 129)]
TC_SHAPES = [(64, 64, 64), (96, 300, 160), (70, 520, 97)]
SKINNY_SHAPES = [(8, 2, 4099), (16, 16, 333), (4, 4, 1000), (2, 3, 12345)]
BATCHED = {"simt": (3, 9, 20, 11), "tc": (3, 33, 280, 65), "skinny": (3, 4, 5, 77)}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def u32(x):
    import torch

    return x.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((u32(a) - u32(b)).abs().max().item()) if a.numel() else 0


def cuda_ms(fn, iters: int = 1, warmup: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_runs_ms(fn, runs: int, warmup: int = 1) -> list:
    """Device time of each of ``runs`` runs of ``fn``, from CUDA events."""
    for _ in range(warmup):
        fn()
    return [cuda_ms(fn) for _ in range(runs)]


def graph_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph of ``iters``
    calls: the wrappers' host time (Python, ctypes; tens of µs) stays out of
    the measurement, which matters for kernels that take about as long."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as graphs require
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, iters=3) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, iters: int = 20) -> float:
    """Host time per call of ``fn`` (launch overhead), without waiting for
    the device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / iters


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

# ptxas entry names -> (route, template arguments)
_ENTRY = re.compile(r"Compiling entry function '.*?(gr_matmul_kernel|gr_matmul_tc_kernel|"
                    r"gr_matmul_skinny_kernel|limbs_rows_kernel|limbs_cols_kernel)ILi(\d+)E(?:Li(\d+)E)?")
_ROUTE_OF = {"gr_matmul_kernel": "simt", "gr_matmul_tc_kernel": "tc",
             "gr_matmul_skinny_kernel": "skinny", "limbs_rows_kernel": "limbs_rows",
             "limbs_cols_kernel": "limbs_cols"}


def phase_env_build(report: dict) -> None:
    import ctypes

    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels.build import BUILD_DIR, SOURCES, build_info, load_library
    from repro_torch.kernels.gr_matmul import (
        TC_TILE,
        kernel_tile,
        skinny_cols,
        tc_instantiated,
        tower_shape,
    )

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    report["card"] = smi
    report["device_name"] = torch.cuda.get_device_name(0)
    lib = load_library()
    info = build_info()
    log(f"kernel library {info['path']} built={info['built']} in {info['seconds']:.2f} s")
    report["build"] = info
    # registers / spills per instantiation, from nvcc -Xptxas -v of each source
    usage, cur = {}, None
    for name in SOURCES:
        ptxas = BUILD_DIR / f"{name}.ptxas.txt"
        for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
            m = _ENTRY.search(line)
            if m:
                args = ",".join(g for g in m.group(2, 3) if g)
                cur = f"{_ROUTE_OF[m.group(1)]}({args})"
                usage[cur] = {}
            elif cur:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    usage[cur]["spill_st"], usage[cur]["spill_ld"] = int(m.group(1)), int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    usage[cur]["regs"] = int(m.group(1))
    log("ptxas " + json.dumps(usage, separators=(",", ":")))
    report["ptxas"] = usage
    for route in ("simt", "tc", "skinny", "limbs_rows", "limbs_cols"):
        if not any(k.startswith(route + "(") for k in usage):
            fail(f"no ptxas report for the {route} kernels")
    # the library's own tile and instantiation choices must match the mirrors
    for spec in RING_SPECS:
        ring = make_ring(*spec)
        bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.gr_matmul_tile(*tower_shape(ring), bm, bn, bk) != 0:
            fail(f"no simt instantiation for {ring}")
        if (bm.value, bn.value, bk.value) != kernel_tile(ring):
            fail(f"simt tile mirror {kernel_tile(ring)} != library {(bm.value, bn.value, bk.value)}")
    towers = [(d, 1) for d in range(1, 17)] + [(2, 3), (2, 5), (2, 7), (3, 2), (3, 4), (3, 5),
                                                (4, 3), (5, 2), (5, 3), (7, 2)]
    for d0, d1 in towers:
        bm, bn, ks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        has_tc = lib.gr_matmul_tc_tile(d0, d1, bm, bn, ks) == 0
        if has_tc != tc_instantiated(d0, d1) or (has_tc and (bm.value, bn.value, ks.value) != TC_TILE):
            fail(f"tc mirror disagrees with the library for tower {(d0, d1)}")
        cols = lib.gr_matmul_skinny_cols(d0, d1)
        if (cols if cols > 0 else None) != skinny_cols(d0, d1):
            fail(f"skinny mirror {skinny_cols(d0, d1)} != library {cols} for tower {(d0, d1)}")
    report["instantiations"] = {
        "tc": [t for t in towers if tc_instantiated(*t)],
        "skinny": [t for t in towers if skinny_cols(*t)],
    }
    log(f"instantiations {json.dumps(report['instantiations'])}")
    # the library yardstick: PyTorch has no integer GEMM on CUDA
    a = torch.ones((4, 4), dtype=torch.int32, device="cuda")
    try:
        torch.mm(a, a)
        report["torch_mm_int32_cuda"] = "computed"
    except RuntimeError as exc:
        report["torch_mm_int32_cuda"] = f"raises: {str(exc).splitlines()[0][:160]}"
    log(f"torch.mm on int32 CUDA tensors: {report['torch_mm_int32_cuda']}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _main_path_shapes():
    """(ring degrees, batch, t, r, s) of every kernel call on the main path
    (batch_ep_rmfe at 2048^3, n = 2, N = 8, u = v = 2, w = 1)."""
    n, N, R, m, size = 2, 8, 4, 3, MAIN_SIZE
    half = size // 2
    return {
        "phi": ((), None, n, n, size * size),             # M_phi @ (n, t*r)
        "encode_a": ((3,), None, N, 2, half * size),      # Vf @ (uw, tb*rb)
        "encode_b": ((3,), None, N, 2, size * half),      # Vg @ (wv, rb*sb)
        "workers": ((3,), N, half, size, half),           # N x (tb, rb) @ (rb, sb)
        "decode": ((3,), None, R, R, half * half),        # M @ (R, tb*sb)
        "psi": ((), None, n, m, size * size),             # V_psi @ (m, t*s)
    }


def _accepts(route: str, ring, t: int, r: int) -> bool:
    """Whether ``route``'s kernel takes a (t, r) x (r, s) matmul over ``ring``."""
    from repro_torch.kernels.gr_matmul import (
        SKINNY_MAX_R,
        SKINNY_MAX_T,
        skinny_cols,
        tc_instantiated,
        tower_shape,
    )

    d0, d1 = tower_shape(ring)
    if route == "tc":
        return tc_instantiated(d0, d1)
    if route == "skinny":
        return bool(skinny_cols(d0, d1)) and 1 <= t <= SKINNY_MAX_T and 1 <= r <= SKINNY_MAX_R
    return True


def _bounds(ring, b, t, r, s):
    """(bytes_ms, int8_ms, int32_ms): the byte bound (interleaved int32
    operands read once, result written once) and the operation bounds of the
    same matmul on the int8 tensor cores (L(L+1)/2 byte products per word
    product) and as uint32 multiply-adds on the CUDA cores."""
    from repro_torch.kernels.ref import n_limbs

    L = n_limbs(ring)
    nbytes = 4 * ring.D * b * (t * r + r * s + t * s)
    int8_ops = 2 * b * t * s * r * ring.D ** 2 * L * (L + 1) // 2
    mads = b * t * s * (ring.D * ring.D * r + ring.K * ring.D)
    return (1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * int8_ops / INT8_OPS_PER_S,
            1e3 * mads / INT32_MAD_PER_S)


def _int8_yardstick_ms(ring, b, t, r, s):
    """One torch._int_mm (t x r) @ (r x s) int8 product on the card, times the
    number of limb products the tc route needs (b * D^2 * L(L+1)/2).  A
    yardstick of speed only: the port never calls torch._int_mm."""
    import torch

    from repro_torch.kernels.ref import n_limbs

    L = n_limbs(ring)
    a8 = torch.randint(-128, 127, (t, r), dtype=torch.int8, device="cuda")
    b8 = torch.randint(-128, 127, (s, r), dtype=torch.int8, device="cuda").t()
    try:  # replayed from a CUDA graph, like the routes it is set beside
        one = graph_ms(lambda: torch._int_mm(a8, b8))
    except RuntimeError as exc:
        return None, f"torch._int_mm raises: {str(exc).splitlines()[0][:120]}"
    n = b * ring.D ** 2 * L * (L + 1) // 2
    return one * n, f"{n} x torch._int_mm ({t}x{r} @ {r}x{s}) at {one:.4f} ms each"


def _hold(route, ring, A, B, worst: dict, what: str, plain=None) -> None:
    """Hold ``route`` on (A, B) against the plain version, bit for bit, and
    for ``tc`` its limb pre-pass against the pre-pass's plain version; the
    worst error of each goes into ``worst``."""
    from repro_torch.kernels import gr_matmul_ref, run_route
    from repro_torch.kernels.gr_matmul import tc_limbs, tc_padded
    from repro_torch.kernels.ref import limb_planes_ref

    shape = f"{tuple(A.shape[:-1])} x {tuple(B.shape[:-1])}"
    if plain is None:
        plain = gr_matmul_ref(A, B, ring)
    err = max_abs_err(run_route(route, A, B, ring), plain)
    worst[route] = max(worst[route], err)
    if err:
        fail(f"{route} != plain on {ring} at {shape}{what}: max abs err {err}")
    if route == "tc":
        Tp, Rp, Sp = tc_padded(A.shape[-3], A.shape[-2], B.shape[-2])
        A8, B8 = tc_limbs(A, B, ring)
        A3, B3 = (A, B) if A.dim() == 4 else (A[None], B[None])
        err = max(max_abs_err(A8, limb_planes_ref(A3, ring, Tp, Rp)),
                  max_abs_err(B8, limb_planes_ref(B3, ring, Sp, Rp, transpose=True)))
        worst["limbs"] = max(worst["limbs"], err)
        if err:
            fail(f"limb pre-pass != plain on {ring} at {shape}{what}: max abs err {err}")


def _timing_row(ring, A, B, route: str, plain_ms: float) -> dict:
    """Time ``route`` on (A, B) in turns with ``simt`` (simt, route, route,
    simt; replayed from CUDA graphs), eagerly and on the host, beside its
    bounds; for ``tc`` also its limb pre-pass and the int8 yardstick."""
    from repro_torch.kernels import run_route
    from repro_torch.kernels.gr_matmul import tc_limbs, tc_padded
    from repro_torch.kernels.ref import limb_planes_ref, n_limbs

    lead = A.dim() == 4
    b = A.shape[0] if lead else 1
    t, r, s = A.shape[-3], A.shape[-2], B.shape[-2]
    turns = [(rt, graph_ms(lambda rt=rt: run_route(rt, A, B, ring)))
             for rt in ("simt", route, route, "simt")]
    simt_ms = [m for rt, m in turns if rt == "simt"]
    route_ms = [m for rt, m in turns if rt == route]
    bytes_ms, int8_ms, int32_ms = _bounds(ring, b, t, r, s)
    row = {
        "route": route, "ms": sum(route_ms) / 2, "simt_ms": sum(simt_ms) / 2, "turns": turns,
        "plain_ms": plain_ms,
        # launched from Python in a loop: bounded below by the host time
        "eager_ms": cuda_ms(lambda: run_route(route, A, B, ring), iters=10, warmup=2),
        "host_us": host_us(lambda: run_route(route, A, B, ring)),
        "bound_ms": max(bytes_ms, int8_ms),
        "bound_by": "operations" if int8_ms >= bytes_ms else "bytes",
        "bytes_bound_ms": bytes_ms, "int8_bound_ms": int8_ms, "int32_bound_ms": int32_ms,
    }
    if route == "tc":
        Tp, Rp, Sp = tc_padded(t, r, s)
        L = n_limbs(ring)
        row["limbs_ms"] = graph_ms(lambda: tc_limbs(A, B, ring))
        limb_bytes = 4 * ring.D * b * (t * r + r * s) + b * ring.D * L * (Tp + Sp) * Rp
        row["limbs_bound_ms"] = 1e3 * limb_bytes / HBM_BYTES_PER_S
        A3, B3 = (A, B) if lead else (A[None], B[None])
        row["limbs_plain_ms"] = cuda_ms(lambda: (
            limb_planes_ref(A3, ring, Tp, Rp), limb_planes_ref(B3, ring, Sp, Rp, transpose=True)))
        row["int8_yardstick_ms"], row["int8_yardstick"] = _int8_yardstick_ms(ring, b, t, r, s)
    return row


def phase_kernels(report: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul_ref, pick_route

    rng = np.random.default_rng(SEED)
    worst = dict.fromkeys(ROUTES + ("limbs",), 0)
    checked = {r: [] for r in ROUTES}

    def check(route, ring, lead, t, r, s, what=""):
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        _hold(route, ring, A, B, worst, what)

    for spec in RING_SPECS:
        ring = make_ring(*spec)
        for route in ROUTES:
            extra = {"tc": TC_SHAPES, "skinny": SKINNY_SHAPES}.get(route, [])
            shapes = [x for x in SHAPES + extra if _accepts(route, ring, x[0], x[1])]
            if not shapes:
                continue
            for t, r, s in shapes:
                check(route, ring, (), t, r, s)
            nb, t, r, s = BATCHED[route]
            check(route, ring, (nb,), t, r, s, " (batched)")
            checked[route].append(f"{ring.degrees}:K={ring.K}:{len(shapes) + 1} shapes")
    for route in ROUTES:
        log(f"{route} == plain: {checked[route]}")

    timings = {}
    for name, (deg, nb, t, r, s) in _main_path_shapes().items():
        ring = make_ring(2, 32, deg)
        lead = (nb,) if nb else ()
        b = nb or 1
        route = pick_route(ring, t, r, s)
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        holder = {}
        plain_ms = cuda_ms(lambda: holder.__setitem__("C", gr_matmul_ref(A, B, ring)))
        plain = holder.pop("C")
        for rt in dict.fromkeys(("simt", route)):
            _hold(rt, ring, A, B, worst, f" (main-path shape {name})", plain=plain)
        del plain
        row = {"ring": str(ring.degrees), "batch": b, "t": t, "r": r, "s": s,
               **_timing_row(ring, A, B, route, plain_ms)}
        timings[name] = row
        log(f"main-path shape {name}: {json.dumps(row)}")
        del A, B
        torch.cuda.empty_cache()
    report["kernel_checks"] = checked
    report["kernel_max_abs_err"] = worst
    report["kernel_timings"] = timings
    report["thresholds"] = _threshold_timings(rng, worst)
    return timings


# shapes at the edges of the dispatch rule (ops.pick_route), over GR(2^32, 3):
# (batch, t, r, s); every route whose kernel takes the shape is timed
EDGE_SHAPES = {
    "skinny_t16": (None, 16, 16, 1 << 16),
    "simt_t17": (None, 17, 2, 1 << 20),
    "simt_t48": (8, 48, 96, 32),           # the worker product of ep at 96^3
    "tc_t64": (8, 64, 1024, 64),
    "tc_t128": (8, 128, 512, 128),
}


def _threshold_timings(rng, worst: dict) -> dict:
    """Each accepting route at each edge shape, held against the plain
    version and then timed in turns (a, b, ..., b, a), so that the
    thresholds of ops.pick_route rest on this run's numbers."""
    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul_ref, pick_route, run_route

    ring = make_ring(2, 32, (3,))
    out = {}
    for name, (nb, t, r, s) in EDGE_SHAPES.items():
        lead = (nb,) if nb else ()
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        routes = [rt for rt in ROUTES if _accepts(rt, ring, t, r)]
        plain = gr_matmul_ref(A, B, ring)
        for rt in routes:
            _hold(rt, ring, A, B, worst, f" (edge shape {name})", plain=plain)
        del plain
        order = routes + routes[::-1]
        ms = {rt: 0.0 for rt in routes}
        eager = {rt: 0.0 for rt in routes}
        for rt in order:
            fn = lambda rt=rt: run_route(rt, A, B, ring)
            ms[rt] += graph_ms(fn) / 2
            eager[rt] += cuda_ms(fn, iters=10, warmup=2) / 2
        # device time decides where a kernel dominates; eager time (launched
        # from Python, host overhead included) is what a small call costs
        row = {"shape": [nb or 1, t, r, s], "picked": pick_route(ring, t, r, s), "ms": ms,
               "eager_ms": eager, "fastest": min(ms, key=ms.get),
               "fastest_eager": min(eager, key=eager.get)}
        out[name] = row
        log(f"threshold {name}: {json.dumps(row)}")
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _direct(As, Bs, ring):
    """Oracle: direct products over the data ring by the plain version."""
    import torch

    from repro_torch.kernels import gr_matmul_ref

    if As.dim() == 4:
        return torch.stack([gr_matmul_ref(As[i], Bs[i], ring) for i in range(As.shape[0])])
    return gr_matmul_ref(As, Bs, ring)


@contextlib.contextmanager
def _recording_routes(calls: list):
    """Append (route, ring, A's shape, B's shape) of every ring matmul that
    ``ops.gr_matmul`` sends to a kernel to ``calls``, so that the kernels can
    be held against the plain version at exactly the shapes a path gave them."""
    from repro_torch.kernels import ops

    inner = ops.run_route

    def run_route(route, A, B, ring):
        calls.append((route, ring, tuple(A.shape), tuple(B.shape)))
        return inner(route, A, B, ring)

    ops.run_route = run_route
    try:
        yield
    finally:
        ops.run_route = inner


def _run_path(name, family, scheme_or_plan, A, B, mask, report, calls, key=None):
    """Drive one path through ``coded_matmul`` with the counts zeroed just
    before and read just after; returns (launches by route, the scheme, the
    direct product)."""
    import torch

    from repro_torch.cdmm import coded_matmul, decode_from, encode_all, live_indices
    from repro_torch.cdmm.planner import Plan
    from repro_torch.kernels import counters

    torch.cuda.synchronize()
    path_calls = []
    counters.reset()
    t0 = time.perf_counter()
    with _recording_routes(path_calls):
        C = coded_matmul(A, B, scheme_or_plan, backend="local", mask=mask, key=key, device="cuda")
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    by_route, ref_calls = dict(counters.launches_by_route), counters.ref_calls
    if ref_calls != 0:
        fail(f"{name}: {ref_calls} ring matmuls went to the plain version on the card")
    if by_route != EXPECTED_LAUNCHES[name]:
        fail(f"{name}: launches per route {by_route}, expected {EXPECTED_LAUNCHES[name]}")
    recorded = {rt: sum(c[0] == rt for c in path_calls) for rt in ROUTES}
    if any(recorded[rt] != by_route[rt] for rt in ROUTES):
        fail(f"{name}: recorded ring matmuls {recorded} != launches {by_route}")
    calls.extend((name,) + c for c in path_calls)
    scheme = (scheme_or_plan.instantiate(device="cuda")
              if isinstance(scheme_or_plan, Plan) else scheme_or_plan)
    expect = _direct(A, B, scheme.base)
    err = max_abs_err(C, expect)
    if err:
        fail(f"{name}: coded result != direct product (err {err})")
    # stage device times of 5 warm runs each (mean, and every run), through
    # the helpers the local backend uses
    idx = live_indices(scheme, torch.tensor(MASK, device="cuda"))
    st = {}
    stages = {}
    for stage, fn in [
        ("encode", lambda: st.__setitem__("enc", encode_all(scheme, A, B, key=key))),
        ("compute", lambda: st.__setitem__("H", scheme.worker_compute(*st["enc"]))),
        ("decode", lambda: st.__setitem__("C", decode_from(scheme, st["H"], idx))),
    ]:
        runs = cuda_runs_ms(fn, 5)
        stages[f"{stage}_ms"] = sum(runs) / len(runs)
        stages[f"{stage}_runs_ms"] = runs
    if max_abs_err(st["C"], expect):
        fail(f"{name}: staged run != direct product")
    row = {"path": name, "scheme": family, "partition": list(scheme.partition),
           "ring": str(scheme.ring), "R": scheme.R, "live": idx.tolist(), "shape": list(A.shape),
           "launches_by_route": by_route, "ref_calls": ref_calls,
           "first_call_wall_ms": wall_ms, **stages}
    if getattr(scheme, "kappa", None):
        row["kappa"] = scheme.kappa
    log(f"path {json.dumps(row)}")
    report.setdefault("paths", []).append(row)
    return by_route, scheme, expect


def _secure_checks(name, scheme, A, B, expect, report) -> None:
    """The keyed encode on the card: worker i's own share is row i of the
    master encode (both sides), a second key gives other shares and the
    same product, and the mask words are uniform in their top bit."""
    import torch

    from repro_torch.cdmm import coded_matmul, live_indices

    mask = torch.tensor(MASK, device="cuda")
    i = int(live_indices(scheme, mask)[2])  # a live worker, not worker 0
    FA, GB = scheme.encode_a(A, key=KEY), scheme.encode_b(B, key=KEY)
    if max_abs_err(scheme.encode_a_at(A, i, key=KEY), FA[i]) or \
            max_abs_err(scheme.encode_b_at(B, i, key=KEY), GB[i]):
        fail(f"{name}: encode_*_at(.., {i}, key) != row {i} of encode_*(.., key)")
    if torch.equal(scheme.encode_a(A, key=KEY + 1), FA) or \
            torch.equal(scheme.encode_b(B, key=KEY + 1), GB):
        fail(f"{name}: two keys gave the same shares")
    del FA, GB
    if max_abs_err(coded_matmul(A, B, scheme, mask=mask, key=KEY + 1, device="cuda"), expect):
        fail(f"{name}: the second key's product != direct product")
    code = scheme.code
    t, r = A.shape[-3], A.shape[-2]  # (n?, t, r, D0)
    Z = code.masks_a(KEY, t // code.u, r // code.w)
    words = Z.numel()
    top = (Z < 0).sum().item() / words  # int32 bit patterns: sign bit = word's top bit
    row = {"path": name, "worker": i, "mask_words": words, "mask_top_bit_share": top}
    if words < 10**6 or abs(top - 0.5) > 0.01:
        fail(f"{name}: mask top bit set in {top:.4f} of {words} words, not 0.5 +- 0.01")
    log(f"secure checks {json.dumps(row)}")
    report.setdefault("secure_checks", []).append(row)


def phase_main_path(report: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.cdmm import BatchRMFEAdapter, ProblemSpec, plan
    from repro_torch.core import make_ring

    rng = np.random.default_rng(SEED)
    Z32 = make_ring(2, 32, ())
    mask = torch.tensor(MASK, device="cuda")
    totals = dict.fromkeys(ROUTES + ("limbs",), 0)
    calls: list = []

    def add(by_route):
        for k, v in by_route.items():
            totals[k] += v

    As = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    Bs = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    scheme = BatchRMFEAdapter(Z32, n=2, N=8, u=2, v=2, w=1, device="cuda")
    add(_run_path("batch_ep_rmfe", "batch_ep_rmfe", scheme, As, Bs, mask, report, calls)[0])
    del As, Bs
    torch.cuda.empty_cache()

    for name, family, ring, size in [("ep", "ep", make_ring(2, 32, (3,)), SINGLE_SIZE),
                                     ("plain", "plain", Z32, SINGLE_SIZE),
                                     ("ep_rmfe1", "ep_rmfe1", Z32, SINGLE_SIZE),
                                     ("ep_rmfe2", "ep_rmfe2", Z32, SINGLE_SIZE),
                                     ("ep_small", "ep", make_ring(2, 32, (3,)), SMALL_SIZE)]:
        spec = ProblemSpec(size, size, size, n=1, ring=ring, N=8, straggler_budget=2)
        p = plan(spec, schemes=[family])
        A = ring.random(rng, (size, size), device="cuda")
        B = ring.random(rng, (size, size), device="cuda")
        add(_run_path(name, family, p, A, B, mask, report, calls)[0])
        del A, B
        torch.cuda.empty_cache()

    for name, n, size, privacy_t in SLICE3_PATHS:
        spec = ProblemSpec(size, size, size, n=n, ring=Z32, N=8, straggler_budget=2,
                           privacy_t=privacy_t)
        p = plan(spec, schemes=[name])
        lead = (n,) if n > 1 else ()
        A = Z32.random(rng, lead + (size, size), device="cuda")
        B = Z32.random(rng, lead + (size, size), device="cuda")
        key = KEY if privacy_t else None
        by_route, scheme, expect = _run_path(name, name, p, A, B, mask, report, calls, key=key)
        add(by_route)
        if scheme.ring.degrees != (4,):
            fail(f"{name}: planned over {scheme.ring}, expected GR(2^32, 4)")
        if privacy_t:
            _secure_checks(name, scheme, A, B, expect, report)
        del A, B, expect
        torch.cuda.empty_cache()
    report["main_path_launches"] = totals
    return totals, calls


def phase_path_calls(report: dict, calls: list) -> None:
    """Hold each route at every distinct (ring, shape) that phase 3 gave it,
    on fresh random operands of that shape, bit for bit: this covers every
    batch slice of a worker launch, the dead workers' ones too, which the
    end-to-end check cannot see because decode never reads them.  The
    shapes of the GCSA and secure paths are timed as well (``_timing_row``),
    with the plain version's time from the same call that holds them."""
    import numpy as np
    import torch

    from repro_torch.kernels import gr_matmul_ref

    rng = np.random.default_rng(SEED + 1)
    worst = report["kernel_max_abs_err"]
    slice3 = {name for name, *_ in SLICE3_PATHS}
    seen = {}
    for path, route, ring, a_shape, b_shape in calls:
        key = (route, ring.p, ring.e, ring.degrees, a_shape, b_shape)
        seen.setdefault(key, (ring, []))[1].append(path)
    timings = []
    for (route, _, _, _, a_shape, b_shape), (ring, paths) in seen.items():
        A = ring.random(rng, a_shape[:-1], device="cuda")
        B = ring.random(rng, b_shape[:-1], device="cuda")
        holder = {}
        plain_ms = cuda_ms(lambda: holder.__setitem__("C", gr_matmul_ref(A, B, ring)))
        plain = holder.pop("C")
        timed = bool(slice3.intersection(paths))
        for rt in dict.fromkeys(("simt", route) if timed else (route,)):
            _hold(rt, ring, A, B, worst, " (a phase-3 call)", plain=plain)
        del plain
        if timed:
            row = {"paths": sorted(set(paths)), "ring": str(ring.degrees),
                   "a": list(a_shape[:-1]), "b": list(b_shape[:-1]),
                   **_timing_row(ring, A, B, route, plain_ms)}
            timings.append(row)
            log(f"GR(2^32, 4) shape: {json.dumps(row)}")
        del A, B
        torch.cuda.empty_cache()
    report["path_calls_checked"] = [f"{k[0]} {k[3]} {k[4][:-1]} x {k[5][:-1]}" for k in seen]
    report["slice3_kernel_timings"] = timings
    log(f"phase-3 calls == plain: {len(calls)} launches at {len(seen)} distinct "
        f"(route, ring, shape): {report['path_calls_checked']}")


def _kernel_rows(report: dict, totals: dict) -> list:
    """The ``{"kernels": [...]}`` rows: one per route and one for the
    pre-pass, each at its representative main-path shape, with the times of
    every other timed shape of the route in ``per_shape_ms``."""
    t = report["kernel_timings"]
    w, enc = t["workers"], t["encode_a"]
    shape = lambda row: (f"{row['batch']} x ({row['t']}x{row['r']} @ {row['r']}x{row['s']}) "
                         f"over GR(2^32) degrees {row['ring']}")
    d4 = lambda route: {f"{'+'.join(x['paths'])} {x['a']} @ {x['b']} degrees {x['ring']}": x["ms"]
                        for x in report["slice3_kernel_timings"] if x["route"] == route}
    base = {"route": "cuda", "replaces": "src/repro/kernels/gr_matmul.py:40", "library_ms": None,
            "tolerance": 0}  # integer-exact: each kernel and its plain version agree bit for bit
    src = "src/repro_torch/kernels/csrc/"
    return [
        {**base, "name": "gr_matmul_simt", "source": src + "gr_matmul.cu",
         "launches": totals["simt"], "max_abs_err": report["kernel_max_abs_err"]["simt"],
         "ms": w["simt_ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
         "bound_by": w["bound_by"], "int32_bound_ms": w["int32_bound_ms"], "shape": shape(w)},
        {**base, "name": "gr_matmul_tc", "source": src + "gr_matmul_tc.cu",
         "launches": totals["tc"], "max_abs_err": report["kernel_max_abs_err"]["tc"],
         "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
         "bound_by": w["bound_by"], "int8_yardstick_ms": w["int8_yardstick_ms"],
         "simt_ms": w["simt_ms"], "shape": shape(w), "per_shape_ms": d4("tc")},
        {**base, "name": "gr_matmul_tc_limbs", "source": src + "gr_matmul_tc.cu",
         "launches": totals["limbs"], "max_abs_err": report["kernel_max_abs_err"]["limbs"],
         "ms": w["limbs_ms"], "plain_ms": w["limbs_plain_ms"], "bound_ms": w["limbs_bound_ms"],
         "bound_by": "bytes", "shape": shape(w)},
        {**base, "name": "gr_matmul_skinny", "source": src + "gr_matmul_skinny.cu",
         "launches": totals["skinny"], "max_abs_err": report["kernel_max_abs_err"]["skinny"],
         "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
         "bound_by": enc["bound_by"], "simt_ms": enc["simt_ms"], "shape": shape(enc),
         "per_shape_ms": {**{k: v["ms"] for k, v in t.items() if v["route"] == "skinny"},
                          **d4("skinny")}},
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where to write the full JSON report")
    args = ap.parse_args()
    csrc = SRC / "repro_torch" / "kernels" / "csrc"
    if not all((csrc / f).is_file() for f in ("gr_matmul.cu", "gr_matmul_tc.cu", "gr_matmul_skinny.cu")):
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    report: dict = {}
    t0 = time.perf_counter()
    phase_env_build(report)
    phase_kernels(report)
    totals, calls = phase_main_path(report)
    for route in ROUTES + ("limbs",):
        if totals[route] == 0:
            fail(f"the main path never launched the {route} kernel")
    phase_path_calls(report, calls)
    report["seconds"] = time.perf_counter() - t0
    kernels = _kernel_rows(report, totals)
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(report, indent=1, default=str))
    log(f"total {report['seconds']:.1f} s; report in {args.report}")
    log(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
