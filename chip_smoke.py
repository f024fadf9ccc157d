#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases (any mismatch fails the run with a non-zero exit):

1. environment and build: torch/CUDA versions, the card's name and power
   limit, the kernel built from ``src/repro_torch/kernels/csrc`` with nvcc
   (``-Xptxas -v`` registers and spills per instantiation);
2. the ``gr_matmul`` kernel against its plain PyTorch version on the card,
   bit for bit, on the rings and shapes of ``tests/test_kernels.py`` plus
   K = 31 and K = 45 towers and every shape the main path hands the kernel;
3. the main path through the user entry points: ``batch_ep_rmfe`` (n = 2,
   N = 8, u = v = 2, w = 1) over Z_2^32 at t = r = s = 2048 with two
   non-prefix stragglers, then ``ep``, ``plain``, ``ep_rmfe1`` and
   ``ep_rmfe2`` at 1024^3 through ``plan``; every output must equal the
   direct product computed by the plain version.  Kernel launch counts are
   zeroed before each path and read after it.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  The full report (ptxas usage, every
timing) goes to ``--report`` (default ``build/chip_smoke.json``).  Without
a CUDA device, or without the repository around this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# and uint32 multiply-adds on the CUDA cores (INT32 is half of the 128 FP32
# lanes per SM: 132 SMs * 64 lanes * 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9

SEED = 0
MAIN_SIZE = 2048
SINGLE_SIZE = 1024
# dead workers 2 and 5: the first R = 4 live workers are (0, 1, 3, 4), not a prefix
MASK = [True, True, False, True, True, False, True, True]
# in-envelope ring matmuls per coded_matmul: phi/psi packs, two encodes, one
# batched worker launch, one decode
EXPECTED_LAUNCHES = {
    "batch_ep_rmfe": 7,  # phi(A), phi(B), encode a/b, workers, decode, psi
    "ep": 4,             # encode a/b, workers, decode
    "plain": 4,          # embedding is a copy, not a matmul
    "ep_rmfe1": 7,       # phi(A blocks), phi(B blocks), encode a/b, workers, decode, psi
    "ep_rmfe2": 6,       # A embedded; phi1(B), encode a/b, workers, decode, psi1
}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def u32(x):
    import torch

    return x.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a, b) -> int:
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


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_env_build(report: dict) -> None:
    import torch

    from repro_torch.kernels.build import BUILD_DIR, build_info, load_library

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
    # registers / spills per instantiation, from nvcc -Xptxas -v
    ptxas = (BUILD_DIR / "gr_matmul.ptxas.txt")
    usage, cur = {}, None
    for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
        m = re.search(r"Compiling entry function '.*?gr_matmul_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            cur = f"({m.group(1)},{m.group(2)})"
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
    # the library's own tile choice must match the Python mirror
    import ctypes

    from repro_torch.core import make_ring
    from repro_torch.kernels.gr_matmul import kernel_tile, tower_shape

    for deg in [(), (3,), (4,), (5,), (2, 3), (16,), (3, 5)]:
        ring = make_ring(2, 32, deg)
        bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.gr_matmul_tile(*tower_shape(ring), bm, bn, bk) != 0:
            fail(f"no kernel instantiation for {ring}")
        if (bm.value, bn.value, bk.value) != kernel_tile(ring):
            fail(f"tile mirror {kernel_tile(ring)} != library {(bm.value, bn.value, bk.value)}")
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


def phase_kernels(report: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul, gr_matmul_ref

    rng = np.random.default_rng(SEED)
    rings = [make_ring(2, 32, ()), make_ring(2, 32, (3,)), make_ring(2, 32, (4,)),
             make_ring(2, 16, (5,)), make_ring(2, 8, (2, 3)),
             make_ring(2, 32, (16,)), make_ring(2, 32, (3, 5))]
    shapes = [(8, 8, 8), (16, 32, 8), (128, 128, 128), (7, 13, 5), (1, 64, 1),
              (130, 17, 129)]
    checked, worst = [], 0
    for ring in rings:
        for t, r, s in shapes:
            A = ring.random(rng, (t, r), device="cuda")
            B = ring.random(rng, (r, s), device="cuda")
            err = max_abs_err(gr_matmul(A, B, ring), gr_matmul_ref(A, B, ring))
            worst = max(worst, err)
            if err:
                fail(f"kernel != plain on {ring} at {(t, r, s)}: max abs err {err}")
        # a batched launch (grid z) on every ring too
        A = ring.random(rng, (3, 9, 20), device="cuda")
        B = ring.random(rng, (3, 20, 11), device="cuda")
        err = max_abs_err(gr_matmul(A, B, ring), gr_matmul_ref(A, B, ring))
        worst = max(worst, err)
        if err:
            fail(f"batched kernel != plain on {ring}: max abs err {err}")
        checked.append(f"{ring.degrees}:K={ring.K}")
    log(f"kernel == plain on {len(rings)} rings x {len(shapes) + 1} shapes: {checked}")

    timings = {}
    for name, (deg, nb, t, r, s) in _main_path_shapes().items():
        ring = make_ring(2, 32, deg)
        lead = (nb,) if nb else ()
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        out = gr_matmul(A, B, ring)
        plain_holder = {}
        plain_ms = cuda_ms(lambda: plain_holder.__setitem__("C", gr_matmul_ref(A, B, ring)))
        err = max_abs_err(out, plain_holder.pop("C"))
        worst = max(worst, err)
        if err:
            fail(f"kernel != plain at main-path shape {name}: max abs err {err}")
        ms = cuda_ms(lambda: gr_matmul(A, B, ring), iters=10, warmup=2)
        b = nb or 1
        mads = b * t * s * (ring.D * ring.D * r + ring.K * ring.D)
        nbytes = 4 * ring.D * b * (t * r + r * s + t * s)
        t_ops, t_bytes = 1e3 * mads / INT32_MAD_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S
        timings[name] = {
            "ring": str(ring.degrees), "batch": b, "t": t, "r": r, "s": s,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        log(f"main-path shape {name}: {json.dumps(timings[name])}")
        del A, B, out
        torch.cuda.empty_cache()
    report["kernel_checks"] = checked
    report["kernel_max_abs_err"] = worst
    report["kernel_timings"] = timings
    return timings


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


def _run_path(name, scheme_or_plan, A, B, mask, report):
    import torch

    from repro_torch.cdmm import coded_matmul, decode_from, encode_all, live_indices
    from repro_torch.cdmm.planner import Plan
    from repro_torch.kernels import counters

    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    C = coded_matmul(A, B, scheme_or_plan, backend="local", mask=mask, device="cuda")
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches, ref_calls = counters.launches, counters.ref_calls
    if ref_calls != 0:
        fail(f"{name}: {ref_calls} ring matmuls went to the plain version on the card")
    if launches != EXPECTED_LAUNCHES[name]:
        fail(f"{name}: {launches} kernel launches, expected {EXPECTED_LAUNCHES[name]}")
    scheme = (scheme_or_plan.instantiate(device="cuda")
              if isinstance(scheme_or_plan, Plan) else scheme_or_plan)
    expect = _direct(A, B, scheme.base)
    err = max_abs_err(C, expect)
    if C.shape != expect.shape or err:
        fail(f"{name}: coded result != direct product (shape {tuple(C.shape)}, err {err})")
    # stage times (second run, warm): the same helpers the local backend uses
    idx = live_indices(scheme, torch.tensor(MASK, device="cuda"))
    stages = {}
    st = {}
    stages["encode_ms"] = cuda_ms(lambda: st.__setitem__("enc", encode_all(scheme, A, B)))
    stages["compute_ms"] = cuda_ms(lambda: st.__setitem__("H", scheme.worker_compute(*st["enc"])))
    stages["decode_ms"] = cuda_ms(lambda: st.__setitem__("C", decode_from(scheme, st["H"], idx)))
    if max_abs_err(st["C"], expect):
        fail(f"{name}: staged run != direct product")
    row = {"scheme": name, "partition": list(scheme.partition), "ring": str(scheme.ring),
           "R": scheme.R, "live": idx.tolist(), "shape": list(A.shape),
           "launches": launches, "ref_calls": ref_calls,
           "first_call_wall_ms": wall_ms, **stages}
    log(f"path {json.dumps(row)}")
    report.setdefault("paths", []).append(row)
    return launches


def phase_main_path(report: dict) -> int:
    import numpy as np
    import torch

    from repro_torch.cdmm import BatchRMFEAdapter, ProblemSpec, plan
    from repro_torch.core import make_ring

    rng = np.random.default_rng(SEED)
    Z32 = make_ring(2, 32, ())
    mask = torch.tensor(MASK, device="cuda")
    As = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    Bs = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    scheme = BatchRMFEAdapter(Z32, n=2, N=8, u=2, v=2, w=1, device="cuda")
    main_launches = _run_path("batch_ep_rmfe", scheme, As, Bs, mask, report)
    del As, Bs
    torch.cuda.empty_cache()

    for name, ring in [("ep", make_ring(2, 32, (3,))), ("plain", Z32),
                       ("ep_rmfe1", Z32), ("ep_rmfe2", Z32)]:
        spec = ProblemSpec(SINGLE_SIZE, SINGLE_SIZE, SINGLE_SIZE, n=1, ring=ring,
                           N=8, straggler_budget=2)
        p = plan(spec, schemes=[name])
        A = ring.random(rng, (SINGLE_SIZE, SINGLE_SIZE), device="cuda")
        B = ring.random(rng, (SINGLE_SIZE, SINGLE_SIZE), device="cuda")
        _run_path(name, p, A, B, mask, report)
        del A, B
        torch.cuda.empty_cache()
    return main_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where to write the full JSON report")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "gr_matmul.cu").is_file():
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
    timings = phase_kernels(report)
    main_launches = phase_main_path(report)
    report["seconds"] = time.perf_counter() - t0

    w = timings["workers"]
    kernels = [{
        "name": "gr_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gr_matmul.cu",
        "replaces": "src/repro/kernels/gr_matmul.py:40",
        "launches": main_launches,
        "max_abs_err": report["kernel_max_abs_err"],
        "tolerance": 0,  # integer-exact: kernel and plain version must agree bit for bit
        "ms": w["ms"],
        "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"],
        "library_ms": None,
        "shape": f"{w['batch']} x ({w['t']}x{w['r']} @ {w['r']}x{w['s']}) over GR(2^32,3)",
        "checked": report["kernel_checks"],
    }]
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
