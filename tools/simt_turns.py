#!/usr/bin/env python3
"""Time the ``simt`` route of two trees in turns on one card, shape by shape.

    python3 tools/simt_turns.py BASE [--report PATH] [--out PATH]

BASE is a checkout whose ``simt`` is the planar kernel (its
``src/repro_torch/kernels/csrc/gr_matmul.cu`` exports
``gr_matmul_planar_u32``), for example the parent commit unpacked with
``git archive``.  That source is built alone with nvcc and run as that
tree's ``ops.run_route("simt", ...)`` ran it: planar copies of both
operands, then the kernel.  The other side is this tree's ``simt``
(``kernels.gr_matmul.gr_matmul_simt``, built with the port's kernels).
Each shape is held bit for bit (this tree's ``simt`` against the base's on
the same operands) and timed from CUDA graphs in turns, base, this, this,
base.

The shapes: every (ring, A, B) that phase 4 of ``chip_smoke.py`` timed,
read from its report (``--report``, ``path_kernel_timings`` and the main
path's ``kernel_timings``), or, without one, the calls of ``SHAPES``
below.  Prints one JSON line a shape (both times, the ratio, this tree's
grid) and, last, the count of shapes where this tree is slower.  Needs a
CUDA card; imports neither jax nor the JAX package.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (ring degrees, batch, t, r, s) timed without a report: CodedQuantMatmul's
# decode-size worker products over GR(2^32, 4), ep's 96^3 workers, and the
# main path's 2048^3 workers over GR(2^32, 3)
SHAPES = [((4,), 16, 1, 1152, 4608), ((4,), 16, 4, 1152, 4608), ((4,), 16, 16, 1152, 4608),
          ((4,), 16, 1, 4608, 1152), ((4,), 16, 4, 4608, 1152), ((4,), 16, 16, 4608, 1152),
          ((3,), 8, 48, 96, 32), ((3,), 8, 1024, 2048, 1024)]
# a call is replayed from a CUDA graph of 10 launches, or of GRAPH_WORDS //
# (its word products) down to 1 (chip_smoke.py's rule)
GRAPH_WORDS = 2e11


def _shapes(report: Path):
    if report is None:
        return SHAPES
    data = json.loads(report.read_text())
    out = []
    for row in data.get("path_kernel_timings", []):
        deg = tuple(int(x) for x in row["ring"].strip("()").split(",") if x.strip())
        a, b = row["a"], row["b"]
        out.append((deg, a[0] if len(a) == 3 else 1, a[-2], a[-1], b[-1]))
    for row in data.get("kernel_timings", {}).values():
        deg = tuple(int(x) for x in row["ring"].strip("()").split(",") if x.strip())
        out.append((deg, row["batch"], row["t"], row["r"], row["s"]))
    return list(dict.fromkeys(out))


def _build_base(base: Path) -> ctypes.CDLL:
    """The base tree's simt source alone, built with the port's nvcc flags."""
    from repro_torch.kernels.build import ARCH_FLAGS, NVCC_FLAGS, _nvcc

    so = ROOT / "build" / "simt_base" / "libsimt_base.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    src = base / "src" / "repro_torch" / "kernels" / "csrc" / "gr_matmul.cu"
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-shared", "-o", str(so), str(src)]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gr_matmul_planar_u32.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                         ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, vp]
    lib.gr_matmul_planar_u32.restype = ci
    return lib


def _graph_ms(fn, iters: int) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="checkout whose simt is the planar kernel")
    ap.add_argument("--report", type=Path, help="chip_smoke.py's report: time its phase-4 shapes")
    ap.add_argument("--out", type=Path, help="also write every row's JSON here")
    args = ap.parse_args()
    import numpy as np
    import torch

    from repro_torch.core.galois import make_ring
    from repro_torch.kernels.gr_matmul import (
        _check_layout,
        _mask,
        gr_matmul_simt,
        simt_grid,
        tower_shape,
    )

    if not torch.cuda.is_available():
        print("simt_turns: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = _build_base(args.base.resolve())
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def base_simt(A, B, ring):  # the base tree's run_route("simt", ...)
        Ap, Bp = A.movedim(-1, -3).contiguous(), B.movedim(-1, -3).contiguous()
        nb, D, T, R = Ap.shape
        C = torch.empty((nb, D, T, Bp.shape[-1]), dtype=torch.int32, device=A.device)
        err = lib.gr_matmul_planar_u32(Ap.data_ptr(), Bp.data_ptr(), C.data_ptr(), nb, T, R,
                                       Bp.shape[-1], *tower_shape(ring), _check_layout(ring)[1],
                                       _mask(ring), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"base simt launch failed: cudaError {err}")
        return C.movedim(-3, -1)

    rng = np.random.default_rng(0)
    rows = []
    for deg, b, t, r, s in _shapes(args.report):
        ring = make_ring(2, 32, deg)
        A = ring.random(rng, (b, t, r), device="cuda")
        B = ring.random(rng, (b, r, s), device="cuda")
        if not torch.equal(gr_matmul_simt(A, B, ring), base_simt(A, B, ring)):
            print(f"simt_turns: the two trees' simt differ at {deg} {(b, t, r, s)}",
                  file=sys.stderr)
            return 1
        iters = int(min(10, max(1, GRAPH_WORDS // (b * t * r * s * ring.D ** 2))))
        turns = {"base": [], "this": []}
        for side in ("base", "this", "this", "base"):
            fn = base_simt if side == "base" else gr_matmul_simt
            turns[side].append(_graph_ms(lambda fn=fn: fn(A, B, ring), iters))
        row = {"ring": list(deg), "shape": [b, t, r, s], "base_ms": sum(turns["base"]) / 2,
               "this_ms": sum(turns["this"]) / 2, "turns": turns,
               "grid": simt_grid(ring, b, t, r, s, sms)}
        row["base_over_this"] = row["base_ms"] / row["this_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del A, B
        torch.cuda.empty_cache()
    slower = [row["shape"] for row in rows if row["this_ms"] > row["base_ms"]]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(json.dumps({"shapes": len(rows), "slower_here": slower}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
