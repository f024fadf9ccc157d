"""Serving smoke: coalesce concurrent requests, check fill and the bits —
the port's counterpart of ``repro.serve.smoke``, on the card by default::

    python -m repro_torch.serve.smoke --workers 8 --size 1024
    python -m repro_torch.serve.smoke --workers 6 --size 64 --device cpu

It spawns a ``--workers``-process LocalPool, submits ``--requests``
concurrent same-shape requests through :class:`ServeScheduler`, and
asserts (a) the engine actually coalesced — mean batch fill > 1 under the
``"amortized"`` objective's decision — and (b) every per-request result is
bit-identical to the plain ``A @ B`` oracle (the plain version of the ring
matmul, never a kernel).  Exit code 0 = pass.

With ``--trace`` every request runs under a :mod:`repro_torch.obs` trace and the
last request's merged timeline (serve admission -> coalesce wait -> pool
encode/send -> per-worker compute -> any-R decode) is validated against
the span schema: non-empty, monotone span times, compute spans from at
least R responders.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch


def run_smoke(
    workers: int = 6,
    requests: int = 32,
    size: int = 128,
    wait_ms: float = 50.0,
    target_batch: int = 8,
    privacy_t: int = 0,
    seed: int = 0,
    trace: bool = False,
    device=None,
) -> int:
    from .. import obs
    from ..cdmm import ProblemSpec
    from ..core import make_ring
    from ..device import resolve_device
    from ..dist import LocalPool
    from ..kernels import gr_matmul_ref
    from . import CoalescePolicy, ServeScheduler

    device = resolve_device(device)
    if trace:
        obs.set_enabled(True)

    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(
        t=size, r=size, s=size, n=1, ring=Z32, N=workers,
        straggler_budget=1, privacy_t=privacy_t,
    )
    rng = np.random.default_rng(seed)
    pairs = [
        (Z32.random(rng, (size, size), device=device),
         Z32.random(rng, (size, size), device=device))
        for _ in range(requests)
    ]
    oracles = [gr_matmul_ref(A, B, Z32) for A, B in pairs]

    with LocalPool(workers=workers, device=device) as pool:
        policy = CoalescePolicy(
            target_batch_n=target_batch, max_wait_ms=wait_ms
        )
        with ServeScheduler(
            pool.master, policy, max_queue=requests, seed=seed
        ) as sched:
            entry = sched.entry_for(spec)
            print(f"pool up: {workers} workers on {device}; amortized plan: "
                  f"{entry.scheme.name} N={entry.scheme.N} "
                  f"R={entry.scheme.R} coalesce cap={entry.cap}")
            futs = [sched.submit(A, B, spec=spec) for A, B in pairs]
            results = [f.result(timeout=600) for f in futs]
            snap = sched.stats.snapshot()
            if trace:
                timeline = sched.trace(futs[-1])
                problems = obs.validate_timeline(
                    timeline.to_json(),
                    min_workers=entry.scheme.R,
                    require_components=("serve", "pool", "worker"),
                )
                if problems:
                    for p in problems:
                        print(f"FAIL trace: {p}")
                    return 1
                comps = sorted({s.component for s in timeline.spans})
                print(f"trace {timeline.trace_id}: {len(timeline.spans)} "
                      f"spans across components {comps}, "
                      f"{timeline.wall_s * 1e3:.0f} ms wall")

    bad = [i for i, (C, want) in enumerate(zip(results, oracles))
           if not torch.equal(C, want)]
    print(json.dumps({k: snap[k] for k in (
        "serve_submitted", "serve_completed", "serve_batches",
        "serve_coalesced_batches", "serve_mean_fill", "serve_total_pad",
        "serve_amortized_us_per_request", "serve_wait_ms_p50",
        "serve_wait_ms_p99",
    )}, indent=2))
    if bad:
        print(f"FAIL: {len(bad)}/{requests} results differ from the "
              f"A @ B oracle (first bad index: {bad[0]})")
        return 1
    if snap["serve_completed"] != requests:
        print(f"FAIL: {snap['serve_completed']}/{requests} requests "
              f"completed")
        return 1
    if snap["serve_mean_fill"] <= 1.0 or snap["serve_coalesced_batches"] < 1:
        print(f"FAIL: engine never coalesced (mean fill "
              f"{snap['serve_mean_fill']:.2f}, "
              f"{snap['serve_coalesced_batches']} coalesced batches)")
        return 1
    print(f"SERVE SMOKE OK: {requests} requests in {snap['serve_batches']} "
          f"batch jobs (mean fill {snap['serve_mean_fill']:.2f}), every "
          f"result bit-identical to the oracle")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--wait-ms", type=float, default=50.0)
    ap.add_argument("--target-batch", type=int, default=8)
    ap.add_argument("--privacy-t", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="trace every request and validate the last "
                         "request's merged span timeline")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine, the master and the "
                         "workers (default: the card)")
    args = ap.parse_args(argv)
    return run_smoke(args.workers, args.requests, args.size, args.wait_ms,
                     args.target_batch, args.privacy_t, args.seed,
                     trace=args.trace, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
