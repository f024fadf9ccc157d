"""Pool smoke: spawn a local pool, kill workers mid-request, check the bits
— the port's counterpart of ``repro.dist.smoke``, on the card by default::

    python -m repro_torch.dist.smoke --workers 6 --kill 2
    python -m repro_torch.dist.smoke --workers 4 --kill 1 --device cpu

It spawns a ``--workers``-process LocalPool, plans a scheme under a
straggler budget, parks every worker's compute long enough for the kill to
land provably mid-request, SIGKILLs ``--kill`` workers while the request
is in flight, and asserts the decoded product still equals the plain
``A @ B`` oracle bit for bit (the plain version of the ring matmul, never
a kernel).  Exit code 0 = pass.

With ``--trace`` the killed request runs under a :mod:`repro_torch.obs` trace
and the merged timeline is validated against the span schema: non-empty,
monotone span times, per-worker compute spans from at least R responders,
and — when workers were killed — a re-dispatched send span proving the
dead worker's share moved.  ``--trace-out PATH`` additionally writes the
timeline in Chrome ``trace_event`` format (load via chrome://tracing).

With ``--obs-http`` the pool starts its embedded admin server on an
ephemeral port and the smoke scrapes ``/metrics`` *while the killed
request is in flight*, gating on the strict exposition parser
(:func:`repro_torch.obs.parse_prometheus`) plus a ``/healthz`` liveness check
— the acceptance oracle for the live telemetry plane.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch


def _scrape_obs(url: str, min_workers: int) -> list:
    """Scrape /metrics and /healthz of a live pool; returns problems."""
    import json
    import urllib.request

    from ..obs import parse_prometheus

    problems = []
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
        text = resp.read().decode()
    try:
        families = parse_prometheus(text)
    except ValueError as e:
        return [f"/metrics failed strict parsing: {e}"]
    health = [
        s for fam in families.values() for s in fam["samples"]
        if s[0] == "repro_pool_worker_health"
    ]
    if len(health) < min_workers:
        problems.append(
            f"/metrics has {len(health)} pool_worker_health samples, "
            f"expected >= {min_workers}"
        )
    for name in ("repro_pool_requests", "repro_pool_workers_live"):
        if name not in families:
            problems.append(f"/metrics missing family {name}")
    if "repro_pool_wall_ms" in families:
        if families["repro_pool_wall_ms"]["type"] != "histogram":
            problems.append("repro_pool_wall_ms is not a histogram family")
    else:
        problems.append("/metrics missing family repro_pool_wall_ms")
    with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
        doc = json.loads(resp.read().decode())
    if not doc.get("ok"):
        problems.append(f"/healthz not ok: {doc}")
    if "pool" not in doc.get("sources", []):
        problems.append(f"/healthz lists no pool source: {doc}")
    return problems


def run_smoke(
    workers: int = 6,
    kill: int = 1,
    size: int = 32,
    delay_ms: float = 400.0,
    seed: int = 0,
    trace: bool = False,
    trace_out: str = "",
    obs_http: bool = False,
    device=None,
) -> int:
    from .. import obs
    from ..cdmm import ProblemSpec, coded_matmul, plan
    from ..core import make_ring
    from ..device import resolve_device
    from ..kernels import gr_matmul_ref
    from . import LocalPool, PoolBackend, PoolConfig

    device = resolve_device(device)
    if trace:
        obs.set_enabled(True)

    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(
        t=size, r=size, s=size, n=1, ring=Z32, N=workers,
        straggler_budget=max(kill, 1),
    )
    # tightest feasible code: the candidate with the LARGEST R still inside
    # the budget, so killing N - R workers leaves exactly R responders and
    # the any-R property is exercised with zero slack
    p = plan(spec, objective="threshold")
    rank = max(range(len(p.candidates)), key=lambda i: p.candidates[i].costs.R)
    scheme = p.instantiate(rank, device=device)
    rng = np.random.default_rng(seed)
    A = Z32.random(rng, (size, size), device=device)
    B = Z32.random(rng, (size, size), device=device)
    oracle = gr_matmul_ref(A, B, Z32)

    cfg = PoolConfig(workers=workers)
    if obs_http:
        cfg = cfg.with_(obs_http_port=0)  # ephemeral admin port
    with LocalPool(config=cfg, device=device) as pool:
        caps = pool.master.worker_caps()
        print(f"pool up: {len(caps)} workers on {device}, scheme {scheme.name} "
              f"N={scheme.N} R={scheme.R} over {scheme.ring}")
        be = PoolBackend(pool)
        # warm round: every worker builds its ring closure before the race
        warm = coded_matmul(A, B, scheme, backend=be)
        if not torch.equal(warm, oracle):
            print("FAIL: warm-up decode != oracle")
            return 1
        # park every worker so the kill lands mid-compute, then race it
        for wid in pool.master.live_workers():
            pool.master.task_delay_ms[wid] = delay_ms
        result: dict = {}
        ctx = None
        if trace:
            ctx = obs.TraceContext.new("smoke")

        def _request():
            try:
                if ctx is not None:
                    # explicit context so the smoke can fetch the timeline
                    # by trace_id after the race resolves
                    result["C"], result["stats"] = pool.master.execute(
                        scheme, A, B, trace=ctx
                    )
                else:
                    result["C"] = coded_matmul(A, B, scheme, backend=be)
            except Exception as e:  # surfaced below
                result["err"] = e

        t = threading.Thread(target=_request)
        t.start()
        time.sleep(delay_ms / 4e3)  # tasks dispatched, workers parked
        if obs_http:
            # scrape mid-load: the request is in flight, workers parked
            from ..obs import http as obs_http_mod

            url = obs_http_mod.server().url
            problems = _scrape_obs(url, min_workers=scheme.R)
            if problems:
                for p in problems:
                    print(f"FAIL obs: {p}")
                return 1
            print(f"obs scrape OK mid-request: {url}/metrics parsed "
                  f"strictly, /healthz ok")
        killed = pool.kill(kill)
        print(f"SIGKILLed {len(killed)} worker(s) mid-request: pids {killed}")
        t.join(timeout=120)
        if t.is_alive():
            print("FAIL: request did not complete after the kill")
            return 1
        if "err" in result:
            print(f"FAIL: request raised {result['err']!r}")
            return 1
        if not torch.equal(result["C"], oracle):
            print("FAIL: post-kill decode != oracle")
            return 1
        stats = result.get("stats", be.last_stats)
        print(f"decoded from shares {stats.live_idx} "
              f"({stats.redispatched} re-dispatched) in {stats.wall_ms:.0f} ms "
              f"with {pool.alive_count()}/{workers} workers alive")
        if ctx is not None:
            timeline = obs.tracer().timeline(ctx.trace_id)
            problems = obs.validate_timeline(
                timeline.to_json(),
                min_workers=scheme.R,
                require_components=("pool", "worker"),
            )
            sends = [s for s in timeline.spans if s.name == "send"]
            if kill and not any(s.tags.get("redispatch") for s in sends):
                problems.append(
                    f"{kill} worker(s) killed but no redispatched send span"
                )
            if problems:
                for p in problems:
                    print(f"FAIL trace: {p}")
                return 1
            lanes = {
                s.tags.get("wid") for s in timeline.spans
                if s.name == "compute"
            }
            print(f"trace {timeline.trace_id}: {len(timeline.spans)} spans, "
                  f"{timeline.wall_s * 1e3:.0f} ms wall, compute lanes "
                  f"{sorted(lanes)}, {sum(s.tags.get('redispatch', False) for s in sends)}"
                  f" redispatched send span(s)")
            if trace_out:
                with open(trace_out, "w") as f:
                    f.write(obs.to_chrome_trace(timeline, indent=1))
                print(f"chrome trace_event JSON written to {trace_out}")
    print("POOL SMOKE OK: decode bit-identical to the oracle after "
          f"{kill} mid-request SIGKILL(s)")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--kill", type=int, default=1)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--delay-ms", type=float, default=400.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="trace the killed request and validate the "
                         "merged span timeline")
    ap.add_argument("--trace-out", default="",
                    help="write the timeline as Chrome trace_event JSON")
    ap.add_argument("--obs-http", action="store_true",
                    help="start the embedded admin server and gate on a "
                         "strict /metrics parse mid-request")
    ap.add_argument("--device", default=None,
                    help="torch device of the master and the workers "
                         "(default: the card; cpu runs the plain version)")
    args = ap.parse_args(argv)
    return run_smoke(args.workers, args.kill, args.size, args.delay_ms,
                     args.seed, trace=args.trace, trace_out=args.trace_out,
                     obs_http=args.obs_http, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
