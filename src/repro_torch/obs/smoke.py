"""Telemetry-plane smoke: scrape a live pool mid-load, then hedge a
parked straggler and check the bits — the port's counterpart of
``repro.obs.smoke``, on the port's pool (on the card by default)::

    python -m repro_torch.obs.smoke --workers 4
    python -m repro_torch.obs.smoke --workers 4 --device cpu

It spawns a ``--workers``-process LocalPool with the embedded admin
server on an ephemeral port and gates, in order:

1. **mid-load scrape** — with every worker parked and a zero-slack
   request in flight, ``GET /metrics`` must pass the strict exposition
   parser (:func:`repro_torch.obs.parse_prometheus`) and carry one
   ``pool_worker_health{wid=...}`` gauge per worker, ``/healthz`` must
   answer ok, and ``/stats`` must serve the merged JSON snapshot;
2. **hedged straggler** — one worker's compute stays parked on a scheme
   with R == N (every share needed); with ``hedge_factor=2`` the overdue
   share must actually re-ship (``stats.hedged >= 1``), the decode must
   equal the ``A @ B`` oracle bit for bit, and the hedge counters must
   surface in the next ``/stats`` scrape;
3. **trace plane** — a traced request's timeline must come back over
   ``GET /trace/<trace_id>`` in both canonical span JSON and Chrome
   ``trace_event`` form;
4. **dashboard** — ``repro_torch.obs.top --once`` must render a frame from the
   same ``/stats`` endpoint.

Exit code 0 = pass.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request
from typing import Optional

import numpy as np
import torch


def _fetch_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read().decode())


def run_smoke(
    workers: int = 4,
    size: int = 32,
    delay_ms: float = 400.0,
    seed: int = 0,
    device=None,
) -> int:
    from .. import obs
    from ..cdmm import ProblemSpec, coded_matmul, plan
    from ..core import make_ring
    from ..device import resolve_device
    from ..dist import LocalPool, PoolConfig
    from ..dist.smoke import _scrape_obs
    from . import http as obs_http
    from . import top as obs_top

    device = resolve_device(device)

    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(
        t=size, r=size, s=size, n=1, ring=Z32, N=workers,
        straggler_budget=0,
    )
    # zero slack: the candidate with the LARGEST R (== N), so one parked
    # worker stalls the decode until its share is hedged to a spare
    p = plan(spec, objective="threshold")
    rank = max(range(len(p.candidates)), key=lambda i: p.candidates[i].costs.R)
    scheme = p.instantiate(rank, device=device)
    if not (scheme.R == scheme.N == workers):
        print(f"FAIL: no zero-slack scheme at N={workers} "
              f"(got R={scheme.R}, N={scheme.N})")
        return 1
    rng = np.random.default_rng(seed)
    A = Z32.random(rng, (size, size), device=device)
    B = Z32.random(rng, (size, size), device=device)
    oracle = coded_matmul(A, B, scheme, backend="local")

    cfg = PoolConfig(workers=workers).with_(obs_http_port=0)
    with LocalPool(config=cfg, device=device) as pool:
        master = pool.master
        url = obs_http.server().url
        print(f"pool up: {workers} workers, scheme {scheme.name} "
              f"N={scheme.N} R={scheme.R}, admin plane {url}")

        # warm: every worker's first product, then purge the warm-up
        # round-trips and re-seed the hedge window at steady state
        master.hedge_factor = 0.0
        for _ in range(3):
            master.execute(scheme, A, B)
        master.health.clear_window()
        for _ in range(2):
            master.execute(scheme, A, B)

        # -- 1. scrape mid-load: all workers parked, request in flight ----
        for wid in master.live_workers():
            master.task_delay_ms[wid] = delay_ms
        result: dict = {}

        def _request():
            try:
                result["C"], result["stats"] = master.execute(scheme, A, B)
            except Exception as e:
                result["err"] = e

        t = threading.Thread(target=_request)
        t.start()
        time.sleep(delay_ms / 4e3)
        problems = _scrape_obs(url, min_workers=workers)
        stats_doc = _fetch_json(f"{url}/stats")
        for key in ("pool_requests", "pool_workers_live",
                    "pool_worker_health_by_wid"):
            if key not in stats_doc:
                problems.append(f"/stats missing {key}")
        health = stats_doc.get("pool_worker_health_by_wid")
        if isinstance(health, dict) and len(health) < workers:
            problems.append(
                f"/stats has {len(health)} worker health scores, "
                f"expected {workers}"
            )
        if problems:
            for msg in problems:
                print(f"FAIL obs: {msg}")
            return 1
        print(f"mid-load scrape OK: {url}/metrics parsed strictly, "
              f"/healthz ok, /stats has {workers} worker health scores")
        master.task_delay_ms.clear()
        t.join(timeout=120)
        if "err" in result:
            print(f"FAIL: mid-load request raised {result['err']!r}")
            return 1
        if not torch.equal(result["C"], oracle):
            print("FAIL: mid-load decode != oracle")
            return 1

        # -- 2. hedged straggler: parked share must re-ship and decode ----
        # the all-parked mid-load round-trips (~delay_ms each) dominate
        # the hedge window now; purge and re-seed at steady state so the
        # p95-derived deadline sits well under the injected park
        master.health.clear_window()
        for _ in range(2):
            master.execute(scheme, A, B)
        victim = master.live_workers()[0]
        master.task_delay_ms[victim] = delay_ms
        try:
            master.health.reset_scores()  # round-robin is blind again
            master.hedge_factor = 2.0
            C_hedged, st = master.execute(scheme, A, B)
        finally:
            master.hedge_factor = 0.0
            master.task_delay_ms.pop(victim, None)
        if not torch.equal(C_hedged, oracle):
            print("FAIL: hedged decode != oracle")
            return 1
        if st.hedged < 1:
            print(f"FAIL: straggler parked {delay_ms} ms but no share "
                  f"was hedged (time_to_R {st.time_to_R_ms:.0f} ms)")
            return 1
        hedged_total = _fetch_json(f"{url}/stats").get("pool_hedged", 0)
        if not hedged_total:
            print("FAIL: /stats pool_hedged still 0 after a hedged race")
            return 1
        print(f"hedged straggler OK: {st.hedged} share(s) re-shipped, "
              f"time-to-R {st.time_to_R_ms:.0f} ms vs {delay_ms:.0f} ms "
              f"park, decode bit-identical")

        # -- 3. trace plane: /trace/<id> in both formats ------------------
        obs.set_enabled(True)
        try:
            ctx = obs.TraceContext.new("obs-smoke")
            C_traced, _ = master.execute(scheme, A, B, trace=ctx)
        finally:
            obs.set_enabled(None)
        if not torch.equal(C_traced, oracle):
            print("FAIL: traced decode != oracle")
            return 1
        doc = _fetch_json(f"{url}/trace/{ctx.trace_id}")
        if not doc.get("spans"):
            print(f"FAIL: /trace/{ctx.trace_id} returned no spans")
            return 1
        chrome = _fetch_json(f"{url}/trace/{ctx.trace_id}?format=chrome")
        events = chrome.get("traceEvents", chrome)
        if not events:
            print("FAIL: chrome trace export is empty")
            return 1
        print(f"trace plane OK: {len(doc['spans'])} spans over HTTP, "
              f"{len(events)} chrome trace events")

        # -- 4. dashboard: one rendered frame from /stats -----------------
        if obs_top.main(["--url", url, "--once"]) != 0:
            print("FAIL: repro_torch.obs.top --once could not render a frame")
            return 1
    print(f"METRICS SMOKE OK: scrape + hedge + trace + top over {url}")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--delay-ms", type=float, default=400.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the master and the workers "
                         "(default: the card)")
    args = ap.parse_args(argv)
    return run_smoke(args.workers, args.size, args.delay_ms, args.seed,
                     device=args.device)


if __name__ == "__main__":
    sys.exit(main())
