"""``python -m repro_torch.obs.top`` — live terminal dashboard over
``/stats``; the port's copy of ``repro.obs.top``.

Polls the admin HTTP plane (:mod:`repro_torch.obs.http`) of a running pool /
serving engine and renders a compact refresh-in-place view: request and
byte *rates* (differenced between polls), latency quantiles, hedging
and re-dispatch counters, and one row per worker with its live health
score (the same ``pool_worker_health`` gauge Prometheus scrapes).

Usage::

    python -m repro_torch.obs.top --url http://127.0.0.1:9100
    python -m repro_torch.obs.top --url ... --once          # one frame, no clear
    python -m repro_torch.obs.top --url ... --iterations 5  # bounded run (tests)

Stdlib only (urllib + json); exits non-zero when the endpoint never
answers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

__all__ = ["fetch_stats", "main", "render"]

# counters whose per-second rate is the interesting number
_RATES = (
    ("pool_requests", "req/s"),
    ("pool_completed", "done/s"),
    ("pool_bytes_out", "tx B/s"),
    ("pool_bytes_in", "rx B/s"),
    ("serve_submitted", "serve req/s"),
    ("serve_completed", "serve done/s"),
)


def fetch_stats(url: str, timeout: float = 5.0) -> Dict[str, object]:
    with urllib.request.urlopen(f"{url}/stats", timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _fmt(value: object) -> str:
    if isinstance(value, float):
        return f"{value:,.1f}"
    if isinstance(value, int):
        return f"{value:,}"
    return str(value)


def _bar(score: float, width: int = 20) -> str:
    filled = max(0, min(width, int(round(score * width))))
    return "#" * filled + "." * (width - filled)


def render(
    snap: Dict[str, object],
    prev: Optional[Tuple[float, Dict[str, object]]] = None,
    now: Optional[float] = None,
) -> str:
    """One dashboard frame (pure text; the caller decides how to paint).

    ``prev`` is ``(t, snapshot)`` of the previous poll, used to difference
    cumulative counters into rates; rates render as ``-`` on the first
    frame.
    """
    now = time.time() if now is None else now
    lines: List[str] = []
    live = snap.get("pool_workers_live", "-")
    lines.append(
        f"repro_torch.obs.top  {time.strftime('%H:%M:%S', time.localtime(now))}"
        f"  workers live: {_fmt(live)}"
    )

    dt = None
    if prev is not None and now > prev[0]:
        dt = now - prev[0]
    rate_bits = []
    for key, label in _RATES:
        cur = snap.get(key)
        if not isinstance(cur, (int, float)):
            continue
        if dt is None or not isinstance(prev[1].get(key), (int, float)):
            rate_bits.append(f"{label} -")
        else:
            rate_bits.append(f"{label} {(cur - prev[1][key]) / dt:,.1f}")
    if rate_bits:
        lines.append("  " + "   ".join(rate_bits))

    totals = []
    for key in (
        "pool_requests", "pool_completed", "pool_failed",
        "pool_redispatched", "pool_hedged", "pool_hedge_wasted",
        "serve_batches", "serve_mean_fill", "scheduler_completed",
    ):
        val = snap.get(key)
        if isinstance(val, (int, float)):
            totals.append(f"{key.split('_', 1)[1]}={_fmt(val)}")
    if totals:
        lines.append("  " + "  ".join(totals))

    lats = []
    for key in (
        "pool_time_to_R_ms_p50", "pool_time_to_R_ms_p99",
        "pool_wall_ms_p50", "pool_wall_ms_p99", "serve_wait_ms_p50",
        "serve_wait_ms_p99", "pool_share_ms_window_p95",
    ):
        val = snap.get(key)
        if isinstance(val, (int, float)):
            lats.append(f"{key[len('pool_'):] if key.startswith('pool_') else key}"
                        f"={val:,.2f}")
    if lats:
        lines.append("  " + "  ".join(lats))

    health = snap.get("pool_worker_health_by_wid")
    tasks = snap.get("pool_worker_tasks_done_by_wid") or {}
    if isinstance(health, dict) and health:
        lines.append("  worker  health                speed  tasks")
        for wid in sorted(health, key=lambda w: (len(w), w)):
            score = float(health[wid])
            done = tasks.get(wid, "-") if isinstance(tasks, dict) else "-"
            lines.append(
                f"  {wid:>6}  [{_bar(score)}] {score:5.2f}  {_fmt(done):>5}"
            )
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--url", default="http://127.0.0.1:9100",
        help="admin-plane base URL (see REPRO_OBS_HTTP_PORT)",
    )
    ap.add_argument("--interval", type=float, default=1.0, metavar="SECONDS")
    ap.add_argument(
        "--once", action="store_true",
        help="print a single frame and exit (no screen clearing)",
    )
    ap.add_argument(
        "--iterations", type=int, default=0, metavar="N",
        help="stop after N frames (0 = run until interrupted)",
    )
    args = ap.parse_args(argv)
    prev: Optional[Tuple[float, Dict[str, object]]] = None
    frames = 0
    while True:
        try:
            snap = fetch_stats(args.url)
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"repro_torch.obs.top: cannot scrape {args.url}/stats: {e}",
                  file=sys.stderr)
            return 1
        now = time.time()
        frame = render(snap, prev, now=now)
        if args.once:
            print(frame)
            return 0
        # ANSI clear + home keeps the frame in place without curses
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        prev = (now, snap)
        frames += 1
        if args.iterations and frames >= args.iterations:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
