"""Per-worker health scoring from master-observed timing signals —
counterpart of ``repro.obs.health`` (jax-free).

The master already *sees* everything a health score needs: when each
share was sent, when its result landed (round-trip = comm + compute),
and when heartbeats arrive.  :class:`HealthTracker` folds those into two
EWMA signals per worker —

- ``rtt``: EWMA of share round-trip milliseconds (send -> result at the
  master, so a slow network path scores the same as a slow CPU);
- ``jitter``: EWMA of the absolute deviation of heartbeat inter-arrival
  times from their own EWMA (a worker whose heartbeats stutter is
  struggling even if it hasn't missed the death deadline yet);

— and normalizes each against the *pool median*, so "healthy" means
"like your peers", not an absolute number that would need per-hardware
tuning.  The score is

    score(wid) = min(1, median_rtt / rtt) * min(1, median_jitter / jitter)

clamped to (0, 1]; a worker with no data yet scores 1.0 (innocent until
measured).  The master surfaces scores as ``pool_worker_health{wid=...}``
gauges and consumes them twice: dispatch ordering (shares go to workers
scoring >= :data:`DISPATCH_THRESHOLD` first) and the speculative hedge
deadline — :meth:`hedge_deadline_ms` is the p95 of a retention-windowed
:class:`~repro_torch.obs.metrics.Series` of *pool-wide* share round-trips
times the caller's hedge factor, so "outstanding suspiciously long"
is defined by recent measured behaviour, not a static timeout.

Locking: the tracker has exactly one internal lock and calls nothing
that takes another, so callers may invoke it while holding their own
locks without ordering concerns (the master does not — it reads scores
before taking its dispatch lock).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from .metrics import DEFAULT_RETENTION_S, Series

__all__ = ["DISPATCH_THRESHOLD", "HealthTracker"]

# workers scoring below this are dispatched to only when no healthier
# worker is live (they still serve: slow != dead, and the any-R decode
# may yet need their shares)
DISPATCH_THRESHOLD = 0.5

_EPS_MS = 1e-3  # jitter floor so a perfectly steady worker divides cleanly

# the hedge sweep polls far faster than the share window changes shape;
# re-sorting up to 4096 round-trips per poll is pure overhead, so the
# deadline quantile is cached this long
_QUANTILE_TTL_S = 0.05


class _WorkerSignals:
    __slots__ = ("rtt_ewma", "hb_last", "hb_interval_ewma", "jitter_ewma",
                 "samples")

    def __init__(self):
        self.rtt_ewma: Optional[float] = None
        self.hb_last: Optional[float] = None
        self.hb_interval_ewma: Optional[float] = None
        self.jitter_ewma: Optional[float] = None
        self.samples = 0


def _ewma(prev: Optional[float], value: float, alpha: float) -> float:
    return value if prev is None else (1 - alpha) * prev + alpha * value


def _median(vals: Sequence[float]) -> Optional[float]:
    vals = sorted(vals)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


class HealthTracker:
    """EWMA share-RTT + heartbeat-jitter health per worker id."""

    def __init__(
        self,
        alpha: float = 0.2,
        retention_s: float = DEFAULT_RETENTION_S,
        min_hedge_samples: int = 8,
    ):
        self.alpha = float(alpha)
        self.min_hedge_samples = int(min_hedge_samples)
        self._lock = threading.Lock()
        self._workers: Dict[int, _WorkerSignals] = {}
        # pool-wide share round-trips, retention-windowed: the hedge
        # deadline quantile reads this, so it tracks recent behaviour
        self.share_ms = Series("share_ms", retention_s=retention_s)
        # q -> (t, quantile, window_len): hedge sweeps hit this instead of
        # re-sorting the window on every event-loop poll
        self._q_cache: Dict[float, tuple] = {}

    # -- recording ---------------------------------------------------------

    def _signals(self, wid: int) -> _WorkerSignals:
        # caller holds the lock
        sig = self._workers.get(wid)
        if sig is None:
            sig = self._workers[wid] = _WorkerSignals()
        return sig

    def record_share(self, wid: int, rtt_ms: float) -> None:
        """One share answered: master-observed send->result round-trip."""
        with self._lock:
            sig = self._signals(wid)
            sig.rtt_ewma = _ewma(sig.rtt_ewma, float(rtt_ms), self.alpha)
            sig.samples += 1
        self.share_ms.add(float(rtt_ms))

    def record_heartbeat(self, wid: int, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            sig = self._signals(wid)
            if sig.hb_last is not None:
                interval = t - sig.hb_last
                if sig.hb_interval_ewma is not None:
                    dev = abs(interval - sig.hb_interval_ewma) * 1e3
                    sig.jitter_ewma = _ewma(
                        sig.jitter_ewma, dev, self.alpha
                    )
                sig.hb_interval_ewma = _ewma(
                    sig.hb_interval_ewma, interval, self.alpha
                )
            sig.hb_last = t

    def forget(self, wid: int) -> None:
        """Worker left the pool: drop its signals (a rejoin starts clean)."""
        with self._lock:
            self._workers.pop(wid, None)

    def reset_scores(self) -> None:
        """Forget per-worker EWMAs but keep the pooled share series.

        The cold-straggler seam for benchmarks: scores return to 1.0 (so
        round-robin dispatch is blind again) while the hedge deadline
        still knows what a normal round-trip costs.
        """
        with self._lock:
            self._workers.clear()

    def clear_window(self) -> None:
        """Drop the pooled share round-trip window (and its quantile
        cache).  Benchmarks call this after a compile-storm warmup so
        the hedge deadline reflects steady-state round-trips only."""
        self.share_ms.clear()
        with self._lock:
            self._q_cache.clear()

    # -- scoring -----------------------------------------------------------

    def scores(self) -> Dict[int, float]:
        """``{wid: score}`` for every worker with any recorded signal."""
        with self._lock:
            rtts = {
                w: s.rtt_ewma for w, s in self._workers.items()
                if s.rtt_ewma is not None
            }
            jitters = {
                w: s.jitter_ewma for w, s in self._workers.items()
                if s.jitter_ewma is not None
            }
            wids = list(self._workers)
        med_rtt = _median(list(rtts.values()))
        med_jit = _median(list(jitters.values()))
        out: Dict[int, float] = {}
        for wid in wids:
            score = 1.0
            rtt = rtts.get(wid)
            if rtt is not None and med_rtt is not None and rtt > 0:
                score *= min(1.0, med_rtt / rtt)
            jit = jitters.get(wid)
            if jit is not None and med_jit is not None:
                score *= min(1.0, (med_jit + _EPS_MS) / (jit + _EPS_MS))
            out[wid] = max(score, 1e-6)
        return out

    def score(self, wid: int) -> float:
        return self.scores().get(wid, 1.0)

    def ranked(self, wids: Sequence[int]) -> List[int]:
        """``wids`` reordered healthiest-first (stable for ties, so the
        all-healthy pool keeps its round-robin order)."""
        scores = self.scores()
        return sorted(wids, key=lambda w: -scores.get(w, 1.0))

    # -- hedge deadline ----------------------------------------------------

    def hedge_deadline_ms(
        self,
        factor: float,
        q: float = 0.95,
        min_ms: float = 1.0,
    ) -> Optional[float]:
        """How long a share may stay outstanding before it is hedged:
        ``p95(recent share round-trips) * factor``.

        None (never hedge) when ``factor`` <= 0 or fewer than
        ``min_hedge_samples`` round-trips are in the retention window —
        hedging on no evidence would re-ship everything during warmup.
        """
        if factor <= 0:
            return None
        now = time.monotonic()
        with self._lock:
            cached = self._q_cache.get(q)
        if cached is not None and now - cached[0] < _QUANTILE_TTL_S:
            _, p, n = cached
        else:
            n = len(self.share_ms)
            p = self.share_ms.quantile(q)
            with self._lock:
                self._q_cache[q] = (now, p, n)
        if n < self.min_hedge_samples or p is None:
            return None
        return max(float(min_ms), p * float(factor))
