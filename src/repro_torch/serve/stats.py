"""ServeStats: the observability surface of the continuous-batching engine
— the port's copy of ``repro.serve.stats``, the same snapshot schema.

Everything the latency/throughput policy trades off is counted here so the
trade is inspectable while the engine runs: how full the coalesced batches
actually are (per-batch fill and padded slots), how long requests waited
for peers (a fixed-bucket wait-time histogram — admission-to-execution,
so queue time is never hidden), and what a request effectively costs once
batch execution is amortized over its fill (``amortized_us_per_request``).

Snapshots follow the shared :mod:`repro_torch.stats` schema — ``serve_``-
prefixed counters plus the ``serve_wait_ms_hist`` / ``serve_wait_ms_p50``
/ ``serve_wait_ms_p99`` triple from :class:`repro_torch.stats.Histogram`
(legacy unprefixed keys resolve with a one-time deprecation warning) —
so they merge cleanly with the pool
master's and scheduler's snapshots via :func:`repro_torch.stats.merge_snapshots`
(``python -m repro_torch.launch.serve --stats-every`` prints the
merged view).
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Sequence, Tuple

from ..obs.metrics import MetricsRegistry
from ..stats import StatsSnapshot

__all__ = ["ServeStats", "WAIT_BUCKETS_MS"]

# upper edges (ms) of the wait-time histogram; the last bucket is open
WAIT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    math.inf,
)

RECENT_BATCHES = 64  # bounded per-batch log (spec label, fill, pad, wall)


class ServeStats:
    """Thread-safe counters + histograms for one serving engine.

    Registry-backed: every bump lands in a live
    :class:`repro_torch.obs.metrics.MetricsRegistry` (the same numbers the
    HTTP ``/metrics``/``/stats`` plane scrapes continuously), and the
    legacy attribute reads (``stats.completed``) resolve to the live
    counter values.
    """

    _COUNTERS = (
        "submitted", "rejected", "completed", "failed", "timed_out",
        "cancelled", "batches", "coalesced_batches", "total_fill",
        "total_pad", "plan_cache_hits", "plan_cache_misses",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()  # guards the recent-batch deque
        self.metrics = MetricsRegistry("serve")
        for name, doc in (
            ("submitted", "requests admitted"),
            ("rejected", "requests shed at the bounded admission queue"),
            ("completed", "requests resolved with a product"),
            ("failed", "requests that raised"),
            ("timed_out", "requests that spent their deadline"),
            ("cancelled", "requests cancelled before dispatch"),
            ("batches", "batch jobs executed"),
            ("coalesced_batches", "batch jobs with fill > 1"),
            ("total_fill", "request slots served across all batches"),
            ("total_pad", "RMFE slots padded with zeros (wasted packing)"),
            ("plan_cache_hits", "serving decisions answered from cache"),
            ("plan_cache_misses", "serving decisions planned fresh"),
        ):
            self.metrics.counter(name, doc)
        self._counters = {
            name: self.metrics.counter(name) for name in self._COUNTERS
        }
        # summed master wall-clock of batch jobs (float counter)
        self._exec_wall = self.metrics.counter(
            "exec_wall_ms", "summed master wall-clock of batch jobs (ms)"
        )
        self.wait_ms = self.metrics.histogram(
            "wait_ms", "admission -> execution wait (ms)",
            bounds=WAIT_BUCKETS_MS,
        )
        self.metrics.gauge("mean_fill", "mean requests per executed batch")
        self.recent: "deque" = deque(maxlen=RECENT_BATCHES)

    # -- recording ---------------------------------------------------------

    def bump(self, name: str, by: int = 1) -> None:
        self._counters[name].inc(by)

    def record_batch(
        self,
        label: str,
        fill: int,
        pad: int,
        wall_ms: float,
        waits_ms: Sequence[float],
    ) -> None:
        """One executed batch job: ``fill`` requests served, ``pad`` zero
        slots, master wall-clock, and each member's admission->execute wait."""
        self.bump("batches")
        if fill > 1:
            self.bump("coalesced_batches")
        self.bump("total_fill", fill)
        self.bump("total_pad", pad)
        self._exec_wall.inc(wall_ms)
        with self._lock:
            self.recent.append(
                {"spec": label, "fill": fill, "pad": pad,
                 "wall_ms": round(wall_ms, 3)}
            )
        for w in waits_ms:
            self.wait_ms.observe(w)

    # -- reading -----------------------------------------------------------

    def __getattr__(self, name: str):
        # legacy attribute reads resolve to the live counter values;
        # __getattr__ only fires for names missing from __dict__
        counters = self.__dict__.get("_counters") or {}
        if name in counters:
            return counters[name].value
        if name == "exec_wall_ms":
            exec_wall = self.__dict__.get("_exec_wall")
            if exec_wall is not None:
                return exec_wall.value
        raise AttributeError(name)

    def snapshot(self) -> StatsSnapshot:
        """Every counter plus the derived serving signals (mean fill,
        wait quantiles, amortized us/request) in the shared repro_torch.stats
        schema (``serve_``-prefixed keys; the legacy unprefixed names
        resolve with one DeprecationWarning).  Safe to call from any
        thread at any time."""
        batches = self._counters["batches"].value
        total_fill = self._counters["total_fill"].value
        exec_ms = float(self._exec_wall.value)
        self.metrics.gauge("mean_fill").set(
            total_fill / batches if batches else 0.0
        )
        with self._lock:
            recent = list(self.recent)
        snap = self.metrics.snapshot(extra={
            "amortized_us_per_request": (
                exec_ms * 1e3 / total_fill if total_fill else None
            ),
            "recent_batches": recent,
        })
        snap["serve_exec_wall_ms"] = round(exec_ms, 3)
        return snap
