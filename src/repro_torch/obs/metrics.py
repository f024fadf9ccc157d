"""Live metrics registry: cheap in-line recording, scrape-shaped reads —
counterpart of ``repro.obs.metrics`` (jax-free; same snapshot schema).

Before this module, every runtime surface kept its own ad-hoc counter
dict behind its own lock and materialized numbers only when someone
called ``snapshot()`` — pull-only observability.  The registry inverts
that: ``Master``, ``PoolScheduler`` and ``ServeScheduler`` each own a
:class:`MetricsRegistry` and record into typed instruments *as events
happen* (a counter ``inc`` is one lock + one add), and ``snapshot()``
becomes a cheap read of state that already exists — the same numbers the
HTTP plane (``repro_torch.obs.http``) serves continuously at ``/metrics``
and ``/stats``.

Instruments:

- :class:`Counter` — monotone float/int accumulator (``inc``);
- :class:`Gauge` — last-write-wins scalar, optionally *labeled*
  (``gauge("worker_health", label="wid")`` snapshots as a
  ``worker_health_by_wid`` dict, which the Prometheus exporter turns
  into one ``{wid="..."}``-labeled sample per key);
- histograms are :class:`repro_torch.stats.Histogram` — the shared
  ``*_hist``/``*_p50``/``*_p99``/``*_sum`` schema, so registry
  snapshots merge with legacy ones via ``merge_snapshots``;
- :class:`Series` — a ring buffer of ``(t, value)`` observations with a
  retention window, for *windowed* quantiles over recent behaviour
  (the health tracker's hedge deadline is ``series.quantile(0.95)``
  over the last few minutes of share round-trips, not over the whole
  process lifetime).

``snapshot()`` emits the component-prefixed :class:`repro_torch.stats`
schema, so everything downstream (``merge_snapshots``, ``--stats-every``
consumers, the Prometheus exporter) works unchanged.  The snapshot also
carries per-key type and doc maps (``_types`` / ``_docs`` attributes)
that :func:`repro_torch.obs.export.to_prometheus` consults for ``# TYPE`` /
``# HELP`` lines.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..stats import BUCKETS_MS, Histogram, StatsSnapshot, namespaced

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "Series",
]

DEFAULT_RETENTION_S = 300.0  # series window when REPRO_OBS_RETENTION unset
DEFAULT_SERIES_CAP = 4096  # hard bound per series regardless of window


class Counter:
    """Monotone accumulator.  ``inc`` is the hot-path call: one lock, one
    add — cheap enough to live inline in dispatch/result paths."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, by: float = 1) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            v = self._value
        # counters bumped only by ints stay ints in snapshots
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins scalar, optionally labeled.

    A plain gauge snapshots as ``{name: value}``.  A labeled gauge
    (``label="wid"``) snapshots as ``{f"{name}_by_{label}": {key: value}}``
    — the ``_by_<label>`` convention the Prometheus exporter unpacks into
    one labeled sample per key (``repro_pool_worker_health{wid="0"} ...``).
    """

    def __init__(self, name: str, label: Optional[str] = None):
        self.name = name
        self.label = label
        self._value: Optional[float] = None
        self._labeled: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, key: Optional[object] = None) -> None:
        with self._lock:
            if key is None:
                self._value = value
            else:
                if self.label is None:
                    raise ValueError(
                        f"gauge {self.name!r} was not declared with a label"
                    )
                self._labeled[str(key)] = value

    def clear_labels(self, keep: Sequence[object] = ()) -> None:
        """Drop labeled entries not in ``keep`` (dead workers leave the
        health gauge instead of freezing at their last score)."""
        keepset = {str(k) for k in keep}
        with self._lock:
            self._labeled = {
                k: v for k, v in self._labeled.items() if k in keepset
            }

    def snapshot_items(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {}
            if self._value is not None:
                out[self.name] = self._value
            if self.label is not None:
                out[f"{self.name}_by_{self.label}"] = dict(self._labeled)
        return out


class Series:
    """Ring buffer of ``(t, value)`` observations with a retention window.

    ``quantile(q)`` answers over the retained window only — "p95 share
    round-trip over the last five minutes", not over process lifetime —
    which is what a hedge deadline must track when worker behaviour
    drifts.  Bounded twice: by ``retention_s`` (old points pruned on
    every add/read) and ``capacity`` (hard memory cap).
    """

    def __init__(
        self,
        name: str,
        retention_s: float = DEFAULT_RETENTION_S,
        capacity: int = DEFAULT_SERIES_CAP,
    ):
        self.name = name
        self.retention_s = float(retention_s)
        self._points: "deque" = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, value: float, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._points.append((t, float(value)))
            self._prune(t)

    def _prune(self, now: float) -> None:
        # caller holds the lock
        horizon = now - self.retention_s
        while self._points and self._points[0][0] < horizon:
            self._points.popleft()

    def clear(self) -> None:
        """Drop every retained point (e.g. discard compile-storm warmup
        round-trips so windowed quantiles reflect steady state only)."""
        with self._lock:
            self._points.clear()

    def values(self, window_s: Optional[float] = None) -> List[float]:
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            pts = list(self._points)
        if window_s is not None:
            pts = [p for p in pts if p[0] >= now - window_s]
        return [v for _, v in pts]

    def __len__(self) -> int:
        with self._lock:
            self._prune(time.monotonic())
            return len(self._points)

    def quantile(
        self, q: float, window_s: Optional[float] = None
    ) -> Optional[float]:
        vals = sorted(self.values(window_s))
        if not vals:
            return None
        idx = min(len(vals) - 1, max(0, int(q * len(vals))))
        return vals[idx]


class MetricsRegistry:
    """One component's instruments, snapshotting in the shared schema.

    Get-or-create accessors (``counter``/``gauge``/``histogram``/
    ``series``) are idempotent by name, so recording sites never need a
    registration phase.  ``snapshot()`` returns the same
    component-prefixed :class:`repro_torch.stats.StatsSnapshot` the legacy
    ``snapshot()`` methods produced, annotated with ``_types``/``_docs``
    for the Prometheus exporter.
    """

    def __init__(
        self,
        component: str,
        retention_s: float = DEFAULT_RETENTION_S,
    ):
        self.component = component
        self.retention_s = float(retention_s)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._series: Dict[str, Series] = {}
        self._docs: Dict[str, str] = {}

    def _doc(self, name: str, doc: str) -> None:
        if doc:
            self._docs[name] = doc

    def counter(self, name: str, doc: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
                self._doc(name, doc)
        return c

    def gauge(self, name: str, doc: str = "",
              label: Optional[str] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, label=label)
                self._doc(name, doc)
        return g

    def histogram(self, name: str, doc: str = "",
                  bounds: Sequence[float] = BUCKETS_MS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(bounds)
                self._doc(name, doc)
        return h

    def series(self, name: str, doc: str = "",
               retention_s: Optional[float] = None) -> Series:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = Series(
                    name,
                    retention_s=(self.retention_s if retention_s is None
                                 else retention_s),
                )
                self._doc(name, doc)
        return s

    def snapshot(
        self, extra: Optional[Dict[str, object]] = None
    ) -> StatsSnapshot:
        """Everything recorded so far, component-prefixed.

        ``extra`` merges derived, caller-computed keys (mean fill,
        amortized cost ...) into the same snapshot before prefixing.
        Series are summarized (count + windowed p50/p95) rather than
        dumped — raw points are an internal signal, not a stat.
        """
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.values())
            hists = list(self._hists.items())
            series = list(self._series.items())
        data: Dict[str, object] = {}
        types: Dict[str, str] = {}
        for name, c in counters:
            data[name] = c.value
            types[name] = "counter"
        for g in gauges:
            items = g.snapshot_items()
            data.update(items)
            for key in items:
                types[key] = "gauge"
        for name, h in hists:
            data.update(h.snapshot(name))
            types[f"{name}_hist"] = "histogram"
        for name, s in series:
            data[f"{name}_window_count"] = len(s)
            p50 = s.quantile(0.50)
            p95 = s.quantile(0.95)
            if p50 is not None:
                data[f"{name}_window_p50"] = round(p50, 3)
                types[f"{name}_window_p50"] = "gauge"
            if p95 is not None:
                data[f"{name}_window_p95"] = round(p95, 3)
                types[f"{name}_window_p95"] = "gauge"
        if extra:
            data.update(extra)
        snap = namespaced(self.component, data)
        prefix = f"{self.component}_"

        def _canon(key: str) -> str:
            return key if key.startswith(prefix) else prefix + key

        snap._types = {_canon(k): v for k, v in types.items()}
        snap._docs = {_canon(k): v for k, v in self._docs.items()}
        return snap
