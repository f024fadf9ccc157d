"""One stats schema for every runtime surface — counterpart of
``repro.stats`` (jax-free; copied so the port runs without ``repro``, with
the same snapshot schema, so the two packages' reports merge and diff).

``ServeStats``, ``SchedulerStats`` and the pool master's cumulative
counters historically disagreed on key names and units; this module pins
the shared snapshot contract they all emit:

- **counters** are plain ints under their own name (``submitted``,
  ``completed``, ``redispatched`` ...);
- **latency distributions** are milliseconds and follow the
  ``<name>_ms_hist`` / ``<name>_ms_p50`` / ``<name>_ms_p99`` /
  ``<name>_ms_sum`` family — the histogram is a dict of
  cumulative-style bucket labels (``"<=0.5"`` ... ``"inf"``) to counts,
  the quantiles are the upper bound of the bucket the quantile falls in
  (``None`` when empty), and the sum is the total observed milliseconds
  (what Prometheus histogram ``_sum`` samples carry);
- **bytes** are ``bytes_in`` / ``bytes_out`` for what actually crossed
  the wire and ``raw_bytes_in`` / ``raw_bytes_out`` for the pre-codec
  payload sizes, so ``raw/wire`` is the observed compression ratio.

Every key is **component-prefixed**: ``<component>_<metric>`` with
``component`` one of ``serve`` / ``scheduler`` / ``pool``
(``serve_completed``, ``pool_bytes_out``, ``scheduler_request_ms_p99``),
so merged reports from several components never collide.
:func:`namespaced` applies the prefix to a raw snapshot, and
:class:`StatsSnapshot` resolves the historical unprefixed names
(``snap["completed"]``) with a one-time ``DeprecationWarning`` so
``--stats-every`` consumers keep working across the rename.

:class:`Histogram` produces the triple; :func:`merge_snapshots` combines
snapshots from several components (e.g. the serving engine + the pool
master) into one report, summing counters and bucket counts and
recomputing quantiles from the merged histograms.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from .settings import warn_deprecated_once

__all__ = [
    "BUCKETS_MS",
    "Histogram",
    "StatsSnapshot",
    "merge_snapshots",
    "namespaced",
    "quantile_from_hist",
]

# shared latency bucket bounds (ms); inf catches the long tail
BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0,
    float("inf"),
)


def _label(bound: float) -> str:
    if bound == float("inf"):
        return "inf"
    return f"<={bound:g}"


def _bound(label: str) -> float:
    if label == "inf":
        return float("inf")
    return float(label[2:])


class Histogram:
    """Fixed-bucket latency histogram emitting the shared ``*_ms`` triple.

    Thread-safe: ``observe`` may race with ``snapshot`` from reporting
    threads.
    """

    def __init__(self, bounds: Sequence[float] = BUCKETS_MS):
        self.bounds = tuple(bounds)
        self._counts = [0] * len(self.bounds)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value_ms: float) -> None:
        for k, bound in enumerate(self.bounds):
            if value_ms <= bound:
                with self._lock:
                    self._counts[k] += 1
                    self._sum += value_ms
                return

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._counts)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self._counts)
        return quantile_from_hist(
            dict(zip(map(_label, self.bounds), counts)), q
        )

    def snapshot(self, name: str) -> Dict[str, object]:
        """``{f"{name}_hist": {...}, f"{name}_p50": ..., f"{name}_p99": ...,
        f"{name}_sum": ...}`` — ``name`` should end in ``_ms`` per the
        schema; the sum is what Prometheus histograms need next to the
        bucket counts."""
        with self._lock:
            counts = list(self._counts)
            total = self._sum
        hist = dict(zip(map(_label, self.bounds), counts))
        return {
            f"{name}_hist": hist,
            f"{name}_p50": quantile_from_hist(hist, 0.50),
            f"{name}_p99": quantile_from_hist(hist, 0.99),
            f"{name}_sum": round(total, 3),
        }


def quantile_from_hist(hist: Dict[str, int], q: float) -> Optional[float]:
    """Upper bucket bound holding the q-quantile of a ``*_ms_hist`` dict
    (None when the histogram is empty).  A quantile landing in the open
    ``inf`` bucket clamps to the largest finite bound so snapshots stay
    JSON-clean."""
    items = sorted(hist.items(), key=lambda kv: _bound(kv[0]))
    total = sum(c for _, c in items)
    if total == 0:
        return None
    finite = [_bound(lbl) for lbl, _ in items if _bound(lbl) != float("inf")]
    cap = finite[-1] if finite else float("inf")
    target = q * total
    seen = 0
    for label, count in items:
        seen += count
        if seen >= target:
            return min(_bound(label), cap)
    return cap  # pragma: no cover - fp slack


class StatsSnapshot(dict):
    """A schema-conforming snapshot that still answers legacy key names.

    Keys are stored component-prefixed (``serve_completed``).  Indexing
    with a historical unprefixed name (``snap["completed"]``) resolves
    through the alias table built at construction and emits one
    ``DeprecationWarning`` per process per alias; iteration and ``dict()``
    only ever expose the canonical names.
    """

    def __init__(self, data: Dict[str, object],
                 aliases: Optional[Dict[str, str]] = None):
        super().__init__(data)
        self._aliases = dict(aliases or {})

    def __missing__(self, key):
        target = self._aliases.get(key)
        if target is None or target not in self:
            raise KeyError(key)
        warn_deprecated_once(
            f"stats:{key}",
            f"stats key {key!r} is deprecated; read {target!r} instead",
        )
        return self[target]

    def __contains__(self, key) -> bool:
        if super().__contains__(key):
            return True
        target = self._aliases.get(key)
        return target is not None and super().__contains__(target)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


def namespaced(
    component: str,
    snap: Dict[str, object],
    extra_aliases: Optional[Dict[str, str]] = None,
) -> StatsSnapshot:
    """Prefix every key of ``snap`` with ``<component>_`` and wrap it so
    the unprefixed names still resolve (with a deprecation warning).

    Idempotent per key: a key already starting with the prefix is kept
    as-is, so callers that pre-prefixed by hand don't double up.
    """
    prefix = f"{component}_"
    data: Dict[str, object] = {}
    aliases: Dict[str, str] = {}
    for key, val in snap.items():
        if key.startswith(prefix):
            data[key] = val
        else:
            data[prefix + key] = val
            aliases[key] = prefix + key
    if extra_aliases:
        aliases.update(extra_aliases)
    return StatsSnapshot(data, aliases)


def merge_snapshots(*snaps: Dict[str, object]) -> Dict[str, object]:
    """Merge schema-conforming snapshots into one combined report.

    Counters (ints/floats) sum; ``*_hist`` dicts sum per bucket;
    ``*_p50``/``*_p99`` are recomputed from the merged histograms (never
    summed — quantiles don't add).  A precomputed quantile whose matching
    ``*_hist`` appears in no snapshot keeps its first occurrence — there is
    nothing to recompute from, and dropping it would silently thin the
    schema.  Keys that appear in only one snapshot pass through;
    non-numeric values (labels, lists) keep the first occurrence.
    """
    merged: Dict[str, object] = {}
    hists: Dict[str, Dict[str, int]] = {}
    quantiles: Dict[str, object] = {}
    for snap in snaps:
        for key, val in snap.items():
            if key.endswith("_hist") and isinstance(val, dict):
                acc = hists.setdefault(key, {})
                for label, count in val.items():
                    acc[label] = acc.get(label, 0) + int(count)
            elif key.endswith("_p50") or key.endswith("_p99"):
                # recomputed below when the merged hist exists; kept as a
                # passthrough (first occurrence) when it doesn't
                quantiles.setdefault(key, val)
            elif isinstance(val, bool):
                merged[key] = merged.get(key, False) or val
            elif isinstance(val, (int, float)):
                merged[key] = merged.get(key, 0) + val
            elif key not in merged:
                merged[key] = val
    for key, hist in hists.items():
        base = key[: -len("_hist")]
        merged[key] = hist
        merged[f"{base}_p50"] = quantile_from_hist(hist, 0.50)
        merged[f"{base}_p99"] = quantile_from_hist(hist, 0.99)
    for key, val in quantiles.items():
        if f"{key[:-len('_p50')]}_hist" not in hists:  # _p99 same length
            merged[key] = val
    aliases: Dict[str, str] = {}
    for snap in snaps:
        if isinstance(snap, StatsSnapshot):
            aliases.update(snap._aliases)
    if aliases:
        return StatsSnapshot(merged, aliases)
    return merged
