"""Exporters and validators for :class:`repro_torch.obs.Timeline` —
counterpart of ``repro.obs.export`` (jax-free; same output formats).

Three output formats, one input schema (the span JSON emitted by
``Timeline.to_json``):

- :func:`to_json` — the canonical schema, round-trippable via
  ``Timeline.from_json``;
- :func:`to_chrome_trace` — Chrome ``trace_event`` JSON for
  ``about://tracing`` / https://ui.perfetto.dev: complete ("X") events,
  one process lane per component and one thread lane per worker, so the
  any-R race is visible as R+ overlapping compute bars;
- :func:`to_prometheus` — text exposition of a ``repro_torch.stats`` snapshot
  (counters as ``counter``, ``*_hist`` buckets as cumulative
  ``histogram`` series) for scrape-style consumers.

:func:`validate_timeline` is the schema check CI runs on ``--trace``
smoke exports: spans non-empty, every span time-ordered and carrying the
required fields, and per-worker compute spans present for at least the
R responders that fed decode.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import Timeline

__all__ = [
    "parse_prometheus",
    "to_chrome_trace",
    "to_json",
    "to_prometheus",
    "validate_timeline",
]


def to_json(timeline: Timeline, indent: Optional[int] = None) -> str:
    """The canonical span-JSON document (see ``Timeline.to_json``)."""
    return json.dumps(timeline.to_json(), indent=indent, sort_keys=True)


def _chrome_tid(span) -> str:
    wid = span.tags.get("wid")
    return f"worker {wid}" if wid is not None else "main"


def to_chrome_trace(timeline: Timeline, indent: Optional[int] = None) -> str:
    """Chrome ``trace_event`` JSON: load in about://tracing or Perfetto.

    Lanes: pid = component, tid = worker id (or "main").  Timestamps are
    microseconds relative to the timeline's first span so the viewer
    opens at t=0 instead of the 2026 epoch.
    """
    t0 = timeline.t_start
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[Dict] = []
    for span in timeline.spans:
        pid = pids.setdefault(span.component, len(pids) + 1)
        tid = tids.setdefault((span.component, _chrome_tid(span)),
                              len(tids) + 1)
        events.append({
            "name": span.name,
            "cat": span.component,
            "ph": "X",
            "ts": (span.t_start - t0) * 1e6,
            "dur": span.duration_s * 1e6,
            "pid": pid,
            "tid": tid,
            "args": {k: v for k, v in span.tags.items()},
        })
    for component, pid in pids.items():
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": component},
        })
    for (component, label), tid in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pids[component],
            "tid": tid, "args": {"name": label},
        })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": timeline.trace_id},
    }
    return json.dumps(doc, indent=indent)


_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")

# gauge-shaped snapshot keys that aren't quantiles: last-write-wins
# signals where "sum across restarts" would be meaningless
_GAUGE_SUFFIXES = ("_live", "_fill", "_health", "_score", "_window_count")


def _prom_name(key: str) -> str:
    return "repro_" + _NAME_SANITIZE.sub("_", key)


def _escape_label(value: object) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _hist_bound(bucket: str) -> float:
    if bucket == "inf":
        return float("inf")
    return float(bucket[2:] if bucket.startswith("<=") else bucket)


class _Emitter:
    """Collects exposition lines, guarding family-name collisions.

    Distinct snapshot keys can sanitize to the same metric name
    (``wall.ms`` and ``wall_ms`` both become ``repro_wall_ms``); a
    duplicate family in the exposition is invalid, so the first key
    wins and colliders are skipped with a comment naming them.
    """

    def __init__(self):
        self.lines: List[str] = []
        self._families: Dict[str, str] = {}  # family name -> source key

    def family(self, name: str, key: str, typ: str, help_text: str) -> bool:
        owner = self._families.get(name)
        if owner is not None and owner != key:
            self.lines.append(
                f"# collision: snapshot key {key!r} also sanitizes to "
                f"{name}; skipped (kept {owner!r})"
            )
            return False
        if owner is None:
            self._families[name] = key
            self.lines.append(f"# HELP {name} {_escape_help(help_text)}")
            self.lines.append(f"# TYPE {name} {typ}")
        return True


def to_prometheus(
    snapshot: Dict[str, object],
    docs: Optional[Dict[str, str]] = None,
) -> str:
    """Prometheus text exposition of a ``repro_torch.stats`` snapshot.

    - ``*_hist`` dicts become real cumulative histogram families:
      ``<name>_bucket{le="..."}`` (accumulated — snapshot buckets are
      per-bucket counts), ``<name>_sum`` (from the snapshot's matching
      ``*_sum`` key when present) and ``<name>_count``;
    - ``*_p50``/``*_p99`` and registry gauges become ``gauge`` samples;
    - ``*_by_<label>`` dicts (labeled gauges from
      :class:`repro_torch.obs.metrics.Gauge`) become one ``{label="key"}``
      sample per entry, label values escaped;
    - other scalars become ``counter`` samples; bools and non-numerics
      are skipped.

    Every family gets ``# HELP`` (from ``docs`` and the snapshot's own
    ``_docs`` annotation when present) and ``# TYPE`` lines, and
    distinct keys colliding after name sanitization are skipped (first
    wins) instead of silently overwriting.  ``_types`` annotations from
    :meth:`repro_torch.obs.metrics.MetricsRegistry.snapshot` override the
    suffix heuristics for counter-vs-gauge.
    """
    all_docs = dict(getattr(snapshot, "_docs", {}) or {})
    if docs:
        all_docs.update(docs)
    types = dict(getattr(snapshot, "_types", {}) or {})
    em = _Emitter()
    consumed_sums = {
        key[: -len("_hist")] + "_sum"
        for key, val in snapshot.items()
        if key.endswith("_hist") and isinstance(val, dict)
    }
    for key in sorted(snapshot):
        val = snapshot[key]
        help_text = all_docs.get(key, f"repro stats key {key}")
        if key.endswith("_hist") and isinstance(val, dict):
            base_key = key[: -len("_hist")]
            name = _prom_name(base_key)
            if not em.family(name, key, "histogram",
                             all_docs.get(key, f"repro stats key {base_key}")):
                continue
            buckets = sorted(
                (
                    (b, int(c)) for b, c in val.items()
                    if isinstance(c, (int, float))
                ),
                key=lambda bc: _hist_bound(bc[0]),
            )
            cum = 0
            for bucket, count in buckets:
                cum += count
                bound = _hist_bound(bucket)
                le = "+Inf" if bound == float("inf") else f"{bound:g}"
                em.lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
            if not buckets or _hist_bound(buckets[-1][0]) != float("inf"):
                em.lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            total_sum = snapshot.get(f"{base_key}_sum", 0)
            if not isinstance(total_sum, (int, float)):
                total_sum = 0
            em.lines.append(f"{name}_sum {total_sum}")
            em.lines.append(f"{name}_count {cum}")
        elif key in consumed_sums:
            continue  # folded into its histogram family above
        elif "_by_" in key and isinstance(val, dict):
            base_key, _, label = key.rpartition("_by_")
            if not base_key or not label:
                continue
            name = _prom_name(base_key)
            if not em.family(name, key, "gauge", help_text):
                continue
            for lkey in sorted(val):
                lval = val[lkey]
                if isinstance(lval, bool) or not isinstance(
                    lval, (int, float)
                ):
                    continue
                em.lines.append(
                    f'{name}{{{label}="{_escape_label(lkey)}"}} {lval}'
                )
        elif isinstance(val, bool):
            continue
        elif isinstance(val, (int, float)):
            name = _prom_name(key)
            typ = types.get(key)
            if typ is None:
                typ = (
                    "gauge"
                    if key.endswith(("_p50", "_p95", "_p99")
                                    ) or key.endswith(_GAUGE_SUFFIXES)
                    else "counter"
                )
            if not em.family(name, key, typ, help_text):
                continue
            em.lines.append(f"{name} {val}")
    return "\n".join(em.lines) + "\n"


# -- strict exposition parsing (the CI metrics-smoke gate) -----------------

_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (\w+)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"  # metric name
    r"(?:\{(.*)\})?"  # optional label block
    r"\s+(\S+)"  # value
    r"(?:\s+(-?\d+))?$"  # optional timestamp
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_VALID_TYPES = {
    "counter", "gauge", "histogram", "summary", "untyped",
}


def _parse_labels(block: str, lineno: int) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    rest = block
    while rest:
        m = _LABEL_RE.match(rest)
        if m is None:
            raise ValueError(
                f"line {lineno}: malformed label block {block!r}"
            )
        labels[m.group(1)] = (
            m.group(2)
            .replace("\\n", "\n")
            .replace('\\"', '"')
            .replace("\\\\", "\\")
        )
        rest = rest[m.end():]
        if rest.startswith(","):
            rest = rest[1:]
        elif rest:
            raise ValueError(
                f"line {lineno}: junk after label pair in {block!r}"
            )
    return labels


def _family_of(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def parse_prometheus(text: str) -> Dict[str, Dict]:
    """Strictly parse Prometheus text exposition (format 0.0.4).

    Returns ``{family: {"type", "help", "samples": [(name, labels,
    value)]}}`` and raises ``ValueError`` on anything malformed: bad
    metric/label syntax, unknown TYPE, TYPE redeclared or declared after
    the family's samples, duplicate (name, labelset) samples, histogram
    families missing their ``+Inf`` bucket, non-monotone cumulative
    bucket counts, or ``_count`` disagreeing with the ``+Inf`` bucket.
    This is the gate CI's ``metrics-smoke`` runs on a live ``/metrics``
    scrape, so it prefers false alarms over leniency.
    """
    families: Dict[str, Dict] = {}
    seen_samples: set = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _HELP_RE.match(line)
            if m is not None:
                fam = families.setdefault(
                    m.group(1), {"type": None, "help": None, "samples": []}
                )
                fam["help"] = m.group(2)
                continue
            m = _TYPE_RE.match(line)
            if m is not None:
                name, typ = m.group(1), m.group(2)
                if typ not in _VALID_TYPES:
                    raise ValueError(
                        f"line {lineno}: unknown metric type {typ!r}"
                    )
                fam = families.setdefault(
                    name, {"type": None, "help": None, "samples": []}
                )
                if fam["type"] is not None:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {name}"
                    )
                if fam["samples"]:
                    raise ValueError(
                        f"line {lineno}: TYPE for {name} after its samples"
                    )
                fam["type"] = typ
                continue
            continue  # plain comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, label_block, value_s = m.group(1), m.group(2), m.group(3)
        labels = (
            _parse_labels(label_block, lineno) if label_block else {}
        )
        try:
            value = float(value_s)
        except ValueError:
            raise ValueError(
                f"line {lineno}: unparsable value {value_s!r}"
            ) from None
        sample_key = (name, tuple(sorted(labels.items())))
        if sample_key in seen_samples:
            raise ValueError(
                f"line {lineno}: duplicate sample {name}{labels}"
            )
        seen_samples.add(sample_key)
        family = _family_of(name)
        fam = families.setdefault(
            family, {"type": None, "help": None, "samples": []}
        )
        if fam["type"] is None and family != name:
            # _bucket/_sum/_count of an undeclared family: the bare name
            # is its own (untyped) family
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []}
            )
        fam["samples"].append((name, labels, value))
    for family, fam in families.items():
        if fam["type"] != "histogram":
            continue
        buckets: List[Tuple[float, float]] = []
        count_val: Optional[float] = None
        for name, labels, value in fam["samples"]:
            if name == f"{family}_bucket":
                if "le" not in labels:
                    raise ValueError(
                        f"{family}: bucket sample without le label"
                    )
                le = labels["le"]
                bound = float("inf") if le == "+Inf" else float(le)
                buckets.append((bound, value))
            elif name == f"{family}_count":
                count_val = value
        if not buckets:
            raise ValueError(f"{family}: histogram with no buckets")
        buckets.sort(key=lambda bv: bv[0])
        if buckets[-1][0] != float("inf"):
            raise ValueError(f"{family}: histogram missing +Inf bucket")
        prev = 0.0
        for bound, value in buckets:
            if value < prev:
                raise ValueError(
                    f"{family}: bucket counts not cumulative at le={bound}"
                )
            prev = value
        if count_val is not None and count_val != buckets[-1][1]:
            raise ValueError(
                f"{family}: _count {count_val} != +Inf bucket "
                f"{buckets[-1][1]}"
            )
    return families


_REQUIRED_SPAN_FIELDS = ("trace_id", "name", "component", "t_start", "t_end")


def validate_timeline(
    doc: Dict,
    min_workers: int = 0,
    require_components: Sequence[str] = (),
) -> List[str]:
    """Schema-check an exported span-JSON document.

    Returns a list of human-readable problems (empty = valid):
    spans present, every span carrying the required fields with
    ``t_end >= t_start``, at least ``min_workers`` distinct worker ids
    among compute spans, and every component in ``require_components``
    represented.
    """
    problems: List[str] = []
    spans = doc.get("spans")
    if not isinstance(spans, list) or not spans:
        return ["timeline has no spans"]
    wids = set()
    components = set()
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            problems.append(f"span[{i}] is not an object")
            continue
        missing = [f for f in _REQUIRED_SPAN_FIELDS if f not in s]
        if missing:
            problems.append(f"span[{i}] missing fields {missing}")
            continue
        if not (isinstance(s["t_start"], (int, float))
                and isinstance(s["t_end"], (int, float))):
            problems.append(f"span[{i}] has non-numeric times")
            continue
        if s["t_end"] < s["t_start"]:
            problems.append(
                f"span[{i}] ({s['name']}) ends before it starts: "
                f"{s['t_end']} < {s['t_start']}"
            )
        components.add(s["component"])
        tags = s.get("tags", {})
        if s["name"] == "compute" and "wid" in tags:
            wids.add(tags["wid"])
    if len(wids) < min_workers:
        problems.append(
            f"expected compute spans from >= {min_workers} workers, "
            f"saw {len(wids)} ({sorted(map(str, wids))})"
        )
    for comp in require_components:
        if comp not in components:
            problems.append(f"no spans from component {comp!r}")
    return problems
