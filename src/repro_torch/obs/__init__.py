"""repro_torch.obs — structured tracing, live metrics, health scores and
their exporters; counterpart of ``repro.obs`` (all jax-free).

See :mod:`repro_torch.obs.trace` for the span model,
:mod:`repro_torch.obs.metrics` for the push-based registry,
:mod:`repro_torch.obs.health` for per-worker health scoring, and
:mod:`repro_torch.obs.export` for the JSON / Chrome trace_event /
Prometheus output formats (:func:`parse_prometheus` validates the
exposition text strictly).  The reference's HTTP admin plane, terminal
dashboard and smoke (``repro.obs.http``, ``top``, ``smoke``) come with the
port's worker pool and serving engine, which are what exercise them.
"""
from .export import (
    parse_prometheus,
    to_chrome_trace,
    to_json,
    to_prometheus,
    validate_timeline,
)
from .health import HealthTracker
from .metrics import Counter, Gauge, MetricsRegistry, Series
from .trace import (
    Span,
    Timeline,
    TraceContext,
    Tracer,
    enabled,
    maybe_context,
    new_trace_id,
    now,
    set_enabled,
    spans_from_wire,
    spans_to_wire,
    tracer,
)

__all__ = [
    "Counter",
    "Gauge",
    "HealthTracker",
    "MetricsRegistry",
    "Series",
    "Span",
    "Timeline",
    "TraceContext",
    "Tracer",
    "enabled",
    "maybe_context",
    "new_trace_id",
    "now",
    "parse_prometheus",
    "set_enabled",
    "spans_from_wire",
    "spans_to_wire",
    "to_chrome_trace",
    "to_json",
    "to_prometheus",
    "tracer",
    "validate_timeline",
]
