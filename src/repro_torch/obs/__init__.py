"""repro_torch.obs — structured tracing, live metrics, health scores, the
HTTP admin plane and their exporters; counterpart of ``repro.obs`` (all
jax-free).

See :mod:`repro_torch.obs.trace` for the span model,
:mod:`repro_torch.obs.metrics` for the push-based registry the pool,
scheduler and serving engine publish into,
:mod:`repro_torch.obs.health` for per-worker health scoring,
:mod:`repro_torch.obs.http` for the embedded ``/metrics`` ``/healthz``
``/stats`` ``/trace/<id>`` server, and :mod:`repro_torch.obs.export` for
the JSON / Chrome trace_event / Prometheus output formats
(:func:`parse_prometheus` validates the exposition text strictly).
``python -m repro_torch.obs.top`` is a live terminal dashboard over
``/stats``; ``python -m repro_torch.obs.smoke`` drives them all on a pool.
"""
from .export import (
    parse_prometheus,
    to_chrome_trace,
    to_json,
    to_prometheus,
    validate_timeline,
)
from .health import HealthTracker
from .http import (
    ObsHttpServer,
    register_source,
    register_trace_resolver,
    start_server,
    stop_server,
    unregister_source,
    unregister_trace_resolver,
)
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
    "ObsHttpServer",
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
    "register_source",
    "register_trace_resolver",
    "set_enabled",
    "spans_from_wire",
    "spans_to_wire",
    "start_server",
    "stop_server",
    "to_chrome_trace",
    "to_json",
    "to_prometheus",
    "tracer",
    "unregister_source",
    "unregister_trace_resolver",
    "validate_timeline",
]
