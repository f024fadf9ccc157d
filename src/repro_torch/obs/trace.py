"""Structured request tracing: spans, trace contexts, a bounded tracer —
counterpart of ``repro.obs.trace`` (jax-free; same span schema).

The paper's performance claim is about *time-to-R* — any R of N workers
suffice — and aggregate histograms can't show where one request's latency
went (coalesce wait vs. encode vs. wire vs. the R-th worker's straggle
vs. decode).  This module is the per-request evidence layer:

- :class:`Span` — one timed operation: name, component (``serve`` /
  ``scheduler`` / ``pool`` / ``worker`` / ``local`` / ``elastic``),
  epoch-aligned start/end seconds, and free-form tags (worker id, share
  index, byte counts, host pid);
- :class:`TraceContext` — a trace id plus the span-name stack, carried
  explicitly through the request path (the path hops threads and
  processes, so ambient context vars can't follow it);
- :class:`Tracer` — the process-local collector: a thread-safe ring
  buffer (capacity from ``REPRO_TRACE_BUFFER``) so a long-lived serving
  process never grows without bound;
- :class:`Timeline` — every span of one trace id (plus any linked
  carrier trace — a coalesced batch records its pool spans once, under
  the carrier), sorted by start time, exportable via
  :mod:`repro_torch.obs.export`.

Timestamps come from :func:`now`: ``perf_counter`` anchored to the epoch
once per process — monotone within a process, comparable across
processes on one host (cross-host spans carry their host's clock; tags
identify the origin, and skew is the reader's problem, as in any
distributed trace).

Tracing is off by default; enable with ``REPRO_TRACE=1``, a ``--trace``
flag on the entry points, or :func:`set_enabled`.  Every recording path
is gated on a live :class:`TraceContext`, created only when enabled, so
the disabled overhead is one ``None`` check per request.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from .. import settings

__all__ = [
    "Span",
    "Timeline",
    "TraceContext",
    "Tracer",
    "enabled",
    "maybe_context",
    "new_trace_id",
    "now",
    "set_enabled",
    "tracer",
]

# epoch-aligned monotonic clock: perf_counter anchored once per process
_EPOCH = time.time() - time.perf_counter()


def now() -> float:
    """Epoch-aligned seconds, monotone within this process."""
    return _EPOCH + time.perf_counter()


_ids = itertools.count()
_PID = os.getpid()


def new_trace_id(prefix: str = "t") -> str:
    """Process-unique trace id (pid + counter; no RNG, no syscalls)."""
    return f"{prefix}-{_PID:x}-{next(_ids):x}"


@dataclass(frozen=True)
class Span:
    """One timed operation inside a trace."""

    trace_id: str
    name: str  # "encode", "send", "compute", "decode", "coalesce_wait"...
    component: str  # "serve" | "scheduler" | "pool" | "worker" | ...
    t_start: float  # epoch seconds (see now())
    t_end: float
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def to_json(self) -> Dict[str, object]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "component": self.component,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "tags": dict(self.tags),
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "Span":
        return cls(
            trace_id=str(obj["trace_id"]),
            name=str(obj["name"]),
            component=str(obj["component"]),
            t_start=float(obj["t_start"]),
            t_end=float(obj["t_end"]),
            tags=dict(obj.get("tags", {})),
        )


@dataclass
class TraceContext:
    """A trace id plus the active span-name stack.

    Passed explicitly along the request path (admission queue -> coalesce
    thread -> executor -> pool master -> wire).  The stack only feeds the
    ``parent`` tag of nested spans — Chrome's trace viewer lanes spans by
    component/worker, so no span tree is needed.
    """

    trace_id: str
    request_id: Optional[int] = None
    stack: List[str] = field(default_factory=list)

    @classmethod
    def new(cls, prefix: str = "t",
            request_id: Optional[int] = None) -> "TraceContext":
        return cls(trace_id=new_trace_id(prefix), request_id=request_id)


@dataclass(frozen=True)
class Timeline:
    """Every recorded span of one trace, sorted by start time."""

    trace_id: str
    spans: List[Span]

    @property
    def t_start(self) -> float:
        return min(s.t_start for s in self.spans) if self.spans else 0.0

    @property
    def t_end(self) -> float:
        return max(s.t_end for s in self.spans) if self.spans else 0.0

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start

    def by_component(self, component: str) -> List[Span]:
        return [s for s in self.spans if s.component == component]

    def to_json(self) -> Dict[str, object]:
        return {
            "trace_id": self.trace_id,
            "wall_s": self.wall_s,
            "spans": [s.to_json() for s in self.spans],
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "Timeline":
        return cls(
            trace_id=str(obj["trace_id"]),
            spans=[Span.from_json(s) for s in obj.get("spans", [])],
        )


# --------------------------------------------------------------------------
# enablement
# --------------------------------------------------------------------------

_enabled_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force tracing on/off for this process; ``None`` re-reads the
    ``REPRO_TRACE`` setting."""
    global _enabled_override
    _enabled_override = value


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return settings.get_bool("trace")


def maybe_context(
    prefix: str = "t", request_id: Optional[int] = None
) -> Optional[TraceContext]:
    """A fresh TraceContext when tracing is enabled, else None — the one
    branch every instrumented entry point takes per request."""
    if not enabled():
        return None
    return TraceContext.new(prefix, request_id=request_id)


# --------------------------------------------------------------------------
# the process-local tracer
# --------------------------------------------------------------------------


class Tracer:
    """Thread-safe bounded span collector (one per process via
    :func:`tracer`)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = settings.get_int("trace_buffer") or 8192
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=self.capacity)

    def record(self, span: Span) -> Span:
        with self._lock:
            self._spans.append(span)
        return span

    def add(
        self,
        ctx: Optional[TraceContext],
        name: str,
        component: str,
        t_start: float,
        t_end: float,
        **tags: object,
    ) -> Optional[Span]:
        """Record one finished span under ``ctx`` (no-op when ctx is None,
        so call sites never branch)."""
        if ctx is None:
            return None
        return self.record(Span(
            trace_id=ctx.trace_id, name=name, component=component,
            t_start=t_start, t_end=t_end, tags=tags,
        ))

    @contextmanager
    def span(
        self, ctx: Optional[TraceContext], name: str, component: str,
        **tags: object,
    ):
        """Time a block as one span; yields a mutable tag dict so the block
        can attach results (byte counts, worker ids) before close."""
        if ctx is None:
            yield {}
            return
        parent = ctx.stack[-1] if ctx.stack else None
        ctx.stack.append(name)
        live_tags: Dict[str, object] = dict(tags)
        if parent is not None:
            live_tags.setdefault("parent", parent)
        t0 = now()
        try:
            yield live_tags
        finally:
            ctx.stack.pop()
            self.record(Span(
                trace_id=ctx.trace_id, name=name, component=component,
                t_start=t0, t_end=now(), tags=live_tags,
            ))

    def spans(self, *trace_ids: str) -> List[Span]:
        """Every retained span of the given trace ids, in recording order."""
        wanted = set(trace_ids)
        with self._lock:
            return [s for s in self._spans if s.trace_id in wanted]

    def timeline(self, trace_id: str, *linked: str) -> Timeline:
        """The merged timeline of ``trace_id`` plus any linked (carrier)
        traces, sorted by span start."""
        spans = sorted(
            self.spans(trace_id, *linked),
            key=lambda s: (s.t_start, s.t_end),
        )
        return Timeline(trace_id=trace_id, spans=spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    """The process-local tracer (created on first use)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def spans_to_wire(spans: Iterable[Span]) -> List[Dict[str, object]]:
    """Compact wire form for piggybacking worker spans on response frames
    (trace_id omitted — the receiver stamps its request's id back on)."""
    return [
        {"name": s.name, "t0": s.t_start, "t1": s.t_end, "tags": dict(s.tags)}
        for s in spans
    ]


def spans_from_wire(
    entries: Iterable[Dict], trace_id: str, component: str = "worker",
    **extra_tags: object,
) -> List[Span]:
    """Inverse of :func:`spans_to_wire`: rebuild spans under the receiving
    request's trace id, folding in receiver-side tags (worker id, share)."""
    out = []
    for e in entries or ():
        tags = dict(e.get("tags", {}))
        tags.update(extra_tags)
        out.append(Span(
            trace_id=trace_id, name=str(e.get("name", "span")),
            component=component, t_start=float(e.get("t0", 0.0)),
            t_end=float(e.get("t1", 0.0)), tags=tags,
        ))
    return out
