"""Serving scheduler: one pool, many concurrent coded-matmul requests —
the port's counterpart of ``repro.dist.scheduler``.

The master multiplexes tasks by request id, so nothing stops N requests
from being in flight at once — but a serving system needs *policy* on top
of that mechanism: how many requests may be in flight (``max_inflight``
dispatcher threads), how many may wait (a bounded admission queue —
``submit`` raises :class:`SchedulerSaturated` instead of buffering
unboundedly, so the caller can shed load), and how to avoid re-planning
and re-instantiating a scheme for every request of the same shape (a
per-spec plan cache keyed by ``(ProblemSpec, objective)``; the port's
planner ranks on the analytic proxy, and each scheme is built on the pool
master's device).

Usage::

    pool = LocalPool(workers=8)
    sched = PoolScheduler(pool.master, max_queue=32, max_inflight=4)
    fut = sched.submit(A, B, spec=spec)          # non-blocking, may raise
    C = fut.result()                              # blocks for this request
    sched.close(); pool.close()
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

from ..cdmm.api import CdmmScheme, ProblemSpec
from ..cdmm.planner import plan
from ..obs import http as obs_http
from ..obs import trace as obs
from ..obs.metrics import MetricsRegistry
from ..stats import StatsSnapshot

__all__ = ["PoolScheduler", "SchedulerSaturated", "SchedulerStats"]


class SchedulerSaturated(RuntimeError):
    """Admission control rejected the request: the bounded queue is full.
    Callers shed load (retry with backoff, route elsewhere) instead of the
    scheduler buffering without bound."""


class SchedulerStats:
    """Scheduler counters, registry-backed for the live telemetry plane.

    Recording is in-line (``_bump`` is one counter ``inc``); the legacy
    attribute reads (``stats.completed``) and ``snapshot()`` both read
    the same live :class:`repro_torch.obs.metrics.MetricsRegistry` the HTTP
    ``/metrics``/``/stats`` endpoints scrape.
    """

    _COUNTERS = (
        "submitted", "rejected", "completed", "failed", "timed_out",
        "plan_cache_hits", "plan_cache_misses",
    )

    def __init__(self) -> None:
        self.metrics = MetricsRegistry("scheduler")
        self._counters = {
            name: self.metrics.counter(name) for name in self._COUNTERS
        }
        # submit-to-completion latency in the shared repro_torch.stats schema
        # (request_ms_hist / _p50 / _p99 / _sum in snapshots)
        self.request_ms = self.metrics.histogram(
            "request_ms", "submit -> result latency (ms)"
        )

    def _bump(self, name: str) -> None:
        self._counters[name].inc()

    def __getattr__(self, name: str):
        # legacy attribute reads (stats.completed == 6) resolve to the
        # live counter values; __getattr__ only fires for names not in
        # __dict__, so the instruments above stay ordinary attributes
        counters = self.__dict__.get("_counters") or {}
        if name in counters:
            return counters[name].value
        raise AttributeError(name)

    def snapshot(self) -> StatsSnapshot:
        """Every counter plus the request-latency histogram family, in
        the shared ``repro_torch.stats`` snapshot schema (``scheduler_``-
        prefixed keys; legacy unprefixed names resolve with one
        DeprecationWarning)."""
        return self.metrics.snapshot()


class PoolScheduler:
    """Bounded-queue admission control + plan cache over one pool master."""

    def __init__(
        self,
        master,
        max_queue: int = 32,
        max_inflight: int = 4,
        objective: str = "latency",
        request_timeout: Optional[float] = None,
    ):
        self.master = master
        self.objective = objective
        self.request_timeout = request_timeout
        self.stats = SchedulerStats()
        # the admin HTTP plane scrapes this scheduler alongside its pool
        self._obs_source = obs_http.register_source(
            "scheduler", self.stats.snapshot
        )
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._plans: Dict[Tuple[ProblemSpec, str], CdmmScheme] = {}
        self._plans_lock = threading.Lock()
        self._closed = False
        self._threads = [
            threading.Thread(
                target=self._dispatch_loop, name=f"pool-sched-{i}", daemon=True
            )
            for i in range(max_inflight)
        ]
        for t in self._threads:
            t.start()

    # -- plan cache --------------------------------------------------------

    def scheme_for(self, spec: ProblemSpec) -> CdmmScheme:
        """The executable scheme serving ``spec`` (planned once, reused for
        every request of that shape)."""
        key = (spec, self.objective)
        with self._plans_lock:
            scheme = self._plans.get(key)
        if scheme is not None:
            self.stats._bump("plan_cache_hits")
            return scheme
        self.stats._bump("plan_cache_misses")
        built = plan(spec, objective=self.objective).instantiate(
            device=self.master.device)
        with self._plans_lock:
            # a racing planner for the same spec wins idempotently
            scheme = self._plans.setdefault(key, built)
        return scheme

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        A,
        B,
        spec: Optional[ProblemSpec] = None,
        scheme: Optional[CdmmScheme] = None,
        mask=None,
        key=None,
    ) -> Future:
        """Admit one request; returns a Future of the decoded product.

        Exactly one of ``spec`` (planned + cached) or ``scheme`` (already
        built) selects the code.  Raises :class:`SchedulerSaturated` when
        the admission queue is full.
        """
        if (spec is None) == (scheme is None):
            raise ValueError("pass exactly one of spec= or scheme=")
        if self._closed:
            raise RuntimeError("scheduler is closed")
        if scheme is None:
            scheme = self.scheme_for(spec)
        fut: Future = Future()
        trace = obs.maybe_context("req")
        fut.trace_id = trace.trace_id if trace is not None else None
        try:
            self._queue.put_nowait(
                (fut, scheme, A, B, mask, key, time.perf_counter(), trace)
            )
        except queue.Full:
            self.stats._bump("rejected")
            raise SchedulerSaturated(
                f"admission queue full ({self._queue.maxsize} waiting); "
                f"shed load or raise max_queue"
            ) from None
        self.stats._bump("submitted")
        return fut

    def trace(self, fut_or_trace_id) -> obs.Timeline:
        """The merged timeline of one submitted request: queue wait,
        per-share encode/send, every responder's compute span, decode.
        Accepts the Future returned by :meth:`submit` (its ``trace_id``
        attribute) or a trace id string."""
        tid = getattr(fut_or_trace_id, "trace_id", fut_or_trace_id)
        if tid is None:
            raise ValueError(
                "request was not traced (enable with REPRO_TRACE=1 or "
                "repro_torch.obs.set_enabled(True) before submit)"
            )
        return obs.tracer().timeline(tid)

    # -- dispatch ----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, scheme, A, B, mask, key, t_submit, trace = item
            if not fut.set_running_or_notify_cancel():
                continue
            if trace is not None:
                # admission-queue dwell: submit() -> this dispatch slot
                t1 = obs.now()
                obs.tracer().add(
                    trace, "queue_wait", "scheduler",
                    t1 - (time.perf_counter() - t_submit), t1,
                )
            # request_timeout is a deadline from submit(): time spent
            # waiting in the admission queue draws down the same budget
            # the pool execution gets, so a saturated scheduler fails
            # requests at the promised latency instead of stretching it
            remaining = None
            if self.request_timeout is not None:
                remaining = self.request_timeout - (
                    time.perf_counter() - t_submit
                )
                if remaining <= 0:
                    self.stats._bump("timed_out")
                    fut.set_exception(TimeoutError(
                        f"request spent its {self.request_timeout}s budget "
                        f"in the admission queue before dispatch"
                    ))
                    continue
            try:
                C, _ = self.master.execute(
                    scheme, A, B, mask=mask, key=key, timeout=remaining,
                    trace=trace,
                )
                self.stats._bump("completed")
                self.stats.request_ms.observe(
                    (time.perf_counter() - t_submit) * 1e3
                )
                fut.set_result(C)
            except BaseException as e:
                self.stats._bump(
                    "timed_out" if isinstance(e, TimeoutError) else "failed"
                )
                fut.set_exception(e)

    def close(self, drain: bool = True) -> None:
        """Stop the dispatchers.  ``drain=True`` serves queued requests
        first; ``drain=False`` cancels whatever is still waiting."""
        if self._closed:
            return
        self._closed = True
        obs_http.unregister_source(self._obs_source)
        if not drain:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[0].cancel()
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=30)
        # a submit racing this close can slip an item in behind the
        # sentinels after the dispatchers exited: cancel the leftovers so
        # no Future is left forever unresolved
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[0].cancel()

    def __enter__(self) -> "PoolScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
