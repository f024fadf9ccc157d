"""ServeScheduler: continuous batching between admission and the pool —
the port's counterpart of ``repro.serve.engine``.

The paper's batch construction (Thm III.2) multiplies n independent
products at ~1/n of GCSA's recovery threshold — but it only pays off in a
service if n *concurrent requests* actually share one codeword.  This
engine sits where :class:`repro_torch.dist.scheduler.PoolScheduler` sits (bounded
admission queue over one pool master) and adds the batch dimension:

admission   ``submit(A, B, spec)`` — per-request specs (``spec.n == 1``),
            bounded queue, :class:`SchedulerSaturated` on overflow;
planning    per spec, once: scan batch arities 1..``target_batch_n`` under
            the planner's ``"amortized"`` objective and keep the cheapest
            per-request configuration — a batched family at some fill
            (coalesce, cap = the scheme's RMFE pack size) or a single
            family (per-request dispatch, exactly PoolScheduler behavior);
coalescing  a :class:`~repro_torch.serve.coalescer.BatchCoalescer` groups
            same-spec arrivals until the cap fills or the policy's wait
            budget expires (``max_wait_ms`` / adaptive idle);
execution   one ``Master.execute`` per batch: members stack on the leading
            batch axis, a partial final batch zero-pads up to the pack
            size (zero rows decode to exact zero products over the ring
            and are sliced off), and each member's Future resolves to its
            own slice of the decoded batch.

``privacy_t > 0`` specs ride the same path on ``ep_rmfe_secure``: one
derived key masks the whole batch (a batch IS one codeword), so coalesced
and sequential execution stay bit-identical under a caller-fixed key.  The
port's keys are ints (ROADMAP, "Decisions that stand"): the engine's base key is its
int ``seed``, batch ``k`` is masked with ``galois.fold_in(seed, k)``, and a
caller's key still wins.

Devices: the engine plans and builds every scheme on its pool master's
device (or ``device=``, None meaning the card, when it has no master yet);
operands are ring tensors there or numpy uint32 arrays moved there, and
every Future resolves to a tensor on that device.

``request_timeout`` is a *deadline from submit* — queue wait, coalesce
wait and pool execution all spend the same budget.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cdmm.api import CdmmScheme, ProblemSpec, get_scheme
from ..cdmm.planner import plan
from ..core.galois import fold_in, from_numpy
from ..device import resolve_device
from ..dist.scheduler import SchedulerSaturated
from ..obs import http as obs_http
from ..obs import trace as obs

from .coalescer import BatchCoalescer, CoalescePolicy
from .stats import ServeStats

__all__ = ["ServeScheduler"]

_WAKE = object()  # internal: queue.get timed out, run the expiry sweep


@dataclass
class _Member:
    """One admitted request: arrays pinned at submit, resolved by slice."""

    fut: Future
    A: torch.Tensor
    B: torch.Tensor
    key: Optional[int]
    t_submit: float
    rid: int = -1
    trace: Optional[obs.TraceContext] = None


@dataclass
class _SpecEntry:
    """The serving decision for one ProblemSpec, planned once.

    ``cap > 1``: coalesce up to ``cap`` requests into ``scheme`` (a batched
    adapter whose pack size is ``cap``).  ``cap == 1``: the amortized
    ranking found no batch arity that beats per-request dispatch, so
    ``scheme`` is the best single-product adapter and requests never wait
    for peers.
    """

    spec: ProblemSpec
    scheme: CdmmScheme
    cap: int
    label: str


class ServeScheduler:
    """Continuous-batching admission control over one pool master."""

    def __init__(
        self,
        master=None,
        policy: Optional[CoalescePolicy] = None,
        max_queue: int = 64,
        max_inflight: int = 4,
        objective: str = "amortized",
        request_timeout: Optional[float] = None,
        seed: Optional[int] = None,
        config=None,
        device=None,
    ):
        # config= (a repro_torch.dist.PoolConfig) with no master: the
        # engine owns the pool it serves over — launched here on
        # ``device``, closed in close().  master=None with no config stays
        # legal: planning entry points (entry_for) never touch a pool
        # until a request dispatches.
        self._owned_pool = None
        if master is None and config is not None:
            from ..dist.launch import launch_pool

            self._owned_pool = launch_pool(config, device=device)
            master = self._owned_pool.master
        elif config is not None and request_timeout is None:
            request_timeout = config.request_timeout
        if master is not None:
            if device is not None and resolve_device(device) != master.device:
                raise ValueError(f"device {device} != the pool master's {master.device}")
            self.device = master.device
        else:
            self.device = resolve_device(device)
        self.master = master
        self.policy = policy or CoalescePolicy()
        self.policy.validate()
        self.objective = objective
        self.request_timeout = request_timeout
        self.stats = ServeStats()
        # the admin HTTP plane scrapes this engine alongside its pool,
        # and /trace/<request_id> resolves through the engine's rid index
        self._obs_source = obs_http.register_source(
            "serve", self.stats.snapshot
        )
        obs_http.register_trace_resolver(self._resolve_trace)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._coalescer = BatchCoalescer(self.policy)
        self._entries: Dict[ProblemSpec, _SpecEntry] = {}
        self._entries_lock = threading.Lock()
        self._key_lock = threading.Lock()
        self._batch_seq = 0
        self._next_rid = 0
        # rid -> (request trace_id, carrier trace_id): a coalesced batch
        # records its pool spans once under the first member's trace (the
        # "carrier"); trace(rid) merges both (bounded, oldest roll off)
        self._trace_index: Dict[int, tuple] = {}
        self._trace_lock = threading.Lock()
        self._trace_index_cap = 1024
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self._base_key = int(seed)
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=max_inflight, thread_name_prefix="serve-exec"
        )
        self._thread = threading.Thread(
            target=self._coalesce_loop, name="serve-coalesce", daemon=True
        )
        self._thread.start()

    # -- planning ----------------------------------------------------------

    def entry_for(self, spec: ProblemSpec) -> _SpecEntry:
        """The (cached) serving decision for ``spec``: scan batch arities
        under the ``"amortized"`` objective, keep the cheapest per-request
        configuration, and build its executable scheme once."""
        with self._entries_lock:
            entry = self._entries.get(spec)
        if entry is not None:
            self.stats.bump("plan_cache_hits")
            return entry
        self.stats.bump("plan_cache_misses")

        # fill=1 first: ties go to per-request dispatch (never make a
        # request wait for peers unless coalescing strictly wins)
        choices = [(plan(spec, objective=self.objective), 1)]
        for f in range(2, self.policy.target_batch_n + 1):
            try:
                pf = plan(spec.with_batch(f), objective=self.objective)
            except ValueError:
                continue  # no feasible configuration at this arity
            if get_scheme(pf.best.scheme).batched:
                choices.append((pf, f))
        chosen, fill = min(choices, key=lambda c: c[0].best.score)
        scheme = chosen.instantiate(device=self.device)
        cap = scheme.batch if fill > 1 else 1
        entry = _SpecEntry(
            spec=spec,
            scheme=scheme,
            cap=cap,
            label=f"{scheme.name}[{spec.t}x{spec.r}x{spec.s}]",
        )
        with self._entries_lock:
            # a racing planner for the same spec wins idempotently
            entry = self._entries.setdefault(spec, entry)
        return entry

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        A,
        B,
        spec: ProblemSpec,
        key=None,
    ) -> Future:
        """Admit one request; returns a Future of this request's product.

        ``spec`` describes the *single* request (``spec.n == 1``) — batch
        arity is the engine's decision, not the caller's.  ``key`` (an
        int) pins a secure batch's masks.  Raises
        :class:`~repro_torch.dist.scheduler.SchedulerSaturated` when the
        admission queue is full.
        """
        if spec.n != 1:
            raise ValueError(
                f"serve coalesces per-request specs (n=1), got n={spec.n}; "
                f"batch arity is the engine's decision"
            )
        if self._closed:
            raise RuntimeError("scheduler is closed")
        entry = self.entry_for(spec)
        fut: Future = Future()
        with self._trace_lock:
            rid = self._next_rid
            self._next_rid += 1
        trace = obs.maybe_context("serve", request_id=rid)
        fut.request_id = rid
        fut.trace_id = trace.trace_id if trace is not None else None
        member = _Member(
            fut=fut,
            A=self._operand(A, entry.scheme),
            B=self._operand(B, entry.scheme),
            key=key,
            t_submit=time.perf_counter(),
            rid=rid,
            trace=trace,
        )
        try:
            self._queue.put_nowait((entry, member))
        except queue.Full:
            self.stats.bump("rejected")
            raise SchedulerSaturated(
                f"admission queue full ({self._queue.maxsize} waiting); "
                f"shed load or raise max_queue"
            ) from None
        self.stats.bump("submitted")
        return fut

    # -- coalescing --------------------------------------------------------

    def _coalesce_loop(self) -> None:
        while True:
            wait = self._coalescer.next_wait_s(
                time.perf_counter(), self._queue.empty()
            )
            try:
                item = self._queue.get(timeout=wait)
            except queue.Empty:
                item = _WAKE
            if item is None:  # close() sentinel: drain buffers and exit
                for _, items in self._coalescer.flush_all():
                    self._dispatch([m for _, m in items])
                return
            if item is not _WAKE:
                entry, member = item
                if entry.cap <= 1:
                    self._dispatch([(entry, member)])
                else:
                    full = self._coalescer.add(
                        entry.spec, (entry, member), entry.cap,
                        time.perf_counter(),
                    )
                    if full is not None:
                        self._dispatch(full)
            for _, items in self._coalescer.due(
                time.perf_counter(), self._queue.empty()
            ):
                self._dispatch(items)

    def _dispatch(self, items: List) -> None:
        """Hand one batch (list of (entry, member)) to an executor slot."""
        entry = items[0][0]
        members = [m for _, m in items]
        try:
            self._pool.submit(self._run_batch, entry, members)
        except RuntimeError as e:  # executor already shut down
            for m in members:
                if not m.fut.done():
                    m.fut.set_exception(e)

    # -- execution ---------------------------------------------------------

    def _operand(self, x, scheme) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            return from_numpy(x, scheme.base, self.device)
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, serving engine on {self.device}")
        return x

    def _batch_key(self, members: List[_Member]) -> int:
        """One key masks the whole batch (it is one codeword): the first
        caller-provided key wins, else derive a fresh per-batch key."""
        for m in members:
            if m.key is not None:
                return m.key
        with self._key_lock:
            seq = self._batch_seq
            self._batch_seq += 1
        return fold_in(self._base_key, seq)

    def _run_batch(self, entry: _SpecEntry, members: List[_Member]) -> None:
        now = time.perf_counter()
        active = []
        for m in members:
            if m.fut.set_running_or_notify_cancel():
                active.append(m)
            else:
                self.stats.bump("cancelled")
        if self.request_timeout is not None:
            still = []
            for m in active:
                if now - m.t_submit >= self.request_timeout:
                    self.stats.bump("timed_out")
                    m.fut.set_exception(TimeoutError(
                        f"request spent its {self.request_timeout}s budget "
                        f"waiting (queue + coalesce) before dispatch"
                    ))
                else:
                    still.append(m)
            active = still
        if not active:
            return
        scheme = entry.scheme
        fill = len(active)
        waits_ms = [(now - m.t_submit) * 1e3 for m in active]
        timeout = None
        if self.request_timeout is not None:
            # the earliest member's remaining budget bounds the whole batch
            timeout = min(
                m.t_submit + self.request_timeout for m in active
            ) - now
        key = None
        if scheme.privacy_t > 0:
            key = self._batch_key(active)
        # one batch = one pool execution: its pool/worker spans record
        # once, under the first traced member (the carrier); every
        # member's trace(rid) merges the carrier timeline back in
        carrier = next((m.trace for m in active if m.trace is not None),
                       None)
        if carrier is not None:
            t_now = obs.now()
            tracer = obs.tracer()
            with self._trace_lock:
                for m in active:
                    if m.trace is None:
                        continue
                    self._trace_index[m.rid] = (
                        m.trace.trace_id, carrier.trace_id
                    )
                while len(self._trace_index) > self._trace_index_cap:
                    self._trace_index.pop(next(iter(self._trace_index)))
            for m, wait_ms in zip(active, waits_ms):
                tracer.add(
                    m.trace, "coalesce_wait", "serve",
                    t_now - wait_ms / 1e3, t_now,
                    batch=scheme.batch, fill=fill, label=entry.label,
                )
        try:
            if entry.cap > 1:
                pad = scheme.batch - fill
                zA = torch.zeros_like(active[0].A)
                zB = torch.zeros_like(active[0].B)
                As = torch.stack([m.A for m in active] + [zA] * pad)
                Bs = torch.stack([m.B for m in active] + [zB] * pad)
                C, pstats = self.master.execute(
                    scheme, As, Bs, key=key, timeout=timeout,
                    batch_fill=fill, trace=carrier,
                )
                for j, m in enumerate(active):
                    m.fut.set_result(C[j])
            else:
                pad = 0
                m = active[0]
                C, pstats = self.master.execute(
                    scheme, m.A, m.B, key=key, timeout=timeout, trace=carrier
                )
                m.fut.set_result(C)
            self.stats.bump("completed", fill)
            self.stats.record_batch(
                entry.label, fill, pad, pstats.wall_ms, waits_ms
            )
        except BaseException as e:
            self.stats.bump(
                "timed_out" if isinstance(e, TimeoutError) else "failed",
                fill,
            )
            for m in active:
                if not m.fut.done():
                    m.fut.set_exception(e)

    # -- tracing -----------------------------------------------------------

    def trace(self, request_id) -> obs.Timeline:
        """The merged end-to-end timeline of one request: coalesce wait,
        the batch's per-share encode/send, every responder's compute span
        (late arrivals and post-SIGKILL re-dispatches included), the
        any-R wait and decode.

        Accepts the Future returned by :meth:`submit` (its ``request_id``
        attribute) or the request id itself.  Spans of the batch the
        request rode in are merged from the carrier trace, so coalesced
        peers share the same pool/worker spans.  Raises ``KeyError``
        until the request has dispatched (or if it rolled off the
        bounded index), ``ValueError`` when tracing was disabled.
        """
        if not obs.enabled():
            raise ValueError(
                "tracing is disabled (enable with REPRO_TRACE=1, --trace, "
                "or repro_torch.obs.set_enabled(True) before submit)"
            )
        rid = getattr(request_id, "request_id", request_id)
        with self._trace_lock:
            pair = self._trace_index.get(rid)
        if pair is None:
            raise KeyError(
                f"request {rid!r} has no dispatched trace (not yet "
                f"dispatched, never submitted, or rolled off the index)"
            )
        tid, carrier_tid = pair
        linked = (carrier_tid,) if carrier_tid != tid else ()
        return obs.tracer().timeline(tid, *linked)

    def _resolve_trace(self, key: str):
        """HTTP /trace/<request_id> hook: serve request ids are ints."""
        try:
            rid = int(key)
        except (TypeError, ValueError):
            return None
        try:
            return self.trace(rid)
        except (KeyError, ValueError):
            return None

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Drain: buffered partial batches execute, then dispatchers stop.
        Requests admitted after close() raise; stragglers that raced the
        sentinel into the queue are cancelled."""
        if self._closed:
            return
        self._closed = True
        obs_http.unregister_source(self._obs_source)
        obs_http.unregister_trace_resolver(self._resolve_trace)
        self._queue.put(None)
        self._thread.join(timeout=60)
        self._pool.shutdown(wait=True)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and item is not _WAKE:
                item[1].fut.cancel()
        if self._owned_pool is not None:
            self._owned_pool.close()
            self._owned_pool = None

    def __enter__(self) -> "ServeScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
