"""Pool master: real workers, heartbeats, death detection, any-R decode —
the port's counterpart of ``repro.dist.master``.

:class:`Master` listens on a socket, accepts worker registrations (the
``hello`` capability handshake, which negotiates a wire codec per
connection — see :mod:`repro_torch.dist.protocol`), and executes coded
matmuls against the pool: the master encodes per-worker shares on its
device with the same ``encode_*_at`` closures the elastic backend uses
(``repro_torch.cdmm.elastic.worker_closures``, an int share index and an
int key), copies each to the host as numpy uint32 (the reference's wire
layout), ships each
share to a live worker process (chunked along the contraction axis when
``stream_chunk_bytes`` says the share is big enough to pipeline — the
worker accumulates partial products, so transfer and compute overlap),
and fires the LRU-cached any-R ``decode_op`` the moment the R-th
response lands — through :func:`repro_torch.cdmm.elastic.decode_responses`
on the master's device, the exact decode tail of the in-process elastic
master, so the two paths are bit-identical by construction.  Reader
threads keep the responses as numpy arrays; they become tensors, with the
device named, only in the thread that decodes.

Failure model.  A worker is dead when its socket drops (SIGKILL, crash,
network) or its heartbeat goes silent past ``heartbeat_timeout``.  Death
mid-request re-dispatches the worker's unanswered shares to surviving
workers (any process can compute any share — the share index, not the
process, is the paper's "worker"), so a request completes as long as one
process survives and R distinct shares can still be computed.  Membership
is tracked by :class:`repro_torch.core.straggler.MembershipEvents`, so the
observed join/leave/response history is available as a real
:class:`~repro_torch.core.straggler.WorkerTrace` (``Master.trace()``) and plugs
into everything built on trace semantics.

Shares are multiplexed: a pool of W processes serves schemes with any N
(round-robin assignment), decoupling pool size from the code's worker
count.  Requests are multiplexed too — every task carries a request id and
responses are routed to per-request queues — which is what lets the
serving scheduler (:mod:`repro_torch.dist.scheduler`) keep several requests in
flight over one pool.

Bandwidth accounting: every connection counts pre-codec (raw) vs. on-wire
bytes; per-request totals land on :class:`PoolStats` and cumulative
totals (plus latency histograms in the shared ``repro_torch.stats``
schema) on ``Master.stats()``.  Each worker's kernel launch counts ride
its heartbeats and result frames; :meth:`Master.worker_launches` reads
them, current up to every task sent before the call.

:class:`LocalPool` spawns a master plus N
``python -m repro_torch.dist.worker`` OS processes on a Unix-domain socket
(TCP fallback) in one call, with ``kill()`` for failure injection and
clean shutdown on ``close()`` — it is the single-host specialization of
:func:`repro_torch.dist.launch.launch_pool` and accepts the same
:class:`~repro_torch.dist.config.PoolConfig`.

Devices: ``Master``, ``LocalPool`` and ``launch_pool`` take ``device=``
(None means the card, and raises without one).  The master encodes and
decodes there, executes only schemes built on it, and passes it on to
every worker it spawns; on a card it builds the kernel library before
spawning, so the workers load it instead of compiling it each.
"""
from __future__ import annotations

import math
import os
import queue
import signal
import socket
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import settings
from ..cdmm.elastic import NotEnoughResponders, decode_responses, worker_closures
from ..core.galois import from_numpy, to_numpy
from ..core.straggler import MembershipEvents
from ..device import resolve_device
from ..obs import http as obs_http
from ..obs import trace as obs
from ..obs.health import DISPATCH_THRESHOLD, HealthTracker
from ..obs.metrics import MetricsRegistry
from ..stats import StatsSnapshot

from .config import Endpoint, PoolConfig, warn_deprecated_once
from .protocol import Channel, ProtocolError, listen, negotiate

__all__ = ["LocalPool", "Master", "PoolStats", "WorkerDied"]


def _shutdown_socket(sock: socket.socket) -> None:
    """Force-wake any thread blocked reading ``sock``, then close it.
    ``close()`` alone leaves a blocked ``recv`` sleeping forever;
    ``shutdown(SHUT_RDWR)`` delivers EOF first."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class WorkerDied(RuntimeError):
    """A request became impossible: too few live workers remain to compute
    R distinct shares (every surviving share was already re-dispatched)."""


@dataclass(frozen=True)
class PoolStats:
    """Accounting of one pool execution (real wall-clock, real processes)."""

    dispatched: Tuple[int, ...]  # share indices shipped to workers
    live_idx: Tuple[int, ...]  # the R-subset actually decoded from
    workers: Tuple[int, ...]  # pool worker ids that served shares
    redispatched: int  # shares re-shipped after a worker death
    wall_ms: float  # master wall-clock for the call
    time_to_R_ms: float  # wall-clock until the R-th response landed
    hedged: int = 0  # shares speculatively re-shipped past their deadline
    batch: int = 1  # products the scheme packs per codeword (RMFE slots)
    fill: int = 1  # slots carrying real requests (rest were zero padding)
    # bandwidth accounting (shared schema: raw = pre-codec payload bytes,
    # bytes_* = what actually crossed the socket, framing included)
    raw_bytes_out: int = 0  # share payloads before the wire codec
    bytes_out: int = 0  # what the master actually sent
    raw_bytes_in: int = 0  # result payloads before the wire codec
    bytes_in: int = 0  # what the master actually received
    codecs: Tuple[str, ...] = ()  # negotiated codecs of the workers used


class _WorkerHandle:
    def __init__(self, wid: int, chan: Channel, caps: Dict):
        self.wid = wid
        self.chan = chan
        self.sock = chan.sock
        self.caps = caps
        self.codec = chan.codec
        self.name = caps.get("name", f"worker-{wid}")
        self.alive = True
        self.last_seen = time.time()
        self.send_lock = threading.Lock()
        # worker-published load figures (heartbeat piggyback); launches:
        # the port worker's kernel counts (absent from a JAX worker)
        self.tasks_done = 0
        self.busy_us = 0.0
        self.launches: Optional[Dict[str, int]] = None

    def send(self, header: Dict, arrays=None,
             codec: Optional[str] = None) -> Tuple[int, int]:
        with self.send_lock:
            return self.chan.send(header, arrays, codec=codec)


class _Request:
    """Routing state of one in-flight coded matmul."""

    def __init__(self, rid: int, R: int,
                 trace: Optional[obs.TraceContext] = None):
        self.rid = rid
        self.R = R
        self.trace = trace
        self.events: "queue.Queue" = queue.Queue()
        self.lock = threading.Lock()
        # task_id -> (share index, fa, gb, assigned wid, t_sent)
        self.pending: Dict[
            int, Tuple[int, np.ndarray, np.ndarray, int, float]
        ] = {}
        self.redispatched = 0
        self.satisfied: set = set()  # share indices already answered
        self.hedged_shares: set = set()  # shares hedged (at most once each)
        self.hedged = 0
        self.done = False
        # per-request bandwidth accounting (summed into PoolStats)
        self.raw_out = 0
        self.wire_out = 0
        self.raw_in = 0
        self.wire_in = 0
        self.codecs: set = set()


class Master:
    """Accept workers, track membership, execute coded matmuls on the pool."""

    def __init__(
        self,
        address: Optional[str] = None,
        heartbeat_timeout: Optional[float] = None,
        use_kernel: Optional[bool] = None,
        config: Optional[PoolConfig] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        cfg = config or PoolConfig()
        if heartbeat_timeout is not None:
            cfg = cfg.with_(heartbeat_timeout=heartbeat_timeout)
        if use_kernel is not None:
            cfg = cfg.with_(use_kernel=use_kernel)
        if address is not None:
            cfg = cfg.with_(endpoint=Endpoint.parse(address))
        self.config = cfg
        listen_addr = (
            cfg.endpoint.address if cfg.endpoint else "tcp:127.0.0.1:0"
        )
        self._listener, self.address = listen(listen_addr)
        self.heartbeat_timeout = cfg.heartbeat_timeout
        # None = let each worker auto-select (kernel wherever it compiles on
        # the worker's device); True/False force it pool-wide
        self.use_kernel = cfg.use_kernel
        self.transport = cfg.transport
        self.compression_level = cfg.compression_level
        self.stream_chunk_bytes = cfg.stream_chunk_bytes
        self.membership = MembershipEvents()
        self._workers: Dict[int, _WorkerHandle] = {}
        self._requests: Dict[int, _Request] = {}
        self._lock = threading.Lock()
        self._joined = threading.Condition(self._lock)
        self._next_wid = 0
        self._next_rid = 0
        self._next_task = 0
        self._next_echo = 0
        self._echo_waiters: Dict[int, Tuple[threading.Event, List]] = {}
        self._next_ping = 0
        self._ping_waiters: Dict[int, threading.Event] = {}
        self._rr = 0  # round-robin cursor for share -> worker assignment
        self._closed = False
        # telemetry knobs: explicit config wins, else the settings registry
        # (REPRO_HEDGE_FACTOR / REPRO_HEALTH_EWMA / REPRO_OBS_HTTP_PORT /
        # REPRO_OBS_RETENTION)
        self.hedge_factor = float(
            cfg.hedge_factor if cfg.hedge_factor is not None
            else (settings.get_float("hedge_factor") or 0.0)
        )
        health_ewma = float(
            cfg.health_ewma if cfg.health_ewma is not None
            else (settings.get_float("health_ewma") or 0.2)
        )
        retention_s = float(settings.get_float("obs_retention") or 300.0)
        # cumulative accounting: a live MetricsRegistry the dispatch and
        # result paths record into inline; stats() reads it (shared
        # repro_torch.stats schema, pool_-prefixed)
        self.metrics = MetricsRegistry("pool", retention_s=retention_s)
        for name, doc in (
            ("requests", "coded-matmul requests started on this pool"),
            ("completed", "requests decoded successfully"),
            ("failed", "requests that raised"),
            ("redispatched", "shares re-shipped after a worker death"),
            ("hedged", "shares speculatively re-shipped past the hedge "
                       "deadline"),
            ("hedge_wasted", "hedged shares whose extra reply lost the "
                             "race (duplicate discarded)"),
            ("raw_bytes_out", "share payload bytes before the wire codec"),
            ("bytes_out", "bytes actually sent on the wire"),
            ("raw_bytes_in", "result payload bytes before the wire codec"),
            ("bytes_in", "bytes actually received on the wire"),
            ("heartbeats", "worker heartbeat messages received"),
        ):
            self.metrics.counter(name, doc)
        self._wall_hist = self.metrics.histogram(
            "wall_ms", "request wall-clock (ms)"
        )
        self._time_to_R_hist = self.metrics.histogram(
            "time_to_R_ms", "dispatch -> R-th response (ms)"
        )
        self.metrics.gauge("workers_live", "live workers in the pool")
        self.metrics.gauge(
            "worker_health",
            "per-worker health score in (0, 1]: EWMA share round-trip "
            "and heartbeat jitter vs the pool median",
            label="wid",
        )
        self.metrics.gauge(
            "worker_tasks_done", "tasks completed, as self-reported on "
            "the worker's last heartbeat", label="wid",
        )
        # per-worker health: share round-trips land in _route_result,
        # heartbeat jitter in _reader_loop; dispatch ordering and the
        # hedge deadline both read it
        self.health = HealthTracker(
            alpha=health_ewma, retention_s=retention_s
        )
        # the admin HTTP plane: source/resolver registration is
        # unconditional (cheap, lets an externally started server see this
        # master); the server itself starts only when a port is configured
        self._obs_source = obs_http.register_source("pool", self.stats)
        obs_http.register_trace_resolver(self._resolve_trace)
        self._obs_server = None
        obs_port = (
            cfg.obs_http_port if cfg.obs_http_port is not None
            else settings.get_int("obs_http_port")
        )
        if obs_port is not None:
            self._obs_server = obs_http.start_server(obs_port)
        # rid -> trace_id of recently finished traced requests, so spans
        # from stragglers that answer after the any-R decode still land
        # on the right timeline (bounded: oldest entries roll off)
        self._done_traces: "Dict[int, str]" = {}
        self._done_traces_cap = 256
        # failure injection: per-worker-id compute delay stamped into task
        # headers (tests/CI park a victim's compute so SIGKILL lands mid-task)
        self.task_delay_ms: Dict[int, float] = {}
        # error injection: these workers raise instead of computing, which
        # exercises the bounded share-retry path without corrupting state
        self.task_fail_wids: set = set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pool-accept", daemon=True
        )
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="pool-monitor", daemon=True
        )
        self._monitor_thread.start()

    # -- membership --------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._register, args=(sock,), daemon=True
            ).start()

    def _register(self, sock: socket.socket) -> None:
        try:
            chan = Channel(sock, level=self.compression_level)
            caps, _, _, _ = chan.recv()
        except (ProtocolError, OSError):
            sock.close()
            return
        if caps.get("type") != "hello":
            sock.close()
            return
        # per-connection codec: the strongest the peer decodes, or the
        # pinned transport when both sides support it; a v0 worker that
        # advertises nothing gets raw frames (full interop)
        chan.codec = negotiate(caps.get("codecs"), prefer=self.transport)
        with self._lock:
            wid = self._next_wid
            self._next_wid += 1
            handle = _WorkerHandle(wid, chan, caps)
            self._workers[wid] = handle
            self._joined.notify_all()
        self.membership.record_join(wid, time.time())
        threading.Thread(
            target=self._reader_loop, args=(handle,),
            name=f"pool-reader-{wid}", daemon=True,
        ).start()

    def _reader_loop(self, handle: _WorkerHandle) -> None:
        try:
            while True:
                header, arrays, raw, wire = handle.chan.recv()
                handle.last_seen = time.time()
                kind = header.get("type")
                if "launches" in header:
                    handle.launches = dict(header["launches"])
                if kind == "result":
                    self._account(raw_bytes_in=raw, bytes_in=wire)
                    self._route_result(handle, header, arrays, raw, wire)
                elif kind == "heartbeat":
                    # heartbeat inter-arrival jitter is a health signal:
                    # a stuttering worker is struggling long before it
                    # trips the death deadline
                    self.health.record_heartbeat(handle.wid)
                    handle.tasks_done = int(header.get("tasks_done", 0))
                    handle.busy_us = float(header.get("busy_us", 0.0))
                    self._account(heartbeats=1)
                    if header.get("ping") is not None:
                        with self._lock:
                            waiter = self._ping_waiters.pop(header["ping"], None)
                        if waiter is not None:
                            waiter.set()
                elif kind == "echo_reply":
                    with self._lock:
                        waiter = self._echo_waiters.pop(
                            header.get("seq"), None
                        )
                    if waiter is not None:
                        event, slot = waiter
                        slot.append((raw, wire))
                        event.set()
        except (ProtocolError, OSError):
            self._on_death(handle)

    def _monitor_loop(self) -> None:
        while not self._closed:
            time.sleep(min(self.heartbeat_timeout / 4.0, 0.5))
            deadline = time.time() - self.heartbeat_timeout
            with self._lock:
                stale = [
                    h for h in self._workers.values()
                    if h.alive and h.last_seen < deadline
                ]
            for h in stale:
                # shutdown() (not close()) is what actually wakes a reader
                # thread blocked in recv with EOF, tripping its death path
                _shutdown_socket(h.sock)

    def _on_death(self, handle: _WorkerHandle) -> None:
        with self._lock:
            if not handle.alive:
                return
            handle.alive = False
            self._workers.pop(handle.wid, None)
            requests = list(self._requests.values())
        self.membership.record_leave(handle.wid, time.time())
        self.health.forget(handle.wid)
        _shutdown_socket(handle.sock)
        for req in requests:
            self._redispatch(req, handle.wid)

    def _route_result(
        self, handle: _WorkerHandle, header: Dict, arrays: Dict,
        raw: int = 0, wire: int = 0,
    ) -> None:
        rid = header.get("req")
        with self._lock:
            req = self._requests.get(rid)
            done_tid = self._done_traces.get(rid) if req is None else None
        if req is None:
            # request already decoded (straggler / duplicate) — but a
            # traced request still wants the late responder on its
            # timeline, tagged so the viewer can tell it lost the race
            if done_tid is not None:
                self._collect_worker_spans(
                    done_tid, handle, header, wire, late=True
                )
            return
        if req.trace is not None:
            self._collect_worker_spans(
                req.trace.trace_id, handle, header, wire, late=False
            )
        with req.lock:
            entry = req.pending.pop(header.get("task"), None)
            req.raw_in += raw
            req.wire_in += wire
        if entry is not None and header.get("ok"):
            # master-observed send->result round-trip: the health signal
            # covering comm + compute in one number (hedged duplicates
            # measure too — both round-trips really happened)
            self.health.record_share(
                handle.wid, (time.perf_counter() - entry[4]) * 1e3
            )
        self.membership.record_response(
            handle.wid, float(header.get("wall_us", 0.0)) / 1e3
        )
        if header.get("ok"):
            req.events.put(("result", int(header["i"]), arrays.get("h")))
        else:
            req.events.put(
                ("error", int(header["i"]), (handle.wid, header.get("err")))
            )

    def _collect_worker_spans(
        self, trace_id: str, handle: _WorkerHandle, header: Dict,
        wire: int, late: bool,
    ) -> None:
        """Land a result frame's compute span on the request's timeline.

        Tracing-capable workers piggyback their span on the reply
        (``spans`` header field); a v0 peer sends none, so the master
        synthesizes one from the ``wall_us`` it already reports, ending
        at receipt time — same schema either way, tagged so readers know
        which clock produced it.
        """
        entries = header.get("spans")
        tags = {
            "wid": handle.wid, "worker": handle.name,
            "share": header.get("i"), "wire_bytes": wire,
        }
        if late:
            tags["late"] = True
        tracer = obs.tracer()
        if entries:
            for span in obs.spans_from_wire(entries, trace_id, **tags):
                tracer.record(span)
        else:
            t1 = obs.now()
            wall_s = float(header.get("wall_us", 0.0)) / 1e6
            tracer.record(obs.Span(
                trace_id=trace_id, name="compute", component="worker",
                t_start=t1 - wall_s, t_end=t1,
                tags={**tags, "synthesized": True,
                      "ok": bool(header.get("ok"))},
            ))

    # -- introspection -----------------------------------------------------

    def live_workers(self) -> List[int]:
        with self._lock:
            return sorted(w for w, h in self._workers.items() if h.alive)

    def worker_caps(self) -> Dict[int, Dict]:
        with self._lock:
            return {w: dict(h.caps) for w, h in self._workers.items()}

    def worker_codecs(self) -> Dict[int, str]:
        """Negotiated wire codec per live worker."""
        with self._lock:
            return {w: h.codec for w, h in self._workers.items()}

    def trace(self):
        """The observed membership history as a real WorkerTrace."""
        return self.membership.trace()

    def worker_launches(self, timeout: float = 60.0) -> Dict[int, Dict[str, int]]:
        """Each live port worker's kernel launch counts by route, current
        up to every task sent to it before this call: every worker is
        pinged, and its answer comes after the tasks it received earlier
        (a worker serves its socket in order).  Workers whose hello shows
        no torch (a JAX worker does not answer pings with their seq), and
        workers that die before they answer, are left out."""
        with self._lock:
            handles = [h for h in self._workers.values()
                       if h.alive and "torch_version" in h.caps]
            waits = []
            for h in handles:
                seq = self._next_ping
                self._next_ping += 1
                event = threading.Event()
                self._ping_waiters[seq] = event
                waits.append((h, seq, event))
        for h, seq, _ in waits:
            try:
                h.send({"type": "ping", "seq": seq})
            except OSError:  # died since the snapshot: no counts to read
                self._on_death(h)
        answered = []
        deadline = time.time() + timeout
        for h, seq, event in waits:
            while not event.wait(0.05) and h.alive:
                if time.time() > deadline:
                    raise TimeoutError(f"worker {h.wid} did not answer ping {seq} in {timeout}s")
            with self._lock:
                self._ping_waiters.pop(seq, None)
            if event.is_set():
                answered.append(h)
        return {h.wid: dict(h.launches or {}) for h in answered}

    def _account(self, **deltas) -> None:
        for k, v in deltas.items():
            self.metrics.counter(k).inc(v)

    def stats(self) -> StatsSnapshot:
        """Cumulative master accounting in the shared ``repro_torch.stats``
        snapshot schema (``pool_``-prefixed keys): counters,
        ``pool_bytes_in/out`` vs ``pool_raw_bytes_in/out`` (on-wire vs
        pre-codec), ``pool_wall_ms``/``pool_time_to_R_ms`` histograms
        with p50/p99/sum, and the live gauges (``pool_workers_live``,
        per-worker ``pool_worker_health_by_wid`` scores).  Legacy
        unprefixed keys still resolve (with one DeprecationWarning per
        key)."""
        with self._lock:
            live = {
                w: h for w, h in self._workers.items() if h.alive
            }
        self.metrics.gauge("workers_live").set(len(live))
        scores = self.health.scores()
        health_gauge = self.metrics.gauge("worker_health")
        tasks_gauge = self.metrics.gauge("worker_tasks_done")
        health_gauge.clear_labels(keep=list(live))
        tasks_gauge.clear_labels(keep=list(live))
        for wid, handle in live.items():
            health_gauge.set(round(scores.get(wid, 1.0), 4), key=wid)
            tasks_gauge.set(handle.tasks_done, key=wid)
        return self.metrics.snapshot()

    def _resolve_trace(self, key: str):
        """Map a ``/trace/<key>`` request id to its merged Timeline (or
        None when this master never saw it).  Accepts the pool's integer
        request id; raw trace-id strings fall through to the process
        tracer inside :mod:`repro_torch.obs.http`."""
        try:
            rid = int(key)
        except ValueError:
            return None
        with self._lock:
            req = self._requests.get(rid)
            tid = (
                req.trace.trace_id
                if req is not None and req.trace is not None
                else self._done_traces.get(rid)
            )
        if tid is None:
            return None
        timeline = obs.tracer().timeline(tid)
        return timeline if timeline.spans else None

    def wait_for_workers(self, n: int, timeout: float = 60.0) -> None:
        deadline = time.time() + timeout
        with self._joined:
            while len(self._workers) < n:
                remaining = deadline - time.time()
                if remaining <= 0 or not self._joined.wait(remaining):
                    raise TimeoutError(
                        f"pool has {len(self._workers)}/{n} workers after "
                        f"{timeout:.0f}s"
                    )

    # -- calibration probe -------------------------------------------------

    def echo(
        self, nbytes: int, wid: Optional[int] = None,
        timeout: float = 30.0, codec: Optional[str] = None,
    ) -> Dict[str, float]:
        """Time one real round-trip of an ``nbytes`` share-shaped payload
        to a worker and back (the calibration probe behind the pool
        backend's measured comm coefficients).  Returns seconds and byte
        counts: ``{"rtt_s", "raw_bytes", "wire_bytes"}``."""
        with self._lock:
            handle = (
                self._workers.get(wid) if wid is not None
                else next(iter(sorted(self._workers.items())), (None, None))[1]
            )
        if handle is None or not handle.alive:
            raise WorkerDied("no live worker for echo probe")
        payload = np.arange(max(1, nbytes // 4), dtype=np.uint32)
        with self._lock:
            seq = self._next_echo
            self._next_echo += 1
            event, slot = threading.Event(), []
            self._echo_waiters[seq] = (event, slot)
        t0 = time.perf_counter()
        use = handle.codec if codec is None else codec
        raw, wire = handle.send(
            {"type": "echo", "seq": seq, "codec": use},
            {"x": payload}, codec=use,
        )
        if not event.wait(timeout):
            with self._lock:
                self._echo_waiters.pop(seq, None)
            raise TimeoutError(f"echo probe {seq} got no reply in {timeout}s")
        rtt = time.perf_counter() - t0
        raw_back, wire_back = slot[0]
        return {
            "rtt_s": rtt,
            "raw_bytes": float(raw + raw_back),
            "wire_bytes": float(wire + wire_back),
        }

    # -- dispatch ----------------------------------------------------------

    def _pick_worker(self, exclude: Tuple[int, ...] = ()) -> _WorkerHandle:
        # health read happens before the dispatch lock (the tracker has
        # its own lock and never takes this one: no ordering cycle)
        scores = self.health.scores()
        with self._lock:
            live = [
                h for w, h in sorted(self._workers.items())
                if h.alive and w not in exclude
            ]
            if not live:
                live = [h for _, h in sorted(self._workers.items()) if h.alive]
            if not live:
                raise WorkerDied("pool has no live workers")
            # health-aware ordering: round-robin over the healthy subset;
            # known-slow workers (score < threshold) only serve when no
            # healthier worker is available.  With no health data every
            # score is 1.0 and this is exactly the old pure round-robin.
            healthy = [
                h for h in live
                if scores.get(h.wid, 1.0) >= DISPATCH_THRESHOLD
            ]
            pool = healthy or live
            self._rr += 1
            return pool[self._rr % len(pool)]

    def _stream_chunks(self, fa: np.ndarray, gb: np.ndarray) -> int:
        """How many chunks to pipeline this share in (1 = single message).
        Only 3-D planar block shares with a shared contraction axis are
        chunkable: ``fa (t,r,D) @ gb (r,s,D)`` splits along r exactly."""
        if self.stream_chunk_bytes <= 0:
            return 1
        if (
            getattr(fa, "ndim", 0) != 3 or getattr(gb, "ndim", 0) != 3
            or fa.shape[1] != gb.shape[0]
        ):
            return 1
        r = int(fa.shape[1])
        total = int(fa.nbytes) + int(gb.nbytes)
        if total <= self.stream_chunk_bytes:
            return 1
        return max(1, min(r, math.ceil(total / self.stream_chunk_bytes)))

    def _send_task(
        self,
        req: _Request,
        scheme,
        i: int,
        fa: np.ndarray,
        gb: np.ndarray,
        exclude: Tuple[int, ...] = (),
        redispatch: bool = False,
        hedge: bool = False,
    ) -> int:
        tried = set(exclude)
        while True:
            handle = self._pick_worker(tuple(tried))
            with self._lock:
                task = self._next_task
                self._next_task += 1
            header = {
                "type": "task",
                "req": req.rid,
                "task": task,
                "i": i,
                "codec": handle.codec,
                "ring": {
                    "p": scheme.ring.p,
                    "e": scheme.ring.e,
                    "degrees": list(scheme.ring.degrees),
                },
            }
            # trace_id rides the task header only when this worker's hello
            # advertised tracing — a v0 peer never sees the field and the
            # master synthesizes its compute span from wall_us instead
            if req.trace is not None and handle.caps.get("tracing"):
                header["trace"] = req.trace.trace_id
            # None = auto: each worker decides per its own device/ring
            # (kernel_auto_enabled on the worker side)
            header["use_kernel"] = (
                "auto" if self.use_kernel is None else bool(self.use_kernel)
            )
            delay = self.task_delay_ms.get(handle.wid, 0.0)
            if delay > 0.0:
                header["delay_ms"] = delay
            if handle.wid in self.task_fail_wids:
                header["inject_fail"] = True
            with req.lock:
                req.pending[task] = (
                    i, fa, gb, handle.wid, time.perf_counter()
                )
            try:
                t_send = obs.now()
                chunks = self._stream_chunks(fa, gb)
                if chunks <= 1:
                    raw, wire = handle.send(header, {"fa": fa, "gb": gb})
                else:
                    # pipelined transfer: ship the share as contraction-
                    # axis slices so the worker computes partial products
                    # while later chunks are still in flight.  The header
                    # must promise exactly the number of chunk messages
                    # that follow (ceil(r/step) can undershoot the chunk
                    # target when step rounds up), or the worker's
                    # accumulator waits forever on a phantom chunk.
                    r = fa.shape[1]
                    step = math.ceil(r / chunks)
                    starts = range(0, r, step)
                    header["stream"] = len(starts)
                    raw, wire = handle.send(header)
                    for seq, lo in enumerate(starts):
                        hi = min(lo + step, r)
                        craw, cwire = handle.send(
                            {
                                "type": "chunk", "req": req.rid,
                                "task": task, "seq": seq,
                            },
                            {
                                "fa": np.ascontiguousarray(fa[:, lo:hi, :]),
                                "gb": np.ascontiguousarray(gb[lo:hi, :, :]),
                            },
                        )
                        raw += craw
                        wire += cwire
                with req.lock:
                    req.raw_out += raw
                    req.wire_out += wire
                    req.codecs.add(handle.codec)
                self._account(raw_bytes_out=raw, bytes_out=wire)
                # the send span IS the dead worker's footprint when it
                # never answers: timeline evidence the share went there
                obs.tracer().add(
                    req.trace, "send", "pool", t_send, obs.now(),
                    wid=handle.wid, share=i, task=task,
                    raw_bytes=raw, wire_bytes=wire, chunks=chunks,
                    codec=handle.codec, redispatch=redispatch,
                    hedge=hedge,
                )
                return handle.wid
            except OSError:
                # the send found the corpse; retry on another worker (the
                # death path would skip this task if _on_death already ran)
                with req.lock:
                    req.pending.pop(task, None)
                tried.add(handle.wid)
                self._on_death(handle)

    def _redispatch(self, req: _Request, dead_wid: int) -> None:
        """Re-ship the dead worker's unanswered shares to survivors."""
        with req.lock:
            if req.done:
                return
            orphans = [
                (task, i, fa, gb)
                for task, (i, fa, gb, wid, _t) in req.pending.items()
                # a share already satisfied (its hedge or twin answered)
                # has nothing left to recover
                if wid == dead_wid and i not in req.satisfied
            ]
            for task, *_ in orphans:
                req.pending.pop(task, None)
        for _, i, fa, gb in orphans:
            try:
                self._send_task(req, req.scheme, i, fa, gb,
                                exclude=(dead_wid,), redispatch=True)
                with req.lock:
                    req.redispatched += 1
                self._account(redispatched=1)
            except WorkerDied as e:
                req.events.put(("dead", -1, str(e)))
                return

    def _maybe_hedge(self, req: _Request, scheme, got) -> Optional[float]:
        """Speculative re-dispatch sweep: any share outstanding past the
        health-derived deadline (p95 of recent round-trips x
        ``hedge_factor``) is re-shipped once to a different live worker
        — *before* the heartbeat timeout would declare its holder dead.
        First valid reply wins; the duplicate is discarded idempotently
        in ``execute``.  Returns seconds until the next share becomes
        hedge-due (None when hedging is off/armed with no evidence), so
        the wait loop knows how long it may block.
        """
        deadline_ms = self.health.hedge_deadline_ms(self.hedge_factor)
        if deadline_ms is None:
            return None
        now_pc = time.perf_counter()
        due: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
        next_due: Optional[float] = None
        with req.lock:
            for task, (i, fa, gb, wid, t_sent) in req.pending.items():
                if i in got or i in req.satisfied or i in req.hedged_shares:
                    continue
                age_ms = (now_pc - t_sent) * 1e3
                if age_ms >= deadline_ms:
                    due.append((i, fa, gb, wid))
                else:
                    remain = (deadline_ms - age_ms) / 1e3
                    if next_due is None or remain < next_due:
                        next_due = remain
        for i, fa, gb, wid in due:
            # hedging needs a genuinely spare worker: another live
            # process besides the one still holding the share
            # (_pick_worker's exclude falls back to everyone otherwise)
            if not (set(self.live_workers()) - {wid}):
                continue
            with req.lock:
                if i in req.satisfied or i in req.hedged_shares:
                    continue
                req.hedged_shares.add(i)
            try:
                self._send_task(
                    req, scheme, i, fa, gb, exclude=(wid,), hedge=True
                )
            except WorkerDied:
                continue  # the original dispatch may still answer
            with req.lock:
                req.hedged += 1
            self._account(hedged=1)
        return next_due

    # -- protocol entry point ----------------------------------------------

    def execute(
        self,
        scheme,
        A,
        B,
        mask=None,
        key=None,
        timeout: Optional[float] = None,
        batch_fill: Optional[int] = None,
        trace: Optional[obs.TraceContext] = None,
    ) -> Tuple[torch.Tensor, PoolStats]:
        """Run one coded matmul on the pool; returns (C, PoolStats).

        ``scheme`` must live on the master's device; ``A``/``B`` are ring
        tensors there or numpy uint32 arrays (moved there).  ``C`` is a
        tensor on the master's device.

        ``mask`` is the usual (N,)-bool share-liveness vector: masked-out
        share indices are never dispatched (the test seam for simulating
        straggler budgets deterministically).  ``key`` feeds the keyed
        encode of secure schemes — encode runs master-side, so workers
        only ever see masked shares.  ``batch_fill`` is observability from
        a coalescing caller: how many of the scheme's batch slots carry
        real requests (the rest are padding), surfaced on PoolStats.
        ``trace`` carries an upstream :class:`repro_torch.obs.TraceContext`
        (scheduler/serving); when tracing is enabled and none is passed, a
        fresh one is opened so direct ``Master.execute`` calls trace too.
        """
        t0 = time.perf_counter()
        if scheme.code.device != self.device:
            raise ValueError(
                f"{scheme.name} lives on {scheme.code.device}; this pool's master "
                f"encodes and decodes on {self.device}")
        A = self._operand(A, scheme)
        B = self._operand(B, scheme)
        if trace is None:
            trace = obs.maybe_context("pool")
        tracer = obs.tracer()
        N, R = scheme.N, scheme.R
        shares = list(range(N))
        if mask is not None:
            if isinstance(mask, torch.Tensor):
                mask = mask.cpu()
            m = np.asarray(mask, dtype=bool)
            if len(m) != N:
                raise ValueError(f"mask has {len(m)} entries, scheme N={N}")
            shares = [i for i in shares if m[i]]
        if len(shares) < R:
            raise NotEnoughResponders(
                f"{scheme.name}: mask leaves {len(shares)} shares, "
                f"decode needs R={R}"
            )
        encode_at, _ = worker_closures(scheme, keyed=key is not None)

        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(rid, R, trace=trace)
            req.scheme = scheme
            self._requests[rid] = req
        self._account(requests=1)
        deadline = time.perf_counter() + timeout if timeout else None
        workers_used: List[int] = []
        ok = False
        try:
            for i in shares:
                t_enc = obs.now()
                if key is None:
                    fa, gb = encode_at(A, B, i)
                else:
                    fa, gb = encode_at(A, B, i, key)
                fa, gb = to_numpy(fa), to_numpy(gb)
                tracer.add(trace, "encode", "pool", t_enc, obs.now(),
                           share=i, scheme=scheme.name)
                wid = self._send_task(req, scheme, i, fa, gb)
                workers_used.append(wid)
            t_wait = obs.now()

            got: Dict[int, np.ndarray] = {}
            errors: Dict[int, int] = {}  # share -> failed compute attempts
            t_R = None
            while len(got) < R:
                wait = None
                if deadline is not None:
                    wait = deadline - time.perf_counter()
                    if wait <= 0:
                        raise TimeoutError(
                            f"pool request {rid}: {len(got)}/{R} responses "
                            f"after {timeout}s"
                        )
                poll = wait
                if self.hedge_factor > 0:
                    # hedge sweep, then bound the blocking get by the next
                    # share's hedge deadline so overdue shares re-ship
                    # promptly instead of waiting out the request timeout
                    next_due = self._maybe_hedge(req, scheme, got)
                    if next_due is None:
                        next_due = 0.25  # deadline not armed yet: re-check
                    poll = max(
                        1e-3,
                        next_due if poll is None else min(poll, next_due),
                    )
                try:
                    kind, i, payload = req.events.get(timeout=poll)
                except queue.Empty:
                    if self.hedge_factor > 0:
                        continue  # hedge wakeup; loop top re-checks deadline
                    raise TimeoutError(
                        f"pool request {rid}: {len(got)}/{R} responses "
                        f"after {timeout}s"
                    ) from None
                if kind == "result":
                    if i in got:
                        # duplicate reply (a hedge twin, or an error-retry
                        # racing its original): first valid reply already
                        # won — discard idempotently
                        if i in req.hedged_shares:
                            self._account(hedge_wasted=1)
                    else:
                        got[i] = payload
                        with req.lock:
                            req.satisfied.add(i)
                elif kind == "error":
                    # a compute error is a worker failure, not a request
                    # failure: retry the share ONCE on a different worker,
                    # then write it off — the any-R decode only needs R of
                    # the remaining shares
                    bad_wid, err = payload
                    errors[i] = errors.get(i, 0) + 1
                    healthy = [
                        s for s in shares
                        if s in got or errors.get(s, 0) < 2
                    ]
                    if len(healthy) < R:
                        raise RuntimeError(
                            f"pool request {rid}: share {i} failed "
                            f"{errors[i]}x and only {len(healthy)} viable "
                            f"shares remain (R={R}); last error: {err}"
                        )
                    if errors[i] < 2 and i not in got:
                        t_enc = obs.now()
                        if key is None:
                            fa, gb = encode_at(A, B, i)
                        else:
                            fa, gb = encode_at(A, B, i, key)
                        fa, gb = to_numpy(fa), to_numpy(gb)
                        tracer.add(trace, "encode", "pool", t_enc,
                                   obs.now(), share=i, retry=True)
                        self._send_task(
                            req, scheme, i, fa, gb,
                            exclude=(bad_wid,), redispatch=True,
                        )
                else:  # "dead": no live workers remain for a re-dispatch
                    raise WorkerDied(
                        f"pool request {rid}: {payload} with {len(got)}/{R} "
                        f"responses collected"
                    )
            t_R = (time.perf_counter() - t0) * 1e3
            with req.lock:
                req.done = True
            # the any-R race: dispatch done -> R-th response landed
            tracer.add(trace, "wait_R", "pool", t_wait, obs.now(),
                       R=R, responders=sorted(got),
                       redispatched=req.redispatched, hedged=req.hedged)
            t_dec = obs.now()
            # the R responses decoded from, on the master's device
            C = decode_responses(scheme, {
                i: from_numpy(got[i], scheme.ring, self.device)
                for i in sorted(got)[:R]
            })
            tracer.add(trace, "decode", "pool", t_dec, obs.now(),
                       live_idx=sorted(got)[:R], scheme=scheme.name)
            wall_ms = (time.perf_counter() - t0) * 1e3
            stats = PoolStats(
                dispatched=tuple(shares),
                live_idx=tuple(sorted(got))[:R],
                workers=tuple(sorted(set(workers_used))),
                redispatched=req.redispatched,
                wall_ms=wall_ms,
                time_to_R_ms=t_R,
                hedged=req.hedged,
                batch=int(getattr(scheme, "batch", 1)),
                fill=(int(batch_fill) if batch_fill is not None
                      else int(getattr(scheme, "batch", 1))),
                raw_bytes_out=req.raw_out,
                bytes_out=req.wire_out,
                raw_bytes_in=req.raw_in,
                bytes_in=req.wire_in,
                codecs=tuple(sorted(req.codecs)),
            )
            ok = True
            self._account(completed=1)
            self._wall_hist.observe(wall_ms)
            self._time_to_R_hist.observe(t_R)
            return C, stats
        finally:
            if not ok:
                self._account(failed=1)
            with self._lock:
                self._requests.pop(rid, None)
                if trace is not None:
                    # keep routing late responders' spans to this timeline
                    self._done_traces[rid] = trace.trace_id
                    while len(self._done_traces) > self._done_traces_cap:
                        self._done_traces.pop(next(iter(self._done_traces)))

    def _operand(self, x, scheme):
        if isinstance(x, np.ndarray):
            return from_numpy(x, scheme.base, self.device)
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, pool master on {self.device}")
        return x

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        obs_http.unregister_source(self._obs_source)
        obs_http.unregister_trace_resolver(self._resolve_trace)
        with self._lock:
            handles = list(self._workers.values())
            self._workers.clear()
        for h in handles:
            try:
                h.send({"type": "shutdown"})
            except OSError:
                pass
            _shutdown_socket(h.sock)
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self) -> "Master":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# local pools: master + N worker OS processes in one call
# --------------------------------------------------------------------------


def _worker_env() -> Dict[str, str]:
    """Child env: inherit, but make sure the repro_torch package resolves."""
    import repro_torch

    env = dict(os.environ)
    pkg_dir = os.path.dirname(os.path.abspath(repro_torch.__file__))
    src = os.path.dirname(pkg_dir)
    parts = [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return env


_LEGACY_POOL_ARGS = (
    "workers", "address", "heartbeat_s", "heartbeat_timeout", "use_kernel",
    "spawn_timeout",
)


class LocalPool:
    """A master plus N local worker OS processes (the zero-config pool).

    The single-host specialization of the launcher
    (:func:`repro_torch.dist.launch.launch_pool`): prefers a Unix-domain socket
    under a private tempdir, falls back to loopback TCP.  ``kill(k)``
    SIGKILLs k workers (failure injection); ``close()`` shuts the master
    down and reaps every child.

    Preferred construction is ``LocalPool(config=PoolConfig(...))``;
    keyword arguments (``workers=``, ``address=``, ...) remain supported
    and override the config.  Positional arguments are deprecated (one
    ``DeprecationWarning`` per process) but keep working.  ``device``
    (None: the card) is the master's and every worker's.
    """

    def __init__(self, *args, config: Optional[PoolConfig] = None, device=None,
                 **kwargs):
        if args:
            warn_deprecated_once(
                "LocalPool-positional",
                "positional LocalPool arguments are deprecated; pass "
                "LocalPool(config=PoolConfig(workers=...)) or keyword "
                "arguments",
            )
            for name, val in zip(_LEGACY_POOL_ARGS, args):
                if name in kwargs:
                    raise TypeError(
                        f"LocalPool got multiple values for {name!r}"
                    )
                kwargs[name] = val
        unknown = set(kwargs) - set(_LEGACY_POOL_ARGS)
        if unknown:
            raise TypeError(f"LocalPool got unexpected {sorted(unknown)}")
        cfg = config or PoolConfig()
        if "address" in kwargs and kwargs["address"] is not None:
            cfg = cfg.with_(endpoint=Endpoint.parse(kwargs["address"]))
        for name in ("workers", "heartbeat_s", "heartbeat_timeout",
                     "use_kernel", "spawn_timeout"):
            if name in kwargs:
                cfg = cfg.with_(**{name: kwargs[name]})
        self.config = cfg
        device = resolve_device(device)  # raises before anything is spawned
        self._tmpdir = None
        if cfg.endpoint is None:
            if hasattr(socket, "AF_UNIX"):
                self._tmpdir = tempfile.mkdtemp(prefix="repro-torch-pool-")
                cfg = cfg.with_(endpoint=Endpoint.unix(
                    os.path.join(self._tmpdir, "pool.sock")
                ))
            else:  # pragma: no cover - non-POSIX fallback
                cfg = cfg.with_(endpoint=Endpoint.tcp("127.0.0.1", 0))
        self.master = Master(config=cfg, device=device)
        # the launcher owns process spawning; LocalPool is its local case
        from .launch import spawn_local_workers

        self.procs: List[subprocess.Popen] = spawn_local_workers(
            self.master.address, cfg.workers,
            heartbeat_s=cfg.heartbeat_s, name_prefix="local", device=device,
        )
        try:
            self.master.wait_for_workers(
                cfg.workers, timeout=cfg.spawn_timeout
            )
        except TimeoutError:
            self.close()
            raise

    @property
    def address(self) -> str:
        return self.master.address

    @property
    def device(self):
        return self.master.device

    def execute(self, scheme, A, B, mask=None, key=None, timeout=None,
                batch_fill=None, trace=None):
        return self.master.execute(scheme, A, B, mask=mask, key=key,
                                   timeout=timeout, batch_fill=batch_fill,
                                   trace=trace)

    def stats(self) -> Dict[str, object]:
        """Cumulative pool accounting (shared repro_torch.stats schema)."""
        return self.master.stats()

    def kill(self, k: int = 1, sig: int = signal.SIGKILL) -> List[int]:
        """SIGKILL ``k`` live worker processes; returns the killed pids."""
        killed = []
        for proc in self.procs:
            if len(killed) >= k:
                break
            if proc.poll() is None:
                os.kill(proc.pid, sig)
                killed.append(proc.pid)
        for pid in killed:  # reap promptly so poll() reflects reality
            for proc in self.procs:
                if proc.pid == pid:
                    proc.wait(timeout=30)
        return killed

    def alive_count(self) -> int:
        return sum(1 for p in self.procs if p.poll() is None)

    def close(self) -> None:
        self.master.close()
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                proc.kill()
                proc.wait(timeout=10)
        if self._tmpdir:
            try:
                sock = os.path.join(self._tmpdir, "pool.sock")
                if os.path.exists(sock):
                    os.unlink(sock)
                os.rmdir(self._tmpdir)
            except OSError:  # pragma: no cover
                pass

    def __enter__(self) -> "LocalPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
