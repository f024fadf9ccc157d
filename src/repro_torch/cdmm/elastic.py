"""Elastic event-driven execution backend: decode at the R-th response —
counterpart of ``repro.cdmm.elastic``.

The ``local`` backend runs encode -> compute-all -> decode behind a barrier,
so a single straggler costs wall-clock even though any R of N responses
suffice.  :class:`ElasticBackend` completes at the R-th fastest response:

  * the master encodes per-worker shares (``encode_*_at``) and dispatches
    each worker's compute to a thread pool the moment that worker is
    scheduled, so later encodes overlap earlier computes;
  * worker results land on a response queue; the any-R decode fires the
    moment the R-th needed response arrives, through the scheme's
    per-live-set decode operator (``CdmmScheme.decode_op``);
  * membership is a :class:`~repro_torch.core.straggler.WorkerTrace`:
    workers may join late, leave mid-batch (never responding) or run slow;
    the master races past anything outside the R fastest responders;
  * :class:`ElasticStream` carves the live pool into groups of
    ``group_size`` workers, re-chunks the batch on every membership change
    (``repro_torch.runtime.elastic.replan_batch``) and re-plans the scheme
    for the new batch size.

On the card every worker thread launches on the stream the master encoded
on (captured at dispatch, with its device): one shared stream keeps the
shares' memory safe without cross-stream bookkeeping.  The counterpart of
the reference's ``block_until_ready`` is one CUDA event per worker,
recorded after its product and waited on in that worker's thread, so a slow
worker never turns the race into a device-wide barrier.

Determinism: the decoded subset varies with the trace (first R *arrivals*,
not first R indices), but every registered scheme's any-R decode is
integer-exact, so the output equals the ``local`` backend's bit for bit for
every valid trace.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.galois import Ring
from ..core.straggler import WorkerTrace
from ..device import resolve_device
from ..obs import trace as obs
from ..runtime.elastic import replan_batch
from .api import CdmmScheme, ProblemSpec
from .backends import check_use_kernel, encode_all, register_backend
from .planner import plan

__all__ = [
    "ElasticBackend",
    "ElasticStats",
    "ElasticStream",
    "NotEnoughResponders",
    "decode_responses",
    "worker_closures",
]


class NotEnoughResponders(RuntimeError):
    """Raised when a trace/mask leaves fewer than R workers ever responding:
    the any-R decode is mathematically impossible, and decoding from repeated
    indices would return garbage silently."""


@dataclass(frozen=True)
class ElasticStats:
    """Per-call accounting of one elastic execution (virtual-time model)."""

    fast_path: bool  # all-live batched path, no thread pool
    dispatched: Tuple[int, ...]  # workers whose compute was launched
    live_idx: Tuple[int, ...]  # the R-subset actually decoded from
    n_responders: int  # workers whose response would eventually land
    time_to_R_ms: float  # virtual arrival of the R-th response
    time_to_all_ms: float  # virtual arrival of the last response (inf if
    #                         any worker never responds — the sync barrier)
    wall_ms: float  # measured master wall-clock (host) for the call


def _response_order(resp_ms: np.ndarray) -> np.ndarray:
    """Worker indices sorted by virtual arrival (ties -> lower index)."""
    return np.lexsort((np.arange(len(resp_ms)), resp_ms))


def decode_responses(scheme: CdmmScheme, got: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The shared response-ordering/decode tail of every any-R master.

    ``got`` maps worker index -> response for (at least) R workers.  The
    live set is canonicalized to sorted order — the any-R decode is
    subset-order agnostic as long as rows match ``idx``, and a canonical
    order maximizes ``decode_op`` cache reuse across membership patterns.
    """
    if len(got) < scheme.R:
        raise NotEnoughResponders(
            f"{scheme.name}: decode needs R={scheme.R} responses, "
            f"have {len(got)}"
        )
    idx = tuple(sorted(int(i) for i in got))[: scheme.R]
    return scheme.decode_op(idx)(torch.stack([got[i] for i in idx]))


def worker_closures(scheme: CdmmScheme, keyed: bool = False, use_kernel: Optional[bool] = None):
    """(encode_at, compute) closures for one scheme.

    ``encode_at(A, B, i[, key])`` returns worker i's two shares;
    ``compute(fa, gb)`` its block product, the scheme's ``worker_compute``
    on a batch of one.  ``keyed`` selects the keyed-encode variant (secure
    schemes regenerate the same masks from the key in every call).
    ``use_kernel``: see :func:`~repro_torch.cdmm.backends.check_use_kernel`.
    """
    check_use_kernel(scheme, use_kernel)
    if keyed:
        def encode_at(a, b, i, k):
            return scheme.encode_a_at(a, i, key=k), scheme.encode_b_at(b, i, key=k)
    else:
        def encode_at(a, b, i):
            return scheme.encode_a_at(a, i), scheme.encode_b_at(b, i)

    def compute(fa, gb):
        return scheme.worker_compute(fa[None], gb[None])[0]

    return encode_at, compute


def _on_stream(device: torch.device, stream):
    """Enter ``device`` and ``stream`` in the calling (worker) thread: a
    fresh thread's current stream is the default one, not the master's."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


class ElasticBackend:
    """Event-driven elastic execution of one coded matmul.

    ``trace`` fixes the membership realization (default: everyone live and
    instant — the fast path).  An (N,)-bool ``mask`` passed at call time is
    composed with the trace (masked-out workers never respond).
    ``simulate_ms_scale > 0`` makes worker threads sleep
    ``response_ms * scale / 1000`` seconds so *real* wall-clock exhibits the
    race past stragglers (benchmarks); leave at 0 for tests.
    ``use_kernel``: see :func:`~repro_torch.cdmm.backends.check_use_kernel`.
    """

    name = "elastic"

    def __init__(
        self,
        trace: Optional[WorkerTrace] = None,
        simulate_ms_scale: float = 0.0,
        use_kernel: Optional[bool] = None,
    ):
        self.trace = trace
        self.simulate_ms_scale = simulate_ms_scale
        self.use_kernel = use_kernel
        self.last_stats: Optional[ElasticStats] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        self._inflight: list = []  # futures of the last traced call

    def _worker_pool(self, n: int) -> ThreadPoolExecutor:
        # one pool per backend instance, sized to the scheme's worker count:
        # a cap below N would serialize dispatch and make simulated
        # stragglers block fast workers' slots.  Grown, never shrunk.
        want = max(n, 8)
        if self._pool is None or self._pool_size < want:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = ThreadPoolExecutor(max_workers=want, thread_name_prefix="cdmm-elastic")
            self._pool_size = want
        return self._pool

    def drain(self) -> None:
        """Wait for every worker task of the last traced call, stragglers
        and dead workers included (the master returns at the R-th response
        and does not wait for them)."""
        wait_futures(self._inflight)

    def close(self) -> None:
        """Release the worker thread pool (idempotent).  In-flight straggler
        tasks are abandoned, not joined."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pool_size = 0

    def __enter__(self) -> "ElasticBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- protocol entry point ------------------------------------------------

    def __call__(
        self,
        scheme: CdmmScheme,
        A: torch.Tensor,
        B: torch.Tensor,
        mask=None,
        key: Optional[int] = None,
    ) -> torch.Tensor:
        C, self.last_stats = self.run(scheme, A, B, mask, key=key)
        return C

    def run(
        self,
        scheme: CdmmScheme,
        A: torch.Tensor,
        B: torch.Tensor,
        mask=None,
        key: Optional[int] = None,
    ) -> Tuple[torch.Tensor, ElasticStats]:
        t0 = time.perf_counter()
        check_use_kernel(scheme, self.use_kernel)
        if self.trace is None and mask is None:
            return self._run_all_live(scheme, A, B, t0, key)
        trace = self.trace or WorkerTrace.all_live(scheme.N)
        if trace.N != scheme.N:
            raise ValueError(
                f"trace has N={trace.N} workers, scheme needs N={scheme.N}"
            )
        if mask is not None:
            if isinstance(mask, torch.Tensor):
                mask = mask.cpu()
            trace = trace.restrict(np.asarray(mask, dtype=bool))
        return self._run_traced(scheme, A, B, trace, t0, key)

    # -- all-live fast path --------------------------------------------------

    def _run_all_live(self, scheme, A, B, t0, key=None):
        """Everyone present and instant: one batched worker launch, and the
        decode through the cached per-live-set operator, as the event loop
        decodes."""
        ctx = obs.maybe_context("elastic")
        tracer = obs.tracer()
        with tracer.span(ctx, "encode", "elastic", scheme=scheme.name):
            FA, GB = encode_all(scheme, A, B, key=key)
        with tracer.span(ctx, "compute", "elastic", N=int(scheme.N)):
            H = scheme.worker_compute(FA, GB)
        idx = tuple(range(scheme.R))
        with tracer.span(ctx, "decode", "elastic", scheme=scheme.name):
            C = scheme.decode_op(idx)(H[: scheme.R])
        stats = ElasticStats(
            fast_path=True,
            dispatched=tuple(range(scheme.N)),
            live_idx=idx,
            n_responders=scheme.N,
            time_to_R_ms=0.0,
            time_to_all_ms=0.0,
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )
        return C, stats

    # -- event-driven master loop --------------------------------------------

    def _run_traced(self, scheme, A, B, trace: WorkerTrace, t0, key=None):
        N, R = scheme.N, scheme.R
        resp = trace.response_ms()
        responders = np.flatnonzero(np.isfinite(resp))
        if len(responders) < R:
            raise NotEnoughResponders(
                f"{scheme.name}: only {len(responders)} of N={N} workers "
                f"ever respond, decode needs R={R}"
            )
        # the R virtually-fastest responders; the master is done at t_R and
        # never even dispatches workers that join after that
        order = _response_order(resp)
        fastR = order[:R]
        t_R = trace.time_to_kth_response(R)
        t_all = trace.time_to_kth_response(N)
        dispatch = [i for i in np.argsort(trace.join_ms, kind="stable")
                    if trace.join_ms[i] <= t_R]

        encode_at, compute = worker_closures(
            scheme, keyed=key is not None, use_kernel=self.use_kernel
        )
        ctx = obs.maybe_context("elastic")
        tracer = obs.tracer()
        device = scheme.code.device
        # the master's stream: every worker launches on it (see module doc)
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

        q: "queue.Queue" = queue.Queue()
        scale = self.simulate_ms_scale
        done = threading.Event()  # master finished: stragglers stop early

        def worker_task(i: int, fa, gb):
            try:
                t_c = obs.now()
                with _on_stream(device, stream):
                    h = compute(fa, gb)
                    if stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                        ready.synchronize()  # this worker's product, not the card
                tracer.add(ctx, "compute", "worker", t_c, obs.now(),
                           wid=int(i), share=int(i), simulated=True)
                if scale > 0.0 and np.isfinite(resp[i]):
                    # simulated latency; cut short the moment the master
                    # decodes so stragglers never block pool reuse or exit
                    done.wait(resp[i] * scale / 1e3)
                q.put((i, h, None))
            except Exception as e:  # surfaced on the master thread
                q.put((i, None, e))

        needed = set(int(i) for i in fastR)
        got: Dict[int, torch.Tensor] = {}
        pool = self._worker_pool(len(dispatch))
        self._inflight = []
        # dispatch in join order; encode of worker k overlaps the pool's
        # compute of workers < k (the master thread never blocks here)
        for i in dispatch:
            t_e = obs.now()
            if key is None:
                fa, gb = encode_at(A, B, int(i))
            else:
                fa, gb = encode_at(A, B, int(i), key)
            tracer.add(ctx, "encode", "elastic", t_e, obs.now(), share=int(i))
            self._inflight.append(pool.submit(worker_task, int(i), fa, gb))
        # response queue: consume until the R-th needed response lands;
        # straggler tasks drain into the dead queue after `done` fires
        t_w = obs.now()
        try:
            while needed - set(got):
                i, h, err = q.get()
                if err is not None:
                    raise err
                if i in needed:
                    got[i] = h
        finally:
            done.set()  # race past stragglers: wake any simulated sleeps
        tracer.add(ctx, "wait_R", "elastic", t_w, obs.now(),
                   R=int(R), responders=sorted(int(i) for i in got))

        t_d = obs.now()
        C = decode_responses(scheme, got)
        tracer.add(ctx, "decode", "elastic", t_d, obs.now(), scheme=scheme.name)
        idx = tuple(sorted(int(i) for i in fastR))
        stats = ElasticStats(
            fast_path=False,
            dispatched=tuple(int(i) for i in dispatch),
            live_idx=idx,
            n_responders=len(responders),
            time_to_R_ms=t_R,
            time_to_all_ms=t_all,
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )
        return C, stats


register_backend("elastic", ElasticBackend)


# --------------------------------------------------------------------------
# batch streams that rescale mid-stream
# --------------------------------------------------------------------------


class ElasticStream:
    """Run a stream of batch matmuls over a worker pool that rescales.

    The live pool is carved into ``live // group_size`` independent groups;
    each wave, every group executes one planner-chosen coded scheme over its
    chunk of the global batch.  On a membership change the per-group batch
    is re-chunked with :func:`repro_torch.runtime.elastic.replan_batch`
    (ceil — the trailing chunk is zero-padded and trimmed after decode) and
    the planner re-ranks schemes for the new batch size.  Plans are
    memoized per chunk size.  Schemes live on ``device`` (None: CUDA).
    """

    def __init__(
        self,
        t: int,
        r: int,
        s: int,
        ring: Ring,
        group_size: int = 8,
        objective: str = "latency",
        straggler_budget: int = 0,
        backend: Optional[ElasticBackend] = None,
        device=None,
    ):
        self.t, self.r, self.s, self.ring = t, r, s, ring
        self.group_size = group_size
        self.objective = objective
        self.straggler_budget = straggler_budget
        self.backend = backend or ElasticBackend()
        self.device = resolve_device(device)
        self._schemes: Dict[int, CdmmScheme] = {}
        self.last_replan: Optional[Tuple[int, int]] = None  # (groups, per)

    def _scheme_for(self, per: int) -> CdmmScheme:
        if per not in self._schemes:
            spec = ProblemSpec(
                self.t, self.r, self.s, n=per, ring=self.ring,
                N=self.group_size, straggler_budget=self.straggler_budget,
            )
            self._schemes[per] = plan(spec, objective=self.objective).instantiate(
                device=self.device)
        return self._schemes[per]

    def step(self, As: torch.Tensor, Bs: torch.Tensor, live: int) -> torch.Tensor:
        """One wave: ``As (n, t, r, D0) @ Bs (n, r, s, D0)`` with ``live``
        workers currently in the pool.  Returns ``Cs (n, t, s, D0)``."""
        nprod = int(As.shape[0])
        groups = live // self.group_size
        if groups < 1:
            raise NotEnoughResponders(
                f"pool of {live} live workers cannot form one group of "
                f"{self.group_size}"
            )
        per = replan_batch(nprod, groups)
        self.last_replan = (groups, per)
        scheme = self._scheme_for(per)
        chunk = scheme.batch  # may exceed `per` (RMFE packs up, never down)

        outs = []
        for lo in range(0, nprod, chunk):
            Ac, Bc = As[lo : lo + chunk], Bs[lo : lo + chunk]
            pad = chunk - Ac.shape[0]
            if pad:
                Ac = torch.cat([Ac, Ac.new_zeros((pad, *As.shape[1:]))])
                Bc = torch.cat([Bc, Bc.new_zeros((pad, *Bs.shape[1:]))])
            if chunk == 1:
                outs.append(self.backend(scheme, Ac[0], Bc[0])[None])
            else:
                outs.append(self.backend(scheme, Ac, Bc))
        return torch.cat(outs, dim=0)[:nprod]
