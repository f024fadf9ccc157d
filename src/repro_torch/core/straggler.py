"""Straggler modelling and responsive-worker selection — counterpart of
``repro.core.straggler``.

The whole point of CDMM is that the master decodes from the FIRST R
responses.  ``select_workers`` turns a boolean liveness mask into the
worker-index vector the decoders take.

For the elastic backend (``repro_torch.cdmm.elastic``) liveness is richer
than a bool: workers join late, leave mid-batch, or run slow.
``WorkerTrace`` captures one realization of that membership process — per
worker join time, leave time and compute latency — and ``sample_trace``
draws randomized traces from the heavy-tailed latency model the planner's
``time_to_R`` objective uses.  ``WorkerTrace`` and ``MembershipEvents`` are
numpy code, the reference's as they are.

The samplers take the port's key, a non-negative int (as the secure codes
do), and draw from a CPU ``torch.Generator`` seeded from it: a fixed key
gives fixed draws, but not the reference's bits (``jax.random``'s threefry
is not reproduced).  Their tensors live on the CPU: they model the host's
view of the pool, and the backends move masks to the scheme's device.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .galois import _seed64, fold_in

__all__ = [
    "select_workers",
    "simulate_stragglers",
    "straggler_latencies",
    "MembershipEvents",
    "WorkerTrace",
    "sample_trace",
]


def select_workers(mask: torch.Tensor, R: int) -> torch.Tensor:
    """First R responsive worker indices (stable order). mask: (N,) bool.

    Requires sum(mask) >= R for a valid decode; with fewer responders the
    trailing indices repeat dead workers and the caller must treat the
    result as failed (see the ``enough`` flag of ``simulate_stragglers``).
    """
    # torch sorts no bool tensors: order by ~mask as 0/1 integers
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    return order[:R]


def _uniform(key: int, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [low, high) from a CPU generator seeded by ``key``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(_seed64(key))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (high - low) + low


def simulate_stragglers(
    key: int, N: int, fail_prob: float, min_live: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random liveness mask; guarantees at least ``min_live`` workers live.

    Returns (mask (N,) bool, enough: () bool — whether the raw draw already
    had >= min_live responders before the guarantee kicked in).
    """
    raw = _uniform(key, (N,)) >= fail_prob
    enough = raw.sum() >= min_live
    # force the first min_live workers alive if the draw was too harsh —
    # models re-dispatch/retry in a real scheduler
    forced = torch.where(torch.arange(N) < min_live, True, raw)
    mask = torch.where(enough, raw, forced)
    return mask, enough


def straggler_latencies(
    key: int, N: int, base_ms: float = 1.0, tail: float = 3.0
) -> torch.Tensor:
    """Pareto-ish latency model: most workers ~base, a heavy tail of
    stragglers, float32 (N,).  The planner's ``time_to_R`` objective and
    ``sample_trace`` draw from it."""
    u = _uniform(key, (N,), 1e-6, 1.0)
    return base_ms * (1.0 + tail * (u ** (-0.5) - 1.0))


@dataclass(frozen=True)
class WorkerTrace:
    """One realization of an elastic worker-membership process.

    Worker i joins at ``join_ms[i]``, leaves (forever) at ``leave_ms[i]``
    (+inf = never leaves), and — once joined — takes ``compute_ms[i]`` of
    wall-clock to produce its response.  A worker responds iff it finishes
    before leaving; its response lands at ``join + compute``.
    """

    join_ms: np.ndarray  # (N,) float
    leave_ms: np.ndarray  # (N,) float, +inf = stays for the whole batch
    compute_ms: np.ndarray  # (N,) float

    def __post_init__(self):
        n = len(self.join_ms)
        if not (len(self.leave_ms) == len(self.compute_ms) == n):
            raise ValueError("WorkerTrace arrays must share one length N")

    @property
    def N(self) -> int:
        return len(self.join_ms)

    def response_ms(self) -> np.ndarray:
        """(N,) virtual arrival time of each worker's response; +inf for
        workers that leave before finishing (they never respond)."""
        done = self.join_ms + self.compute_ms
        return np.where(done <= self.leave_ms, done, np.inf)

    def mask(self) -> np.ndarray:
        """(N,) bool liveness: workers whose response eventually lands."""
        return np.isfinite(self.response_ms())

    def restrict(self, mask) -> "WorkerTrace":
        """Trace with workers where ``mask`` is False forced dead (they
        leave before joining) — composes an external fault mask with the
        membership process."""
        mask = np.asarray(mask, dtype=bool)
        leave = np.where(mask, self.leave_ms, self.join_ms - 1.0)
        return WorkerTrace(self.join_ms, leave, self.compute_ms)

    def time_to_kth_response(self, k: int) -> float:
        """Virtual time at which the k-th response lands (inf if < k land)."""
        resp = np.sort(self.response_ms())
        return float(resp[k - 1]) if k <= self.N else float("inf")

    @staticmethod
    def all_live(N: int) -> "WorkerTrace":
        """Degenerate trace: everyone present from t=0, instant compute."""
        z = np.zeros(N)
        return WorkerTrace(z, np.full(N, np.inf), z)


class MembershipEvents:
    """Live join/leave/response bookkeeping that *produces* WorkerTraces.

    ``WorkerTrace`` is one frozen realization of a membership process; a
    running master observes that process as events instead.  This
    accumulator records real wall-clock joins, leaves and response latencies
    per worker id and renders the history as a ``WorkerTrace`` on demand, so
    everything built on trace semantics (expected time-to-R, elastic-style
    stats) applies unchanged to a real pool.  Thread-safe: a master's reader
    threads record concurrently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = None  # epoch of the first event; trace times are relative
        self._join: dict = {}
        self._leave: dict = {}
        self._last_response: dict = {}
        self._order: list = []  # worker ids in join order (stable slots)

    def _now_ms(self, t: float) -> float:
        if self._t0 is None:
            self._t0 = t
        return (t - self._t0) * 1e3

    def record_join(self, wid, t: float) -> None:
        with self._lock:
            if wid not in self._join:
                self._join[wid] = self._now_ms(t)
                self._order.append(wid)
            self._leave.pop(wid, None)  # re-join after a recorded leave

    def record_leave(self, wid, t: float) -> None:
        with self._lock:
            if wid in self._join and wid not in self._leave:
                self._leave[wid] = self._now_ms(t)

    def record_response(self, wid, compute_ms: float) -> None:
        with self._lock:
            if wid in self._join:
                self._last_response[wid] = float(compute_ms)

    def live(self) -> Tuple:
        """Worker ids currently joined and not left, in join order."""
        with self._lock:
            return tuple(w for w in self._order if w not in self._leave)

    def seen(self) -> Tuple:
        with self._lock:
            return tuple(self._order)

    def trace(self) -> WorkerTrace:
        """The observed history as a WorkerTrace over every worker seen.

        Workers still in the pool get ``leave_ms = +inf``; a worker that
        never responded gets ``compute_ms = +inf`` (it contributes no
        response, exactly like a leaver mid-compute).
        """
        with self._lock:
            join = np.array(
                [self._join[w] for w in self._order], dtype=float
            )
            leave = np.array(
                [self._leave.get(w, np.inf) for w in self._order],
                dtype=float,
            )
            compute = np.array(
                [self._last_response.get(w, np.inf) for w in self._order],
                dtype=float,
            )
        return WorkerTrace(join, leave, compute)


def sample_trace(
    key: int,
    N: int,
    *,
    base_ms: float = 1.0,
    tail: float = 3.0,
    join_spread_ms: float = 0.0,
    leave_prob: float = 0.0,
    slowdown_prob: float = 0.0,
    slowdown_factor: float = 10.0,
) -> WorkerTrace:
    """Randomized join/leave/slowdown trace over the latency model.

    Each worker draws a heavy-tailed compute latency; a ``slowdown_prob``
    fraction is further slowed by ``slowdown_factor`` (persistent straggler);
    joins are uniform in [0, join_spread_ms]; a ``leave_prob`` fraction
    leaves halfway through its compute and never responds.  The four draws
    use the keys ``fold_in(key, 0..3)``.
    """
    k_lat, k_join, k_leave, k_slow = (fold_in(key, j) for j in range(4))
    compute = straggler_latencies(k_lat, N, base_ms, tail).numpy().astype(float)
    slow = _uniform(k_slow, (N,)).numpy() < slowdown_prob
    compute = np.where(slow, compute * slowdown_factor, compute)
    join = _uniform(k_join, (N,)).numpy().astype(float) * join_spread_ms
    leaves = _uniform(k_leave, (N,)).numpy() < leave_prob
    leave = np.where(leaves, join + 0.5 * compute, np.inf)
    return WorkerTrace(join, leave, compute)
