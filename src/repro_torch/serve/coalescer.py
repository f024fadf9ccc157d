"""BatchCoalescer: group concurrent same-spec requests into batch slots —
the port's copy of ``repro.serve.coalescer``.

This is the policy half of continuous batching, kept free of threads,
sockets and devices so the latency/throughput trade is unit-testable with a
synthetic clock: the engine thread feeds requests in arrival order and the
coalescer decides *when a buffer becomes a batch*:

  * the moment it reaches its ``cap`` (the RMFE pack size of the planned
    batch scheme — never beyond, a packed codeword has exactly that many
    slots), or
  * when the oldest member has waited ``max_wait_ms`` (the latency bound:
    no request waits for peers longer than the knob allows), or
  * in ``adaptive`` mode, when arrivals pause — the buffer is flushed once
    ``adaptive_idle_ms`` passes without a new same-spec request while the
    admission queue is empty.  Deep queues therefore fill batches to cap
    (arrivals keep refreshing the idle clock as fast as the engine drains
    them) while an idle service degenerates to per-request dispatch with
    ~``adaptive_idle_ms`` added latency instead of always paying
    ``max_wait_ms``.

Requests only ever coalesce within one buffer key — the engine keys
buffers by the full ``ProblemSpec`` — so mixed-spec streams can never pack
into one codeword (tests/test_torch_serve.py holds its flush decisions
equal to the reference's).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

__all__ = ["BatchCoalescer", "CoalescePolicy"]


@dataclass(frozen=True)
class CoalescePolicy:
    """The latency/throughput knob of the serving engine.

    ``target_batch_n`` is the concurrency the planner prices coalescing at
    (an upper bound on the searched batch arity, not a promise: the
    ``"amortized"`` objective may choose a smaller fill — or reject
    coalescing entirely and fall back to per-request dispatch).
    ``max_wait_ms`` bounds how long any request waits for peers.
    ``adaptive`` flushes partial batches as soon as arrivals pause instead
    of sitting out the full wait (see module docstring).
    """

    target_batch_n: int = 8
    max_wait_ms: float = 5.0
    adaptive: bool = False
    adaptive_idle_ms: float = 0.5

    def validate(self) -> None:
        if self.target_batch_n < 1:
            raise ValueError(
                f"target_batch_n must be >= 1, got {self.target_batch_n}"
            )
        if self.max_wait_ms < 0 or self.adaptive_idle_ms < 0:
            raise ValueError("wait knobs must be >= 0")


@dataclass
class _Buffer:
    cap: int
    first_s: float  # arrival of the oldest member (monotonic seconds)
    last_s: float  # arrival of the newest member
    items: List = field(default_factory=list)


class BatchCoalescer:
    """Per-key request buffers governed by one :class:`CoalescePolicy`."""

    def __init__(self, policy: CoalescePolicy):
        policy.validate()
        self.policy = policy
        self._buffers: Dict[Hashable, _Buffer] = {}

    # -- feeding -----------------------------------------------------------

    def add(
        self, key: Hashable, item, cap: int, now_s: float
    ) -> Optional[List]:
        """Buffer one request under ``key``; returns the full batch the
        moment the buffer reaches ``cap`` (and removes it), else None."""
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = _Buffer(
                cap=cap, first_s=now_s, last_s=now_s
            )
        buf.cap = cap
        buf.last_s = now_s
        buf.items.append(item)
        if len(buf.items) >= buf.cap:
            del self._buffers[key]
            return buf.items
        return None

    # -- draining ----------------------------------------------------------

    def _deadline_s(self, buf: _Buffer, queue_empty: bool) -> float:
        deadline = buf.first_s + self.policy.max_wait_ms / 1e3
        if self.policy.adaptive and queue_empty:
            deadline = min(
                deadline, buf.last_s + self.policy.adaptive_idle_ms / 1e3
            )
        return deadline

    def due(
        self, now_s: float, queue_empty: bool = True
    ) -> List[Tuple[Hashable, List]]:
        """Pop every buffer whose wait budget is spent at ``now_s``."""
        out = []
        for key, buf in list(self._buffers.items()):
            if now_s >= self._deadline_s(buf, queue_empty):
                del self._buffers[key]
                out.append((key, buf.items))
        return out

    def next_wait_s(
        self, now_s: float, queue_empty: bool = True
    ) -> Optional[float]:
        """Seconds until the earliest buffer expires (None: nothing
        buffered, the engine may block on admissions indefinitely)."""
        if not self._buffers:
            return None
        earliest = min(
            self._deadline_s(buf, queue_empty)
            for buf in self._buffers.values()
        )
        return max(earliest - now_s, 0.0)

    def flush_all(self) -> List[Tuple[Hashable, List]]:
        """Pop every buffer regardless of wait budget (shutdown drain)."""
        out = [(key, buf.items) for key, buf in self._buffers.items()]
        self._buffers.clear()
        return out

    def pending(self) -> int:
        return sum(len(b.items) for b in self._buffers.values())
