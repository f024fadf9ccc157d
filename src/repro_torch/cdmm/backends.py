"""Execution backends behind one entry point: ``coded_matmul``.

Counterpart of ``repro.cdmm.backends``.  ``local``: encode, all N worker
products (one batched kernel launch on the card), response gather, any-R
decode from the first R live workers.  ``elastic``
(``repro_torch.cdmm.elastic``, registered on import of ``repro_torch.cdmm``):
an event-driven master that dispatches per-worker encode and compute and
decodes at the R-th arrival.  Every registered scheme is integer-exact, so
the result equals ``A @ B`` bit for bit whatever the live set.

``pool`` (``repro_torch.dist``, imported on first use of the name): the
same protocol over real worker OS processes.  ``shard_map``: the protocol
SPMD over N ranks of a ``torch.distributed`` group
(``repro_torch.cdmm.runtime``), one rank per worker, each encoding its own
share, computing its product and all-gathering the responses.

The local and elastic backends record ``repro_torch.obs`` spans (encode /
compute / decode, the reference's schema) when tracing is on; with it off
the cost is one ``None`` check per call.  ``shard_map`` adds a ``gather``
span, and its spans close after the card finished the stage.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.galois import from_numpy
from ..core.straggler import select_workers
from ..device import resolve_device
from ..obs import trace as obs
from . import runtime
from .api import CdmmScheme
from .planner import Plan

__all__ = [
    "LocalSimBackend",
    "ShardMapBackend",
    "shard_worker_body",
    "check_use_kernel",
    "coded_matmul",
    "get_backend",
    "register_backend",
    "live_indices",
    "encode_all",
    "decode_from",
]


def check_use_kernel(scheme: CdmmScheme, use_kernel: Optional[bool]) -> None:
    """``use_kernel`` is accepted for parity with the reference, which can
    pin XLA with False.  On the card the ring matmul's only path is the
    kernel: None and True mean it, and False raises ValueError rather than
    fall back to the plain version quietly.  On the CPU it is ignored."""
    if use_kernel is False and scheme.code.device.type == "cuda":
        raise ValueError(
            f"{scheme.name}: use_kernel=False on the card; the kernel is the only "
            "path of a ring matmul there (run on the CPU for the plain version)"
        )


def live_indices(scheme: CdmmScheme, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """First-R live worker indices under ``mask`` (all-live when None)."""
    device = scheme.code.device
    if mask is None:
        return torch.arange(scheme.R, device=device)
    return select_workers(torch.as_tensor(mask, dtype=torch.bool, device=device), scheme.R)


def encode_all(
    scheme: CdmmScheme, A: torch.Tensor, B: torch.Tensor, key: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Master-side encode of both operands: (N, ...) share stacks.

    ``key`` feeds the masks of secure schemes (each side derives its own
    from it); the other schemes ignore it.
    """
    return scheme.encode_a(A, key=key), scheme.encode_b(B, key=key)


def decode_from(scheme: CdmmScheme, H: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Any-R decode from the responses of workers ``idx`` (rows of ``H``
    indexed by worker, i.e. the full (N, ...) response stack)."""
    return scheme.decode(H.index_select(0, idx), idx)


class LocalSimBackend:
    """Simulate all N workers locally; decode from the first R responsive
    workers under ``mask``."""

    name = "local"

    def __call__(
        self,
        scheme: CdmmScheme,
        A: torch.Tensor,
        B: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        key: Optional[int] = None,
    ) -> torch.Tensor:
        # the reference's span schema, so a "local" trace reads like a pool
        # trace; spans time the host side of asynchronous launches
        ctx = obs.maybe_context("local")
        tracer = obs.tracer()
        with tracer.span(ctx, "encode", "local", scheme=scheme.name):
            FA, GB = encode_all(scheme, A, B, key=key)
        with tracer.span(ctx, "compute", "local", N=int(scheme.N)):
            H = scheme.worker_compute(FA, GB)
        with tracer.span(ctx, "decode", "local", scheme=scheme.name):
            return decode_from(scheme, H, live_indices(scheme, mask))


@contextlib.contextmanager
def _stage(ctx, name: str, device: torch.device, **tags):
    """One ``shard_map`` span; traced, it closes after the card finished
    the stage (so the product's span is device time, not its enqueue)."""
    with obs.tracer().span(ctx, name, "shard_map", **tags) as live:
        yield live
        if ctx is not None and device.type == "cuda":
            torch.cuda.synchronize(device)


def shard_worker_body(
    scheme: CdmmScheme,
    axis: str,
    A: torch.Tensor,
    B: torch.Tensor,
    mask=None,
    *,
    use_kernel: Optional[bool] = None,
    key: Optional[int] = None,
) -> torch.Tensor:
    """Per-rank master/worker protocol: call on every rank of the group
    bound to ``axis`` (``runtime.cdmm_shard_map``) with all operands
    replicated.

    Each rank encodes only its own codeword pair (``encode_a_at`` /
    ``encode_b_at`` at its index: no rank materialises all N shares),
    computes its block product, all-gathers the N responses and decodes
    from the first R live workers under ``mask`` (every rank computes; the
    mask only selects which responses are read).  ``key`` feeds every rank
    the same masks of a secure scheme (drawn from the same generator seed
    on the same device type), so the codeword polynomial is consistent.
    """
    check_use_kernel(scheme, use_kernel)
    dev = scheme.code.device
    i = runtime.axis_index(axis)
    ctx = obs.maybe_context("shard_map")
    with _stage(ctx, "encode", dev, rank=i, scheme=scheme.name):
        fa = scheme.encode_a_at(A, i, key=key)
        gb = scheme.encode_b_at(B, i, key=key)
    with _stage(ctx, "compute", dev, rank=i):
        h = scheme.worker_compute(fa[None], gb[None])[0]
    with _stage(ctx, "gather", dev, rank=i, bytes_in=h.numel() * h.element_size() * scheme.N):
        H = runtime.all_gather(h, axis)
    with _stage(ctx, "decode", dev, rank=i, scheme=scheme.name):
        return decode_from(scheme, H, live_indices(scheme, mask))


class ShardMapBackend:
    """Run the protocol SPMD over a group of N ranks, one per worker.

    Inside an initialized ``torch.distributed`` world of size N (e.g. under
    ``torchrun``) every rank calls with replicated operands and the default
    group is the worker axis.  Otherwise the caller joins as rank 0 of a
    :class:`~repro_torch.cdmm.runtime.RankPool` spawned once per N on the
    operands' device (or the one given as ``pool``): the operands are
    broadcast from this process and ``close()`` stops the ranks.
    ``last_reports``: every rank's launches per route (and, with
    ``trace=True``, its encode / compute / gather / decode spans).
    """

    name = "shard_map"

    def __init__(self, pool: Optional["runtime.RankPool"] = None, axis: str = "workers",
                 use_kernel: Optional[bool] = None, trace: bool = False):
        self.axis, self.use_kernel, self.trace = axis, use_kernel, trace
        self._pools: dict = {} if pool is None else {pool.size: pool}
        self._owned = pool is None
        self.last_reports: list = []

    def pool(self, N: int, device=None) -> "runtime.RankPool":
        """The rank pool of N ranks (spawned on first use)."""
        if N not in self._pools:
            self._pools[N] = runtime.RankPool(N, device=device, trace=self.trace)
        return self._pools[N]

    def __call__(
        self,
        scheme: CdmmScheme,
        A: torch.Tensor,
        B: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        key: Optional[int] = None,
    ) -> torch.Tensor:
        body = functools.partial(shard_worker_body, scheme, self.axis,
                                 use_kernel=self.use_kernel, key=key)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool).cpu()
        if dist.is_initialized() and dist.get_world_size() == scheme.N:
            with runtime.bind_axis(self.axis, runtime.RankGroup.world()):
                return body(A, B, mask)
        pool = self.pool(scheme.N, scheme.code.device)
        out = pool.run(body, A, B, mask, axis=self.axis)
        self.last_reports = pool.last_reports
        return out

    def close(self) -> None:
        """Stop the rank pools this backend spawned (idempotent)."""
        if self._owned:
            for pool in self._pools.values():
                pool.close()
        self._pools = {}

    def __enter__(self) -> "ShardMapBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_shared_shard_map: Optional[ShardMapBackend] = None


def _shard_map_backend() -> ShardMapBackend:
    """``backend="shard_map"``: one process-wide instance, so its rank pools
    are spawned once and stopped when the interpreter exits."""
    global _shared_shard_map
    if _shared_shard_map is None:
        _shared_shard_map = ShardMapBackend()
        atexit.register(_shared_shard_map.close)
    return _shared_shard_map


_BACKENDS: dict = {"local": LocalSimBackend, "shard_map": _shard_map_backend}

# backends registered by a module imported on first use of their name
_LAZY_BACKENDS: dict = {"pool": "repro_torch.dist"}


def register_backend(name: str, factory) -> None:
    """Register a backend factory under ``name`` (used by coded_matmul)."""
    _BACKENDS[name] = factory


def get_backend(backend: Union[None, str, object]):
    """Normalize a backend argument: instance, name, or None (local)."""
    if backend is None:
        return LocalSimBackend()
    if isinstance(backend, str):
        if backend not in _BACKENDS and backend in _LAZY_BACKENDS:
            import importlib

            importlib.import_module(_LAZY_BACKENDS[backend])
        try:
            return _BACKENDS[backend]()
        except KeyError:
            raise ValueError(
                f"unknown backend {backend!r}; one of "
                f"{sorted(set(_BACKENDS) | set(_LAZY_BACKENDS))}"
            ) from None
    return backend


def _as_operand(x, scheme: CdmmScheme, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return from_numpy(x, scheme.base, device)
    if x.device != device:
        raise ValueError(f"operand on {x.device}, scheme on {device}")
    return x


def coded_matmul(
    A: torch.Tensor,
    B: torch.Tensor,
    plan: Union[Plan, CdmmScheme],
    *,
    backend: Union[None, str, object] = None,
    mask: Optional[torch.Tensor] = None,
    key: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Execute a planned coded matmul: ``C = A @ B`` over ``plan.spec.ring``.

    ``plan`` is a :class:`Plan` (its best candidate is instantiated on
    ``device`` and memoized) or an already-built scheme (then its device
    is used).  ``device`` None means CUDA; without a card it raises unless
    ``device="cpu"``.  Single schemes take ``(t, r, D0)`` x ``(r, s, D0)``;
    batch schemes ``(n, t, r, D0)`` x ``(n, r, s, D0)``; numpy uint32
    operands are moved to the device.  ``mask`` is an (N,) bool liveness
    vector; dead workers' responses are never read by the any-R decode.

    ``key`` (a non-negative int) feeds the masks of secure (``privacy_t >
    0``) schemes: required by them, ignored by the rest.  The same key
    gives the same shares on one device type; privacy needs a fresh key
    per call.
    """
    if isinstance(plan, Plan):
        scheme = plan.instantiate(device=device)
    else:
        scheme = plan
        if device is not None and resolve_device(device) != scheme.code.device:
            raise ValueError(f"scheme lives on {scheme.code.device}, not {device}")
    dev = scheme.code.device
    A = _as_operand(A, scheme, dev)
    B = _as_operand(B, scheme, dev)
    return get_backend(backend)(scheme, A, B, mask, key=key)
