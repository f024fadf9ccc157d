"""``coded_matmul(A, B, plan, backend="pool")`` — the one-line switch;
the port's counterpart of ``repro.dist.pool_backend``.

:class:`PoolBackend` adapts a pool master to the execution-backend
protocol every other backend implements (``__call__(scheme, A, B, mask,
key)``), so the same planned scheme that runs in-process runs over real
worker OS processes by changing one string.  With no explicit pool it
lazily spawns a shared process-global
:class:`~repro_torch.dist.master.LocalPool` on first use, on the device of
the first scheme it serves, and reaps it at interpreter exit.  Pool shape
and transport come from a :class:`~repro_torch.dist.config.PoolConfig`
(``config=`` here, or ``PoolConfig.from_env()`` for the shared pool).
"""
from __future__ import annotations

import atexit
import threading
from typing import Optional, Union

from ..device import resolve_device
from .config import PoolConfig
from .master import LocalPool, Master, PoolStats

__all__ = ["PoolBackend", "default_pool", "shutdown_default_pool"]

_default_pool: Optional[LocalPool] = None
_default_lock = threading.Lock()


def default_pool(
    workers: Optional[int] = None, config: Optional[PoolConfig] = None,
    device=None,
) -> LocalPool:
    """The shared process-global LocalPool, spawned on first use on
    ``device`` (None: the card).

    Shape comes from ``config`` (or ``PoolConfig.from_env()``, which
    honors ``REPRO_DIST_WORKERS`` and — deprecated, one warning — the old
    ``REPRO_POOL_WORKERS``).  Pool size is independent of any scheme's N:
    the master multiplexes share indices round-robin over however many
    processes exist.  Asking for another device than the live shared
    pool's raises ValueError.
    """
    global _default_pool
    device = resolve_device(device)
    with _default_lock:
        if _default_pool is None:
            cfg = config or PoolConfig.from_env()
            if workers is not None:
                cfg = cfg.with_(workers=workers)
            _default_pool = LocalPool(config=cfg, device=device)
            atexit.register(shutdown_default_pool)
        elif _default_pool.device != device:
            raise ValueError(
                f"the shared pool runs on {_default_pool.device}, not {device}; "
                f"build a LocalPool(device=...) for a pool of its own")
        elif workers is not None and workers != len(_default_pool.procs):
            import warnings

            warnings.warn(
                f"default_pool(workers={workers}) reuses the existing "
                f"{len(_default_pool.procs)}-process shared pool; build a "
                f"LocalPool(workers={workers}) explicitly for a dedicated "
                f"pool of that size",
                stacklevel=2,
            )
        return _default_pool


def shutdown_default_pool() -> None:
    global _default_pool
    with _default_lock:
        pool, _default_pool = _default_pool, None
    if pool is not None:
        pool.close()


class PoolBackend:
    """Execute the coded-matmul protocol on a multi-process worker pool.

    ``pool`` may be an existing Master/LocalPool/HostPool; with
    ``config=`` and no pool, the backend owns a dedicated pool built from
    the config (spawned lazily on ``device``, or on the first scheme's
    device, and closed by :meth:`close` or at interpreter exit); with
    neither, the shared process-global default pool serves.
    """

    name = "pool"

    def __init__(
        self,
        pool: Union[None, Master, LocalPool] = None,
        workers: Optional[int] = None,
        timeout: Optional[float] = None,
        config: Optional[PoolConfig] = None,
        device=None,
    ):
        self._pool = pool
        self._workers = workers
        self._config = config
        self._device = device
        self._owned = None  # the pool this backend spawned from config=
        self.timeout = (
            timeout if timeout is not None
            else (config.request_timeout if config else None)
        )
        self.last_stats: Optional[PoolStats] = None

    def _master(self, device=None) -> Master:
        pool = self._pool
        device = self._device if self._device is not None else device
        if pool is None and self._config is not None:
            if self._owned is None:
                from .launch import launch_pool

                self._owned = launch_pool(self._config, device=device)
                atexit.register(self.close)
            pool = self._owned
        if pool is None:
            pool = default_pool(self._workers, device=device)
        return pool.master if hasattr(pool, "master") else pool

    @property
    def master(self) -> Master:
        return self._master()

    def stats(self):
        """Cumulative master accounting (shared repro_torch.stats schema)."""
        return self.master.stats()

    def close(self) -> None:
        """Shut down the config-owned pool (no-op for shared/borrowed)."""
        owned, self._owned = self._owned, None
        if owned is not None:
            owned.close()

    def __call__(self, scheme, A, B, mask=None, key=None):
        C, self.last_stats = self._master(scheme.code.device).execute(
            scheme, A, B, mask=mask, key=key, timeout=self.timeout
        )
        return C
