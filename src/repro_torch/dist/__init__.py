"""repro_torch.dist: the multi-process worker pool behind coded_matmul —
the port's counterpart of ``repro.dist``, on the same wire protocol.

  * :mod:`repro_torch.dist.config` — :class:`PoolConfig`/:class:`Endpoint`;
  * :mod:`repro_torch.dist.protocol` — length-prefixed framed RPC with the
    reference's codecs (raw, bit-packing, pack+zlib, pack+zstd when the
    optional module is installed); shares travel as numpy uint32;
  * :mod:`repro_torch.dist.worker` — the worker process
    (``python -m repro_torch.dist.worker --connect ... [--device cpu]``):
    its block products run on the hand-written ``gr_matmul`` CUDA routes on
    a card, and its heartbeats and results carry its kernel launch counts;
  * :mod:`repro_torch.dist.master` — the master: membership, health,
    hedged re-dispatch, chunked streaming, share retry and tracing, with
    encode and the any-R decode on the master's device; :class:`LocalPool`
    spawns a master plus N worker OS processes;
  * :mod:`repro_torch.dist.launch` — the multi-host launcher;
  * :mod:`repro_torch.dist.scheduler` — bounded-queue serving over one pool;
  * :mod:`repro_torch.dist.pool_backend` — :class:`PoolBackend`, registered
    as ``coded_matmul(A, B, plan, backend="pool")``.

Importing this package registers the ``"pool"`` backend;
``repro_torch.cdmm.backends`` also imports it on first use of the name.
Every pool runs on a device (None: the card); a JAX worker can serve a
torch master and a torch worker a JAX master (tests/test_torch_dist_interop.py).

Determinism: encode runs master-side, worker compute is exact integer ring
arithmetic, and the decode subset is the canonical sorted first-R arrival
set, so a fixed encode key gives results bit-identical to the ``local``
backend's even under real worker deaths.
"""
from ..cdmm.backends import register_backend
from .config import Endpoint, HostSpec, PoolConfig, parse_hostfile
from .launch import HostPool, launch_pool, spawn_local_workers
from .master import LocalPool, Master, PoolStats, WorkerDied
from .pool_backend import PoolBackend, default_pool, shutdown_default_pool
from .protocol import recv_msg, send_msg
from .scheduler import PoolScheduler, SchedulerSaturated

register_backend("pool", PoolBackend)

__all__ = [
    "Endpoint",
    "HostPool",
    "HostSpec",
    "LocalPool",
    "Master",
    "PoolBackend",
    "PoolConfig",
    "PoolScheduler",
    "PoolStats",
    "SchedulerSaturated",
    "WorkerDied",
    "default_pool",
    "launch_pool",
    "parse_hostfile",
    "shutdown_default_pool",
    "spawn_local_workers",
    "recv_msg",
    "send_msg",
]
