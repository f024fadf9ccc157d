"""Unified pool/transport configuration: ``PoolConfig`` + ``Endpoint`` —
the port's copy of ``repro.dist.config``, reading ``repro_torch.settings``
(the same knobs and env vars).  The pool's device is not part of the
config: ``LocalPool``, ``Master``, ``launch_pool`` and ``PoolBackend`` take
``device=`` (None means the card).

Before this module, pool wiring lived in ad-hoc pieces: address strings
(``"tcp:HOST:PORT"``/``"unix:/path"``) parsed in three places, worker
counts from ``REPRO_POOL_WORKERS``, and heartbeat/codec knobs scattered
across ``LocalPool``/``Master`` signatures.  :class:`PoolConfig` is the
one value every entry point accepts — ``LocalPool(config=...)``,
``launch_pool(config)``, ``PoolBackend(config=...)``,
``coded_matmul(..., pool_config=...)`` and ``ServeScheduler(config=...)``
— and :class:`Endpoint` replaces raw address strings (the string forms
still parse, for compatibility).

Hostfile format (one host per line, ``#`` comments)::

    # host [slots=N] [port=P]
    10.0.0.4 slots=8
    10.0.0.5 slots=8 port=7777

Deprecated forms (``REPRO_POOL_WORKERS``, positional ``LocalPool`` args)
keep working through a shim that emits a single ``DeprecationWarning``
per process.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple, Union

from .. import settings

# the warn-once registry lives in repro_torch.settings; re-exported here
# as the reference re-exports its own
from ..settings import _WARNED, warn_deprecated_once  # noqa: F401

__all__ = [
    "Endpoint",
    "HostSpec",
    "PoolConfig",
    "parse_hostfile",
]


@dataclass(frozen=True)
class Endpoint:
    """A listener/connect endpoint: TCP host+port or a Unix-domain path.

    Replaces the ``"tcp:HOST:PORT"`` / ``"unix:/path"`` strings that used
    to be parsed ad hoc at every call site; ``Endpoint.parse`` accepts
    those strings (and Endpoint instances, idempotently) so existing
    addresses keep working.
    """

    kind: str  # "tcp" | "unix"
    host: str = ""
    port: int = 0
    path: str = ""

    @classmethod
    def tcp(cls, host: str = "127.0.0.1", port: int = 0) -> "Endpoint":
        return cls(kind="tcp", host=host, port=int(port))

    @classmethod
    def unix(cls, path: str) -> "Endpoint":
        return cls(kind="unix", path=path)

    @classmethod
    def parse(cls, value: Union[str, "Endpoint"]) -> "Endpoint":
        if isinstance(value, Endpoint):
            return value
        kind, _, rest = str(value).partition(":")
        if kind == "unix" and rest:
            return cls.unix(rest)
        if kind == "tcp" and rest:
            host, _, port = rest.rpartition(":")
            if host and port.lstrip("-").isdigit() and int(port) >= 0:
                return cls.tcp(host, int(port))
        raise ValueError(
            f"bad endpoint {value!r}; expected tcp:HOST:PORT or unix:/path"
        )

    @property
    def address(self) -> str:
        """The canonical address string the wire layer consumes."""
        if self.kind == "unix":
            return f"unix:{self.path}"
        return f"tcp:{self.host}:{self.port}"

    def __str__(self) -> str:
        return self.address


@dataclass(frozen=True)
class HostSpec:
    """One hostfile row: a host and how many worker slots it contributes."""

    host: str
    slots: int = 1
    port: int = 0  # optional per-host connect port override (0 = master's)

    @property
    def is_local(self) -> bool:
        import socket as _socket

        return self.host in (
            "localhost", "127.0.0.1", "::1", _socket.gethostname(),
        )


def parse_hostfile(source: str) -> Tuple[HostSpec, ...]:
    """Parse hostfile text *or* a path to one into ``(HostSpec, ...)``."""
    if os.path.exists(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    hosts: List[HostSpec] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        host, slots, port = parts[0], 1, 0
        for opt in parts[1:]:
            k, _, v = opt.partition("=")
            if k == "slots" and v.isdigit():
                slots = int(v)
            elif k == "port" and v.isdigit():
                port = int(v)
            else:
                raise ValueError(
                    f"hostfile line {lineno}: unknown option {opt!r} "
                    f"(expected slots=N or port=P)"
                )
        hosts.append(HostSpec(host=host, slots=slots, port=port))
    if not hosts:
        raise ValueError("hostfile has no host entries")
    return tuple(hosts)


@dataclass(frozen=True)
class PoolConfig:
    """Everything needed to bring up and talk to a worker pool.

    ``workers`` is the local worker count when no ``hosts`` are given;
    with ``hosts`` the per-host ``slots`` govern and ``total_workers``
    sums them.  ``transport`` picks the share wire codec: ``"auto"``
    (best both sides support — packed+compressed when available),
    ``"raw"``, ``"pack"``, ``"pack+zlib"``, ``"pack+zstd"``.
    ``stream_chunk_bytes`` > 0 pipelines share transfer in chunks of
    roughly that many raw bytes so encode/transfer/compute overlap
    (0 disables streaming).

    Telemetry/hedging (None = resolve from the matching ``repro_torch.settings``
    knob): ``obs_http_port`` starts the embedded admin server
    (:mod:`repro_torch.obs.http`; 0 = ephemeral port), ``hedge_factor`` > 0
    enables speculative re-dispatch of shares outstanding past
    p95(recent round-trips) x factor, ``health_ewma`` smooths the
    per-worker health signals feeding dispatch order and hedging.
    """

    workers: int = 4
    hosts: Tuple[HostSpec, ...] = ()
    endpoint: Optional[Endpoint] = None
    transport: str = "auto"
    compression_level: int = 3
    stream_chunk_bytes: int = 1 << 20
    heartbeat_s: float = 0.5
    heartbeat_timeout: float = 5.0
    request_timeout: Optional[float] = None
    use_kernel: Optional[bool] = None
    spawn_timeout: float = 120.0
    obs_http_port: Optional[int] = None
    hedge_factor: Optional[float] = None
    health_ewma: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.endpoint, str):
            object.__setattr__(self, "endpoint", Endpoint.parse(self.endpoint))
        if isinstance(self.hosts, list):
            object.__setattr__(self, "hosts", tuple(self.hosts))
        valid = ("auto", "raw", "pack", "pack+zlib", "pack+zstd")
        if self.transport not in valid:
            raise ValueError(
                f"transport {self.transport!r} not one of {valid}"
            )

    @property
    def total_workers(self) -> int:
        if self.hosts:
            return sum(h.slots for h in self.hosts)
        return self.workers

    @property
    def multi_host(self) -> bool:
        return any(not h.is_local for h in self.hosts)

    def with_(self, **changes) -> "PoolConfig":
        return replace(self, **changes)

    @classmethod
    def from_hostfile(cls, source: str, **overrides) -> "PoolConfig":
        """Build a config from a hostfile (path or literal text).  A
        multi-host file forces a TCP listener on all interfaces unless an
        explicit ``endpoint`` override is given."""
        hosts = tuple(parse_hostfile(source))
        cfg = cls(hosts=hosts, **overrides)
        if cfg.endpoint is None and cfg.multi_host:
            cfg = cfg.with_(endpoint=Endpoint.tcp("0.0.0.0", 0))
        return cfg

    @classmethod
    def from_env(cls, env=os.environ, **overrides) -> "PoolConfig":
        """Config from the environment.

        Every variable resolves through :mod:`repro_torch.settings` (see
        ``python -m repro_torch.settings`` for the full documented list):
        ``REPRO_DIST_WORKERS``, ``REPRO_DIST_TRANSPORT``,
        ``REPRO_DIST_HOSTFILE``, ``REPRO_DIST_MASTER_ADDR``,
        ``REPRO_DIST_STREAM_CHUNK``.  The legacy ``REPRO_POOL_WORKERS``
        still works but emits one ``DeprecationWarning`` per process.
        """
        kw = dict(overrides)
        hostfile = settings.get("dist_hostfile", env)
        if hostfile is not None and "hosts" not in kw:
            kw["hosts"] = tuple(parse_hostfile(hostfile))
        if "workers" not in kw:
            workers = settings.get_int("dist_workers", env)
            if workers is not None:
                kw["workers"] = workers
        transport = settings.get("dist_transport", env)
        if transport is not None and "transport" not in kw:
            kw["transport"] = transport
        master_addr = settings.get("dist_master_addr", env)
        if master_addr is not None and "endpoint" not in kw:
            kw["endpoint"] = Endpoint.parse(master_addr)
        chunk = settings.get_int("dist_stream_chunk", env)
        if chunk is not None and "stream_chunk_bytes" not in kw:
            kw["stream_chunk_bytes"] = chunk
        for name, getter in (
            ("obs_http_port", settings.get_int),
            ("hedge_factor", settings.get_float),
            ("health_ewma", settings.get_float),
        ):
            val = getter(name, env)
            if val is not None and name not in kw:
                kw[name] = val
        return cls(**kw)
