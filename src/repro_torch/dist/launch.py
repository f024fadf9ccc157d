"""Multi-host pool launcher:
``python -m repro_torch.dist.launch --hostfile ...`` — the port's
counterpart of ``repro.dist.launch``.  Every entry point takes the pool's
device (``--device``; None means the card) and passes it on to every
worker it spawns.  On a card the kernel library is loaded (built on first
use) before any worker is spawned, so workers load the cached library
instead of each compiling it (``repro_torch.kernels.build`` also holds an
inter-process lock around the build, for agents that share a machine).

One config, three ways to bring a pool up:

- **Hostfile** — ``launch_pool(PoolConfig.from_hostfile("hosts.txt"))``:
  the master listens on a TCP endpoint; every *local* host entry gets a
  worker-group agent process (its own session, so a whole simulated host
  can be SIGKILLed as one unit); remote entries are driven over ``ssh``
  when ``REPRO_DIST_SSH=1``, otherwise the launcher prints the exact
  worker-group command to run on each host and waits for them to dial in.
- **Env rank-wiring (SPMD-style)** — every process runs
  ``python -m repro_torch.dist.launch`` with ``REPRO_DIST_RANK`` set: rank 0
  binds ``REPRO_DIST_MASTER_ADDR``, spawns its local workers and waits
  for the world; ranks > 0 run a worker group against the master address
  and block until it hangs up.
- **Local** — no hosts in the config: :func:`launch_pool` degenerates to
  :class:`repro_torch.dist.LocalPool` (which itself spawns through
  :func:`spawn_local_workers` here — the local pool is the single-host
  specialization of this launcher, not a separate code path).

``--smoke`` runs the multi-host acceptance check used by CI: bring the
pool up per the hostfile, run a planned coded matmul while SIGKILLing one
whole worker group mid-request, and assert (a) the decode equals the
single-process oracle bit for bit and (b) compressed transport put fewer
bytes on the wire than the raw share payloads.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .. import settings
from ..device import resolve_device
from .config import Endpoint, HostSpec, PoolConfig

__all__ = [
    "HostPool",
    "launch_from_env",
    "launch_pool",
    "main",
    "spawn_local_workers",
    "worker_group",
]


def _prepare_device(device):
    """Resolve ``device``; on a card, load (build) the kernel library in
    this process before any worker starts."""
    device = resolve_device(device)
    if device.type == "cuda":
        from ..kernels.build import load_library

        load_library()
    return device


def spawn_local_workers(
    address: str,
    count: int,
    heartbeat_s: float = 0.5,
    name_prefix: str = "local",
    device=None,
) -> List[subprocess.Popen]:
    """Spawn ``count`` worker OS processes dialing ``address``, each on
    ``device`` (None: the card).

    The one place worker processes are forked — LocalPool and the
    hostfile/env worker groups all come through here.
    """
    from .master import _worker_env

    device = _prepare_device(device)
    env = _worker_env()
    # REPRO_POOL_LOG=1 lets worker stderr through for debugging
    sink = None if settings.get_bool("pool_log") else subprocess.DEVNULL
    procs = []
    for i in range(count):
        procs.append(subprocess.Popen(
            [
                sys.executable, "-m", "repro_torch.dist.worker",
                "--connect", str(address),
                "--name", f"{name_prefix}-{i}",
                "--heartbeat", str(heartbeat_s),
                "--device", str(device),
            ],
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=sink,
        ))
    return procs


def worker_group(
    address: str, count: int, heartbeat_s: float = 0.5,
    name_prefix: str = "host", device=None,
) -> int:
    """The per-host agent: spawn ``count`` workers against the master and
    wait until they exit (they exit when the master hangs up)."""
    procs = spawn_local_workers(
        address, count, heartbeat_s=heartbeat_s, name_prefix=name_prefix,
        device=device,
    )
    code = 0
    try:
        for p in procs:
            code = max(code, p.wait() or 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()
    return code


class HostPool:
    """A master plus one worker group per hostfile entry.

    Local host entries become agent subprocesses in their own sessions
    (``kill_host(k)`` SIGKILLs the whole group — a machine failure, not a
    process failure).  Remote entries run the printed/ssh'd worker-group
    command and are out of this process's kill reach.  Same execute
    surface as :class:`~repro_torch.dist.master.LocalPool`.
    """

    def __init__(self, config: PoolConfig, device=None):
        from .master import Master, _worker_env

        if not config.hosts:
            raise ValueError("HostPool needs config.hosts; use LocalPool")
        device = _prepare_device(device)
        cfg = config
        if cfg.endpoint is None:
            host = "0.0.0.0" if cfg.multi_host else "127.0.0.1"
            cfg = cfg.with_(endpoint=Endpoint.tcp(host, 0))
        self.config = cfg
        self.master = Master(config=cfg, device=device)
        connect_addr = self._advertised_address()
        self.agents: List[subprocess.Popen] = []
        pending_remote: List[HostSpec] = []
        env = _worker_env()
        sink = (None if settings.get_bool("pool_log")
                else subprocess.DEVNULL)
        for idx, spec in enumerate(cfg.hosts):
            addr = connect_addr
            if spec.port:
                ep = Endpoint.parse(connect_addr)
                addr = Endpoint.tcp(ep.host, spec.port).address
            cmd = [
                sys.executable, "-m", "repro_torch.dist.launch",
                "--role", "workers", "--connect", addr,
                "--workers", str(spec.slots),
                "--heartbeat", str(cfg.heartbeat_s),
                "--name-prefix", f"host{idx}",
                "--device", str(device),
            ]
            if spec.is_local:
                # own session => one killpg takes down the whole "host"
                self.agents.append(subprocess.Popen(
                    cmd, env=env, stdout=subprocess.DEVNULL, stderr=sink,
                    start_new_session=True,
                ))
            elif os.environ.get("REPRO_DIST_SSH") and shutil.which("ssh"):
                self.agents.append(subprocess.Popen(
                    ["ssh", spec.host, "--"] + cmd,
                    stdout=subprocess.DEVNULL, stderr=sink,
                    start_new_session=True,
                ))
            else:
                pending_remote.append(spec)
        if pending_remote:
            for spec in pending_remote:
                print(
                    f"[repro_torch.dist.launch] run on {spec.host}: "
                    f"python -m repro_torch.dist.launch --role workers "
                    f"--connect {connect_addr} --workers {spec.slots} "
                    f"--device {device}",
                    file=sys.stderr,
                )
        try:
            self.master.wait_for_workers(
                cfg.total_workers, timeout=cfg.spawn_timeout
            )
        except TimeoutError:
            self.close()
            raise

    def _advertised_address(self) -> str:
        """The address workers dial: the bound endpoint, with a wildcard
        host rewritten to something routable."""
        ep = Endpoint.parse(self.master.address)
        if ep.kind == "tcp" and ep.host in ("0.0.0.0", "::"):
            import socket as _socket

            host = os.environ.get("REPRO_DIST_ADVERTISE")
            if not host:
                host = (
                    _socket.gethostname() if self.config.multi_host
                    else "127.0.0.1"
                )
            ep = Endpoint.tcp(host, ep.port)
        return ep.address

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
        return self.master.stats()

    def kill_host(self, idx: int = 0) -> int:
        """SIGKILL one whole worker group (simulates a host failure);
        returns the number of groups killed (0 if already gone)."""
        if idx >= len(self.agents):
            return 0
        agent = self.agents[idx]
        if agent.poll() is not None:
            return 0
        os.killpg(os.getpgid(agent.pid), signal.SIGKILL)
        agent.wait(timeout=30)
        return 1

    def alive_hosts(self) -> int:
        return sum(1 for a in self.agents if a.poll() is None)

    def close(self) -> None:
        self.master.close()
        for a in self.agents:
            if a.poll() is None:
                try:
                    os.killpg(os.getpgid(a.pid), signal.SIGTERM)
                except (OSError, ProcessLookupError):
                    a.terminate()
        for a in self.agents:
            try:
                a.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                try:
                    os.killpg(os.getpgid(a.pid), signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    a.kill()
                a.wait(timeout=10)

    def __enter__(self) -> "HostPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch_pool(config: PoolConfig, device=None):
    """Bring up a pool per ``config`` on ``device`` (None: the card):
    :class:`HostPool` when host entries are present,
    :class:`~repro_torch.dist.master.LocalPool` otherwise."""
    if config.hosts:
        return HostPool(config, device=device)
    from .master import LocalPool

    return LocalPool(config=config, device=device)


def launch_from_env(config: Optional[PoolConfig] = None, device=None):
    """SPMD-style rank wiring: every participating process runs this with
    ``REPRO_DIST_RANK`` / ``REPRO_DIST_MASTER_ADDR`` /
    ``REPRO_DIST_WORKERS`` (per-rank worker count) and, on rank 0,
    ``REPRO_DIST_WORLD_WORKERS`` (total to wait for).

    Rank 0 returns the pool object; other ranks serve their worker group
    until the master hangs up and return ``None``.
    """
    rank = int(os.environ.get("REPRO_DIST_RANK", "0"))
    cfg = config or PoolConfig.from_env()
    if rank != 0:
        addr = os.environ["REPRO_DIST_MASTER_ADDR"]
        worker_group(addr, cfg.workers, heartbeat_s=cfg.heartbeat_s,
                     name_prefix=f"rank{rank}", device=device)
        return None
    from .master import LocalPool, Master

    world = int(os.environ.get("REPRO_DIST_WORLD_WORKERS", "0"))
    if world <= cfg.workers:  # single-rank world: plain local pool
        return LocalPool(config=cfg, device=device)
    device = _prepare_device(device)
    # rank 0 hosts the master + its own local workers, then waits for the
    # other ranks' worker groups to dial in
    master = Master(config=cfg if cfg.endpoint else cfg.with_(
        endpoint=Endpoint.tcp("0.0.0.0", 0)
    ), device=device)
    ep = Endpoint.parse(master.address)
    local_addr = (
        Endpoint.tcp("127.0.0.1", ep.port).address
        if ep.kind == "tcp" and ep.host in ("0.0.0.0", "::") else ep.address
    )
    procs = spawn_local_workers(
        local_addr, cfg.workers, heartbeat_s=cfg.heartbeat_s,
        name_prefix="rank0", device=device,
    )
    pool = _EnvPool(master, procs)
    master.wait_for_workers(world, timeout=cfg.spawn_timeout)
    return pool


class _EnvPool:
    """Thin pool wrapper for env-rank launches (rank 0 side)."""

    def __init__(self, master, procs):
        self.master = master
        self.procs = procs

    @property
    def address(self):
        return self.master.address

    @property
    def device(self):
        return self.master.device

    def execute(self, *a, **kw):
        return self.master.execute(*a, **kw)

    def stats(self):
        return self.master.stats()

    def close(self):
        self.master.close()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# smoke: the CI multihost acceptance check
# --------------------------------------------------------------------------


def run_multihost_smoke(
    hostfile: str,
    transport: str = "pack+zlib",
    kill_hosts: int = 1,
    size: int = 96,
    seed: int = 0,
    stream_chunk_bytes: int = 1 << 16,
    device=None,
) -> Dict[str, object]:
    """Launcher-level smoke: pool per hostfile, one simulated host SIGKILL
    mid-request, oracle bit-equality, and wire < raw bytes under a
    compressed transport.  Raises on any violated invariant."""
    import numpy as np
    import torch

    from ..cdmm import ProblemSpec, plan
    from ..core import make_ring
    from ..kernels import gr_matmul_ref

    cfg = PoolConfig.from_hostfile(
        hostfile, transport=transport,
        stream_chunk_bytes=stream_chunk_bytes,
        heartbeat_timeout=2.0,
    )
    # Z_2^16 shares in uint32 carriers: bit-packing alone halves the wire
    ring = make_ring(2, 16, ())
    N = cfg.total_workers
    spec = ProblemSpec(t=size, r=size, s=size, n=1, ring=ring, N=N,
                       straggler_budget=1)
    # share indices are multiplexed round-robin, so even a whole dead host
    # re-dispatches onto the survivors — any R distinct share responses
    # decode, whichever processes computed them
    p = plan(spec, objective="threshold")
    rank = max(range(len(p.candidates)),
               key=lambda i: p.candidates[i].costs.R)
    device = resolve_device(device)
    scheme = p.instantiate(rank, device=device)
    rng = np.random.default_rng(seed)
    A = ring.random(rng, (size, size), device=device)
    B = ring.random(rng, (size, size), device=device)
    oracle = gr_matmul_ref(A, B, ring)  # the plain version, not a kernel

    with launch_pool(cfg, device=device) as pool:
        # warm round: every worker builds its ring closure before the race
        C0, _ = pool.execute(scheme, A, B)
        if not torch.equal(C0, oracle):
            raise AssertionError("warm-round decode != oracle")
        # park every worker briefly so the host SIGKILL lands mid-request
        for wid in pool.master.live_workers():
            pool.master.task_delay_ms[wid] = 400.0
        import threading

        killed = []
        if kill_hosts > 0 and isinstance(pool, HostPool):
            def _assassin():
                time.sleep(0.15)
                for k in range(kill_hosts):
                    killed.append(pool.kill_host(k))

            t = threading.Thread(target=_assassin, daemon=True)
            t.start()
        C, stats = pool.execute(scheme, A, B, timeout=120.0)
        pool.master.task_delay_ms.clear()
        snap = pool.stats()

    if not torch.equal(C, oracle):
        raise AssertionError("post-kill decode != oracle")
    if transport != "raw" and not (
        snap["bytes_out"] < snap["raw_bytes_out"]
    ):
        raise AssertionError(
            f"compressed transport put {snap['bytes_out']} bytes on the "
            f"wire >= raw {snap['raw_bytes_out']}"
        )
    return {
        "workers": N,
        "hosts": len(cfg.hosts),
        "hosts_killed": int(sum(killed)),
        "redispatched": stats.redispatched,
        "scheme": scheme.name,
        "R": scheme.R,
        "codecs": list(stats.codecs),
        "raw_bytes_out": snap["raw_bytes_out"],
        "bytes_out": snap["bytes_out"],
        "wire_ratio": (
            snap["raw_bytes_out"] / snap["bytes_out"]
            if snap["bytes_out"] else None
        ),
        "time_to_R_ms": stats.time_to_R_ms,
        "bit_identical": True,
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hostfile", metavar="PATH",
                    help="hosts, one per line: HOST [slots=N] [port=P]")
    ap.add_argument("--role", choices=["auto", "master", "workers"],
                    default="auto",
                    help="auto: hostfile/env decides; workers: run a "
                    "worker group against --connect")
    ap.add_argument("--connect", metavar="ADDR",
                    help="master address for --role workers")
    ap.add_argument("--workers", type=int, default=4,
                    help="worker count (per host for --role workers)")
    ap.add_argument("--heartbeat", type=float, default=0.5)
    ap.add_argument("--name-prefix", default="host")
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "raw", "pack", "pack+zlib",
                             "pack+zstd"])
    ap.add_argument("--port", type=int, default=0,
                    help="master listen port (0 = ephemeral)")
    ap.add_argument("--smoke", action="store_true",
                    help="multihost acceptance check: SIGKILL one host "
                    "group mid-request, assert oracle bit-equality and "
                    "wire bytes < raw bytes")
    ap.add_argument("--kill-hosts", type=int, default=1)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--stream-chunk", type=int, default=1 << 16,
                    help="pipelined streaming chunk size in bytes "
                    "(0 = ship whole shares)")
    ap.add_argument("--device", default=None,
                    help="torch device of the master and every worker "
                    "(default: the card; cpu runs the plain version)")
    args = ap.parse_args(argv)

    if args.role == "workers":
        if not args.connect:
            ap.error("--role workers requires --connect ADDR")
        return worker_group(args.connect, args.workers,
                            heartbeat_s=args.heartbeat,
                            name_prefix=args.name_prefix,
                            device=args.device)

    if args.smoke:
        if not args.hostfile:
            ap.error("--smoke requires --hostfile")
        out = run_multihost_smoke(
            args.hostfile, transport=args.transport,
            kill_hosts=args.kill_hosts, size=args.size,
            stream_chunk_bytes=args.stream_chunk, device=args.device,
        )
        print(json.dumps(out, indent=2))
        ok = out["bit_identical"] and (
            args.transport == "raw"
            or out["bytes_out"] < out["raw_bytes_out"]
        )
        print("MULTIHOST SMOKE " + ("OK" if ok else "FAILED"))
        return 0 if ok else 1

    if "REPRO_DIST_RANK" in os.environ and not args.hostfile:
        pool = launch_from_env(device=args.device)
        if pool is None:
            return 0  # worker rank: group served until master hangup
        print(f"pool up at {pool.address}; Ctrl-C to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            pool.close()
        return 0

    if not args.hostfile:
        ap.error("need --hostfile, --role workers, or REPRO_DIST_RANK")
    cfg = PoolConfig.from_hostfile(
        args.hostfile, transport=args.transport,
        endpoint=(Endpoint.tcp("0.0.0.0", args.port) if args.port else None),
    )
    pool = launch_pool(cfg, device=args.device)
    print(f"pool up at {pool.address} "
          f"({cfg.total_workers} workers / {len(cfg.hosts)} hosts); "
          f"Ctrl-C to stop")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
