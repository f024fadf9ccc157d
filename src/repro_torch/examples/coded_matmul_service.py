"""Distributed coded-matmul service on a real multi-process worker pool —
counterpart of the reference's ``examples/coded_matmul_service.py``.

Spawns worker OS processes (``repro_torch.dist.LocalPool``), plans a scheme
for the request spec, and serves concurrent requests through the pool's
admission-controlled scheduler: the paper's master/worker protocol over
sockets and processes, with a real SIGKILL mid-stream instead of a
simulated straggler mask.  Every response is checked bit for bit against
the direct ``A @ B``.

The SPMD ``ShardMapBackend`` is kept below as the comparison path: the same
planned scheme and requests over N ranks of a gloo group (this process is
rank 0, the others are spawned once), with random straggler masks.

    python -m repro_torch.examples.coded_matmul_service [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.cdmm import ProblemSpec, coded_matmul, plan
from repro_torch.cdmm.backends import ShardMapBackend
from repro_torch.core import make_ring, simulate_stragglers
from repro_torch.device import resolve_device
from repro_torch.dist import LocalPool, PoolConfig, PoolScheduler
from repro_torch.kernels import gr_matmul

Z32 = make_ring(2, 32, ())
SIZE = 64


def requests(rng, n, device):
    for _ in range(n):
        yield Z32.random(rng, (2, SIZE, SIZE), device=device), Z32.random(rng, (2, SIZE, SIZE),
                                                                          device=device)


def check(Cs, As, Bs) -> bool:
    return all(torch.equal(Cs[i], gr_matmul(As[i], Bs[i], Z32)) for i in range(2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    spec = ProblemSpec(t=SIZE, r=SIZE, s=SIZE, n=2, ring=Z32, N=8, straggler_budget=4)
    p = plan(spec, objective="latency", calibration=False)
    scheme = p.instantiate(device=device)
    rng = np.random.default_rng(0)
    ok = True

    # -- pool runtime: real worker processes, scheduler, real failure ------
    print(f"pool service up: {p.best.scheme} (u,v,w)=({p.best.u},{p.best.v},{p.best.w}), "
          f"N={spec.N} shares, R={scheme.R}, ring {scheme.ring}, on {device}")
    with LocalPool(config=PoolConfig(workers=6, transport="pack+zlib"), device=device) as pool:
        with PoolScheduler(pool.master, max_queue=16, max_inflight=3) as sched:
            # a warm round: every worker's first product of this ring
            As, Bs = next(requests(rng, 1, device))
            sched.submit(As, Bs, scheme=scheme).result(120)

            batch = list(requests(rng, 5, device))
            t0 = time.perf_counter()
            futs = [sched.submit(As, Bs, scheme=scheme) for As, Bs in batch]
            # real failure injection: SIGKILL one worker while requests fly
            killed = pool.kill(1)
            for req, (fut, (As, Bs)) in enumerate(zip(futs, batch)):
                exact = check(fut.result(timeout=120), As, Bs)
                ok &= exact
                print(f"pool req {req}: exact={exact}")
            dt = (time.perf_counter() - t0) * 1e3
            print(f"pool: 5 concurrent requests in {dt:.0f} ms total, killed pid {killed} "
                  f"mid-stream, {pool.alive_count()}/6 workers alive, scheduler stats: "
                  f"{sched.stats.completed} completed / {sched.stats.rejected} shed")

    # -- comparison path: SPMD over 8 ranks (simulated stragglers) ----------
    with ShardMapBackend(axis="workers") as backend:
        for req, (As, Bs) in enumerate(requests(rng, 5, device)):
            mask, _ = simulate_stragglers(req, 8, fail_prob=0.35, min_live=scheme.R)
            t0 = time.perf_counter()
            Cs = coded_matmul(As, Bs, scheme, backend=backend, mask=mask)
            dt = (time.perf_counter() - t0) * 1e3
            dead = [i for i, v in enumerate(mask.tolist()) if not v]
            exact = check(Cs, As, Bs)
            ok &= exact
            print(f"shard_map req {req}: dead workers {dead or 'none'} -> exact={exact} "
                  f"({dt:.1f} ms, {backend.pool(8).size} ranks)")
    if not ok:
        raise SystemExit("a response differs from its direct product")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
