"""Wire compatibility of the two pools, in both directions, on the CPU:

* a JAX ``repro.dist.Master`` served by ``python -m repro_torch.dist.worker
  --device cpu`` processes;
* a port ``repro_torch.dist.Master`` served by ``python -m
  repro.dist.worker`` processes.

Both decodes must equal the ``repro.dist.smoke`` oracle (the tightest
threshold-ranked scheme over Z_2^32, ``A @ B`` by the reference's ring
matmul) bit for bit, and the codec each master negotiates with the other
package's workers is recorded (``record_property("codec", ...)``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import repro.cdmm as J
import repro.dist as jdist
from repro.core import make_ring as jmake
import repro_torch.cdmm as P
import repro_torch.dist as pdist
from repro_torch.core import make_ring as tmake
from repro_torch.core.galois import to_numpy

SRC = Path(__file__).resolve().parents[1] / "src"
WORKERS = 3
SIZE = 16


def _smoke_problem():
    """repro.dist.smoke's problem: Z_2^32, N = workers, the candidate with
    the largest R under a straggler budget of 1; A, B and the oracle."""
    Z = jmake(2, 32, ())
    spec = J.ProblemSpec(t=SIZE, r=SIZE, s=SIZE, n=1, ring=Z, N=WORKERS, straggler_budget=1)
    p = J.plan(spec, objective="threshold")
    rank = max(range(len(p.candidates)), key=lambda i: p.candidates[i].costs.R)
    rng = np.random.default_rng(0)
    A = np.asarray(Z.random(rng, (SIZE, SIZE)))
    B = np.asarray(Z.random(rng, (SIZE, SIZE)))
    return p, rank, A, B, np.asarray(Z.matmul(A, B))


def _spawn(module, address, extra=()):
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    return [subprocess.Popen(
        [sys.executable, "-m", module, "--connect", address, "--name", f"x-{i}",
         "--heartbeat", "0.5", *extra],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for i in range(WORKERS)]


def _reap(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        proc.wait(timeout=30)


def test_torch_workers_serve_a_jax_master(record_property):
    p, rank, A, B, oracle = _smoke_problem()
    scheme = p.instantiate(rank)
    master = jdist.Master()
    procs = _spawn("repro_torch.dist.worker", master.address, ("--device", "cpu"))
    try:
        master.wait_for_workers(WORKERS, timeout=120)
        for caps in master.worker_caps().values():
            assert caps["device"] == "cpu" and "torch_version" in caps
        C, stats = master.execute(scheme, A, B, timeout=120)
        np.testing.assert_array_equal(np.asarray(C), oracle)
        # a worker death mid-pool: the survivors' shares still decode
        procs[0].kill()
        procs[0].wait(timeout=30)
        C, _ = master.execute(scheme, A, B, timeout=120)
        np.testing.assert_array_equal(np.asarray(C), oracle)
        assert len(master.live_workers()) == WORKERS - 1
    finally:
        master.close()
        _reap(procs)
    record_property("codec", sorted(set(stats.codecs)))
    assert stats.codecs == (jdist.protocol.supported_codecs()[0],)


def test_jax_workers_serve_a_torch_master(record_property):
    p_ref, rank, A, B, oracle = _smoke_problem()
    spec = P.ProblemSpec(t=SIZE, r=SIZE, s=SIZE, n=1, ring=tmake(2, 32, ()), N=WORKERS,
                         straggler_budget=1)
    p = P.plan(spec, objective="threshold")
    # the port's ranking is the reference's: the same candidate, the same scheme
    assert [(c.scheme, c.u, c.v, c.w, c.n) for c in p.candidates] == \
        [(c.scheme, c.u, c.v, c.w, c.n) for c in p_ref.candidates]
    scheme = p.instantiate(rank, device="cpu")
    master = pdist.Master(device="cpu")
    procs = _spawn("repro.dist.worker", master.address)
    try:
        master.wait_for_workers(WORKERS, timeout=180)
        for caps in master.worker_caps().values():
            assert "jax_version" in caps and "torch_version" not in caps
        C, stats = master.execute(scheme, A, B, timeout=180)
        np.testing.assert_array_equal(to_numpy(C), oracle)
        # JAX workers carry no launch counts and are left out of them
        assert master.worker_launches(timeout=30) == {}
    finally:
        master.close()
        _reap(procs)
    record_property("codec", sorted(set(stats.codecs)))
    assert stats.codecs == (pdist.protocol.supported_codecs()[0],)
    assert stats.bytes_out > 0 and stats.raw_bytes_in > 0
