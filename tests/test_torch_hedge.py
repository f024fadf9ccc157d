"""Hedged re-dispatch (``repro_torch.dist.master.Master._maybe_hedge``) on a
pool of CPU worker processes, mirroring tests/test_metrics.py's hedging
cases: aggressive hedging's duplicate replies are discarded idempotently,
a hedged secure decode is bit-identical under a fixed key, and a worker
SIGKILLed after its share was hedged still leaves an exact decode.  Every
result is held against repro's product of the same numpy operands (and the
port's ``local`` backend) on a zero-slack plan (R = N: every share needed).
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.cdmm as P
from repro.core.galois import make_ring as jmake
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.dist import LocalPool, PoolBackend, PoolConfig

POOL_WORKERS = 4
SIZE = 32
PARK_MS = 150.0


def _zero_slack(workers: int = POOL_WORKERS, size: int = SIZE):
    """The reference's zero-slack plan (R = N), the numpy operands, and the
    oracle: repro's direct product of them, checked against port local."""
    Z32 = make_ring(2, 32, ())
    spec = P.ProblemSpec(t=size, r=size, s=size, n=1, ring=Z32, N=workers, straggler_budget=0)
    p = P.plan(spec, objective="threshold", calibration=False)
    rank = max(range(len(p.candidates)), key=lambda i: p.candidates[i].costs.R)
    scheme = p.instantiate(rank, device="cpu")
    assert scheme.R == scheme.N == workers
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=(size, size, 1), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=(size, size, 1), dtype=np.uint64).astype(np.uint32)
    oracle = np.asarray(jmake(2, 32, ()).matmul(a, b))
    A, B = from_numpy(a, Z32, "cpu"), from_numpy(b, Z32, "cpu")
    np.testing.assert_array_equal(to_numpy(P.coded_matmul(A, B, scheme, backend="local")), oracle)
    return scheme, A, B, oracle


def _warm_and_seed(master, scheme, A, B, key=None):
    """Warm requests, then a window of steady-state round trips (>= 8)
    behind the hedge deadline."""
    master.hedge_factor = 0.0
    for _ in range(3):
        master.execute(scheme, A, B, key=key)
    master.health.clear_window()
    for _ in range(2):
        master.execute(scheme, A, B, key=key)


@pytest.fixture(scope="module")
def hedge_pool():
    with LocalPool(config=PoolConfig(workers=POOL_WORKERS), device="cpu") as p:
        scheme, A, B, oracle = _zero_slack()
        _warm_and_seed(p.master, scheme, A, B)
        yield p, scheme, A, B, oracle


def test_aggressive_hedging_discards_duplicates_idempotently(hedge_pool):
    """Every worker parked and an aggressive factor: shares hedge, both
    replies of a hedged share arrive, and every decode stays exact."""
    pool, scheme, A, B, oracle = hedge_pool
    master = pool.master
    before = master.stats()
    hedged = 0
    try:
        for _ in range(3):
            # each race poisons the window with parked round trips: re-seed
            _warm_and_seed(master, scheme, A, B)
            for wid in master.live_workers():
                master.task_delay_ms[wid] = PARK_MS
            master.hedge_factor = 1.05
            C, st = master.execute(scheme, A, B)
            master.hedge_factor = 0.0
            master.task_delay_ms.clear()
            np.testing.assert_array_equal(to_numpy(C), oracle)
            hedged += st.hedged
    finally:
        master.hedge_factor = 0.0
        master.task_delay_ms.clear()
    assert hedged >= 3
    time.sleep(0.8)  # let every late twin land and be discarded
    after = master.stats()
    assert after["pool_hedged"] >= before["pool_hedged"] + 3
    assert after["pool_hedge_wasted"] >= before["pool_hedge_wasted"]
    # the pool is not poisoned: a clean request decodes exactly, unhedged
    C, st = master.execute(scheme, A, B)
    np.testing.assert_array_equal(to_numpy(C), oracle)
    assert st.hedged == 0
    _warm_and_seed(master, scheme, A, B)


def test_hedged_secure_decode_bit_identical_under_fixed_key(hedge_pool):
    """A secure plan with a fixed key, every worker parked so shares hedge:
    the replica re-ships the same keyed share, so the decode equals the
    local keyed run bit for bit."""
    pool = hedge_pool[0]
    master = pool.master
    Z32 = make_ring(2, 32, ())
    spec = P.ProblemSpec(t=8, r=8, s=8, n=1, ring=Z32, N=8, privacy_t=1)
    scheme = P.plan(spec, calibration=False).instantiate(device="cpu")
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, size=(8, 8, 1), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=(8, 8, 1), dtype=np.uint64).astype(np.uint32)
    A, B = from_numpy(a, Z32, "cpu"), from_numpy(b, Z32, "cpu")
    key = 7
    be = PoolBackend(pool)
    local = P.coded_matmul(A, B, scheme, backend="local", key=key)
    np.testing.assert_array_equal(to_numpy(local), np.asarray(jmake(2, 32, ()).matmul(a, b)))
    assert torch.equal(P.coded_matmul(A, B, scheme, backend=be, key=key), local)
    master.health.clear_window()
    for _ in range(2):
        assert torch.equal(P.coded_matmul(A, B, scheme, backend=be, key=key), local)
    for wid in master.live_workers():
        master.task_delay_ms[wid] = PARK_MS
    try:
        master.hedge_factor = 1.05
        hedged = P.coded_matmul(A, B, scheme, backend=be, key=key)
    finally:
        master.hedge_factor = 0.0
        master.task_delay_ms.clear()
    assert torch.equal(hedged, local)
    assert be.last_stats.hedged >= 1


def test_sigkilled_then_hedged_worker_still_satisfies_oracle():
    """A worker SIGKILLed after its share was hedged: the replica (or the
    death's re-dispatch, whichever lands first) completes the zero-slack
    decode exactly, long before the heartbeat deadline."""
    cfg = PoolConfig(workers=POOL_WORKERS, heartbeat_s=0.5, heartbeat_timeout=30.0)
    with LocalPool(config=cfg, device="cpu") as fresh:
        scheme, A, B, oracle = _zero_slack()
        master = fresh.master
        _warm_and_seed(master, scheme, A, B)
        for wid in master.live_workers():
            master.task_delay_ms[wid] = 400.0
        result = {}

        def request():
            try:
                C, result["stats"] = master.execute(scheme, A, B)
                result["C"] = to_numpy(C)
            except Exception as e:  # surfaced below
                result["err"] = e

        master.hedge_factor = 2.0
        t = threading.Thread(target=request)
        t.start()
        time.sleep(0.15)  # shares dispatched; overdue shares hedged
        assert len(fresh.kill(1)) == 1
        t.join(timeout=120)
        master.hedge_factor = 0.0
        master.task_delay_ms.clear()
        assert not t.is_alive(), "request hung after SIGKILL"
        assert "err" not in result, f"request failed: {result.get('err')!r}"
        np.testing.assert_array_equal(result["C"], oracle)
        assert result["stats"].hedged >= 1
        assert result["stats"].wall_ms < 20_000
        assert fresh.alive_count() == POOL_WORKERS - 1
