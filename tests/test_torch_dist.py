"""repro_torch.dist on the CPU: real worker OS processes over sockets, held
bit for bit against the port's ``local`` backend and repro's.

One shared pool of four CPU worker processes serves the whole module
(``backend="pool"`` spawns it through ``default_pool``); the SIGKILL test
runs last because it shrinks the pool.  Shares big enough to cross the
pool's 2 KiB streaming threshold travel in contraction-axis chunks.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cdmm as J
from repro.core.galois import make_ring as jmake
import repro_torch.cdmm as P
from repro_torch.core.galois import from_numpy, make_ring as tmake, to_numpy
from repro_torch.dist import (
    PoolBackend,
    PoolConfig,
    PoolScheduler,
    default_pool,
    shutdown_default_pool,
)
from repro_torch.dist.protocol import supported_codecs
from repro_torch.kernels import gr_matmul_ref
from repro_torch.kernels.autotune import load_cache

SRC = Path(__file__).resolve().parents[1] / "src"
WORKERS = 4
N = 8
SIZE = 16
KEY = 20251017
# (name, ring spec, batch n, (u, v, w), packing n), as tests/test_torch_elastic.py
CASES = [
    ("batch_ep_rmfe", (2, 32, ()), 2, (2, 2, 1), 2),
    ("ep_rmfe1", (2, 32, ()), 1, (2, 2, 1), 2),
    ("gcsa", (2, 32, ()), 2, (1, 1, 1), 2),
]
MASK = np.array([True, True, False, True, True, False, True, True])  # 2 and 5 dead


@pytest.fixture(scope="module")
def pool():
    cfg = PoolConfig(workers=WORKERS, stream_chunk_bytes=2048)
    p = default_pool(config=cfg, device="cpu")
    yield p
    shutdown_default_pool()


_schemes_built: dict = {}
_reference_out: dict = {}


def _schemes(case):
    """(reference scheme, port scheme on the CPU), built once per module so
    the reference compiles each family's jitted paths once."""
    name, ring_spec, n, (u, v, w), pack = case
    if name not in _schemes_built:
        jspec = J.ProblemSpec(SIZE, SIZE, SIZE, n=n, ring=jmake(*ring_spec), N=N)
        tspec = P.ProblemSpec(SIZE, SIZE, SIZE, n=n, ring=tmake(*ring_spec), N=N)
        _schemes_built[name] = (J.get_scheme(name).build(jspec, u, v, w, pack),
                                P.get_scheme(name).build(tspec, u, v, w, pack, device="cpu"))
    return _schemes_built[name]


def _operands(js, seed):
    rng = np.random.default_rng(seed)
    lead = (js.batch,) if js.batch > 1 else ()
    a = np.asarray(js.base.random(rng, lead + (SIZE, SIZE)))
    b = np.asarray(js.base.random(rng, lead + (SIZE, SIZE)))
    return a, b


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pool_backend_matches_local_and_reference(pool, case, stream):
    js, ts = _schemes(case)
    a, b = _operands(js, 7)
    if case[0] not in _reference_out:
        _reference_out[case[0]] = np.asarray(J.coded_matmul(
            jnp.asarray(a), jnp.asarray(b), js, backend="local", mask=jnp.asarray(MASK)))
    want = _reference_out[case[0]]
    mask = torch.from_numpy(MASK)
    local = to_numpy(P.coded_matmul(a, b, ts, backend="local", mask=mask))
    pool.master.stream_chunk_bytes = 2048 if stream else 0
    try:
        got = P.coded_matmul(a, b, ts, backend="pool", mask=mask)
    finally:
        pool.master.stream_chunk_bytes = 2048
    np.testing.assert_array_equal(local, want)
    np.testing.assert_array_equal(to_numpy(got), want)
    # the direct product over the data ring, by the plain version
    direct = gr_matmul_ref(from_numpy(a, ts.base, "cpu"), from_numpy(b, ts.base, "cpu"), ts.base)
    assert torch.equal(got, direct)


def test_pool_stats_shares_and_codecs(pool):
    js, ts = _schemes(CASES[0])
    a, b = _operands(js, 8)
    be = PoolBackend(pool)
    C = P.coded_matmul(a, b, ts, backend=be, mask=torch.from_numpy(MASK))
    assert torch.equal(C, P.coded_matmul(a, b, ts, backend="local"))
    st = be.last_stats
    assert st.dispatched == tuple(int(i) for i in np.flatnonzero(MASK))
    assert len(st.live_idx) == ts.R and set(st.live_idx) <= set(st.dispatched)
    assert set(st.workers) <= set(pool.master.live_workers())
    assert st.codecs == (supported_codecs()[0],)  # the strongest both sides decode
    assert st.raw_bytes_out > 0 and st.bytes_out > 0 and st.raw_bytes_in > 0
    assert st.batch == ts.batch == 2


def test_secure_keyed_request_equals_local_with_the_key(pool):
    spec = P.ProblemSpec(SIZE, SIZE, SIZE, n=2, ring=tmake(2, 32, ()), N=N,
                         straggler_budget=2, privacy_t=1)
    ts = P.plan(spec, schemes=["ep_rmfe_secure"]).instantiate(device="cpu")
    rng = np.random.default_rng(9)
    a = ts.base.random(rng, (2, SIZE, SIZE), device="cpu")
    b = ts.base.random(rng, (2, SIZE, SIZE), device="cpu")
    mask = torch.from_numpy(MASK)
    got = P.coded_matmul(a, b, ts, backend="pool", mask=mask, key=KEY)
    assert torch.equal(got, P.coded_matmul(a, b, ts, backend="local", mask=mask, key=KEY))
    direct = torch.stack([gr_matmul_ref(a[j], b[j], ts.base) for j in range(2)])
    assert torch.equal(got, direct)
    # workers see masked shares only: another key, other shares, same product
    assert torch.equal(P.coded_matmul(a, b, ts, backend="pool", key=KEY + 1), direct)


def test_hello_and_worker_launch_counts(pool):
    caps = pool.master.worker_caps()
    assert len(caps) == WORKERS
    for c in caps.values():
        assert c["device"] == "cpu" and c["torch_version"] == torch.__version__
        # the committed tile cache holds card entries only
        assert c["autotune"] == {"entries": len(load_cache()), "device_entries": 0}
        assert c["rings"]["p2_max_e"] == 32 and "card" not in c
    counts = pool.master.worker_launches(timeout=30)
    assert sorted(counts) == pool.master.live_workers()
    # CPU workers run the plain version: no kernel launches, every route listed
    for by_route in counts.values():
        assert by_route == {"simt": 0, "tc": 0, "skinny": 0, "tower": 0, "tc_left": 0,
                           "limbs": 0, "lift": 0, "stack": 0, "left_lift": 0}


def test_worker_error_is_retried_and_scheduler_serves(pool):
    js, ts = _schemes(CASES[1])
    a, b = _operands(js, 10)
    oracle = P.coded_matmul(a, b, ts, backend="local")
    bad = pool.master.live_workers()[0]
    pool.master.task_fail_wids.add(bad)
    try:
        C, _ = pool.master.execute(ts, a, b, timeout=120)
    finally:
        pool.master.task_fail_wids.clear()
    assert torch.equal(C, oracle)
    assert pool.master.stats()["pool_failed"] == 0
    spec = P.ProblemSpec(8, 8, 8, n=1, ring=tmake(2, 32, ()), N=6, straggler_budget=2)
    rng = np.random.default_rng(11)
    with PoolScheduler(pool.master, max_queue=8, max_inflight=2) as sched:
        pairs = [(ts.base.random(rng, (8, 8), device="cpu"),
                  ts.base.random(rng, (8, 8), device="cpu")) for _ in range(3)]
        futs = [sched.submit(A, B, spec=spec) for A, B in pairs]
        for fut, (A, B) in zip(futs, pairs):
            assert torch.equal(fut.result(120), gr_matmul_ref(A, B, ts.base))
        assert sched.stats.plan_cache_misses == 1 and sched.stats.plan_cache_hits == 2


def test_scheme_on_another_device_is_refused(pool):
    js, ts = _schemes(CASES[1])
    a, b = _operands(js, 12)
    with pytest.raises(ValueError, match="operand on"):
        pool.master.execute(ts, from_numpy(a, ts.base, "meta"), b)


def test_worker_without_device_flag_needs_a_card():
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.worker", "--connect", "unix:/nonexistent.sock"],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device is available; pass device='cpu'" in res.stderr


def test_sigkill_mid_request_still_decodes(pool):
    """Last in the module: it shrinks the shared pool."""
    js, ts = _schemes(CASES[0])
    a, b = _operands(js, 13)
    oracle = P.coded_matmul(a, b, ts, backend="local")
    # blind round-robin (no health ranking from earlier requests): two
    # shares a worker, so the killed worker holds shares of this request
    pool.master.health.reset_scores()
    for wid in pool.master.live_workers():
        pool.master.task_delay_ms[wid] = 300.0
    result = {}

    def request():
        try:
            result["C"], result["stats"] = pool.master.execute(ts, a, b, timeout=120)
        except Exception as e:  # surfaced below
            result["err"] = e

    t = threading.Thread(target=request, daemon=True)
    t.start()
    try:
        time.sleep(0.1)  # every share dispatched, every worker parked
        assert len(pool.kill(1)) == 1
        t.join(timeout=120)
    finally:
        pool.master.task_delay_ms.clear()
    assert not t.is_alive(), "request hung after the SIGKILL"
    assert "err" not in result, result.get("err")
    assert torch.equal(result["C"], oracle)
    assert result["stats"].redispatched >= 1
    assert pool.alive_count() == WORKERS - 1
    assert len(pool.master.live_workers()) == WORKERS - 1
