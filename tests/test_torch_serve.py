"""repro_torch.serve on the CPU, held against repro.serve: the coalescer's
flush decisions on a scripted arrival sequence, the stats schemas, the
continuous-batching engine over a pool of four CPU worker processes (one
pool for the module), and one scrape of the port's ``/metrics``."""
import urllib.request

import numpy as np
import pytest
import torch

import repro.dist as jdist
import repro.serve as jserve
import repro_torch.cdmm as P
import repro_torch.dist as pdist
import repro_torch.serve as pserve
from repro_torch.core import make_ring
from repro_torch.core.galois import fold_in
from repro_torch.kernels import gr_matmul_ref
from repro_torch.obs import http as obs_http
from repro_torch.obs import parse_prometheus

Z32 = make_ring(2, 32, ())
SIZE = 16

# (seconds, key, cap) arrivals; None as key: a due() sweep at that time
SCRIPT = [
    (0.000, "a", 2), (0.001, "b", 4), (0.002, "a", 2), (0.003, None, 0),
    (0.004, "b", 4), (0.0045, None, 0), (0.0049, "c", 3), (0.006, None, 0),
    (0.0061, "b", 4), (0.0062, "b", 4), (0.0065, "c", 3), (0.009, None, 0),
    (0.012, None, 0), (0.020, "d", 8), (0.0201, None, 0),
]


def _replay(mod, policy_kw):
    """Feed SCRIPT through one package's BatchCoalescer; the log of every
    flush it decides, and what is left at the end."""
    co = mod.BatchCoalescer(mod.CoalescePolicy(**policy_kw))
    log = []
    for i, (t, key, cap) in enumerate(SCRIPT):
        if key is None:
            log.append(("due", t, co.due(t, queue_empty=(i % 2 == 0)),
                        co.next_wait_s(t, queue_empty=True)))
        else:
            log.append(("add", t, co.add(key, i, cap, t), co.pending()))
    log.append(("flush", co.flush_all()))
    return log


@pytest.mark.parametrize("policy_kw", [
    {"max_wait_ms": 5.0},
    {"max_wait_ms": 2.0, "target_batch_n": 4},
    {"max_wait_ms": 10.0, "adaptive": True, "adaptive_idle_ms": 1.5},
    {"max_wait_ms": 0.0},
], ids=["wait5", "wait2", "adaptive", "nowait"])
def test_coalescer_flushes_equal_reference(policy_kw):
    assert _replay(pserve, policy_kw) == _replay(jserve, policy_kw)
    with pytest.raises(ValueError):
        pserve.CoalescePolicy(target_batch_n=0).validate()


def test_stats_schemas_equal_reference():
    snaps = []
    for mod in (jserve, pserve):
        st = mod.ServeStats()
        st.bump("submitted", 5)
        st.bump("completed", 4)
        st.record_batch("x[8x8x8]", 2, 0, 12.5, [0.3, 4.0])
        st.record_batch("x[8x8x8]", 1, 1, 7.0, [60.0])
        snaps.append(st.snapshot())
    ref, port = snaps
    assert dict(port) == dict(ref)
    assert port["serve_completed"] == 4 and port["serve_mean_fill"] == 1.5
    # the pool master's and the scheduler's snapshot keys: the same schema
    jm, pm = jdist.Master(), pdist.Master(device="cpu")
    try:
        assert sorted(pm.stats()) == sorted(jm.stats())
        js = jdist.scheduler.SchedulerStats().snapshot()
        ps = pdist.scheduler.SchedulerStats().snapshot()
        assert sorted(ps) == sorted(js)
    finally:
        jm.close()
        pm.close()


@pytest.fixture(scope="module")
def pool():
    with pdist.LocalPool(config=pdist.PoolConfig(workers=4), device="cpu") as p:
        yield p


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return [(Z32.random(rng, (SIZE, SIZE), device="cpu"),
             Z32.random(rng, (SIZE, SIZE), device="cpu")) for _ in range(n)]


def test_engine_coalesces_and_every_slice_is_exact(pool, monkeypatch):
    # the reference ranks on its analytic proxy too (no calibration fit)
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    # the spec's N is the code's worker count; the pool multiplexes its
    # shares over four processes
    spec = P.ProblemSpec(SIZE, SIZE, SIZE, n=1, ring=Z32, N=6, straggler_budget=1)
    pairs = _pairs(8, 1)
    policy = pserve.CoalescePolicy(target_batch_n=4, max_wait_ms=200.0)
    with pserve.ServeScheduler(pool.master, policy, max_queue=16, seed=3) as sched:
        entry = sched.entry_for(spec)
        assert entry.cap > 1 and entry.scheme.name == "batch_ep_rmfe"
        # the reference's amortized decision for the same spec
        jspec = jserve.engine.ProblemSpec(SIZE, SIZE, SIZE, n=1, ring=_jring(), N=6,
                                          straggler_budget=1)
        with jserve.ServeScheduler(None, policy=jserve.CoalescePolicy(
                target_batch_n=4, max_wait_ms=200.0)) as jsched:
            jentry = jsched.entry_for(jspec)
        assert (entry.scheme.name, entry.cap, entry.scheme.partition) == \
            (jentry.scheme.name, jentry.cap, jentry.scheme.partition)
        futs = [sched.submit(A, B, spec=spec) for A, B in pairs]
        for fut, (A, B) in zip(futs, pairs):
            assert torch.equal(fut.result(timeout=120), gr_matmul_ref(A, B, Z32))
        snap = sched.stats.snapshot()
    assert snap["serve_completed"] == len(pairs)
    assert snap["serve_mean_fill"] > 1 and snap["serve_coalesced_batches"] >= 1


def _jring():
    from repro.core import make_ring as jmake

    return jmake(2, 32, ())


def test_secure_batches_and_metrics_scrape(pool):
    spec = P.ProblemSpec(SIZE, SIZE, SIZE, n=1, ring=Z32, N=8, straggler_budget=1,
                         privacy_t=1)
    pairs = _pairs(4, 2)
    policy = pserve.CoalescePolicy(target_batch_n=2, max_wait_ms=200.0)
    srv = obs_http.start_server(0)
    try:
        with pserve.ServeScheduler(pool.master, policy, max_queue=8, seed=5) as sched:
            assert sched.entry_for(spec).scheme.privacy_t >= 1
            futs = [sched.submit(A, B, spec=spec) for A, B in pairs]
            for fut, (A, B) in zip(futs, pairs):
                assert torch.equal(fut.result(timeout=120), gr_matmul_ref(A, B, Z32))
            # batch keys come from the int seed: fold_in(seed, batch number)
            seq = sched._batch_seq
            assert seq >= 2 and sched._batch_key([]) == fold_in(5, seq)
            with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as resp:
                families = parse_prometheus(resp.read().decode())
    finally:
        obs_http.stop_server()
    names = set(families)
    assert any(n.startswith("repro_serve_") for n in names)
    assert any(n.startswith("repro_pool_") for n in names)
    assert families["repro_pool_wall_ms"]["type"] == "histogram"
