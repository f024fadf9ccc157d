"""repro_torch.cdmm.runtime and the shard_map backend on gloo with CPU
ranks, mirroring tests/test_cdmm_runtime.py: worker encode, master encode,
stragglers, batch RMFE and the sharded CodedQuantMatmul over one
module-scoped pool of 8 ranks (this process rank 0), held bit for bit
against repro's output on the same numpy inputs; dead ranks send garbage
on purpose and the decode stays exact; ``get_backend("shard_map")`` from one
process; and the SPMD use, every rank of an initialized world calling with
replicated operands.

JAX and repro are imported inside the tests only: the ranks import this
module to unpickle its per-rank bodies, and must not pay for JAX."""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.cdmm as P
from repro_torch.cdmm.backends import ShardMapBackend, shard_worker_body
from repro_torch.cdmm.runtime import (
    DistributedBatchRMFE,
    DistributedEP,
    RankGroup,
    RankPool,
    all_gather,
    axis_index,
    bind_axis,
    cdmm_shard_map,
)
from repro_torch.core import EPCode, make_ring
from repro_torch.core.galois import from_numpy, to_numpy
from repro_torch.kernels import gr_matmul_ref

N = 8
AXIS = "workers"
KEY = 20251017


@pytest.fixture(scope="module")
def pool():
    with RankPool(N, device="cpu", trace=True) as p:
        yield p


@pytest.fixture(scope="module")
def ref():
    import repro.cdmm as J
    from repro.core import BatchEPRMFE, EPCode as JEPCode, make_ring as jmake

    return J, BatchEPRMFE, JEPCode, jmake


def _np_operands(ring_args, lead, t, r, s, seed):
    rng = np.random.default_rng(seed)
    D = int(np.prod(ring_args[2])) if ring_args[2] else 1
    A = rng.integers(0, 2**32, size=lead + (t, r, D), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, 2**32, size=lead + (r, s, D), dtype=np.uint64).astype(np.uint32)
    return A, B


def _mask(dead):
    m = np.ones(N, dtype=bool)
    m[list(dead)] = False
    return m


@pytest.mark.parametrize("master_encode", [False, True], ids=["worker-encode", "master-encode"])
def test_distributed_ep(pool, ref, master_encode):
    J, _, JEPCode, jmake = ref
    A, B = _np_operands((2, 32, (3,)), (), 32, 64, 32, seed=1)
    jring, ring = jmake(2, 32, (3,)), make_ring(2, 32, (3,))
    want = to_numpy(from_numpy(np.asarray(jring.matmul(A, B)), ring, "cpu"))
    dep = DistributedEP(EPCode(ring, N, 2, 2, 1, device="cpu"), AXIS, master_encode=master_encode)
    f = cdmm_shard_map(dep, pool, AXIS)
    for dead in [(), (0,), (7,), (1, 3), (0, 2, 5, 6)]:
        C = f(from_numpy(A, ring, "cpu"), from_numpy(B, ring, "cpu"), torch.from_numpy(_mask(dead)))
        np.testing.assert_array_equal(to_numpy(C), want, err_msg=str(dead))
    assert len(pool.last_reports) == N and [r["rank"] for r in pool.last_reports] == list(range(N))


def test_distributed_batch_rmfe(pool, ref):
    J, JBatch, _, jmake = ref
    A, B = _np_operands((2, 32, ()), (2,), 32, 32, 64, seed=2)
    base = make_ring(2, 32, ())
    jsch = JBatch(jmake(2, 32, ()), n=2, N=N, u=2, v=2, w=1)
    want = np.asarray(jsch.run(A, B))
    sch = P.BatchRMFEAdapter(base, n=2, N=N, u=2, v=2, w=1, device="cpu")
    f = cdmm_shard_map(DistributedBatchRMFE(sch.inner, AXIS), pool, AXIS)
    C = f(from_numpy(A, base, "cpu"), from_numpy(B, base, "cpu"), torch.from_numpy(_mask((2, 6))))
    np.testing.assert_array_equal(to_numpy(C), want)


def lying_body(scheme, axis, A, B, mask):
    """shard_worker_body's protocol, except that a dead rank (mask False)
    sends garbage instead of its product: the decode must never read it."""
    i = axis_index(axis)
    h = scheme.worker_compute(scheme.encode_a_at(A, i)[None], scheme.encode_b_at(B, i)[None])[0]
    if not bool(mask[i]):
        gen = torch.Generator().manual_seed(1000 + i)
        h = torch.randint(-2**31, 2**31 - 1, h.shape, generator=gen, dtype=torch.int32)
    H = all_gather(h, axis)
    return P.decode_from(scheme, H, P.live_indices(scheme, mask))


@pytest.mark.parametrize("family,ring_args,n,dead", [
    ("batch_ep_rmfe", (2, 32, ()), 2, (1, 4)),
    ("ep_rmfe1", (2, 32, ()), 1, (0, 5, 7)),
    ("gcsa", (2, 32, ()), 2, (6,)),
], ids=lambda x: str(x))
def test_dead_ranks_send_garbage_and_the_decode_stays_exact(pool, ref, family, ring_args, n, dead):
    J, _, _, jmake = ref
    lead = (n,) if n > 1 else ()
    A, B = _np_operands(ring_args, lead, 32, 32, 32, seed=3)
    jring = jmake(*ring_args)
    # repro's products of the same numpy operands (every scheme is exact)
    want = np.stack([np.asarray(jring.matmul(a, b)) for a, b in zip(A.reshape((-1, 32, 32, 1)),
                                                                     B.reshape((-1, 32, 32, 1)))])
    want = want.reshape(lead + want.shape[1:])
    tspec = P.ProblemSpec(32, 32, 32, n=n, ring=make_ring(*ring_args), N=N,
                          straggler_budget=len(dead))
    sch = P.plan(tspec, schemes=[family], calibration=False).instantiate(device="cpu")
    mask = _mask(dead)
    base = sch.base
    f = cdmm_shard_map(lying_body, pool, AXIS)
    C = f(sch, AXIS, from_numpy(A, base, "cpu"), from_numpy(B, base, "cpu"), torch.from_numpy(mask))
    np.testing.assert_array_equal(to_numpy(C), want)
    # the same request through the backend (every rank honest) agrees
    be = ShardMapBackend(pool=pool)
    C2 = P.coded_matmul(from_numpy(A, base, "cpu"), from_numpy(B, base, "cpu"), sch, backend=be,
                        mask=mask)
    np.testing.assert_array_equal(to_numpy(C2), want)
    spans = {sp["name"] for rep in be.last_reports for sp in rep["spans"]}
    assert spans == {"encode", "compute", "gather", "decode"}


def test_secure_key_reaches_every_rank(pool):
    Z32 = make_ring(2, 32, ())
    spec = P.ProblemSpec(32, 32, 32, n=2, ring=Z32, N=N, straggler_budget=2, privacy_t=1)
    sch = P.plan(spec, schemes=["ep_rmfe_secure"], calibration=False).instantiate(device="cpu")
    A, B = _np_operands((2, 32, ()), (2,), 32, 32, 32, seed=4)
    A, B = from_numpy(A, Z32, "cpu"), from_numpy(B, Z32, "cpu")
    mask = torch.from_numpy(_mask((2, 5)))
    be = ShardMapBackend(pool=pool)
    local = P.coded_matmul(A, B, sch, backend="local", mask=mask, key=KEY)
    assert torch.equal(local, torch.stack([gr_matmul_ref(A[i], B[i], Z32) for i in range(2)]))
    assert torch.equal(P.coded_matmul(A, B, sch, backend=be, mask=mask, key=KEY), local)
    with pytest.raises(RuntimeError, match="rank"):  # a secure scheme needs its key
        P.coded_matmul(A, B, sch, backend=be, mask=mask)


def test_coded_quant_spmd_with_stragglers(pool, ref):
    J = ref[0]
    rng = np.random.default_rng(11)
    qx = rng.integers(-127, 128, (64, 32)).astype(np.int8)
    qw = rng.integers(-127, 128, (32, 64)).astype(np.int8)
    mask = _mask((1, 4, 6))  # 3 dead of 8, R = 4
    cm = P.CodedQuantMatmul(N, AXIS, device="cpu")
    out = cdmm_shard_map(cm.exact_int_matmul, pool, AXIS)(
        torch.from_numpy(qx), torch.from_numpy(qw), torch.from_numpy(mask))
    expect = qx.astype(np.int64) @ qw.astype(np.int64)
    np.testing.assert_array_equal(out.numpy().astype(np.int64), expect)
    jout = J.CodedQuantMatmul(N=N, axis_name=None).exact_int_matmul(qx, qw, mask)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert all(rep["launches"] == {"simt": 0, "tc": 0, "skinny": 0, "tower": 0,
                                   "tc_left": 0, "limbs": 0, "lift": 0, "stack": 0,
                                   "left_lift": 0}
               for rep in pool.last_reports)  # CPU ranks run the plain version


def test_get_backend_shard_map_from_one_process():
    Z32 = make_ring(2, 32, ())
    spec = P.ProblemSpec(32, 32, 32, n=1, ring=make_ring(2, 32, (2,)), N=4, straggler_budget=1)
    p = P.plan(spec, schemes=["ep"], calibration=False)
    A, B = _np_operands((2, 32, (2,)), (), 32, 32, 32, seed=5)
    be = P.get_backend("shard_map")
    assert isinstance(be, ShardMapBackend)
    try:
        C = P.coded_matmul(A, B, p, backend="shard_map", device="cpu",
                           mask=torch.tensor([True, False, True, True]))
        ring = p.instantiate(device="cpu").base
        assert torch.equal(C, gr_matmul_ref(from_numpy(A, ring, "cpu"), from_numpy(B, ring, "cpu"),
                                            ring))
        assert list(be._pools) == [4] and be.pool(4).size == 4
    finally:
        be.close()
    assert not be._pools
    del Z32


def _spmd_rank(rank, size, port, queue):
    """One process of an initialized world: every rank calls coded_matmul
    with the same (replicated) operands and the default group as the axis."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=size)
    try:
        ring = make_ring(2, 32, (2,))
        spec = P.ProblemSpec(32, 32, 32, n=1, ring=ring, N=size, straggler_budget=1)
        sch = P.plan(spec, schemes=["ep"], calibration=False).instantiate(device="cpu")
        A, B = _np_operands((2, 32, (2,)), (), 32, 32, 32, seed=6)
        C = P.coded_matmul(A, B, sch, backend=ShardMapBackend(), device="cpu",
                           mask=torch.tensor([True, True, False, True]))
        with bind_axis(AXIS, RankGroup.world()):
            idx = axis_index(AXIS)
        queue.put((rank, idx, to_numpy(C)))
    finally:
        dist.destroy_process_group()


def test_spmd_in_an_initialized_world():
    import multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_spmd_rank, args=(r, 4, port, queue)) for r in range(4)]
    for p in procs:
        p.start()
    results = sorted(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive() and p.exitcode == 0
    ring = make_ring(2, 32, (2,))
    A, B = _np_operands((2, 32, (2,)), (), 32, 32, 32, seed=6)
    want = to_numpy(gr_matmul_ref(from_numpy(A, ring, "cpu"), from_numpy(B, ring, "cpu"), ring))
    assert [r[:2] for r in results] == [(i, i) for i in range(4)]
    for _, _, C in results:
        np.testing.assert_array_equal(C, want)


def test_axis_outside_a_group_raises():
    A = torch.zeros((4, 4, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bound to no group"):
        axis_index(AXIS)
    sch = P.BatchRMFEAdapter(make_ring(2, 32, ()), n=2, N=N, u=2, v=2, w=1, device="cpu")
    with pytest.raises(RuntimeError, match="bound to no group"):
        shard_worker_body(sch, AXIS, A[None].repeat(2, 1, 1, 1), A[None].repeat(2, 1, 1, 1))
