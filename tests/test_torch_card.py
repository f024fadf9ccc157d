"""repro_torch on the card: the five CUDA routes of the ring matmul
(``simt``, its thin kernel at every instantiation, ``tc``, ``skinny``,
``tower``, ``tc_left``) against their plain version, and the main path
through them: ``coded_matmul`` for every family, the elastic backend's
traced path, the coded int8 matmul, a pool of CUDA worker processes (every
worker product a ``tc`` launch, read from the workers' heartbeats) and one
round of the serving engine over it.  Every test here needs a CUDA device and skips
without one; on a machine with a card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

This file imports no JAX, so it also runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.cdmm import (
    BatchRMFEAdapter,
    CodedQuantMatmul,
    ElasticBackend,
    ProblemSpec,
    coded_matmul,
    plan,
)
from repro_torch.core import WorkerTrace, make_ring
from repro_torch.kernels import counters, gr_matmul, gr_matmul_ref, pick_route, run_route
from repro_torch.kernels.gr_matmul import (
    PREPASSES,
    ROUTES,
    SKINNY_CONFIGS,
    TC_CONFIGS,
    SIMT_THIN_CONFIGS,
    gr_matmul_planar,
    gr_matmul_simt,
    gr_matmul_skinny,
    gr_matmul_tc,
    gr_matmul_tower,
    simt_grid,
    skinny_cols,
    skinny_configs,
    tc_configs,
    tc_instantiated,
    tower_configs,
    tower_shape,
)
from repro_torch.kernels.ref import gr_matmul_planar_ref, tc_lifted

pytestmark = pytest.mark.cuda

# (3, 7): D = 21, beyond the reference's envelope (simt at every shape, tc
# by the lift, tower for t, r <= 16 with t r <= 108)
RING_SPECS = [(2, 32, ()), (2, 32, (3,)), (2, 32, (4,)), (2, 16, (5,)), (2, 8, (2, 3)),
              (2, 32, (16,)), (2, 32, (3, 5)), (2, 32, (3, 7))]
SHAPES = [(8, 8, 8), (16, 32, 8), (128, 128, 128), (7, 13, 5), (1, 64, 1), (130, 17, 129)]
# t, s >= 64 and an r across several of the tc route's 64-deep stages; t, r <= 16
# with ragged s for the skinny route, and within the (3, 7) tower's t r <= 108
# for the tower route
ROUTE_SHAPES = {"simt": SHAPES, "tc": SHAPES + [(64, 64, 64), (96, 300, 160)],
                "skinny": [x for x in SHAPES if x[0] <= 16 and x[1] <= 16]
                + [(8, 2, 4099), (16, 16, 333), (2, 3, 12345)],
                "tower": [(8, 8, 8), (7, 13, 5), (1, 1, 77), (8, 2, 4099), (2, 3, 12345)],
                # its t <= 64; a decode past r = 32, a 32 x 32 decode and a
                # 64-row encode, ragged s
                "tc_left": [x for x in SHAPES if x[0] <= 64]
                + [(16, 33, 333), (32, 32, 200), (64, 4, 1001)]}


@pytest.fixture
def cuda():
    # decided at run time, never at import: every xdist worker collects alike
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


@pytest.mark.parametrize("spec", RING_SPECS, ids=str)
def test_kernel_matches_plain(cuda, spec):
    ring = make_ring(*spec)
    rng = np.random.default_rng(7)
    for lead in [(), (3,)]:
        for t, r, s in SHAPES:
            A = ring.random(rng, lead + (t, r), device=cuda)
            B = ring.random(rng, lead + (r, s), device=cuda)
            counters.reset()
            out = gr_matmul(A, B, ring)
            route = pick_route(ring, t, r, s)
            expect = dict.fromkeys(ROUTES + PREPASSES, 0)
            expect[route] = 1
            if route == "tc":  # one limb pre-pass an operand, or A's and B's lift
                expect["limbs"], expect["lift"] = (1, 1) if tc_lifted(ring) else (2, 0)
            if route == "tc_left":  # the lift of A, the stack of B
                expect["left_lift"], expect["stack"] = 1, 1
            assert counters.launches_by_route == expect
            assert torch.equal(out, gr_matmul_ref(A, B, ring)), (lead, t, r, s)


def _takes(route, ring):
    d0, d1 = tower_shape(ring)
    return {"simt": True, "tc": tc_instantiated(d0, d1), "skinny": bool(skinny_cols(d0, d1)),
            "tower": bool(tower_configs(d0, d1)),
            "tc_left": tc_lifted(ring) and tc_instantiated(d0, d1)}[route]


@pytest.mark.parametrize("route", ["simt", "tc", "skinny", "tower", "tc_left"])
@pytest.mark.parametrize("spec", RING_SPECS, ids=str)
def test_route_matches_plain(cuda, spec, route):
    ring = make_ring(*spec)
    rng = np.random.default_rng(11)
    if not _takes(route, ring):  # a ring without an instantiation raises, never falls back
        A = ring.random(rng, (8, 8), device=cuda)
        with pytest.raises(ValueError, match="no instantiation"):
            run_route(route, A, A, ring)
        return
    for lead in [(), (2,)]:
        for t, r, s in ROUTE_SHAPES[route]:
            A = ring.random(rng, lead + (t, r), device=cuda)
            B = ring.random(rng, lead + (r, s), device=cuda)
            assert torch.equal(run_route(route, A, B, ring), gr_matmul_ref(A, B, ring)), (lead, t, r, s)


@pytest.mark.parametrize("wrapper,deg", [(gr_matmul_tc, (3,)), (gr_matmul_skinny, (3,)),
                                         (gr_matmul_tower, (3, 7))], ids=["tc", "skinny", "tower"])
def test_new_route_wrappers_reject_what_they_do_not_take(cuda, wrapper, deg):
    ring = make_ring(2, 32, deg)
    A = ring.random(np.random.default_rng(0), (8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(A.transpose(0, 1), A, ring)
    with pytest.raises(ValueError, match="int32"):
        wrapper(A.to(torch.int64), A, ring)


def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    ring = make_ring(2, 32, (3,))
    A = ring.random(np.random.default_rng(0), (4, 4), device=cuda).movedim(-1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        gr_matmul_planar(A.transpose(1, 2), A.contiguous(), ring)
    with pytest.raises(ValueError, match="int32"):
        gr_matmul_planar(A.contiguous().to(torch.int64), A.contiguous(), ring)


# simt's thin kernel (t <= 64 over GR(2^e, D <= 4)): every t its
# instantiations take, at e = 32, 31 and 16, a ragged r past two stages and
# a deep one (R split up to 8 ways, the mask after the split sum), ragged s
THIN_SPECS = [(2, 32, ()), (2, 32, (2,)), (2, 32, (3,)), (2, 32, (4,)), (2, 31, (3,)),
              (2, 31, (4,)), (2, 16, (4,))]


@pytest.mark.parametrize("spec", THIN_SPECS, ids=str)
def test_simt_thin_kernel_matches_plain(cuda, spec):
    ring = make_ring(*spec)
    rng = np.random.default_rng(13)
    reached = set()
    for t in (1, 4, 8, 16, 24, 48, 63):
        for lead, r, s in (((), 70, 77), ((2,), 300, 9), ((3,), 33, 1000)):
            A = ring.random(rng, lead + (t, r), device=cuda)
            B = ring.random(rng, lead + (r, s), device=cuda)
            counters.reset()
            out = gr_matmul_simt(A, B, ring)
            assert counters.launches_by_route["simt"] == 1 and counters.launches == 1
            assert torch.equal(out, gr_matmul_ref(A, B, ring)), (lead, t, r, s)
            grid = simt_grid(ring, lead[0] if lead else 1, t, r, s, 132)
            reached.add((ring.D, *grid[5:9]))
    assert reached == {c for c in SIMT_THIN_CONFIGS if c[0] == ring.D}


def test_simt_planar_interface_and_wrapping_accumulators(cuda):
    # the reference's planar interface on top of the interleaved kernel, and
    # all-0xFF operands whose split chains pass 2^32 (the s32 accumulators wrap)
    ring = make_ring(2, 32, (4,))
    A = ring.random(np.random.default_rng(3), (2, 16, 100), device=cuda).movedim(-1, -3)
    B = ring.random(np.random.default_rng(4), (2, 100, 40), device=cuda).movedim(-1, -3)
    A, B = A.contiguous(), B.contiguous()
    assert torch.equal(gr_matmul_planar(A, B, ring), gr_matmul_planar_ref(A, B, ring))
    A = torch.full((16, 40960, 4), -1, dtype=torch.int32, device=cuda)
    B = torch.full((40960, 64, 4), -1, dtype=torch.int32, device=cuda)
    assert simt_grid(ring, 1, 16, 40960, 64, 132)[4] == 8
    assert torch.equal(gr_matmul_simt(A, B, ring), gr_matmul_ref(A, B, ring))


def test_coded_quant_matmul_at_decode_sizes_runs_on_simt(cuda):
    # 8 tokens over N = 16 (GR(2^32, 4)), 12 dead: the worker product (4
    # rows) on simt, the same bits as the CPU run and as no deaths
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 192)).astype(np.float32))
    cq, cq_cpu = CodedQuantMatmul(16, None, device=cuda), CodedQuantMatmul(16, None, device="cpu")
    live = torch.zeros(16, dtype=torch.bool)
    live[[1, 5, 10, 14]] = True
    counters.reset()
    y = cq(x.to(cuda), w.to(cuda), live.to(cuda))
    assert counters.launches_by_route["simt"] == 1 and counters.launches_by_route["tc"] == 0
    assert torch.equal(y.cpu().view(torch.int32), cq_cpu(x, w, live).view(torch.int32))
    assert torch.equal(y.view(torch.int32), cq(x.to(cuda), w.to(cuda)).view(torch.int32))


def test_ring_outside_envelope_raises_on_the_card(cuda):
    ring = make_ring(2, 32, (17,))  # D = 17 > MAX_D, no simt instantiation
    A = ring.random(np.random.default_rng(1), (3, 4), device=cuda)
    B = ring.random(np.random.default_rng(2), (4, 2), device=cuda)
    counters.reset()
    with pytest.raises(ValueError, match="outside the kernels' envelope"):
        ring.matmul(A, B)
    assert counters.launches == 0


BATCH_N = {"batch_ep_rmfe": 2, "gcsa": 2, "ep_rmfe_secure": 2, "gcsa_general": 4}


@pytest.mark.parametrize("name", ["ep", "plain", "ep_rmfe1", "ep_rmfe2", "batch_ep_rmfe", "gcsa",
                                  "gcsa_general", "ep_secure", "ep_rmfe_secure"])
def test_main_path_through_kernel(cuda, name):
    ring = make_ring(2, 32, (3,)) if name == "ep" else make_ring(2, 32, ())
    n = BATCH_N.get(name, 1)
    privacy_t = 1 if name.endswith("secure") else 0
    p = plan(ProblemSpec(64, 64, 64, n=n, ring=ring, N=8, straggler_budget=2, privacy_t=privacy_t),
             schemes=[name])
    rng = np.random.default_rng(3)
    lead = (n,) if n > 1 else ()
    A, B = ring.random(rng, lead + (64, 64), device=cuda), ring.random(rng, lead + (64, 64), device=cuda)
    mask = torch.tensor([True, False, True, True, False, True, True, True], device=cuda)
    counters.reset()
    # key: the secure families' masks (CPU and CUDA draw different ones),
    # ignored by the rest
    C = coded_matmul(A, B, p, backend="local", mask=mask, key=5)
    assert counters.launches > 0
    # the same run on the CPU (plain version throughout) gives the same bits
    C_cpu = coded_matmul(A.cpu(), B.cpu(), p, backend="local", mask=mask.cpu(), key=5,
                         device="cpu")
    assert torch.equal(C.cpu(), C_cpu)
    direct = torch.stack([ring.matmul(A[i], B[i]) for i in range(n)]) if n > 1 else ring.matmul(A, B)
    assert torch.equal(C, direct)


def test_elastic_traced_path_on_the_card(cuda):
    """batch_ep_rmfe at 128^3 (worker blocks of 64 rows: the tc route), two
    slow and two dead workers: the decode reads (0, 4, 6, 7), not the first R
    live workers, and equals local's and the direct product."""
    Z = make_ring(2, 32, ())
    scheme = BatchRMFEAdapter(Z, 2, 8, 2, 2, 1, device=cuda)
    rng = np.random.default_rng(9)
    A, B = Z.random(rng, (2, 128, 128), device=cuda), Z.random(rng, (2, 128, 128), device=cuda)
    alive = [True, True, False, True, True, False, True, True]
    trace = WorkerTrace(np.zeros(8), np.full(8, np.inf),
                        np.array([1, 50, 1, 40, 1, 1, 1, 1.0])).restrict(alive)
    eb = ElasticBackend(trace=trace)
    counters.reset()
    C = eb(scheme, A, B)
    eb.drain()  # dead and slow workers compute too, after the decode
    # per dispatched worker (all 8 join at 0): phi(A), encode_a_at, phi(B),
    # encode_b_at on skinny and one tc product; then decode and psi
    assert counters.launches_by_route == {"simt": 0, "tc": 8, "skinny": 34, "tower": 0,
                                          "tc_left": 0, "limbs": 16, "lift": 0, "stack": 0,
                                          "left_lift": 0}
    assert eb.last_stats.live_idx == (0, 4, 6, 7)
    direct = torch.stack([Z.matmul(A[i], B[i]) for i in range(2)])
    assert torch.equal(C, direct)
    assert torch.equal(C, coded_matmul(A, B, scheme, mask=torch.tensor(alive, device=cuda)))
    with pytest.raises(ValueError, match="use_kernel=False"):
        ElasticBackend(trace=trace, use_kernel=False)(scheme, A, B)


def test_coded_quant_matmul_on_the_card(cuda):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    cq, cq_cpu = CodedQuantMatmul(8, None, device=cuda), CodedQuantMatmul(8, None, device="cpu")
    dead = torch.tensor([True, False, True, True, False, True, False, True])
    y = cq(x.to(cuda), w.to(cuda), dead.to(cuda))
    # the same bits as the CPU run (plain version throughout) and as no deaths
    assert torch.equal(y.cpu().view(torch.int32), cq_cpu(x, w, dead).view(torch.int32))
    assert torch.equal(y.view(torch.int32), cq(x.to(cuda), w.to(cuda)).view(torch.int32))
    qx = torch.randint(-127, 128, (128, 256), dtype=torch.int8)
    qw = torch.randint(-127, 128, (256, 128), dtype=torch.int8)
    acc = cq.exact_int_matmul(qx.to(cuda), qw.to(cuda), dead.to(cuda))
    assert torch.equal(acc.cpu(), (qx.long() @ qw.long()).to(torch.int32))
    with pytest.raises(ValueError, match="use_kernel=False"):
        CodedQuantMatmul(8, None, use_kernel=False, device=cuda)


def _summed(by_wid):
    out = dict.fromkeys(ROUTES + PREPASSES, 0)
    for counts in by_wid.values():
        for route, n in counts.items():
            out[route] += n
    return out


def test_pool_of_cuda_workers_runs_every_product_on_a_kernel(cuda):
    """Four CUDA worker processes serve batch_ep_rmfe at 256^3: the decode
    equals local's, every worker product is a tc launch in a worker, and
    the master's encodes and decode are skinny launches in this process."""
    from repro_torch.dist import LocalPool, PoolBackend, PoolConfig

    Z = make_ring(2, 32, ())
    scheme = BatchRMFEAdapter(Z, 2, 8, 2, 2, 1, device=cuda)
    rng = np.random.default_rng(11)
    A, B = Z.random(rng, (2, 256, 256), device=cuda), Z.random(rng, (2, 256, 256), device=cuda)
    with LocalPool(config=PoolConfig(workers=4), device=cuda) as pool:
        for caps in pool.master.worker_caps().values():
            assert caps["device"] == "gpu" and caps["card"] == torch.cuda.get_device_name(0)
            assert caps["kernels"]["path"].endswith(".so")
        before = _summed(pool.master.worker_launches())
        counters.reset()
        C = coded_matmul(A, B, scheme, backend=PoolBackend(pool))
        master = dict(counters.launches_by_route)
        after = _summed(pool.master.worker_launches())
    workers = {k: after[k] - before[k] for k in after}
    assert workers == {"simt": 0, "tc": 8, "skinny": 0, "tower": 0, "tc_left": 0, "limbs": 16,
                       "lift": 0, "stack": 0, "left_lift": 0}
    # per share phi(A), encode_a_at, phi(B), encode_b_at; then decode and psi
    assert master == {"simt": 0, "tc": 0, "skinny": 34, "tower": 0, "tc_left": 0, "limbs": 0,
                      "lift": 0, "stack": 0, "left_lift": 0}
    assert torch.equal(C, coded_matmul(A, B, scheme, backend="local"))
    assert torch.equal(C, torch.stack([gr_matmul_ref(A[i], B[i], Z) for i in range(2)]))


def test_serve_round_on_cuda_workers(cuda):
    from repro_torch.dist import LocalPool, PoolConfig
    from repro_torch.serve import CoalescePolicy, ServeScheduler

    Z = make_ring(2, 32, ())
    spec = ProblemSpec(128, 128, 128, n=1, ring=Z, N=8, straggler_budget=1)
    rng = np.random.default_rng(12)
    pairs = [(Z.random(rng, (128, 128), device=cuda), Z.random(rng, (128, 128), device=cuda))
             for _ in range(4)]
    with LocalPool(config=PoolConfig(workers=4), device=cuda) as pool:
        with ServeScheduler(pool.master, CoalescePolicy(target_batch_n=4, max_wait_ms=200),
                            seed=0) as sched:
            futs = [sched.submit(A, B, spec=spec) for A, B in pairs]
            for fut, (A, B) in zip(futs, pairs):
                C = fut.result(timeout=120)
                assert C.device == A.device and torch.equal(C, gr_matmul_ref(A, B, Z))
            assert sched.stats.snapshot()["serve_mean_fill"] > 1


# -- slice 6: the tuned configurations, the SPMD backend ----------------------


@pytest.mark.parametrize("tower", sorted(TC_CONFIGS), ids=str)
def test_every_tc_configuration_matches_plain(cuda, tower):
    ring = make_ring(2, 32, (tower[0],) if tower[0] > 1 else ())
    rng = np.random.default_rng(13)
    for lead, (t, r, s) in [((), (96, 300, 160)), ((2,), (70, 520, 97)), ((), (130, 17, 129))]:
        A = ring.random(rng, lead + (t, r), device=cuda)
        B = ring.random(rng, lead + (r, s), device=cuda)
        want = gr_matmul_ref(A, B, ring)
        for config in tc_configs(*tower):
            assert torch.equal(gr_matmul_tc(A, B, ring, config), want), (config, lead, t, r, s)
    with pytest.raises(ValueError, match="no instantiation"):
        gr_matmul_tc(A, B, ring, (8, 3))


@pytest.mark.parametrize("tower", sorted(SKINNY_CONFIGS), ids=str)
def test_every_skinny_configuration_matches_plain(cuda, tower):
    ring = make_ring(2, 32, (tower[0],) if tower[0] > 1 else ())
    rng = np.random.default_rng(14)
    for lead, (t, r, s) in [((), (8, 2, 4099)), ((3,), (16, 16, 333)), ((), (2, 3, 123457))]:
        A = ring.random(rng, lead + (t, r), device=cuda)
        B = ring.random(rng, lead + (r, s), device=cuda)
        want = gr_matmul_ref(A, B, ring)
        for config in skinny_configs(*tower):
            assert torch.equal(gr_matmul_skinny(A, B, ring, config), want), (config, lead, t, r, s)


# -- slice 10: the lift of every ring the planner picks, the widened skinny ----


@pytest.mark.parametrize("deg", [(5,), (6,), (7,), (8,), (12,), (16,), (3, 4), (4, 3), (2, 5),
                                 (2, 7), (3, 2)], ids=str)
def test_every_new_lift_matches_plain(cuda, deg):
    """The tc route over a ring it lifts (a single-level D >= 5 as (1, D),
    a two-level tower onto its inner ring): every instantiation against the
    plain version, batched and ragged, with one limb pre-pass and one lift."""
    ring = make_ring(2, 32, deg)
    rng = np.random.default_rng(15)
    for lead, (t, r, s) in [((), (64, 64, 64)), ((2,), (96, 300, 160)), ((), (70, 17, 97))]:
        A = ring.random(rng, lead + (t, r), device=cuda)
        B = ring.random(rng, lead + (r, s), device=cuda)
        want = gr_matmul_ref(A, B, ring)
        for config in tc_configs(*tower_shape(ring)):
            counters.reset()
            assert torch.equal(gr_matmul_tc(A, B, ring, config), want), (config, lead, t, r, s)
            assert counters.launches_by_route["lift"] == counters.launches_by_route["limbs"] == 1


@pytest.mark.parametrize("deg", [(), (3,), (5,), (6,), (7,), (12,), (3, 4)], ids=str)
def test_widened_skinny_matches_plain(cuda, deg):
    """skinny at t = 64 and r = 32 (the encodes and decodes of 64 workers)
    with ragged s, against the plain version; one past either edge it
    refuses the call."""
    ring = make_ring(2, 32, deg)
    rng = np.random.default_rng(16)
    for lead, (t, r, s) in [((), (64, 8, 4099)), ((2,), (32, 32, 333)), ((), (64, 32, 257)),
                            ((), (17, 3, 100001))]:
        A = ring.random(rng, lead + (t, r), device=cuda)
        B = ring.random(rng, lead + (r, s), device=cuda)
        assert torch.equal(gr_matmul_skinny(A, B, ring), gr_matmul_ref(A, B, ring)), (lead, t, r, s)
    for t, r in ((65, 2), (2, 33)):
        A = ring.random(rng, (t, r), device=cuda)
        B = ring.random(rng, (r, 5), device=cuda)
        with pytest.raises(ValueError, match="skinny kernel takes"):
            gr_matmul_skinny(A, B, ring)


# -- slice 11: tc_left, the lift on the small left operand ----------------------


@pytest.mark.parametrize("deg", [(5,), (6,), (7,), (16,), (3, 4), (4, 3), (2, 5), (2, 7),
                                 (3, 7)], ids=str)
def test_tc_left_and_its_prepasses_match_plain(cuda, deg):
    """tc_left over a lifted ring at every instantiation of its inner ring,
    batched and ragged: the lift of A and the stack of B against their
    plain version, the product against the ring's; one launch of each."""
    from repro_torch.kernels.gr_matmul import (
        gr_matmul_tc_left,
        tc_left_configs,
        tc_left_limbs,
        tc_left_padded,
    )
    from repro_torch.kernels.ref import tc_left_planes_ref

    ring = make_ring(2, 32, deg)
    D = ring.D
    rng = np.random.default_rng(21)
    for lead, (t, r, s) in [((), (16, 33, 333)), ((2,), (32, 32, 97)), ((), (64, 4, 1001)),
                            ((), (3, 70, 64))]:
        A = ring.random(rng, lead + (t, r), device=cuda)
        B = ring.random(rng, lead + (r, s), device=cuda)
        A8, B8 = tc_left_limbs(A, B, ring)
        A3, B3 = (A, B) if lead else (A[None], B[None])
        want_a, want_b = tc_left_planes_ref(A3, B3, ring, *tc_left_padded(D * t, D * r, s))
        assert torch.equal(A8, want_a) and torch.equal(B8, want_b), (lead, t, r, s)
        want = gr_matmul_ref(A, B, ring)
        for config in tc_left_configs(*tower_shape(ring)):
            counters.reset()
            assert torch.equal(gr_matmul_tc_left(A, B, ring, config), want), (config, lead, t, r, s)
            assert counters.launches_by_route["tc_left"] == counters.launches == 1
            assert counters.launches_by_route["left_lift"] == counters.launches_by_route["stack"] == 1
            assert counters.launches_by_route["lift"] == 0


@pytest.mark.parametrize("deg,t,r", [((7,), 16, 33), ((3, 7), 32, 32), ((3, 7), 64, 4),
                                     ((3, 7), 64, 8)], ids=str)
def test_tc_left_takes_the_64_worker_calls(cuda, deg, t, r):
    """The decodes and encodes of the planner's 64-worker rounds (s cut
    to 4099) go to tc_left, not simt, and equal the plain version."""
    ring = make_ring(2, 32, deg)
    assert pick_route(ring, t, r, 1 << 17) == "tc_left"
    rng = np.random.default_rng(22)
    A = ring.random(rng, (t, r), device=cuda)
    B = ring.random(rng, (r, 4099), device=cuda)
    counters.reset()
    assert torch.equal(gr_matmul(A, B, ring), gr_matmul_ref(A, B, ring))
    assert counters.launches_by_route["tc_left"] == 1 and counters.launches_by_route["simt"] == 0


@pytest.mark.parametrize("deg,bn", [((3, 7), 80), ((7,), 80)], ids=str)
def test_tc_left_runs_past_65535_column_tiles(cuda, deg, bn):
    """More column tiles than gridDim.y takes (the (3, 7) 64-row encode at
    4096^3 has 131072): tc_left's persistent blocks walk every one of them."""
    from repro_torch.kernels.gr_matmul import gr_matmul_tc_left, tc_left_default

    ring = make_ring(2, 32, deg)
    assert tc_left_default(ring, 1) == (bn,)
    s = 65535 * bn + bn + 1
    rng = np.random.default_rng(23)
    A = ring.random(rng, (2, 1), device=cuda)
    B = ring.random(rng, (1, s), device=cuda)
    assert torch.equal(gr_matmul_tc_left(A, B, ring), gr_matmul_ref(A, B, ring))


# -- tc_left's own kernel -------------------------------------------------------

# the tc_left kernel's shapes (chip_smoke.py's TC_LEFT_SHAPES with t <= 64)
LEFT_SHAPES = [(16, 33, 333), (32, 32, 200), (64, 4, 1001), (64, 8, 4099), (3, 70, 64)]


@pytest.mark.parametrize("tower", [(1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11),
                                   (1, 12), (1, 13), (1, 14), (1, 15), (1, 16), (2, 3), (2, 5),
                                   (2, 7), (3, 2), (3, 4), (3, 5), (3, 7), (4, 3)], ids=str)
def test_tc_left_kernel_on_every_lifted_ring(cuda, tower):
    """The tc_left kernel at every tile width of every lifted ring, against
    the plain version: its shapes, a batched call, both edges of the
    32-byte stage (D r at or under 32 and the next r), both sides of the
    edge where the row tile of M(A) stops fitting in shared memory, ragged
    s."""
    from repro_torch.kernels.gr_matmul import (
        TC_LIFT_TOWERS,
        gr_matmul_tc_left,
        tc_left_configs,
        tc_left_layout,
        tc_left_padded,
    )

    assert tower in TC_LIFT_TOWERS
    d0, d1 = tower
    ring = make_ring(2, 32, (d1,) if d0 == 1 else tower)
    D = ring.D
    configs = tc_left_configs(*tower_shape(ring))
    # the last r whose row tile stays resident at the default width
    resident = max(r for r in range(1, 400)
                   if tc_left_layout(ring, configs[0], tc_left_padded(1, D * r, 1)[1])[1])
    shapes = [((), x) for x in LEFT_SHAPES] + [((3,), (5, 6, 77))] + [
        ((), (9, r, 259)) for r in {max(1, 32 // D), 32 // D + 1, resident, resident + 1}]
    rng = np.random.default_rng(31)
    for lead, (t, r, s) in shapes:
        A = ring.random(rng, lead + (t, r), device=cuda)
        B = ring.random(rng, lead + (r, s), device=cuda)
        want = gr_matmul_ref(A, B, ring)
        for config in configs:
            got = gr_matmul_tc_left(A, B, ring, config)
            assert torch.equal(got, want), (config, lead, t, r, s)


def test_tc_left_wrapper_raises_outside_its_envelope(cuda):
    """Rows past 64, a ring it does not lift, a tile width it was not built
    with: the wrapper raises and launches nothing."""
    from repro_torch.kernels.gr_matmul import gr_matmul_tc_left

    rng = np.random.default_rng(32)
    ring = make_ring(2, 32, (3, 7))
    counters.reset()
    with pytest.raises(ValueError, match="1 <= t <= 64"):
        gr_matmul_tc_left(ring.random(rng, (65, 4), device=cuda),
                          ring.random(rng, (4, 100), device=cuda), ring)
    with pytest.raises(ValueError, match="no instantiation"):
        gr_matmul_tc_left(ring.random(rng, (8, 4), device=cuda),
                          ring.random(rng, (4, 100), device=cuda), ring, (48,))
    plain = make_ring(2, 32, (3,))
    with pytest.raises(ValueError, match="no instantiation"):
        gr_matmul_tc_left(plain.random(rng, (8, 4), device=cuda),
                          plain.random(rng, (4, 100), device=cuda), plain)
    assert counters.launches == 0 and not any(counters.launches_by_route.values())


def test_tuned_entry_is_what_the_route_launches(cuda, monkeypatch):
    """The committed cache covers this card's main-path shapes, or misses
    to the default; run_route launches what pick_blocks names, exactly."""
    from repro_torch.kernels import autotune, ops

    ring = make_ring(2, 32, (3,))
    entry = autotune.load_cache().get(autotune.tune_key(ring, 1024, 2048, 1024, cuda))
    picked = ops.pick_blocks(ring, 1024, 2048, 1024, device=cuda)
    assert picked == (tuple(entry["config"]) if entry else tc_configs(3, 1)[0])
    seen = []
    real = ops.gr_matmul_tc
    monkeypatch.setattr(ops, "gr_matmul_tc", lambda A, B, ring, config: (
        seen.append(config), real(A, B, ring, config))[1])
    rng = np.random.default_rng(15)
    A = ring.random(rng, (2, 1024, 2048), device=cuda)
    B = ring.random(rng, (2, 2048, 1024), device=cuda)
    assert torch.equal(gr_matmul(A, B, ring), gr_matmul_ref(A, B, ring))
    assert seen == [picked]


def test_autotune_one_point_on_the_card(cuda):
    from repro_torch.kernels import autotune

    ring = make_ring(2, 32, (3,))
    try:
        res = autotune.autotune(ring, 128, 256, 128, batch=2, route="tc", iters=2)
    finally:
        autotune.invalidate_memory_cache()
    assert res.entry["default"] == autotune.config_name("tc", tc_configs(3, 1)[0])
    assert set(res.entry["candidates"]) == set(res.entry["usage"])
    assert all(u.get("regs", 0) > 0 for u in res.entry["usage"].values())


def test_shard_map_ranks_on_one_card(cuda):
    """Four ranks (this process and three spawned) on the card in a gloo
    group: every rank's encode, product and decode launch kernels, and the
    result equals local's under two dead ranks."""
    from repro_torch.cdmm.backends import ShardMapBackend

    ring = make_ring(2, 32, (2,))
    spec = ProblemSpec(256, 256, 256, n=1, ring=ring, N=4, straggler_budget=1)
    scheme = plan(spec, schemes=["ep"], calibration=False).instantiate(device=cuda)
    rng = np.random.default_rng(16)
    A, B = ring.random(rng, (256, 256), device=cuda), ring.random(rng, (256, 256), device=cuda)
    mask = torch.tensor([True, False, True, True])
    with ShardMapBackend() as be:
        C = coded_matmul(A, B, scheme, backend=be, mask=mask)
        reports = be.last_reports
    assert torch.equal(C, coded_matmul(A, B, scheme, backend="local", mask=mask.to(cuda)))
    assert torch.equal(C, gr_matmul_ref(A, B, ring))
    assert len(reports) == 4 and all(r["launches"]["tc"] == 1 and r["launches"]["skinny"] >= 3
                                     for r in reports)


# ---------------------------------------------------------------------------
# the LM substrate on the card (plain PyTorch ops; no ring kernel)
# ---------------------------------------------------------------------------

# relative L2 tolerances of tests/test_torch_models.py: float32 end to end
# (TF32 off), a float32 decode step, bf16 logits
LM_TOL = {"float32": 1e-5, "float32-step": 5e-5, "bfloat16": 5e-2}


def _lm_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_smoke_on_the_card_matches_the_cpu(cuda, dtype, monkeypatch):
    """gemma2-2b at smoke size, the same weights on the card and on the
    CPU: prefill at 80 tokens (beyond the window of 64) and 16 decode steps
    (a float32 cache in the float32 config) agree within the tolerances the
    CPU tests hold the port to against the reference; greedy generation on
    the card gives tokens in range and launches no ring kernel."""
    import dataclasses

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import build_model
    from repro_torch.runtime.sharding import _map_leaves, materialize

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(ARCHS["gemma2-2b"].smoke(), dtype=dtype)
    api = build_model(cfg)
    host = materialize(api.param_specs, 0, device="cpu")
    card = _map_leaves(lambda _, t: t.to(cuda), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 80)).astype(np.int32))
    with torch.inference_mode():
        pc = api.prefill_fn(host, {"tokens": toks})
        pg = api.prefill_fn(card, {"tokens": toks.to(cuda)})
        assert pg.device.type == "cuda"
        assert _lm_rel(pg, pc) <= LM_TOL[dtype]
        decl = api.cache_decl(ShapeConfig("s", 24, 2, "decode"))
        cdt = torch.float32 if dtype == "float32" else None

        def zeros(dev):
            return _map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=cdt if cdt and ps.shape
                                                         else ps.dtype, device=dev), decl)

        cc, cg = zeros("cpu"), zeros(cuda)
        for t in range(16):
            lc, cc = api.decode_fn(host, cc, {"tokens": toks[:, t:t + 1]})
            lg, cg = api.decode_fn(card, cg, {"tokens": toks[:, t:t + 1].to(cuda)})
            assert _lm_rel(lg, lc) <= LM_TOL["float32-step" if dtype == "float32" else dtype], t
    counters.reset()
    out = greedy_generate("gemma2-2b", device=cuda, params=card if dtype == "bfloat16" else None)
    assert out["generated"].shape == (2, 8)
    assert ((out["generated"] >= 0) & (out["generated"] < 512)).all()
    assert bool(torch.isfinite(out["logits"]).all()) and len(out["step_ms"]) == 16
    assert sum(counters.launches_by_route.values()) == 0
