"""The planner's wider rings on the CPU: the lifted ``tc`` route over
GR(2^e, D) with 5 <= D <= 16 and over the two-level towers (3, 4), (4, 3),
(2, 5), (2, 7), (3, 2), the widened ``skinny`` route, and where the ring
matmuls of the rounds the planner makes go.

* A single-level GR(2^e, D) with D > 4 runs on the ``tc`` kernel as the
  tower (1, D) over Z_2^e (``ref.tc_view``): A read as (t, D r), the lift
  ``M(B)[(r, i), (s, m)] = sum_j FOLD[i + j, m] B[r, s, j]``, then the limb
  products over Z_2^e.  ``ref.gr_matmul_tc_ref`` composes them; it must
  equal repro's ``Ring.matmul`` (XLA on the CPU) bit for bit, and so must
  the lifted towers, at e in {8, 16, 31, 32} for D = 5, 6 and (3, 4);
* ``pick_route`` sends each new ring's worker product to ``tc`` and the
  64-row encodes and 32 x 32 decodes to ``skinny``;
* for each spec of the planner's probe (64 workers and batches of 4 and 8
  among them), every ring matmul of the planned round at 2048^3 leaves
  ``simt`` (``SIMT_LEFT`` is empty since ``tc_left`` takes the decodes and
  encodes of the 64-worker rounds).  The round's calls
  come from the plan's (u, v, w), n, N and R (``_round_calls``), held
  against a round at 64^3 whose ring matmuls are recorded, not computed.

The kernels themselves run only on the card (tests/test_torch_card.py,
chip_smoke.py).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro_torch.cdmm import ProblemSpec, coded_matmul, plan
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import gr_matmul_ref, gr_matmul_tc_ref, ops, pick_route
from repro_torch.kernels.gr_matmul import (
    SKINNY_MAX_R,
    SKINNY_MAX_T,
    SMEM_BLOCK_BYTES,
    TC_CONFIGS,
    skinny_block,
    skinny_smem_bytes,
    tc_configs,
    tc_instantiated,
    tc_padded,
    tc_shape,
    tc_smem_bytes,
    tower_shape,
)
from repro_torch.kernels.ref import (
    lift_b_ref,
    limb_planes_ref,
    n_limbs,
    outer_reduction,
    tc_lifted,
    tc_planes_ref,
    tc_view,
)

SINGLE = [(5,), (6,), (7,), (12,), (16,)]
TOWERS = [(3, 4), (4, 3), (2, 5), (2, 7), (3, 2)]
# every e for the rings the planner picks at 16 to 64 workers; e = 32 for the rest
WIDE_E = {(5,), (6,), (3, 4)}
CASES = [(deg, e) for deg in SINGLE + TOWERS for e in ((8, 16, 31, 32) if deg in WIDE_E else (32,))]


@lru_cache(maxsize=None)
def _reference(deg):
    """A batch of two (3 x 4) @ (4 x 5) inputs over GR(2^32, deg) and
    repro's products of them (one XLA compile per ring)."""
    jr = jmake(2, 32, deg)
    rng = np.random.default_rng(sum(deg) + len(deg))
    draw = lambda *dims: rng.integers(0, 2**32, size=(2,) + dims + (jr.D,),  # noqa: E731
                                      dtype=np.uint64).astype(np.uint32)
    a, b = draw(3, 4), draw(4, 5)
    return jr, a, b, np.stack([np.asarray(jr.matmul(a[i], b[i])) for i in range(2)])


@pytest.mark.parametrize("deg,e", CASES, ids=str)
def test_lifted_tc_matches_reference(deg, e):
    # repro's GR(2^e, deg) has GR(2^32, deg)'s tables mod 2^e, so the
    # product of inputs reduced mod 2^e is the GR(2^32) product reduced
    jr32, a, b, ref = _reference(deg)
    assert np.array_equal(jmake(2, e, deg).FOLD % 2**e, jr32.FOLD % 2**e)
    mask = np.uint32(2**e - 1)
    ring = make_ring(2, e, deg)
    assert tc_lifted(ring)
    A, B = from_numpy(a & mask, ring, "cpu"), from_numpy(b & mask, ring, "cpu")
    np.testing.assert_array_equal(to_numpy(gr_matmul_tc_ref(A, B, ring)), ref & mask)
    np.testing.assert_array_equal(to_numpy(gr_matmul_tc_ref(A[1], B[1], ring)), ref[1] & mask)


@pytest.mark.parametrize("deg", SINGLE + TOWERS, ids=str)
def test_lift_follows_its_definition(deg):
    """RED from the outer modulus by long division over Z_q (a single-level
    ring's one modulus: RED is FOLD), M(B) entry by entry from it, and the
    pre-pass planes of A read as it lies and of M(B)."""
    ring = make_ring(2, 32, deg)
    d0, d1 = tc_view(*tower_shape(ring))
    assert (d0, d1) == ((1, deg[0]) if len(deg) == 1 else deg)
    q = 2**32
    f = [int(c) for c in ring.moduli[-1]]
    red, cur = [], [1] + [0] * (d1 - 1)
    for _ in range(2 * d1 - 1):
        red.append(cur)
        top = cur[-1]
        cur = [0] + cur[:-1]
        cur = [(c - top * f[i]) % q for i, c in enumerate(cur)]
    assert np.array_equal(outer_reduction(ring), np.array(red, dtype=np.uint64).astype(np.uint32))
    if len(deg) == 1:
        assert np.array_equal(outer_reduction(ring), ring.FOLD_U32)
    rng = np.random.default_rng(5)
    b = rng.integers(0, q, size=(2, 3, 2, ring.D), dtype=np.uint64)
    B = from_numpy(b.astype(np.uint32), ring, "cpu")
    M = to_numpy(lift_b_ref(B, ring)).astype(np.uint64)  # (2, d1 3, d1 2, d0)
    for z, r, s, i, m in np.ndindex(2, 3, 2, d1, d1):
        want = [sum(red[i + j][m] * int(b[z, r, s, j * d0 + d]) for j in range(d1)) % q
                for d in range(d0)]
        assert list(M[z, d1 * r + i, d1 * s + m]) == want
    A = from_numpy(rng.integers(0, q, size=(2, 5, 3, ring.D), dtype=np.uint64).astype(np.uint32),
                   ring, "cpu")
    _, T, R1, S1 = tc_shape(ring, 5, 3, 2)
    assert (T, R1, S1) == (5, d1 * 3, d1 * 2)
    Tp, Rp, Sp = tc_padded(T, R1, S1)
    A8, B8 = tc_planes_ref(A, B, ring, Tp, Rp, Sp)
    inner = ring.base_ring()
    assert inner.D == d0
    assert torch.equal(A8, limb_planes_ref(A.reshape(2, 5, d1 * 3, d0), inner, Tp, Rp))
    words = sum(B8[:, :, l].to(torch.int64) << (8 * l) for l in range(n_limbs(ring)))
    assert np.array_equal(words[:, :, : d1 * 2, : d1 * 3].permute(0, 3, 2, 1).numpy(), M)
    assert not words[:, :, d1 * 2:].any() and not words[..., d1 * 3:].any()


@pytest.mark.parametrize("deg", [(5,), (6,), (3, 4)], ids=str)
def test_lifted_chain_wraps_past_2_31(deg):
    # every limb 0xFF: the inner accumulators chain the byte products of A
    # (all 0xFF) with the lift of B over D1 r elements, past 2^31; the
    # route, wrapping mod 2^32, still equals the plain version
    ring = make_ring(2, 32, deg)
    # the longest chain grows by 780300 (D = 5), 1300500 (D = 6) and 2340900
    # ((3, 4)) an element of r
    r = {(5,): 3000, (6,): 1800, (3, 4): 1000}[deg]
    A = torch.full((2, r, ring.D), -1, dtype=torch.int32)
    B = torch.full((r, 3, ring.D), -1, dtype=torch.int32)
    d0, T, R1, S1 = tc_shape(ring, 2, r, 3)
    A8, B8 = (x.to(torch.int64) for x in tc_planes_ref(A, B, ring, *tc_padded(T, R1, S1)))
    inner, L = ring.base_ring(), n_limbs(ring)
    chains = {}
    for i, j in np.ndindex(d0, d0):
        for x in range(L):
            for y in range(L - x):
                key = (int(inner.CONVPOS[i, j]), x + y)
                chains[key] = chains.get(key, 0) + A8[i, x] @ B8[j, y].T
    assert max(int(c.max()) for c in chains.values()) >= 2**31
    assert torch.equal(gr_matmul_tc_ref(A, B, ring), gr_matmul_ref(A, B, ring))


@pytest.mark.parametrize("deg", SINGLE + TOWERS, ids=str)
def test_lifted_rings_run_their_inner_rings_tc_kernel(deg):
    ring = make_ring(2, 32, deg)
    d0, d1 = tc_view(*tower_shape(ring))
    inner = make_ring(2, 32, (d0,) if d0 > 1 else ())
    assert tc_instantiated(*tower_shape(ring))
    assert tc_configs(*tower_shape(ring)) == TC_CONFIGS[(d0, 1)]
    for config in TC_CONFIGS[(d0, 1)]:
        assert tc_smem_bytes(ring, config) == tc_smem_bytes(inner, config) <= SMEM_BLOCK_BYTES
    assert tc_shape(ring, 512, 1024, 256) == (d0, 512, d1 * 1024, d1 * 256)


# (ring degrees, t, r, s, route): the worker products, encodes and decodes
# of the paths chip_smoke.py drives, and the widened skinny route's edges
ROUTE_CASES = [
    ((3, 4), 1024, 2048, 512, "tc"),        # batch_ep_rmfe n = 4, N = 16
    ((3, 4), 16, 2, 2097152, "skinny"),
    ((3, 4), 16, 4, 1048576, "skinny"),
    ((3, 4), 8, 8, 524288, "skinny"),
    ((6,), 512, 2048, 256, "tc"),           # batch_ep_rmfe n = 2, N = 64
    ((6,), 64, 4, 1048576, "skinny"),
    ((6,), 64, 8, 524288, "skinny"),
    ((6,), 32, 32, 131072, "skinny"),
    ((5,), 512, 1024, 512, "tc"),           # ep_secure N = 16
    ((5,), 16, 3, 524288, "skinny"),
    ((5,), 4, 9, 262144, "skinny"),
    ((7,), 512, 1024, 512, "tc"),
    ((7,), 16, 33, 131072, "tc_left"),      # the R = 33 decode: past r = 32, A lifted
    ((12,), 1024, 2048, 1024, "tc"),
    ((16,), 1024, 2048, 1024, "tc"),
    ((16,), 64, 32, 1000, "skinny"),        # 192 KB of shared memory at 32 threads
    ((4, 3), 1024, 2048, 1024, "tc"),
    ((2, 5), 1024, 2048, 1024, "tc"),
    ((2, 7), 1024, 2048, 1024, "tc"),
    ((3, 2), 1024, 2048, 1024, "tc"),
    ((5, 2), 1024, 2048, 1024, "simt"),     # inner degree 5: no inner instantiation
    ((3,), 64, 32, 4096, "skinny"),         # the widened edges
    ((3,), 65, 32, 4096, "tc"),
    ((3,), 64, 33, 4096, "tc"),
    ((3,), 63, 33, 4096, "simt"),
    ((3,), 32, 33, 4096, "simt"),
    ((3, 7), 64, 4, 1048576, "tc_left"),    # no skinny for (3, 7); tower stops at 16
    ((3, 7), 32, 32, 8192, "tc_left"),
    # the calls of the planner's 64-worker rounds at 2048^3 (chip_smoke.py's
    # WIDE_PATHS): the R = 33 decode over GR(2^32, 7), and the (3, 7)
    # tower's 32 x 32 decode and 64-row encodes for n = 8
    ((7,), 16, 33, 262144, "tc_left"),
    ((3, 7), 32, 32, 131072, "tc_left"),
    ((3, 7), 64, 8, 524288, "tc_left"),
]


@pytest.mark.parametrize("deg,t,r,s,route", ROUTE_CASES, ids=str)
def test_pick_route_on_the_wider_rings(deg, t, r, s, route):
    assert pick_route(make_ring(2, 32, deg), t, r, s) == route


def test_skinny_sizes_its_slab_from_shared_memory():
    gr3, gr6, gr16 = (make_ring(2, 32, (d,)) for d in (3, 6, 16))
    # T, R <= 16 keep their blocks: 128 threads in one group, halved above 100 KB
    assert skinny_block(gr3, 8, 2) == (128, 1)
    assert skinny_smem_bytes(gr3, 8, 2) == 4 * (48 + 2 * 128 * 12)
    assert skinny_block(make_ring(2, 32, (5,)), 16, 16) == (64, 1)  # 165 KB at 128 threads
    worst = max(skinny_smem_bytes(make_ring(2, 32, (d,)), 16, 16) for d in range(1, 9))
    assert worst <= 100 * 1024
    # a 32 x 32 decode over GR(2^32, 6): 128 threads in 4 row groups share a
    # 64-column slab (48 KB) beside A (24 KB), where one group needs 192 KB
    assert skinny_block(gr6, 32, 32) == (128, 4) and skinny_smem_bytes(gr6, 32, 32) == 73728
    # the 64-row encodes fit with one group
    assert skinny_block(gr6, 64, 8) == (128, 1) and skinny_smem_bytes(gr6, 64, 8) == 61440
    # past 100 KB with 4 groups only at the edge: one block an SM, up to 227 KB
    assert skinny_block(gr16, 64, 32) == (128, 4)
    assert skinny_smem_bytes(gr16, 64, 32) == 4 * (64 * 32 * 16 + 32 * 32 * 16) <= SMEM_BLOCK_BYTES
    assert (SKINNY_MAX_T, SKINNY_MAX_R) == (64, 32)


# -- the planner's rounds: every ring matmul, and the route it takes -----------

# (N, n, privacy_t, straggler_budget): the specs whose best plan at 2048^3
# runs its worker product on a ring the lift takes, and the plans of
# chip_smoke.py's main path for comparison
PROBE = [(16, 4, 0, 4), (24, 4, 0, 8), (64, 4, 0, 16), (16, 1, 1, 4), (24, 2, 0, 4),
         (24, 2, 0, 8), (32, 2, 0, 4), (32, 2, 0, 8), (32, 1, 0, 8), (64, 2, 0, 16),
         (64, 1, 1, 0), (64, 2, 1, 0), (8, 2, 0, 2), (16, 2, 0, 4), (8, 8, 0, 2),
         (64, 8, 0, 16), (64, 8, 0, 0)]
# ring matmuls of those rounds at 2048^3 that stay on simt: none.  The R =
# 33 decode of the secure plans for 64 workers (past skinny's r <= 32) and
# the decodes and 64-row encodes over the (3, 7) tower for 64 workers at n
# = 8 (no skinny instantiation, tower takes t, r <= 16) go to tc_left
SIMT_LEFT = {}
SIZE = 2048


def _round_calls(family, u, v, w, n, N, R, deg, size, T=0):
    """(stage, ring degrees, batch, t, r, s) of every ring matmul of one
    round of ``family`` at t = r = s = ``size``, in launch order: the RMFE
    packs phi (level 1 over Z_2^e, then level 2 over GR(2^e, deg[0]) for a
    two-level ring), the encodes of A and B (N x k Vandermonde rows, k =
    u w or w v, plus T mask rows for a secure family), the worker
    products, the decode (uv x R) and the unpacks psi."""
    tb, rb, sb = size // u, size // w, size // v
    sq = size * size
    inner = (deg[0],)
    if family == "ep_rmfe1":  # one product, its contraction halves packed
        phi = [("phi", (), None, 2, 2, sq // 2)]
        enc = [("encode_a", deg, None, N, u * w, tb * rb // 2),
               ("encode_b", deg, None, N, w * v, rb * sb // 2)]
        work = ("workers", deg, N, tb, rb // 2, sb)
        psi = [("psi", (), None, 2, deg[0], sq)]
    else:
        phi, psi = [], []
        if n > 1:  # batch_ep_rmfe, ep_rmfe_secure: n products, two to a level-1 pack
            phi = [("phi", (), None, 2, 2, sq * n // 2)]
            psi = [("psi", (), None, 2, deg[0], sq * n // 2)]
            if len(deg) == 2:
                phi.append(("phi", inner, None, n // 2, n // 2, sq))
                psi.insert(0, ("psi", inner, None, n // 2, deg[1], sq))
        enc = [("encode_a", deg, None, N, u * w + T, tb * rb),
               ("encode_b", deg, None, N, w * v + T, rb * sb)]
        work = ("workers", deg, N, tb, rb, sb)
    return (phi + enc[:1] + phi + enc[1:] + [work, ("decode", deg, None, u * v, R, tb * sb)]
            + psi)


@lru_cache(maxsize=None)
def _plan(spec):
    N, n, privacy_t, budget = spec
    Z32 = make_ring(2, 32, ())
    big = ProblemSpec(SIZE, SIZE, SIZE, n=n, ring=Z32, N=N, straggler_budget=budget,
                      privacy_t=privacy_t)
    return plan(big, calibration=False).candidates[0]


@pytest.mark.parametrize("spec", PROBE, ids=str)
def test_round_calls_follow_the_plan(spec, monkeypatch):
    """The round's ring matmuls, recorded at 64^3 (the plan's own
    configuration built at that size, each matmul answered with zeros),
    are ``_round_calls``' at 64."""
    N, n, privacy_t, budget = spec
    c = _plan(spec)
    small = 64
    Z32 = make_ring(2, 32, ())
    sch = c.instantiate(ProblemSpec(small, small, small, n=n, ring=Z32, N=N,
                                    straggler_budget=budget, privacy_t=privacy_t), "cpu")
    calls = []

    def record(A, B, ring):
        calls.append((ring.degrees, A.shape[0] if A.dim() == 4 else None, A.shape[-3],
                      A.shape[-2], B.shape[-2]))
        return torch.zeros(A.shape[:-2] + (B.shape[-2], ring.D), dtype=torch.int32)

    monkeypatch.setattr(ops, "gr_matmul_ref", record)
    rng = np.random.default_rng(0)
    lead = (n,) if n > 1 else ()
    A = Z32.random(rng, lead + (small, small), device="cpu")
    B = Z32.random(rng, lead + (small, small), device="cpu")
    coded_matmul(A, B, sch, backend="local", key=7 if privacy_t else None, device="cpu")
    want = _round_calls(c.scheme, c.u, c.v, c.w, n, N, sch.R, sch.ring.degrees, small, privacy_t)
    assert calls == [x[1:] for x in want]


@pytest.mark.parametrize("spec", PROBE, ids=str)
def test_planned_round_leaves_simt(spec):
    """At 2048^3 no ring matmul of the planned round goes to simt, but
    those of ``SIMT_LEFT``."""
    N, n, privacy_t, budget = spec
    c = _plan(spec)
    Z32 = make_ring(2, 32, ())
    sch = c.instantiate(ProblemSpec(64, 64, 64, n=n, ring=Z32, N=N, straggler_budget=budget,
                                    privacy_t=privacy_t), "cpu")
    deg = sch.ring.degrees
    left = []
    for stage, d, _, t, r, s in _round_calls(c.scheme, c.u, c.v, c.w, n, N, sch.R, deg, SIZE,
                                             privacy_t):
        if pick_route(make_ring(2, 32, d), t, r, s) == "simt":
            left.append((stage, d, t, r))
    assert left == SIMT_LEFT.get(spec, [])
