"""The ``tc_left`` route as its plain version, on the CPU.

Over a lifted ring (D0, D1) (``ref.tc_view``: a two-level tower, or a
single-level GR(2^e, D) with D > 4 as (1, D)) the ``tc`` route lifts B to
M(B), D1 times B's size.  For a decode or an encode, whose left operand is
a small host-built matrix against millions of columns, ``tc_left`` lifts A
instead and reads B as it lies:

    M(A)[(t, m), (r, k)] = sum_j RED[k + j, m] A[t, r, j]    (D1 t x D1 r)
    B'[(r, k), s] = B[r, s, k]                                (D1 r x s)
    C[t, s, m] = (M(A) B')[(t, m), s]   over the inner ring GR(2^e, D0).

M(A)'s limb planes are the lift pre-pass run on A transposed, and B''s
come from a stack pre-pass.  ``ref.gr_matmul_tc_left_ref`` composes the
route's arithmetic (the limb products of ``gr_matmul_limbs_ref``); it must
equal ``gr_matmul_ref`` and repro's ``Ring.matmul`` (XLA on the CPU) bit
for bit over GR(2^32, 7), GR(2^32, 6), (3, 4) and (3, 7) at the decode and
encode shapes of 64 workers, cut in s.  The kernels themselves run only on
the card (tests/test_torch_card.py, chip_smoke.py).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import (
    counters,
    gr_matmul,
    gr_matmul_ref,
    gr_matmul_tc_left_ref,
    ops,
    pick_route,
)
from repro_torch.kernels.gr_matmul import (
    TC_CONFIGS,
    TC_LIFT_TOWERS,
    gr_matmul_tc_left,
    tc_padded,
    tower_shape,
)
from repro_torch.kernels.ref import (
    lift_b_ref,
    limb_planes_ref,
    n_limbs,
    outer_reduction,
    stacked_planes_ref,
    tc_left_planes_ref,
    tc_view,
)

RINGS = [(7,), (6,), (3, 4), (3, 7)]
# (batch, t, r, s): the 16 x 33 decode of the secure plans and the 32 x 32
# decode of 64 workers, a 64-row encode, a batched call; ragged s
SHAPES = {"decode_r33": (None, 16, 33, 40), "decode_r32": (None, 32, 32, 24),
          "encode": (None, 64, 4, 9), "batched": (2, 3, 5, 7)}


@lru_cache(maxsize=None)
def _reference(deg, batch, t, r, s):
    """Inputs over GR(2^32, deg) and repro's product of them."""
    jr = jmake(2, 32, deg)
    rng = np.random.default_rng(sum(deg) + t + r)
    lead = (batch,) if batch else ()
    draw = lambda *dims: rng.integers(0, 2**32, size=lead + dims + (jr.D,),  # noqa: E731
                                      dtype=np.uint64).astype(np.uint32)
    a, b = draw(t, r), draw(r, s)
    if batch:
        ref = np.stack([np.asarray(jr.matmul(a[i], b[i])) for i in range(batch)])
    else:
        ref = np.asarray(jr.matmul(a, b))
    return a, b, ref


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("deg", RINGS, ids=str)
def test_tc_left_matches_reference(deg, shape):
    a, b, ref = _reference(deg, *SHAPES[shape])
    ring = make_ring(2, 32, deg)
    A, B = from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu")
    out = gr_matmul_tc_left_ref(A, B, ring)
    np.testing.assert_array_equal(to_numpy(out), ref)
    assert torch.equal(out, gr_matmul_ref(A, B, ring))


@pytest.mark.parametrize("deg,e", [((3, 7), 31), ((3, 7), 8), ((6,), 16), ((2, 5), 32),
                                   ((16,), 32), ((4, 3), 24)], ids=str)
def test_tc_left_matches_plain_on_other_rings(deg, e):
    ring = make_ring(2, e, deg)
    rng = np.random.default_rng(e)
    for lead, t, r, s in [((), 16, 33, 11), ((2,), 5, 3, 4)]:
        A = ring.random(rng, lead + (t, r), device="cpu")
        B = ring.random(rng, lead + (r, s), device="cpu")
        assert torch.equal(gr_matmul_tc_left_ref(A, B, ring), gr_matmul_ref(A, B, ring))


@pytest.mark.parametrize("deg", RINGS + [(16,), (2, 7)], ids=str)
def test_lift_of_a_transposed_is_the_a_planes(deg):
    """M(A) entry by entry from RED, then the claim the route rests on: the
    lift pre-pass run on A transposed writes M(A)'s limb planes as the main
    kernel reads A's, (D0, L, Tp, Rp) with rows (t, m) and depth (r, k)."""
    ring = make_ring(2, 32, deg)
    d0, d1 = tc_view(*tower_shape(ring))
    red = outer_reduction(ring).astype(np.uint64)
    rng = np.random.default_rng(3)
    t, r = 3, 5
    a = rng.integers(0, 2**32, size=(t, r, ring.D), dtype=np.uint64)
    MA = np.zeros((d1 * t, d1 * r, d0), dtype=np.uint64)
    for i, k, m, j in np.ndindex(t, r, d1, d1):  # row (i, m), depth (k, j)
        MA[d1 * i + m, d1 * k + j] = sum(red[j + jj, m] * a[i, k, jj * d0: (jj + 1) * d0]
                                         for jj in range(d1)) % 2**32
    A = from_numpy(a.astype(np.uint32), ring, "cpu")
    lifted = to_numpy(lift_b_ref(A.transpose(0, 1), ring)).astype(np.uint64)
    assert np.array_equal(lifted.transpose(1, 0, 2), MA)
    Tp, Rp, _ = tc_padded(d1 * t, d1 * r, 1)
    inner = ring.base_ring()
    want = limb_planes_ref(from_numpy(MA.astype(np.uint32), inner, "cpu"), inner, Tp, Rp)
    B = ring.random(rng, (r, 2), device="cpu")
    A8, _ = tc_left_planes_ref(A, B, ring, Tp, Rp, 32)
    assert A8.shape == (d0, n_limbs(ring), Tp, Rp) and torch.equal(A8, want)


@pytest.mark.parametrize("deg", [(7,), (3, 7), (3, 4)], ids=str)
def test_stack_follows_its_definition(deg):
    """The stack pre-pass's planes: byte l of B[r, s, k, d] at plane (d, l),
    row s, column D1 r + k; zeros past S and past D1 R."""
    ring = make_ring(2, 32, deg)
    d0, d1 = tc_view(*tower_shape(ring))
    rng = np.random.default_rng(4)
    r, s = 3, 5
    b = rng.integers(0, 2**32, size=(2, r, s, ring.D), dtype=np.uint64)
    _, Rp, Sp = tc_padded(1, d1 * r, s)
    planes = stacked_planes_ref(from_numpy(b.astype(np.uint32), ring, "cpu"), ring, Sp, Rp)
    L = n_limbs(ring)
    assert planes.shape == (2, d0, L, Sp, Rp)
    p = planes.numpy()
    for z, rr, ss, k, d, l in np.ndindex(2, r, s, d1, d0, L):
        assert p[z, d, l, ss, d1 * rr + k] == (int(b[z, rr, ss, k * d0 + d]) >> (8 * l)) & 0xFF
    assert not p[:, :, :, s:].any() and not p[..., d1 * r:].any()


@pytest.mark.parametrize("deg,r", [((3, 7), 512), ((6,), 1800)], ids=str)
def test_tc_left_chain_wraps_past_2_31(deg, r):
    """All-0xFF operands: the accumulators of the lifted A's limb products
    chain past 2^31 at the r chip_smoke.py's wrap check uses; the route,
    wrapping mod 2^32, still equals the plain version."""
    ring = make_ring(2, 32, deg)
    d0, d1 = tc_view(*tower_shape(ring))
    A = torch.full((2, r, ring.D), -1, dtype=torch.int32)
    B = torch.full((r, 3, ring.D), -1, dtype=torch.int32)
    A8, B8 = (x.to(torch.int64) for x in
              tc_left_planes_ref(A, B, ring, *tc_padded(d1 * 2, d1 * r, 3)))
    inner, L = ring.base_ring(), n_limbs(ring)
    chains = {}
    for i, j in np.ndindex(d0, d0):
        for x in range(L):
            for y in range(L - x):
                key = (int(inner.CONVPOS[i, j]), x + y)
                chains[key] = chains.get(key, 0) + A8[i, x] @ B8[j, y].T
    assert max(int(c.max()) for c in chains.values()) >= 2**31
    assert torch.equal(gr_matmul_tc_left_ref(A, B, ring), gr_matmul_ref(A, B, ring))


# (ring degrees, t, r, s, route) of the planner's 64-worker rounds at 2048^3
LEFT_ROUTES = [
    ((7,), 16, 33, 262144, "tc_left"),     # the R = 33 decode (ep_secure, ep_rmfe_secure)
    ((3, 7), 32, 32, 131072, "tc_left"),   # batch_ep_rmfe n = 8: the decode
    ((3, 7), 64, 4, 1048576, "tc_left"),   # and its encodes
    ((3, 7), 64, 8, 524288, "tc_left"),
    ((3, 7), 64, 64, 65536, "tc_left"),    # the (8, 8, 1) plan with no straggler budget
    ((3, 7), 64, 4, 4194304, "tc_left"),   # the encode at 4096^3: 131072 column tiles
    ((3, 7), 8, 8, 131072, "tower"),       # ElasticStream's step 9 keeps its route
    ((3, 7), 512, 1024, 256, "tc"),        # worker products lift B
    ((6,), 32, 32, 131072, "skinny"),      # skinny keeps what it takes
    ((3,), 32, 33, 4096, "simt"),          # GR(2^32, 3) is not lifted
    ((7,), 4, 33, 4096, "simt"),           # D1 t = 28 rows: below TC_MIN_TS
    ((3, 7), 32, 32, 40, "simt"),          # s below TC_MIN_TS
    ((5, 2), 16, 33, 4096, "simt"),        # inner degree 5: no tc instantiation
]


@pytest.mark.parametrize("deg,t,r,s,route", LEFT_ROUTES, ids=str)
def test_pick_route_sends_the_small_left_operands_to_tc_left(deg, t, r, s, route):
    assert pick_route(make_ring(2, 32, deg), t, r, s) == route


def test_tc_left_takes_the_lifted_rings_with_the_inner_rings_tile():
    for deg in [(3,), (4,), (), (3, 7), (7,), (16,), (5, 2)]:
        ring = make_ring(2, 32, deg)
        d0, d1 = tc_view(*tower_shape(ring))
        lifted = d1 > 1 and (d0, d1) in TC_LIFT_TOWERS
        assert ops.route_takes("tc_left", ring, 16, 33) == lifted, deg
        if lifted:
            assert ops.pick_blocks(ring, 16, 33, 4096, route="tc_left") == TC_CONFIGS[(d0, 1)][0]


def test_tc_left_wrapper_runs_only_on_the_card():
    # on the CPU a ring matmul takes the plain version and launches nothing;
    # the wrapper itself refuses CPU tensors (it never falls back)
    ring = make_ring(2, 32, (3, 7))
    rng = np.random.default_rng(6)
    A, B = ring.random(rng, (16, 33), device="cpu"), ring.random(rng, (33, 70), device="cpu")
    counters.reset()
    assert torch.equal(gr_matmul(A, B, ring), gr_matmul_ref(A, B, ring))
    assert counters.launches == 0 and not any(counters.launches_by_route.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        gr_matmul_tc_left(A, B, ring)
