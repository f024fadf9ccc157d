"""The ``tc_left`` route as its plain version, on the CPU.

Over a lifted ring (D0, D1) (``ref.tc_view``: a two-level tower, or a
single-level GR(2^e, D) with D > 4 as (1, D)) the ``tc`` route lifts B to
M(B), D1 times B's size.  For a decode or an encode, whose left operand is
a small host-built matrix against millions of columns, ``tc_left`` lifts A
instead, to its multiplication matrices over Z_2^e, and reads B as it
lies:

    M(A)[(t, m), (r, k)] = sum_i A[t, r, i] FOLD[CONVPOS(i, k), m]   (D t x D r)
    B'[(r, k), s] = B[r, s, k]                                        (D r x s)
    C[t, s, m] = (M(A) B')[(t, m), s]   over Z_2^e.

A lift pre-pass writes M(A)'s limb planes and a stack pre-pass B''s, both
at the route's 32-byte depth (``tc_left_padded``).
``ref.gr_matmul_tc_left_ref`` composes the route's arithmetic (the
planes, then the kernel's tile walk); it must
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
    TC_LIFT_TOWERS,
    tc_left_default,
    gr_matmul_tc_left,
    tc_left_padded,
    tower_shape,
)
from repro_torch.kernels.ref import (
    lift_b_ref,
    limb_planes_ref,
    n_limbs,
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
    """M(A) entry by entry from FOLD and CONVPOS, the claim the route rests
    on: A's multiplication matrices, M(A)[(t, m), (r, k)] = sum_i A[t, r, i]
    FOLD[CONVPOS(i, k), m], are the A planes the main kernel reads, (1, L,
    Tp, Rp) with rows (t, m) and depth (r, k); over a single-level ring they
    are the tc route's lift of A transposed (RED = FOLD)."""
    ring = make_ring(2, 32, deg)
    D = ring.D
    fold = ring.FOLD_U32.astype(np.uint64)
    conv = np.asarray(ring.CONVPOS)
    rng = np.random.default_rng(3)
    t, r = 3, 5
    a = rng.integers(0, 2**32, size=(t, r, D), dtype=np.uint64)
    MA = np.zeros((D * t, D * r), dtype=np.uint64)
    for i, k, m in np.ndindex(t, r, D):  # row (i, m), depth (k, j)
        for j in range(D):
            MA[D * i + m, D * k + j] = sum(int(a[i, k, ii]) * int(fold[conv[ii, j], m])
                                           for ii in range(D)) % 2**32
    A = from_numpy(a.astype(np.uint32), ring, "cpu")
    if tc_view(*tower_shape(ring))[0] == 1:
        lifted = to_numpy(lift_b_ref(A.transpose(0, 1), ring)).astype(np.uint64)
        assert np.array_equal(lifted.transpose(1, 0, 2)[..., 0], MA)
    Tp, Rp, _ = tc_left_padded(D * t, D * r, 1)
    want = limb_planes_ref(torch.from_numpy(MA.astype(np.uint32).view(np.int32))[..., None],
                           ring, Tp, Rp)
    B = ring.random(rng, (r, 2), device="cpu")
    A8, _ = tc_left_planes_ref(A, B, ring, Tp, Rp, 32)
    assert A8.shape == (1, n_limbs(ring), Tp, Rp) and torch.equal(A8, want)


@pytest.mark.parametrize("deg", [(7,), (3, 7), (3, 4)], ids=str)
def test_stack_follows_its_definition(deg):
    """The stack pre-pass's planes: byte l of B[r, s, k] at plane l, row s,
    column D r + k; zeros past S and past D R."""
    ring = make_ring(2, 32, deg)
    D = ring.D
    rng = np.random.default_rng(4)
    r, s = 3, 5
    b = rng.integers(0, 2**32, size=(2, r, s, D), dtype=np.uint64)
    _, Rp, Sp = tc_left_padded(1, D * r, s)
    planes = stacked_planes_ref(from_numpy(b.astype(np.uint32), ring, "cpu"), ring, Sp, Rp)
    L = n_limbs(ring)
    assert planes.shape == (2, 1, L, Sp, Rp)
    p = planes.numpy()
    for z, rr, ss, k, l in np.ndindex(2, r, s, D, L):
        assert p[z, 0, l, ss, D * rr + k] == (int(b[z, rr, ss, k]) >> (8 * l)) & 0xFF
    assert not p[:, :, :, s:].any() and not p[..., D * r:].any()


@pytest.mark.parametrize("deg,r", [((3, 7), 700), ((6,), 1800)], ids=str)
def test_tc_left_chain_wraps_past_2_31(deg, r):
    """All-0xFF operands: the accumulators of the lifted A's limb products
    chain past 2^31 at the r chip_smoke.py's wrap check uses; the route,
    wrapping mod 2^32, still equals the plain version."""
    ring = make_ring(2, 32, deg)
    D = ring.D
    A = torch.full((2, r, D), -1, dtype=torch.int32)
    B = torch.full((r, 3, D), -1, dtype=torch.int32)
    A8, B8 = (x.to(torch.int64)[0] for x in
              tc_left_planes_ref(A, B, ring, *tc_left_padded(D * 2, D * r, 3)))
    L = n_limbs(ring)
    chains = {}
    for x in range(L):
        for y in range(L - x):
            chains[x + y] = chains.get(x + y, 0) + A8[x] @ B8[y].T
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
    # the tile width the layout gives at r = 33: 80 wide where two row tiles
    # fit a block; over the (3, 7) tower (704 deep) neither width pairs them,
    # and only the 64-wide tile keeps its one row tile resident
    widths = {(3, 7): (64,), (7,): (80,), (16,): (80,)}
    for deg in [(3,), (4,), (), (3, 7), (7,), (16,), (5, 2)]:
        ring = make_ring(2, 32, deg)
        d0, d1 = tc_view(*tower_shape(ring))
        lifted = d1 > 1 and (d0, d1) in TC_LIFT_TOWERS
        assert ops.route_takes("tc_left", ring, 16, 33) == lifted, deg
        assert lifted == (deg in widths), deg
        if lifted:
            assert ops.pick_blocks(ring, 16, 33, 4096, route="tc_left") == widths[deg], deg
    # the (3, 7) 64-worker round: its 32 x 32 decode 64 wide, its encodes 80
    ring = make_ring(2, 32, (3, 7))
    assert [tc_left_default(ring, r) for r in (32, 4, 8)] == [(64,), (80,), (80,)]


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
