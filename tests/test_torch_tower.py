"""The two routes the two-level towers take, as their plain versions, on the CPU.

Over a tower GR(2^e, (D0, D1)) the ``tc`` route multiplies over the inner
ring GR(2^e, D0): A read as it lies as (t, D1 r, D0), B through the lift
``M(B)[(r, i), (s, m)] = sum_j RED[i + j, m] B[r, s, j]`` whose limb planes
the lift pre-pass writes, then the limb products of
``gr_matmul_limbs_ref`` over the inner ring (``ref.gr_matmul_tc_ref``
composes them).  The ``tower`` route lifts A instead, to its
multiplication matrices (``ref.gr_matmul_tower_ref``).  Both must equal
repro's ``Ring.matmul`` (XLA on the CPU) bit for bit at GR(2^e, (3, 7))
for e in {8, 16, 31, 32} and at (2, 3) and (3, 5), batched and unbatched;
and the lifted chains must wrap mod 2^32 past 2^31.  The kernels
themselves run only on the card (tests/test_torch_card.py, chip_smoke.py).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import gr_matmul_ref, gr_matmul_tc_ref, gr_matmul_tower_ref
from repro_torch.kernels.gr_matmul import tc_padded, tc_shape
from repro_torch.kernels.ref import (
    lift_b_ref,
    limb_planes_ref,
    mult_matrices_ref,
    n_limbs,
    outer_reduction,
    tc_planes_ref,
)

TOWERS = [(3, 7), (2, 3), (3, 5)]
# (batch, t, r, s): unbatched and batched, ragged
SHAPES = {"unbatched": (None, 5, 3, 6), "batched": (2, 3, 4, 2)}


@lru_cache(maxsize=None)
def _reference(deg, batch, t, r, s):
    """Inputs over GR(2^32, deg) and repro's product of them (one XLA
    compile per ring and shape)."""
    jr = jmake(2, 32, deg)
    rng = np.random.default_rng(sum(deg) + t)
    lead = (batch,) if batch else ()
    draw = lambda *dims: rng.integers(0, 2**32, size=lead + dims + (jr.D,),  # noqa: E731
                                      dtype=np.uint64).astype(np.uint32)
    a, b = draw(t, r), draw(r, s)
    if batch:
        ref = np.stack([np.asarray(jr.matmul(a[i], b[i])) for i in range(batch)])
    else:
        ref = np.asarray(jr.matmul(a, b))
    return jr, a, b, ref


def _case(deg, e, shape):
    # repro's GR(2^e, deg) has GR(2^32, deg)'s tables mod 2^e, so the
    # product of inputs reduced mod 2^e is the GR(2^32) product reduced
    jr32, a, b, ref = _reference(deg, *SHAPES[shape])
    assert np.array_equal(jmake(2, e, deg).FOLD % 2**e, jr32.FOLD % 2**e)
    mask = np.uint32(2**e - 1)
    ring = make_ring(2, e, deg)
    return ring, from_numpy(a & mask, ring, "cpu"), from_numpy(b & mask, ring, "cpu"), ref & mask


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("e", [8, 16, 31, 32])
@pytest.mark.parametrize("deg", TOWERS, ids=str)
def test_lifted_tc_matches_reference(deg, e, shape):
    ring, A, B, ref = _case(deg, e, shape)
    np.testing.assert_array_equal(to_numpy(gr_matmul_tc_ref(A, B, ring)), ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("e", [8, 16, 31, 32])
@pytest.mark.parametrize("deg", TOWERS, ids=str)
def test_tower_route_matches_reference(deg, e, shape):
    ring, A, B, ref = _case(deg, e, shape)
    np.testing.assert_array_equal(to_numpy(gr_matmul_tower_ref(A, B, ring)), ref)


@pytest.mark.parametrize("deg", TOWERS, ids=str)
def test_lift_follows_its_definition(deg):
    """M(B) and its limb planes, entry by entry from the outer modulus'
    power reduction (computed here with Python integers, not from FOLD)."""
    jr = jmake(2, 32, deg)
    ring = make_ring(2, 32, deg)
    d0, d1 = deg
    q = 2**32
    # x^k mod the outer modulus, k < 2 d1 - 1, by long division over Z_q
    f = [int(c) for c in ring.moduli[1]]
    red = []
    cur = [1] + [0] * (d1 - 1)
    for _ in range(2 * d1 - 1):
        red.append(cur)
        top = cur[-1]
        cur = [0] + cur[:-1]
        cur = [(c - top * f[i]) % q for i, c in enumerate(cur)]
    assert np.array_equal(outer_reduction(ring), np.array(red, dtype=np.uint64).astype(np.uint32))
    assert np.array_equal(ring.FOLD_U32, np.asarray(jr.FOLD % q, dtype=np.uint64).astype(np.uint32))
    rng = np.random.default_rng(3)
    b = rng.integers(0, q, size=(2, 3, 4, d0 * d1), dtype=np.uint64)
    B = from_numpy(b.astype(np.uint32), ring, "cpu")
    M = to_numpy(lift_b_ref(B, ring)).astype(np.uint64)  # (2, d1 3, d1 4, d0)
    for z in range(2):
        for r in range(3):
            for s in range(4):
                for i in range(d1):
                    for m in range(d1):
                        want = [sum(red[i + j][m] * int(b[z, r, s, j * d0 + d]) for j in range(d1)) % q
                                for d in range(d0)]
                        assert list(M[z, d1 * r + i, d1 * s + m]) == want
    # the pre-pass's planes: byte l of M(B)'s coefficient d, K-major, zero-padded
    A = from_numpy(rng.integers(0, q, size=(2, 5, 3, d0 * d1), dtype=np.uint64).astype(np.uint32),
                   ring, "cpu")
    _, T, R1, S1 = tc_shape(ring, 5, 3, 4)
    assert (T, R1, S1) == (5, d1 * 3, d1 * 4)
    Tp, Rp, Sp = tc_padded(T, R1, S1)
    A8, B8 = tc_planes_ref(A, B, ring, Tp, Rp, Sp)
    assert A8.shape == (2, d0, n_limbs(ring), Tp, Rp) and B8.shape == (2, d0, n_limbs(ring), Sp, Rp)
    inner = ring.base_ring()
    assert torch.equal(A8, limb_planes_ref(A.reshape(2, 5, d1 * 3, d0), inner, Tp, Rp))
    words = sum(B8[:, :, l].to(torch.int64) << (8 * l) for l in range(n_limbs(ring)))  # (2, d0, Sp, Rp)
    assert np.array_equal(words[:, :, : d1 * 4, : d1 * 3].permute(0, 3, 2, 1).numpy(), M)
    assert not words[:, :, d1 * 4:].any() and not words[..., d1 * 3:].any()


def test_mult_matrices_multiply():
    """(a b)_k = sum_j M(a)[j, k] b_j over the (3, 7) tower."""
    ring = make_ring(2, 32, (3, 7))
    rng = np.random.default_rng(4)
    a, b = (ring.random(rng, (6,), device="cpu") for _ in range(2))
    M = mult_matrices_ref(a, ring)  # (6, D, D)
    got = ((M * (b.to(torch.int64) & 0xFFFFFFFF)[..., :, None]).sum(-2) & 0xFFFFFFFF)
    assert torch.equal(got, ring.mul(a, b).to(torch.int64) & 0xFFFFFFFF)


def test_lifted_chain_wraps_past_2_31():
    # every limb 0xFF: over the (3, 7) tower the inner accumulators chain
    # the byte products of A (all 0xFF) with the lift of B over D1 r = 3584
    # elements; their exact sums pass 2^31 (4.68e6 a row of B), and the
    # route, wrapping mod 2^32, still equals the plain version
    ring = make_ring(2, 32, (3, 7))
    r = 512
    A = torch.full((2, r, ring.D), -1, dtype=torch.int32)
    B = torch.full((r, 3, ring.D), -1, dtype=torch.int32)
    d0, T, R1, S1 = tc_shape(ring, 2, r, 3)
    A8, B8 = (x.to(torch.int64) for x in tc_planes_ref(A, B, ring, *tc_padded(T, R1, S1)))
    inner, L = ring.base_ring(), n_limbs(ring)
    chains = {}
    for i in range(d0):
        for j in range(d0):
            for x in range(L):
                for y in range(L - x):
                    key = (int(inner.CONVPOS[i, j]), x + y)
                    chains[key] = chains.get(key, 0) + A8[i, x] @ B8[j, y].T
    assert max(int(c.max()) for c in chains.values()) >= 2**31
    want = gr_matmul_ref(A, B, ring)
    assert torch.equal(gr_matmul_tc_ref(A, B, ring), want)
    assert torch.equal(gr_matmul_tower_ref(A[:, :16], B[:16], ring),
                       gr_matmul_ref(A[:, :16], B[:16], ring))
