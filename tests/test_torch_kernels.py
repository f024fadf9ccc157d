"""repro_torch.kernels held against repro.kernels (JAX on the CPU).

On the CPU the port's ``gr_matmul`` takes the plain PyTorch version; it is
held against the reference's Pallas kernel in interpret mode at two small
shapes (interpret mode is slow) and against the reference's XLA ring matmul
elsewhere.  The CUDA kernel itself runs only on the card: the tests in
tests/test_torch_card.py (marker ``cuda``) compare it with the plain
version there and skip here.
"""
import numpy as np
import pytest

from repro.core.galois import make_ring as jmake
from repro.kernels import gr_matmul as j_gr_matmul
from repro.kernels import kernel_supported as j_kernel_supported
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import (
    counters,
    gr_matmul,
    gr_matmul_planar_ref,
    gr_matmul_ref,
    kernel_auto_enabled,
    kernel_supported,
    pick_blocks,
)
from repro_torch.kernels.gr_matmul import gr_matmul_planar, kernel_tile, tower_shape


def d_thin(ring):
    """Whether simt's thin kernel takes thin calls over ``ring``: a
    single-level GR(2^e, D) with D <= 4."""
    return len(ring.degrees) <= 1 and ring.D <= 4

RING_SPECS = [
    (2, 32, ()),
    (2, 32, (3,)),
    (2, 32, (4,)),
    (2, 16, (5,)),
    (2, 8, (2, 3)),
    (2, 32, (16,)),
    (2, 32, (3, 5)),
]

def _inputs(spec, shape, seed=3, batch=()):
    jr = jmake(*spec)
    t, r, s = shape
    rng = np.random.default_rng(seed)
    return jr, np.asarray(jr.random(rng, batch + (t, r))), np.asarray(jr.random(rng, batch + (r, s)))


@pytest.mark.parametrize(
    "spec,shape",
    [((2, 32, (3,)), (7, 13, 5)), ((2, 32, (3,)), (16, 32, 8)), ((2, 8, (2, 3)), (7, 13, 5))],
    ids=str,
)
def test_matches_pallas_interpret(spec, shape):
    jr, a, b = _inputs(spec, shape)
    ring = make_ring(*spec)
    ref = np.asarray(j_gr_matmul(a, b, jr, interpret=True))
    got = to_numpy(gr_matmul(from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu"), ring))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "spec,shape",
    [(spec, (7, 13, 5)) for spec in RING_SPECS]
    + [((2, 32, ()), (130, 17, 129)), ((2, 32, (3,)), (130, 17, 129)), ((2, 32, (3, 5)), (1, 64, 1))],
    ids=str,
)
def test_plain_matches_reference_matmul(spec, shape):
    jr, a, b = _inputs(spec, shape, seed=5)
    ring = make_ring(*spec)
    ref = np.asarray(jr.matmul(a, b))
    got = to_numpy(gr_matmul_ref(from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu"), ring))
    assert got.shape == ref.shape == (shape[0], shape[2], ring.D)
    np.testing.assert_array_equal(got, ref)


def test_planar_and_batched_plain_versions():
    spec = (2, 32, (3,))
    jr, a, b = _inputs(spec, (5, 6, 4), batch=(3,))
    ring = make_ring(*spec)
    A, B = from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu")
    batched = to_numpy(gr_matmul(A, B, ring))
    for i in range(3):
        np.testing.assert_array_equal(batched[i], np.asarray(jr.matmul(a[i], b[i])))
    planar = gr_matmul_planar_ref(A[0].movedim(-1, 0), B[0].movedim(-1, 0), ring)
    np.testing.assert_array_equal(to_numpy(planar.movedim(0, -1)), batched[0])


def test_odd_p_plain_version():
    spec = (3, 2, (2,))
    jr, a, b = _inputs(spec, (4, 4, 4))
    ring = make_ring(*spec)
    assert not kernel_supported(ring) and not j_kernel_supported(jr)
    got = to_numpy(gr_matmul(from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu"), ring))
    np.testing.assert_array_equal(got, np.asarray(j_gr_matmul(a, b, jr)))


def test_routing_on_cpu_never_launches():
    ring = make_ring(2, 32, (3,))
    A = ring.random(np.random.default_rng(0), (4, 4), device="cpu")
    counters.reset()
    gr_matmul(A, A, ring)
    assert counters.launches == 0
    assert not any(counters.launches_by_route.values())
    assert not kernel_auto_enabled(ring, A)
    # the kernel wrapper itself takes CUDA tensors only: it launches or raises
    with pytest.raises(ValueError, match="CUDA"):
        gr_matmul_planar(A.movedim(-1, 0).contiguous(), A.movedim(-1, 0).contiguous(), ring)


def test_envelope_and_tiles():
    for spec in RING_SPECS:
        ring, jr = make_ring(*spec), jmake(*spec)
        assert kernel_supported(ring) == j_kernel_supported(jr)
        # simt's tile kernel (every call past 64 rows, every call over a ring
        # its thin kernel does not take): square tiles, both of them, with
        # rows padded by one word, in 48 KB of static shared memory
        bt, bs, br = pick_blocks(ring)
        assert (bt, bs, br) == kernel_tile(ring) and bt == bs and br in (8, 16)
        assert 2 * ring.D * (bt + 1) * br * 4 <= 48 * 1024
        # up to 64 rows over GR(2^e, D <= 4), its thin kernel: floor(64 / D)
        # whole t a block, 32 n columns a warp column's nn, 32 rows of r a
        # stage; the tile kernel's otherwise
        for t in (1, 4, 16, 48, 63, 64, 65):
            tile = pick_blocks(ring, t, 70, 9, route="simt")
            if d_thin(ring) and t <= 64:
                assert tile[0] == min(t, 64 // ring.D) and tile[1] % 32 == 0 and tile[2] == 32
            else:
                assert tile == kernel_tile(ring)
        d0, d1 = tower_shape(ring)
        assert d0 * d1 == ring.D
    assert not kernel_supported(make_ring(2, 32, (21,)))  # one level, D = 21
    # the (3, 7) tower of batch_ep_rmfe at n = 8 over Z32: beyond the
    # reference's envelope, taken by the port's simt kernel (one 16x16 tile)
    assert kernel_supported(make_ring(2, 32, (3, 7)))
    assert not j_kernel_supported(jmake(2, 32, (3, 7)))
    assert kernel_tile(make_ring(2, 32, (3, 7))) == (16, 16, 16)
