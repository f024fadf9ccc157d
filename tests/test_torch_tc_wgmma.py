"""The ``tc`` route's arithmetic as the wgmma kernel runs it, on the CPU.

The kernel (``csrc/gr_matmul_tc.cu``) chains every byte-limb product of a
conv plane c and shift s into one int32 accumulator over all of r, lets it
wrap mod 2^32, and shift-adds once at the end.  Its plain version,
``ref.gr_matmul_limbs_ref``, does the same with int64 matmuls; here it is
held bit for bit against repro's ``gr_matmul_planar`` (the Pallas kernel in
interpret mode, at one small shape) and repro's ``Ring.matmul`` (XLA) for
D = 1..4 and e in {8, 16, 31, 32} (L = 1, 2, 4, 4), and against the limb
planes zero-padded as the pre-pass pads them.  The kernel itself runs only
on the card (tests/test_torch_card.py, chip_smoke.py phase 2).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro.kernels.gr_matmul import gr_matmul_planar as jax_planar
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import gr_matmul_limbs_ref, gr_matmul_ref
from repro_torch.kernels.gr_matmul import TC_CONFIGS, tc_padded
from repro_torch.kernels.ref import _fold, limb_planes_ref, n_limbs

# single-level towers the tc kernel is instantiated for, D = 1..4
DEGREES = [(d,) if d > 1 else () for d, _ in sorted(TC_CONFIGS)]
SHAPE = (9, 70, 11)  # t, r, s: r past one 64-deep stage


def _draw(rng, e, D, *dims):
    return rng.integers(0, 2**e, size=dims + (D,), dtype=np.uint64).astype(np.uint32)


@lru_cache(maxsize=None)
def _reference(deg):
    """Inputs over GR(2^32, deg) and repro's XLA product of them (one
    compile per tower)."""
    jr = jmake(2, 32, deg)
    rng = np.random.default_rng(7 + len(deg) + sum(deg))
    t, r, s = SHAPE
    a, b = _draw(rng, 32, jr.D, t, r), _draw(rng, 32, jr.D, r, s)
    return jr, a, b, np.asarray(jr.matmul(a, b))


@pytest.mark.parametrize("e", [8, 16, 31, 32])
@pytest.mark.parametrize("deg", DEGREES, ids=str)
def test_limbs_ref_matches_xla_reference(deg, e):
    # GR(2^e, deg)'s tables are GR(2^32, deg)'s mod 2^e, so the product of
    # the reduced inputs is repro's GR(2^32) product reduced
    _, a, b, ref = _reference(deg)
    mask = np.uint32(2**e - 1)
    ring = make_ring(2, e, deg)
    assert n_limbs(ring) == -(-e // 8)
    A, B = from_numpy(a & mask, ring, "cpu"), from_numpy(b & mask, ring, "cpu")
    np.testing.assert_array_equal(to_numpy(gr_matmul_limbs_ref(A, B, ring)), ref & mask)


@pytest.mark.parametrize("deg", [(3,), (4,)], ids=str)
def test_limbs_ref_matches_the_pallas_kernel(deg):
    # repro's TPU kernel in interpret mode on the planar layout, one small
    # shape per main-path tower
    jr = jmake(2, 32, deg)
    rng = np.random.default_rng(11)
    a, b = _draw(rng, 32, jr.D, 16, 40), _draw(rng, 32, jr.D, 40, 8)
    ref = np.asarray(jax_planar(np.moveaxis(a, -1, 0), np.moveaxis(b, -1, 0), jr, interpret=True))
    ring = make_ring(2, 32, deg)
    got = gr_matmul_limbs_ref(from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu"), ring)
    np.testing.assert_array_equal(to_numpy(got), np.moveaxis(ref, 0, -1))


@pytest.mark.parametrize("deg", DEGREES, ids=str)
def test_padded_planes_and_wrapping_accumulators(deg):
    """The kernel's data flow in plain PyTorch: limb planes zero-padded to
    ``tc_padded`` (the tiles past them read as zeros too), one int32
    accumulator per (c, s) that wraps (to_i32 after every product), the
    shift-add and the fold.  Equals the plain ring matmul."""
    ring = make_ring(2, 32, deg)
    rng = np.random.default_rng(5)
    t, r, s = 70, 130, 33
    A = ring.random(rng, (2, t, r), device="cpu")
    B = ring.random(rng, (2, r, s), device="cpu")
    Tp, Rp, Sp = tc_padded(t, r, s)
    L = n_limbs(ring)
    A8 = limb_planes_ref(A, ring, Tp, Rp).to(torch.int64)
    B8 = limb_planes_ref(B, ring, Sp, Rp, transpose=True).to(torch.int64)
    wrap = lambda x: ((x + 2**31) % 2**32) - 2**31  # int32 two's complement
    acc = {}
    for i in range(ring.D):
        for j in range(ring.D):
            c = int(ring.CONVPOS[i, j])
            for x in range(L):
                for y in range(L - x):
                    p = A8[:, i, x] @ B8[:, j, y].transpose(-1, -2)
                    acc[c, x + y] = wrap(acc.get((c, x + y), 0) + p)
    conv = [torch.zeros((2, Tp, Sp), dtype=torch.int64) for _ in range(ring.K)]
    for (c, sh), v in acc.items():
        conv[c] = (conv[c] + (v << (8 * sh))) & 0xFFFFFFFF
    got = _fold(conv, ring).movedim(-3, -1)
    assert not got[:, t:].any() and not got[:, :, s:].any()  # padding stays zero
    assert torch.equal(got[:, :t, :s], gr_matmul_ref(A, B, ring))
