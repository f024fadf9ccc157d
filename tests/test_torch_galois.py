"""repro_torch.core.galois / polyops held against repro (JAX on the CPU).

Same numpy inputs into both packages; the bar is bit equality (every op is
exact ring arithmetic).  The port runs with device="cpu", where its ring
matmul takes the plain PyTorch version.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core import galois as jg
from repro.core import polyops as jp
from repro_torch.core import galois as tg
from repro_torch.core import polyops as tp

# the tests/test_kernels.py rings, the K=45 tower and one odd-p ring
SPECS = [
    (2, 32, ()),
    (2, 32, (3,)),
    (2, 32, (4,)),
    (2, 16, (5,)),
    (2, 8, (2, 3)),
    (2, 32, (3, 5)),
    (3, 2, (2,)),
]


def _pair(spec):
    return jg.make_ring(*spec), tg.make_ring(*spec)


def _t(x, ring):
    return tg.from_numpy(np.asarray(x), ring, "cpu")


def _n(x):
    return tg.to_numpy(x)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_setup_tables_match(spec):
    jr, tr = _pair(spec)
    assert (tr.K, tr.D, tr.conv_shape, tr.moduli) == (jr.K, jr.D, jr.conv_shape, jr.moduli)
    np.testing.assert_array_equal(tr.CONVPOS, jr.CONVPOS)
    np.testing.assert_array_equal(tr.FOLD, jr.FOLD)
    np.testing.assert_array_equal(tr.T, jr.T)
    n = min(jr.p**jr.D, 9)
    np.testing.assert_array_equal(tr.exceptional_points(n), jr.exceptional_points(n))
    assert tr.dtype == (__import__("torch").int32 if tr.p2fast else __import__("torch").int64)


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_mul_matmul_match(spec):
    jr, tr = _pair(spec)
    rng = np.random.default_rng(11)
    a, b = jr.random(rng, (3, 5)), jr.random(rng, (3, 5))
    np.testing.assert_array_equal(_n(tr.mul(_t(a, tr), _t(b, tr))), np.asarray(jr.mul(a, b)))
    A, B = jr.random(rng, (4, 6)), jr.random(rng, (6, 3))
    np.testing.assert_array_equal(_n(tr.matmul(_t(A, tr), _t(B, tr))),
                                  np.asarray(jr.matmul(A, B)))
    # the elementwise ops against exact python-int arithmetic mod q
    ai, bi = np.asarray(a).astype(object), np.asarray(b).astype(object)
    at, bt = _t(a, tr), _t(b, tr)
    for got, want in [(tr.add(at, bt), ai + bi), (tr.sub(at, bt), ai - bi),
                      (tr.neg(at), -ai), (tr.scale(at, 2**32 - 3), ai * (2**32 - 3))]:
        np.testing.assert_array_equal(_n(got), (want % jr.q).astype(np.uint32))


def test_inv_and_pow_match():
    jr, tr = _pair((2, 32, (3,)))
    u = jr.random_units(np.random.default_rng(4), (5,))
    ut = _t(u, tr)
    np.testing.assert_array_equal(_n(tr.inv(ut)), np.asarray(jax.jit(jr.inv)(u)))
    np.testing.assert_array_equal(_n(tr.pow(ut, 5)), np.asarray(jax.jit(lambda x: jr.pow(x, 5))(u)))
    assert np.all(_n(tr.mul(ut, tr.inv(ut))) == np.asarray(jr.ones((5,))))


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_inv_matches_host_mirror(spec):
    """Every ring: the device inverse equals the reference's exact s_inv."""
    jr, tr = _pair(spec)
    u = np.asarray(jr.random_units(np.random.default_rng(8), (3,)))
    got = _n(tr.inv(_t(u, tr)))
    for i in range(3):
        np.testing.assert_array_equal(got[i], jp.as_u32(jr.s_inv(u[i].astype(object))))


def test_random_same_seed_same_elements():
    for spec in SPECS:
        jr, tr = _pair(spec)
        a = jr.random(np.random.default_rng(3), (4, 2))
        b = tr.random(np.random.default_rng(3), (4, 2), device="cpu")
        np.testing.assert_array_equal(_n(b), np.asarray(a))
        ua = jr.random_units(np.random.default_rng(3), (4,))
        ub = tr.random_units(np.random.default_rng(3), (4,), device="cpu")
        np.testing.assert_array_equal(_n(ub), np.asarray(ua))


def test_storage_round_trip_and_wrap():
    import torch

    Z = tg.make_ring(2, 32, ())
    x = np.array([[0, 1, 2**31 - 1, 2**31, 2**32 - 1]], dtype=np.uint32)[..., None]
    t = tg.from_numpy(x, Z, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tg.to_numpy(t), x)
    # 2^31-1 * 3 + 5 * 7 wraps mod 2^32 exactly as uint32 does
    A = tg.from_numpy(np.array([[[2**31 - 1], [5]]], dtype=np.uint32).reshape(1, 2, 1), Z, "cpu")
    B = tg.from_numpy(np.array([[3], [7]], dtype=np.uint32).reshape(2, 1, 1), Z, "cpu")
    assert int(tg.to_numpy(Z.matmul(A, B)).ravel()[0]) == (3 * (2**31 - 1) + 35) % 2**32


def test_embed_and_tower_coeffs_match():
    jb, tb = _pair((2, 32, (3,)))
    je, te = jg.make_ring(2, 32, (3, 4)), tg.make_ring(2, 32, (3, 4))
    x = jb.random(np.random.default_rng(2), (2, 3))
    e = te.embed_base(_t(x, tb), tb)
    np.testing.assert_array_equal(_n(e), np.asarray(je.embed_base(x, jb)))
    np.testing.assert_array_equal(_n(te.tower_coeffs(e, tb)),
                                  np.asarray(je.tower_coeffs(je.embed_base(x, jb), jb)))
    assert te.extend(5) == tg.make_ring(2, 32, (3, 4, 5)) and te.base_ring() == tb


@pytest.mark.parametrize("spec", [(2, 32, (3,)), (2, 16, (5,)), (3, 2, (2,))], ids=str)
def test_polyops_match(spec):
    jr, tr = _pair(spec)
    pts = jr.exceptional_points(4)
    ptt = _t(pts, tr)
    V_host = jp.as_u32(jp.s_vandermonde(jr, pts, 5))
    np.testing.assert_array_equal(jp.as_u32(tp.s_vandermonde(tr, pts, 5)), V_host)
    np.testing.assert_array_equal(_n(tp.vandermonde(tr, ptt, 5)), V_host)
    M_host = jp.as_u32(jp.s_lagrange_coeff_matrix(jr, pts))
    np.testing.assert_array_equal(jp.as_u32(tp.s_lagrange_coeff_matrix(tr, pts)), M_host)
    np.testing.assert_array_equal(_n(tp.lagrange_coeff_matrix(tr, ptt)), M_host)


def test_polyops_device_versions_match():
    """The runtime-point-set versions, against the reference's jnp
    interpolation and its exact host arithmetic."""
    jr, tr = _pair((2, 32, (3,)))
    pts = jr.exceptional_points(4)
    ptt = _t(pts, tr)
    rng = np.random.default_rng(6)
    coeffs, vals = jr.random(rng, (4, 3)), jr.random(rng, (4, 2))
    horner = _n(tp.eval_poly_horner(tr, _t(coeffs, tr), ptt[1]))
    x = pts[1].astype(object)
    for j in range(3):
        want, xk = jr.s_zero(), jr.s_one()
        for k in range(4):
            want = jr.s_add(want, jr.s_mul(np.asarray(coeffs)[k, j].astype(object), xk))
            xk = jr.s_mul(xk, x)
        np.testing.assert_array_equal(horner[j], jp.as_u32(want))
    np.testing.assert_array_equal(
        _n(tp.interpolate_coeffs(tr, ptt, _t(vals, tr))),
        np.asarray(jax.jit(lambda v: jp.interpolate_coeffs(jr, jnp.asarray(pts), v))(vals)),
    )
