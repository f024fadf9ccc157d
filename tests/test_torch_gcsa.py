"""repro_torch.core.gcsa held against repro.core.gcsa (JAX on the CPU), bit
for bit: gr_solve, the CSA and general GCSA codes on every GCSA_CASES row of
tests/test_gcsa.py (the odd-p ring included), their guards, the cost model,
and the port's per-live-set decode matrix.

The reference's encodes and direct products run in one jit per case, and its
decode (an unrolled gr_solve, seconds to compile) once, on the CSA point; the
port's decode of every case is compared with the reference's direct product,
which the reference's own decode equals (tests/test_gcsa.py)."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import gcsa as jgc
from repro.core import galois as jg
from repro_torch.core import gcsa as tgc
from repro_torch.core import galois as tg
from repro_torch.core.polyops import DECODE_CACHE_SIZE, s_inverse

CPU = "cpu"

# (ring args, u, v, w, kappa, L, N), as tests/test_gcsa.py:39
GCSA_CASES = [
    ((2, 16, (4,)), 2, 2, 1, 1, 2, 10),
    ((2, 16, (4,)), 1, 1, 2, 2, 2, 8),
    ((2, 16, (4,)), 2, 1, 2, 1, 2, 12),
    ((2, 16, (4,)), 1, 1, 1, 2, 4, 6),
    ((2, 8, (5,)), 2, 2, 2, 1, 2, 18),
    ((3, 2, (3,)), 2, 2, 1, 1, 2, 9),
]


def _t(x, ring):
    return tg.from_numpy(np.asarray(x), ring, CPU)


def _n(x):
    return tg.to_numpy(x)


def _invertible(ring, rng, n):
    """A random (n, n) matrix over the ring that the host inverse accepts."""
    while True:
        M = np.asarray(ring.random(rng, (n, n)))
        try:
            s_inverse(tg.make_ring(ring.p, ring.e, ring.degrees), M.astype(object))
            return M
        except ValueError:
            continue


@pytest.mark.parametrize("ring_args", [(2, 16, (3,)), (3, 2, (2,))], ids=str)
def test_gr_solve_matches_reference(ring_args):
    jr, tr = jg.make_ring(*ring_args), tg.make_ring(*ring_args)
    rng = np.random.default_rng(11)
    M = _invertible(jr, rng, 3)
    Y = np.asarray(jr.random(rng, (3, 2)))
    want = jax.jit(lambda M, Y: jgc.gr_solve(jr, M, Y, check=False))(jnp.asarray(M), Y)
    got = tgc.gr_solve(tr, _t(M, tr), _t(Y, tr))
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    units = np.asarray(jgc.is_unit_mask(jr, jnp.asarray(M)))
    np.testing.assert_array_equal(tgc.is_unit_mask(tr, _t(M, tr)).numpy(), units)


def test_gr_solve_singular_raises():
    """The systems of tests/test_gcsa.py:147: a duplicate column, and an
    all-even pivot column; both raise with the reference's message."""
    ring = tg.make_ring(2, 16, (3,))
    rng = np.random.default_rng(7)
    n = 3
    M = _n(ring.random(rng, (n, n), device=CPU)).copy()
    for i in range(n):
        M[i, i, 0] |= 1
        for j in range(i + 1, n):
            M[i, j] = 0
    M[:, 1] = M[:, 0]  # duplicate column => singular mod p
    Y = ring.random(rng, (n, 2), device=CPU)
    with pytest.raises(ValueError, match="singular system over"):
        tgc.gr_solve(ring, _t(M, ring), Y)
    M2 = np.array(M)
    M2[:, 1] = 0
    M2[1, 1, 0] = 2
    with pytest.raises(ValueError, match="no unit pivot in elimination column 1"):
        tgc.gr_solve(ring, _t(M2, ring), Y)


def test_decode_duplicate_live_set_raises():
    """tests/test_gcsa.py:169: duplicate worker indices raise in the CSA and
    the general decode, before anything is launched."""
    ring = tg.make_ring(2, 16, (4,))
    rng = np.random.default_rng(3)
    csa = tgc.CSACode(ring, L=3, N=8, device=CPU)
    H = csa.worker_compute(csa.encode_a(ring.random(rng, (3, 3, 3), device=CPU)),
                           csa.encode_b(ring.random(rng, (3, 3, 3), device=CPU)))
    bad = torch.tensor([0, 0, 1, 2, 3])
    with pytest.raises(ValueError, match="singular"):
        csa.decode(H[bad], bad)
    gen = tgc.GCSACode(ring, L=2, N=8, u=1, v=1, w=2, kappa=2, device=CPU)  # R = 7
    Hg = gen.worker_compute(gen.encode_a(ring.random(rng, (2, 4, 4), device=CPU)),
                            gen.encode_b(ring.random(rng, (2, 4, 4), device=CPU)))
    badg = torch.tensor([0, 1, 2, 3, 4, 5, 5])
    with pytest.raises(ValueError, match="singular"):
        gen.decode(Hg[badg], badg)
    assert len(csa._decode_mats) == len(gen._decode_mats) == 0


@pytest.mark.parametrize("ringargs,u,v,w,kappa,L,N", GCSA_CASES, ids=str)
def test_gcsa_general_matches_reference(ringargs, u, v, w, kappa, L, N):
    jr, tr = jg.make_ring(*ringargs), tg.make_ring(*ringargs)
    jc = jgc.GCSACode(jr, L=L, N=N, u=u, v=v, w=w, kappa=kappa)
    tc = tgc.GCSACode(tr, L=L, N=N, u=u, v=v, w=w, kappa=kappa, device=CPU)
    assert tc.R == jc.R
    for name in ("Ea", "Eb", "M", "Tinv", "points"):
        np.testing.assert_array_equal(_n(getattr(tc, name)), np.asarray(getattr(jc, name)))
    rng = np.random.default_rng(17)
    As, Bs = jr.random(rng, (L, 4, 4)), jr.random(rng, (L, 4, 4))

    def ref(As, Bs):
        FA, GB = jc.encode_a(As), jc.encode_b(Bs)
        return FA, GB, jc.worker_compute(FA, GB), jax.vmap(jr.matmul)(As, Bs)

    FA, GB, H, direct = (np.asarray(x) for x in jax.jit(ref)(As, Bs))
    tA, tB = _t(As, tr), _t(Bs, tr)
    tFA, tGB = tc.encode_a(tA), tc.encode_b(tB)
    np.testing.assert_array_equal(_n(tFA), FA)
    np.testing.assert_array_equal(_n(tGB), GB)
    tH = tc.worker_compute(tFA, tGB)
    np.testing.assert_array_equal(_n(tH), H)
    # any R of N, not a prefix
    idx = torch.from_numpy(np.random.default_rng(L * N).permutation(N)[: tc.R])
    np.testing.assert_array_equal(_n(tc.decode(tH[idx], idx)), direct)
    for i in (0, N - 1):
        np.testing.assert_array_equal(_n(tc.encode_a_at(tA, i)), FA[i])
        np.testing.assert_array_equal(_n(tc.encode_b_at(tB, i)), GB[i])


def test_csa_decode_and_kappa_n_match_reference():
    """The CSA point: port shares and decode equal the reference's decode on a
    non-prefix live set, and the general code at kappa = n is the CSA code,
    symbol for symbol."""
    jr, tr = jg.make_ring(2, 16, (4,)), tg.make_ring(2, 16, (4,))
    jc = jgc.CSACode(jr, L=3, N=8)
    csa = tgc.CSACode(tr, L=3, N=8, device=CPU)
    gen = tgc.GCSACode(tr, L=3, N=8, kappa=3, device=CPU)
    assert csa.R == gen.R == jc.R == 5
    for name in ("cauchy", "enc_a", "cg_inv", "vand", "points"):
        np.testing.assert_array_equal(_n(getattr(csa, name)), np.asarray(getattr(jc, name)))
    rng = np.random.default_rng(5)
    As, Bs = jr.random(rng, (3, 4, 4)), jr.random(rng, (3, 4, 4))
    live = jnp.asarray([0, 2, 3, 5, 7], dtype=jnp.int32)

    def ref(As, Bs):
        FA, GB = jc.encode_a(As), jc.encode_b(Bs)
        H = jc.worker_compute(FA, GB)
        return FA, GB, jc.decode(jnp.take(H, live, axis=0), live)

    FA, GB, want = (np.asarray(x) for x in jax.jit(ref)(As, Bs))
    tA, tB = _t(As, tr), _t(Bs, tr)
    for code in (csa, gen):
        tFA, tGB = code.encode_a(tA), code.encode_b(tB)
        np.testing.assert_array_equal(_n(tFA), FA)
        np.testing.assert_array_equal(_n(tGB), GB)
        idx = torch.tensor([0, 2, 3, 5, 7])
        H = code.worker_compute(tFA, tGB)
        np.testing.assert_array_equal(_n(code.decode(H[idx], idx)), want)
    for i in range(8):
        np.testing.assert_array_equal(_n(csa.encode_a_at(tA, i)), FA[i])
        np.testing.assert_array_equal(_n(csa.encode_b_at(tB, i)), GB[i])


def test_gcsa_cost_model_matches_reference():
    """Table 1's GCSA points (CSA at kappa = n, per-product poles at kappa = 1,
    an EP inner split) and the kappa guard."""
    for args in [(64, 64, 64, 1, 1, 1, 2, 2, 8, 4.0), (64, 64, 64, 1, 1, 1, 4, 1, 8, 3.0),
                 (96, 48, 32, 2, 2, 1, 4, 2, 16, 2.0), (128, 64, 64, 2, 1, 2, 2, 1, 12, 4.0)]:
        assert astuple(tgc.gcsa_cost_model(*args)) == astuple(jgc.gcsa_cost_model(*args))
    with pytest.raises(ValueError, match="divide"):
        tgc.gcsa_cost_model(8, 8, 8, 1, 1, 1, 4, 3, 8, 1.0)
    with pytest.raises(ValueError, match="divide"):
        tgc.GCSACode(tg.make_ring(2, 16, (4,)), L=4, N=16, kappa=3, device=CPU)
    with pytest.raises(ValueError, match="R="):
        tgc.GCSACode(tg.make_ring(2, 16, (4,)), L=2, N=10, u=2, v=2, w=1, kappa=2, device=CPU)


def test_decode_matrix_is_cached_per_live_set_and_dead_rows_unread():
    """One host-built matrix per live set: reused on a repeat, evicted least
    recently used first; rows of H from dead workers are never read."""
    ring = tg.make_ring(2, 16, (4,))
    code = tgc.GCSACode(ring, L=2, N=8, u=1, v=1, w=2, kappa=2, device=CPU)  # R = 7
    rng = np.random.default_rng(9)
    As, Bs = ring.random(rng, (2, 4, 4), device=CPU), ring.random(rng, (2, 4, 4), device=CPU)
    H = code.worker_compute(code.encode_a(As), code.encode_b(Bs))
    want = torch.stack([ring.matmul(As[g], Bs[g]) for g in range(2)])
    # poison the dead worker's responses: the decode must not see them
    live = [7, 0, 5, 2, 1, 6, 3]
    Hp = H.clone()
    Hp[4] = 12345
    idx = torch.tensor(live)
    assert torch.equal(code.decode(Hp[idx], idx), want)
    W = code._decode_mats.get(tuple(live), lambda: pytest.fail("rebuilt a cached matrix"))
    assert torch.equal(code.decode(Hp[idx], idx), want)
    assert code._decode_mats.get(tuple(live), lambda: None) is W
    # LRU: fill to the bound with other live sets, touching `live` last but one
    cache = code._decode_mats
    assert cache.size == DECODE_CACHE_SIZE
    cache.size = 3
    others = [(0, 1, 2, 3, 4, 5, 6), (1, 2, 3, 4, 5, 6, 7)]
    for other in others:
        o = torch.tensor(other)
        assert torch.equal(code.decode(H[o], o), want)
    assert torch.equal(code.decode(Hp[idx], idx), want)  # `live` is now the newest
    o = torch.tensor((0, 2, 3, 4, 5, 6, 7))
    assert torch.equal(code.decode(H[o], o), want)
    assert len(cache) == 3 and others[0] not in cache
    assert tuple(live) in cache and others[1] in cache
