"""repro_torch.core.secure held against repro.core.secure (JAX on the CPU),
bit for bit, through the explicit-mask entry points: the same numpy masks go
into both packages (the port draws its own masks from an integer key with a
torch.Generator, which cannot reproduce jax.random's bits).  Then the
port's keyed encode, its mask draws, exhaustive T-privacy on a tiny ring,
and the secure families through plan -> coded_matmul."""
import itertools
from collections import Counter
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import galois as jg
from repro.core import secure as js
import repro_torch.cdmm as P
from repro_torch.core import galois as tg
from repro_torch.core import secure as ts

CPU = "cpu"
# dead workers 1 and 4: the first R = 5 live workers (0, 2, 3, 5, 6) are no prefix
MASK = [True, False, True, True, False, True, True, True]


def _t(x, ring):
    return tg.from_numpy(np.asarray(x), ring, CPU)


def _n(x):
    return tg.to_numpy(x)


def _check_against_reference(jc, tc, jr, tr, A, B, live):
    """Masked encodes, worker products and the any-R decode of the two codes
    on the same inputs and masks, bit for bit."""
    rng = np.random.default_rng(23)
    tb, rb, sb = A.shape[0] // jc.u, A.shape[1] // jc.w, B.shape[1] // jc.v
    Z = np.asarray(jr.random(rng, (jc.T, tb, rb)))
    W = np.asarray(jr.random(rng, (jc.T, rb, sb)))
    idx = jnp.asarray(live, dtype=jnp.int32)

    def ref(A, B, Z, W):
        FA, GB = jc.encode_a_with_masks(A, Z), jc.encode_b_with_masks(B, W)
        H = jc.worker_compute(FA, GB)
        return FA, GB, H, jc.decode(jnp.take(H, idx, axis=0), idx)

    FA, GB, H, C = (np.asarray(x) for x in jax.jit(ref)(A, B, Z, W))
    tFA = tc.encode_a_with_masks(_t(A, tr), _t(Z, tr))
    tGB = tc.encode_b_with_masks(_t(B, tr), _t(W, tr))
    np.testing.assert_array_equal(_n(tFA), FA)
    np.testing.assert_array_equal(_n(tGB), GB)
    tH = tc.worker_compute(tFA, tGB)
    np.testing.assert_array_equal(_n(tH), H)
    ti = torch.tensor(live)
    np.testing.assert_array_equal(_n(tc.decode(tH[ti], ti)), C)
    return C


@pytest.mark.parametrize("cfg", [((2, 32, (4,)), 8, 1, 2, 1, 1), ((2, 16, (4,)), 12, 2, 1, 2, 2),
                                 ((3, 2, (2,)), 8, 1, 1, 1, 2)], ids=str)
def test_secure_ep_code_matches_reference(cfg):
    ring_args, N, u, v, w, T = cfg
    jr, tr = jg.make_ring(*ring_args), tg.make_ring(*ring_args)
    jc = js.SecureEPCode(jr, N, u, v, w, T)
    tc = ts.SecureEPCode(tr, N, u, v, w, T, device=CPU)
    assert (tc.R, tc.exp_f, tc.exp_g, tc.mask_exp) == (jc.R, jc.exp_f, jc.exp_g, jc.mask_exp)
    np.testing.assert_array_equal(_n(tc.points), jc.points_np)
    np.testing.assert_array_equal(_n(tc.Vf), np.asarray(jc.Vf))
    np.testing.assert_array_equal(_n(tc.Vg), np.asarray(jc.Vg))
    rng = np.random.default_rng(3)
    A, B = jr.random(rng, (4, 4)), jr.random(rng, (4, 6))
    live = list(np.random.default_rng(N).permutation(N)[: jc.R])
    C = _check_against_reference(jc, tc, jr, tr, A, B, live)
    np.testing.assert_array_equal(C, np.asarray(jr.matmul(A, B)))


def test_secure_batch_rmfe_matches_reference():
    jbase, tbase = jg.make_ring(2, 32, ()), tg.make_ring(2, 32, ())
    jS = js.SecureBatchEPRMFE(jbase, 2, 8, 1, 2, 1, 1)
    tS = ts.SecureBatchEPRMFE(tbase, 2, 8, 1, 2, 1, 1, device=CPU)
    assert tS.ext == tg.make_ring(2, 32, (4,)) and tS.R == jS.R == 5
    rng = np.random.default_rng(4)
    As, Bs = jbase.random(rng, (2, 4, 4)), jbase.random(rng, (2, 4, 4))
    A, B = np.asarray(jS.pack(As)), np.asarray(jS.pack(Bs))
    np.testing.assert_array_equal(_n(tS.pack(_t(As, tbase))), A)
    C = _check_against_reference(jS.code, tS.code, jS.ext, tS.ext, A, B, [7, 0, 3, 5, 2])
    Cs = _n(tS.unpack(_t(C, tS.ext)))
    np.testing.assert_array_equal(Cs, np.asarray(jS.unpack(jnp.asarray(C))))
    for i in range(2):
        np.testing.assert_array_equal(Cs[i], np.asarray(jbase.matmul(As[i], Bs[i])))
    assert astuple(tS.costs(64, 64, 64)) == astuple(jS.costs(64, 64, 64))
    for N in (3, 8, 16):
        got, want = ts.smallest_secure_ext(tbase, N), js.smallest_secure_ext(jbase, N)
        assert (got.p, got.e, got.degrees) == (want.p, want.e, want.degrees)


def test_keyed_encode_master_worker_and_missing_key():
    """One key, the same masks on master and worker; another key, other
    shares and the same product; no key, a ValueError as in the reference."""
    Z = tg.make_ring(2, 32, ())
    S = ts.SecureEP(Z, 8, 1, 2, 1, 1, device=CPU)
    code = S.code
    rng = np.random.default_rng(6)
    A, B = Z.random(rng, (6, 4), device=CPU), Z.random(rng, (4, 6), device=CPU)
    eA, eB = S.embed(A), S.embed(B)
    FA, GB = code.encode_a(eA, key=5), code.encode_b(eB, key=5)
    for i in (0, 3, 7):
        assert torch.equal(code.encode_a_at(eA, i, key=5), FA[i])
        assert torch.equal(code.encode_b_at(eB, i, key=5), GB[i])
    assert torch.equal(code.encode_a(eA, key=5), FA)
    assert not torch.equal(code.encode_a(eA, key=6), FA)
    assert not torch.equal(code.encode_b(eB, key=6), GB)
    want = Z.matmul(A, B)
    live = torch.tensor([6, 1, 4, 2, 0])
    for key in (5, 6, 2**70 + 3):
        assert torch.equal(S.run(A, B, key, live), want)
    for fn in (lambda: code.encode_a(eA), lambda: code.encode_b_at(eB, 2),
               lambda: code.encode_a_at(eA, 2, key=None)):
        with pytest.raises(ValueError, match="requires a key"):
            fn()
    with pytest.raises(ValueError, match="non-negative"):
        code.encode_a(eA, key=-1)


def test_random_torch_draws():
    """Full-range words without an out-of-range cast (the top bit is set in
    about half of them), e-bit masking, general-q draws in [0, q), the same
    key the same words, and the two sides' keys apart."""
    Z = tg.make_ring(2, 32, ())
    x = Z.random_torch(1, (1 << 16,), CPU)
    assert torch.equal(x, Z.random_torch(1, (1 << 16,), CPU))
    assert not torch.equal(x, Z.random_torch(2, (1 << 16,), CPU))
    top = (tg.to_numpy(x) >> 31).mean()
    assert 0.49 < top < 0.51
    R16 = tg.make_ring(2, 16, (3,))
    y = tg.to_numpy(R16.random_torch(3, (4096,), CPU))
    assert y.shape == (4096, 3) and y.max() < 1 << 16 and (y >> 15).mean() > 0.45
    R9 = tg.make_ring(3, 2, (2,))
    z = R9.random_torch(3, (4096,), CPU)
    assert z.dtype == torch.int64 and 0 <= int(z.min()) and int(z.max()) == 8
    assert len({tg.fold_in(7, 0), tg.fold_in(7, 1), tg.fold_in(8, 0), 7}) == 4


def _all_elements(ring):
    for coeffs in itertools.product(range(ring.q), repeat=ring.D):
        yield np.array(coeffs, dtype=np.uint32)


def test_exhaustive_privacy_t1():
    """The tiny ring of tests/test_secure.py:59, GR(2^2, 2), T = 1, N = 3:
    over every mask, any one worker's share is uniform and independent of
    the input, and any two workers' joint shares are not."""
    ring = tg.make_ring(2, 2, (2,))
    code = ts.SecureEPCode(ring, N=3, u=1, v=1, w=1, T=1, device=CPU)
    inputs = [np.zeros((1, 1, 2), dtype=np.uint32), np.array([3, 1], dtype=np.uint32).reshape(1, 1, 2)]
    for encode in (code.encode_a_with_masks, code.encode_b_with_masks):
        shares = [[_n(encode(_t(a, ring), _t(z.reshape(1, 1, 1, 2), ring)))
                   for z in _all_elements(ring)] for a in inputs]

        def dist(stack, workers):
            return Counter(tuple(int(v) for i in workers for v in FA[i].ravel()) for FA in stack)

        for i in range(code.N):
            d0, d1 = dist(shares[0], (i,)), dist(shares[1], (i,))
            assert d0 == d1 and len(d0) == ring.q**ring.D and set(d0.values()) == {1}
        for pair in itertools.combinations(range(code.N), 2):
            assert dist(shares[0], pair) != dist(shares[1], pair)


@pytest.mark.parametrize("name", ["ep_secure", "ep_rmfe_secure"])
def test_secure_coded_matmul_decodes_exactly(name):
    Z = tg.make_ring(2, 32, ())
    n = 2 if name == "ep_rmfe_secure" else 1
    spec = P.ProblemSpec(8, 8, 8, n=n, ring=Z, N=8, straggler_budget=2, privacy_t=1)
    p = P.plan(spec, schemes=[name])
    scheme = p.instantiate(device=CPU)
    assert scheme.name == name and scheme.privacy_t == 1 and scheme.R == 5
    rng = np.random.default_rng(8)
    lead = (n,) if n > 1 else ()
    A, B = Z.random(rng, lead + (8, 8), device=CPU), Z.random(rng, lead + (8, 8), device=CPU)
    C = P.coded_matmul(A, B, p, mask=torch.tensor(MASK), key=11, device=CPU)
    want = torch.stack([Z.matmul(A[i], B[i]) for i in range(n)]) if n > 1 else Z.matmul(A, B)
    assert torch.equal(C, want)
    with pytest.raises(ValueError, match="requires a key"):
        P.coded_matmul(A, B, p, mask=torch.tensor(MASK), device=CPU)
    # the dead workers' responses are never read: poison them
    FA, GB = P.encode_all(scheme, A, B, key=11)
    H = scheme.worker_compute(FA, GB)
    H[1], H[4] = 7, 9
    assert torch.equal(P.decode_from(scheme, H, P.live_indices(scheme, torch.tensor(MASK))),
                       want)
