"""repro_torch.core codes (EP, RMFE, Batch-EP_RMFE, EP_RMFE-I/II, worker
selection) held against repro (JAX on the CPU), bit for bit.

Setup tables, phi/psi and packing are compared with the reference's own;
end-to-end runs are compared with the reference's direct ring product
(the reference pipelines equal it too, see tests/test_codes.py), which
keeps the JAX compile time of this file small.  tests/test_torch_cdmm.py
compares whole coded_matmul runs with the reference's."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import batch_rmfe as jb
from repro.core import ep_codes as je
from repro.core import galois as jg
from repro.core import rmfe as jrm
from repro.core import single_rmfe as js
from repro.core import straggler as jst
from repro_torch.core import batch_rmfe as tb
from repro_torch.core import ep_codes as te
from repro_torch.core import galois as tg
from repro_torch.core import rmfe as trm
from repro_torch.core import single_rmfe as ts
from repro_torch.core import straggler as tst

CPU = "cpu"


def _t(x, ring):
    return tg.from_numpy(np.asarray(x), ring, CPU)


def _n(x):
    return tg.to_numpy(x)


@pytest.mark.parametrize("cfg", [((2, 32, (3,)), 8, 2, 2, 1), ((2, 32, (4,)), 16, 2, 2, 2),
                                 ((3, 2, (2,)), 9, 1, 2, 2)], ids=str)
def test_ep_tables_match(cfg):
    spec, N, u, v, w = cfg
    jc = je.EPCode(jg.make_ring(*spec), N, u, v, w)
    tc = te.EPCode(tg.make_ring(*spec), N, u, v, w, device=CPU)
    np.testing.assert_array_equal(_n(tc.points), np.asarray(jc.points))
    np.testing.assert_array_equal(_n(tc.Vf), np.asarray(jc.Vf))
    np.testing.assert_array_equal(_n(tc.Vg), np.asarray(jc.Vg))
    np.testing.assert_array_equal(tc.exp_c, jc.exp_c)
    assert (tc.R, tc.exp_f, tc.exp_g) == (jc.R, jc.exp_f, jc.exp_g)
    assert astuple(tc.costs(64, 64, 64, tc.ring)) == astuple(
        je.ep_cost_model(64, 64, 64, u, v, w, N, 1.0))


def test_ep_run_any_R_matches():
    jr, tr = jg.make_ring(2, 32, (3,)), tg.make_ring(2, 32, (3,))
    tc = te.EPCode(tr, 8, 2, 2, 1, device=CPU)
    rng = np.random.default_rng(1)
    A, B = jr.random(rng, (8, 6)), jr.random(rng, (6, 4))
    idx = torch.tensor([6, 1, 3, 7])
    np.testing.assert_array_equal(_n(tc.run(_t(A, tr), _t(B, tr), idx)),
                                  np.asarray(jr.matmul(A, B)))
    # the per-worker encode equals row i of the all-worker encode
    FA = _n(tc.encode_a(_t(A, tr)))
    np.testing.assert_array_equal(_n(tc.encode_a_at(_t(A, tr), 5)), FA[5])
    GB = _n(tc.encode_b(_t(B, tr)))
    np.testing.assert_array_equal(_n(tc.encode_b_at(_t(B, tr), 2)), GB[2])


@pytest.mark.parametrize("cfg", [((2, 32, ()), 2, 0), ((2, 32, ()), 2, 3), ((2, 32, (3,)), 4, 0),
                                 ((3, 2, ()), 3, 0)], ids=str)
def test_basic_rmfe_tables_and_maps_match(cfg):
    spec, n, min_m = cfg
    jbase, tbase = jg.make_ring(*spec), tg.make_ring(*spec)
    jR = jrm.BasicRMFE(jbase, n, min_m=min_m)
    tR = trm.BasicRMFE(tbase, n, min_m=min_m, device=CPU)
    assert tR.ext == tg.make_ring(jR.ext.p, jR.ext.e, jR.ext.degrees) and tR.m == jR.m
    np.testing.assert_array_equal(_n(tR.M_phi), np.asarray(jR.M_phi))
    np.testing.assert_array_equal(_n(tR.V_psi), np.asarray(jR.V_psi))
    rng = np.random.default_rng(2)
    x = jbase.random(rng, (3, n))
    np.testing.assert_array_equal(_n(tR.phi(_t(x, tbase))), np.asarray(jR.phi(x)))
    g = jR.ext.random(rng, (3,))
    np.testing.assert_array_equal(_n(tR.psi(_t(g, tR.ext))), np.asarray(jR.psi(g)))


def test_concat_rmfe_matches():
    jbase, tbase = jg.make_ring(2, 32, ()), tg.make_ring(2, 32, ())
    jR, tR = jrm.build_rmfe(jbase, 3), trm.build_rmfe(tbase, 3, device=CPU)
    assert isinstance(tR, trm.ConcatRMFE) and tR.n == jR.n == 4 and tR.m == jR.m
    x = jbase.random(np.random.default_rng(3), (2, 4))
    px = tR.phi(_t(x, tbase))
    np.testing.assert_array_equal(_n(px), np.asarray(jR.phi(x)))
    # psi(phi(x) * phi(y)) = x * y
    y = jbase.random(np.random.default_rng(4), (2, 4))
    prod = tR.psi(tR.ext.mul(px, tR.phi(_t(y, tbase))))
    np.testing.assert_array_equal(_n(prod), np.asarray(jbase.mul(x, y)))


def test_batch_ep_rmfe_matches():
    jbase, tbase = jg.make_ring(2, 32, ()), tg.make_ring(2, 32, ())
    jS, tS = jb.BatchEPRMFE(jbase, 2, 8, 2, 2, 1), tb.BatchEPRMFE(tbase, 2, 8, 2, 2, 1, device=CPU)
    assert tS.ext == tg.make_ring(2, 32, (3,)) and tS.R == jS.R == 4
    rng = np.random.default_rng(5)
    As, Bs = jbase.random(rng, (2, 4, 6)), jbase.random(rng, (2, 6, 8))
    np.testing.assert_array_equal(_n(tS.pack(_t(As, tbase))), np.asarray(jS.pack(As)))
    got = _n(tS.run(_t(As, tbase), _t(Bs, tbase), torch.tensor([0, 2, 5, 7])))
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(jbase.matmul(As[i], Bs[i])))
    assert astuple(tS.costs(64, 64, 64)) == astuple(jS.costs(64, 64, 64))


@pytest.mark.parametrize("split_a", [False, True])
def test_ep_rmfe_ii_matches(split_a):
    jbase, tbase = jg.make_ring(2, 32, ()), tg.make_ring(2, 32, ())
    jS = js.EPRMFE_II(jbase, 2, 8, 1, 1, 1, split_a=split_a)
    tS = ts.EPRMFE_II(tbase, 2, 8, 1, 1, 1, split_a=split_a, device=CPU)
    assert tS.top == tg.make_ring(jS.top.p, jS.top.e, jS.top.degrees)
    A, B = jbase.random(np.random.default_rng(6), (4, 4)), jbase.random(np.random.default_rng(7), (4, 4))
    got = _n(tS.run(_t(A, tbase), _t(B, tbase)))
    np.testing.assert_array_equal(got, np.asarray(jbase.matmul(A, B)))
    np.testing.assert_array_equal(_n(tS.pack_b(_t(B, tbase))), np.asarray(jS.pack_b(B)))
    assert astuple(tS.costs(64, 64, 64)) == astuple(jS.costs(64, 64, 64))


def test_ep_rmfe_i_and_plain_match():
    jbase, tbase = jg.make_ring(2, 32, ()), tg.make_ring(2, 32, ())
    A, B = jbase.random(np.random.default_rng(8), (4, 4)), jbase.random(np.random.default_rng(9), (4, 4))
    direct = np.asarray(jbase.matmul(A, B))
    t1 = ts.EPRMFE_I(tbase, 2, 8, 2, 1, 1, device=CPU)
    np.testing.assert_array_equal(_n(t1.run(_t(A, tbase), _t(B, tbase))), direct)
    assert astuple(t1.costs(64, 64, 64)) == astuple(
        js.EPRMFE_I(jbase, 2, 8, 2, 1, 1).costs(64, 64, 64))
    tp = te.PlainCDMM(tbase, 8, 2, 2, 1, device=CPU)
    assert tp.ext == tg.make_ring(2, 32, (3,))
    np.testing.assert_array_equal(_n(tp.run(_t(A, tbase), _t(B, tbase))), direct)
    assert astuple(tp.costs(64, 64, 64)) == astuple(je.PlainCDMM(jbase, 8, 2, 2, 1).costs(64, 64, 64))


def test_embedding_ext_and_cost_model_match():
    for spec, npts in [((2, 32, ()), 8), ((2, 32, ()), 17), ((2, 32, (3,)), 9), ((3, 2, ()), 10)]:
        got = te.smallest_embedding_ext(tg.make_ring(*spec), npts)
        want = je.smallest_embedding_ext(jg.make_ring(*spec), npts)
        assert (got.p, got.e, got.degrees) == (want.p, want.e, want.degrees)
    for args in [(64, 64, 64, 2, 2, 1, 8, 3.0), (96, 32, 48, 3, 2, 2, 16, 4.0)]:
        assert astuple(te.ep_cost_model(*args, batch=2)) == astuple(je.ep_cost_model(*args, batch=2))
        assert astuple(te.ep_cost_model(*args, privacy_t=1)) == astuple(
            je.ep_cost_model(*args, privacy_t=1))
    assert te.secure_recovery_threshold(2, 2, 1, 2) == je.secure_recovery_threshold(2, 2, 1, 2)


def test_select_workers_matches():
    for mask in ([True] * 8, [False, True, True, False, True, True, True, False],
                 [True, False, False, True, True, False, False, True]):
        for R in (1, 3, 4):
            want = np.asarray(jst.select_workers(jnp.asarray(mask), R))
            got = tst.select_workers(torch.tensor(mask), R).numpy()
            np.testing.assert_array_equal(got, want)
