"""repro_torch.core.straggler and the planner's time_to_R objective held
against repro (JAX on the CPU).

``WorkerTrace`` and ``MembershipEvents`` are numpy code in both packages:
the same arrays and event sequences must give the same answers.  The
samplers cannot match the reference's bits (no threefry), so their
contracts are tested instead, and ``expected_time_to_R`` of both packages
is held to the closed form of the latency model's order statistics.
"""
from dataclasses import astuple
from math import exp, lgamma, sqrt

import numpy as np
import pytest
import torch

import repro.cdmm as J
import repro.core.straggler as JS
from repro.core.galois import make_ring as jmake
import repro_torch.cdmm as P
import repro_torch.core.straggler as PS
from repro_torch.core.galois import make_ring as tmake

INF = np.inf


def _traces():
    """(join, leave, compute) arrays: the elastic cases' shapes, ties, late
    joiners, leavers before and after finishing, and all-dead."""
    rng = np.random.default_rng(5)
    out = [
        (np.zeros(8), np.full(8, INF), np.array([1, 50, 1, 40, 1, 1, 1, 1.0])),
        (np.array([0, 0, 3, 0, 5, 0, 0, 9.0]), np.array([INF, 2, INF, 0.5, INF, INF, 4, INF]),
         np.array([2, 1, 1, 3, 1, 7, 5, 2.0])),
        (np.zeros(4), np.full(4, -1.0), np.ones(4)),
    ]
    for _ in range(3):
        n = int(rng.integers(4, 17))
        join = rng.uniform(0, 2, n)
        compute = 1 + 3 * (rng.uniform(1e-6, 1, n) ** -0.5 - 1)
        leave = np.where(rng.uniform(size=n) < 0.3, join + 0.5 * compute, INF)
        out.append((join, leave, compute))
    return out


@pytest.mark.parametrize("arrays", _traces(), ids=lambda a: f"N{len(a[0])}")
def test_worker_trace_matches_reference(arrays):
    jt, pt = JS.WorkerTrace(*arrays), PS.WorkerTrace(*arrays)
    assert pt.N == jt.N
    np.testing.assert_array_equal(pt.response_ms(), jt.response_ms())
    np.testing.assert_array_equal(pt.mask(), jt.mask())
    for k in range(1, jt.N + 2):
        assert pt.time_to_kth_response(k) == jt.time_to_kth_response(k)
    restrict = np.arange(jt.N) % 3 != 1
    jr, pr = jt.restrict(restrict), pt.restrict(restrict)
    for a, b in zip(astuple(pr), astuple(jr)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pr.response_ms(), jr.response_ms())
    for a, b in zip(astuple(PS.WorkerTrace.all_live(jt.N)), astuple(JS.WorkerTrace.all_live(jt.N))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="one length"):
        PS.WorkerTrace(arrays[0], arrays[1][:-1], arrays[2])


def test_membership_events_match_reference():
    events = [("join", "w0", 10.0), ("join", "w1", 10.002), ("resp", "w0", 3.5),
              ("join", "w2", 10.010), ("leave", "w1", 10.020), ("resp", "w1", 9.0),
              ("resp", "w2", 1.25), ("leave", "w2", 10.030), ("join", "w2", 10.040),
              ("join", "w3", 10.050), ("resp", "ghost", 1.0), ("leave", "ghost", 10.060),
              ("leave", "w0", 10.070), ("leave", "w0", 10.080)]
    jm, pm = JS.MembershipEvents(), PS.MembershipEvents()
    for kind, wid, val in events:
        for m in (jm, pm):
            {"join": m.record_join, "leave": m.record_leave,
             "resp": m.record_response}[kind](wid, val)
        assert pm.live() == jm.live() and pm.seen() == jm.seen()
        for a, b in zip(astuple(pm.trace()), astuple(jm.trace())):
            np.testing.assert_array_equal(a, b)
    assert pm.live() == ("w2", "w3")
    np.testing.assert_array_equal(pm.trace().mask(), jm.trace().mask())


# --------------------------------------------------------------------------
# samplers: contracts (the draws are not the reference's bits)
# --------------------------------------------------------------------------


def test_straggler_latencies_contract():
    for N in (1, 8, 64):
        lat = PS.straggler_latencies(3, N, base_ms=2.0, tail=3.0)
        assert lat.shape == (N,) and lat.dtype == torch.float32
        assert bool((lat >= 2.0).all())  # u <= 1: never faster than base
        assert torch.equal(lat, PS.straggler_latencies(3, N, base_ms=2.0, tail=3.0))
    assert not torch.equal(PS.straggler_latencies(3, 64), PS.straggler_latencies(4, 64))


@pytest.mark.parametrize("fail_prob,min_live", [(0.0, 3), (0.5, 4), (0.95, 6), (1.0, 8)])
def test_simulate_stragglers_contract(fail_prob, min_live):
    for key in range(20):
        mask, enough = PS.simulate_stragglers(key, 8, fail_prob, min_live)
        assert mask.shape == (8,) and mask.dtype == torch.bool and enough.shape == ()
        assert int(mask.sum()) >= min_live
        if not bool(enough):  # the guarantee forces the first min_live alive
            assert bool(mask[:min_live].all())
        again = PS.simulate_stragglers(key, 8, fail_prob, min_live)
        assert torch.equal(again[0], mask) and bool(again[1]) == bool(enough)
    if fail_prob == 0.0:
        assert bool(mask.all()) and bool(enough)
    if fail_prob == 1.0:
        assert int(mask.sum()) == min_live and not bool(enough)


def test_sample_trace_contract():
    for key in range(10):
        tr = PS.sample_trace(key, 12, join_spread_ms=2.0, leave_prob=0.4, slowdown_prob=0.3)
        assert tr.N == 12
        assert ((tr.join_ms >= 0) & (tr.join_ms <= 2.0)).all()
        assert (tr.compute_ms >= 1.0).all()
        leavers = np.isfinite(tr.leave_ms)
        # a leaver leaves halfway through its compute and never responds
        np.testing.assert_allclose(tr.leave_ms[leavers],
                                   tr.join_ms[leavers] + 0.5 * tr.compute_ms[leavers])
        assert not tr.mask()[leavers].any()
        assert tr.mask()[~leavers].all()
        same = PS.sample_trace(key, 12, join_spread_ms=2.0, leave_prob=0.4, slowdown_prob=0.3)
        for a, b in zip(astuple(tr), astuple(same)):
            np.testing.assert_array_equal(a, b)
    quiet = PS.sample_trace(7, 16)
    assert (quiet.join_ms == 0).all() and quiet.mask().all()
    slow = PS.sample_trace(7, 16, slowdown_prob=1.0, slowdown_factor=10.0)
    np.testing.assert_allclose(slow.compute_ms, 10.0 * quiet.compute_ms)


# --------------------------------------------------------------------------
# expected time to R: closed form, and the planner objective
# --------------------------------------------------------------------------


def _beta(a, b):
    return exp(lgamma(a) + lgamma(b) - lgamma(a + b))


def _closed_form(N, R, base=1.0, tail=3.0):
    """Mean and standard deviation of the R-th smallest of N latencies
    base * (1 + tail * (u^-1/2 - 1)): the R-th smallest latency comes from
    the (N-R+1)-th smallest uniform, U ~ Beta(N-R+1, R), and
    E[U^-s] = B(a - s, b) / B(a, b)."""
    a, b = N - R + 1, R
    m_half = _beta(a - 0.5, b) / _beta(a, b)
    m_one = _beta(a - 1, b) / _beta(a, b)  # finite for R <= N - 1
    return base * (1 + tail * (m_half - 1)), base * tail * sqrt(m_one - m_half ** 2)


# tolerance: 4 standard errors of the 256-trial Monte-Carlo mean
TRIALS, Z_TOL = 256, 4.0


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("module", [J, P], ids=["repro", "repro_torch"])
def test_expected_time_to_R_matches_closed_form(module, N):
    prev = 0.0
    for R in range(2, N):
        mean, sd = _closed_form(N, R)
        got = module.expected_time_to_R(N, R)
        assert abs(got - mean) <= Z_TOL * sd / sqrt(TRIALS), (N, R, got, mean)
        assert got > prev  # monotone in R: what makes the rankings agree
        prev = got


def _ranking(p):
    """A plan's order, without scores (the latency draws differ)."""
    return [(c.scheme, c.u, c.v, c.w, c.n, astuple(c.costs)) for c in p.candidates]


# the two specs of tests/test_elastic.py's time_to_R tests, then a sweep
# over batch, ring, worker count and budgets
TIME_TO_R_SPECS = [
    (16, 16, 16, 1, (2, 32, ()), 8, 0, 0),
    (16, 16, 16, 1, (2, 32, ()), 8, 2, 0),
    (64, 64, 64, 2, (2, 32, ()), 8, 2, 0),
    (32, 64, 16, 1, (2, 32, (3,)), 8, 1, 0),
    (32, 32, 32, 4, (2, 16, ()), 16, 4, 0),
    (48, 48, 48, 3, (2, 32, ()), 16, 3, 0),
    (64, 64, 64, 1, (2, 32, ()), 8, 1, 1),
    (64, 32, 64, 2, (2, 32, ()), 12, 2, 1),
]


@pytest.mark.parametrize("spec", TIME_TO_R_SPECS, ids=str)
def test_time_to_R_rankings_match_reference(spec):
    t, r, s, n, ring_spec, N, budget, privacy_t = spec
    jspec, tspec = (M.ProblemSpec(t, r, s, n=n, ring=make(*ring_spec), N=N,
                                  straggler_budget=budget, privacy_t=privacy_t)
                    for M, make in ((J, jmake), (P, tmake)))
    want = J.plan(jspec, objective="time_to_R", calibration=False)
    got = P.plan(tspec, objective="time_to_R")
    assert _ranking(got) == _ranking(want)
    scores = [c.score for c in got.candidates]
    assert scores == sorted(scores)
    assert got.best.costs.R == min(c.costs.R for c in got.candidates)
