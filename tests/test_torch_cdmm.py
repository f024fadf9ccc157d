"""repro_torch.cdmm (plan -> coded_matmul) held against repro.cdmm (JAX on
the CPU): the seven non-secure families end to end under a non-prefix
straggler mask, bit for bit, and the planner's rankings over all nine
families (the secure two end to end: tests/test_torch_secure.py)."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.cdmm as J
from repro.core.galois import make_ring as jmake
import repro_torch.cdmm as P
from repro_torch.core.galois import make_ring as tmake
from repro_torch.core.galois import to_numpy

FIVE = ["ep", "plain", "ep_rmfe1", "ep_rmfe2", "batch_ep_rmfe"]
BATCHED = {"batch_ep_rmfe", "gcsa", "gcsa_general"}
NINE = FIVE + ["gcsa", "gcsa_general", "ep_secure", "ep_rmfe_secure"]
# dead workers 1 and 4: the first R = 4 live workers (0, 2, 3, 5) are no prefix
MASK = [True, False, True, True, False, True, True, True]


def _specs(t, r, s, n, ring_spec, budget=2, privacy_t=0):
    return tuple(M.ProblemSpec(t, r, s, n=n, ring=make(*ring_spec), N=8, straggler_budget=budget,
                               privacy_t=privacy_t)
                 for M, make in ((J, jmake), (P, tmake)))


def _ranking(p):
    return [(c.scheme, c.u, c.v, c.w, c.n, c.score, astuple(c.costs)) for c in p.candidates]


@pytest.mark.parametrize("name", FIVE + ["gcsa", "gcsa_general"])
def test_coded_matmul_matches_reference(name):
    ring_spec = (2, 32, (3,)) if name == "ep" else (2, 32, ())
    n = 2 if name in BATCHED else 1
    jspec, tspec = _specs(4, 4, 4, n, ring_spec)
    jp = J.plan(jspec, "latency", schemes=[name], calibration=False)
    tp = P.plan(tspec, "latency", schemes=[name])
    assert _ranking(tp) == _ranking(jp)
    rng = np.random.default_rng(21)
    lead = (n,) if n > 1 else ()
    a, b = jspec.ring.random(rng, lead + (4, 4)), jspec.ring.random(rng, lead + (4, 4))
    # one jit of the reference pipeline compiles faster than its eager ops;
    # the scheme (and the rings it makes) is built outside the trace
    jp.instantiate()
    ref = jax.jit(lambda a, b: J.coded_matmul(a, b, jp, backend="local", mask=jnp.asarray(MASK)))
    want = np.asarray(ref(a, b))
    got = P.coded_matmul(np.asarray(a), np.asarray(b), tp, backend="local",
                         mask=torch.tensor(MASK), device="cpu")
    np.testing.assert_array_equal(to_numpy(got), want)
    scheme = tp.instantiate(device="cpu")
    assert scheme.name == name and scheme.R == jp.instantiate().R
    live = [i for i, alive in enumerate(MASK) if alive][: scheme.R]
    assert P.live_indices(scheme, torch.tensor(MASK)).tolist() == live


@pytest.mark.parametrize("objective", ["threshold", "download", "upload", "latency", "amortized"])
@pytest.mark.parametrize("shape", [(64, 64, 64, 1, (2, 32, ()), 2, 0),
                                   (96, 48, 32, 1, (2, 32, (3,)), 2, 0),
                                   (64, 64, 64, 2, (2, 32, ()), 2, 0),
                                   (32, 32, 32, 4, (2, 16, ()), 2, 0),
                                   (64, 64, 64, 1, (2, 32, ()), 2, 1),
                                   (64, 32, 64, 2, (2, 32, ()), 1, 1),
                                   (32, 32, 32, 4, (2, 16, ()), 3, 2),
                                   (64, 64, 64, 3, (2, 32, ()), 2, 1)],
                         ids=str)
def test_plan_rankings_match(shape, objective):
    """All nine families, batch and privacy_t > 0 specs among them; a spec
    no family serves raises in both packages with the same message."""
    t, r, s, n, ring_spec, budget, privacy_t = shape
    try:
        jspec, tspec = _specs(t, r, s, n, ring_spec, budget, privacy_t)
        want = _ranking(J.plan(jspec, objective, schemes=NINE, calibration=False))
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            _, tspec = _specs(t, r, s, n, ring_spec, budget, privacy_t)
            P.plan(tspec, objective, schemes=NINE)
        assert str(got.value) == str(exc)
        return
    assert _ranking(P.plan(tspec, objective, schemes=NINE)) == want


def test_registry_and_unported_paths():
    assert sorted(P.registered_schemes()) == sorted(NINE)
    assert sorted(P.registered_schemes()) == sorted(J.registered_schemes())
    jspec, tspec = _specs(64, 64, 64, 1, (2, 32, ()))
    # time_to_R is ported now: its ranking is the reference's (its scores
    # differ, the latency draws are not the reference's bits)
    want = [r[:5] + r[6:] for r in _ranking(J.plan(jspec, "time_to_R", calibration=False))]
    assert [r[:5] + r[6:] for r in _ranking(P.plan(tspec, "time_to_R"))] == want
    # privacy_t = 1 is served by a secure family, as in the reference
    jsecure, secure = _specs(64, 64, 64, 1, (2, 32, ()), budget=1, privacy_t=1)
    best = P.plan(secure).best
    assert best.scheme == J.plan(jsecure, calibration=False).best.scheme == "ep_secure"
    assert best.costs.privacy_t >= 1
    # the shard_map backend is ported: one shared instance, which spawns no
    # rank before its first call
    from repro_torch.cdmm.backends import ShardMapBackend

    assert isinstance(P.get_backend("shard_map"), ShardMapBackend)
    assert P.get_backend("shard_map") is P.get_backend("shard_map")
    assert not P.get_backend("shard_map")._pools
    # the pool backend is ported: its name resolves to a PoolBackend, which
    # spawns nothing before its first call
    from repro_torch.dist import PoolBackend

    assert isinstance(P.get_backend("pool"), PoolBackend)
    with pytest.raises(ValueError, match="unknown backend"):
        P.get_backend("no_such_backend")


def test_decode_op_lru_and_any_subset():
    Z = tmake(2, 32, ())
    scheme = P.BatchRMFEAdapter(Z, 2, 8, 2, 2, 1, device="cpu")
    rng = np.random.default_rng(4)
    As, Bs = Z.random(rng, (2, 4, 4), device="cpu"), Z.random(rng, (2, 4, 4), device="cpu")
    FA, GB = P.encode_all(scheme, As, Bs)
    H = scheme.worker_compute(FA, GB)
    want = torch.stack([Z.matmul(As[i], Bs[i]) for i in range(2)])
    for live in [(7, 0, 5, 2), (1, 3, 4, 6)]:
        op = scheme.decode_op(live)
        assert scheme.decode_op(live) is op
        assert torch.equal(op(H[list(live)]), want)
    with pytest.raises(ValueError):
        scheme.decode_op((0, 0, 1, 2))


def test_readme_quickstart_on_the_port():
    """The README quickstart, on the port with device="cpu"."""
    Z32 = tmake(2, 32, ())
    spec = P.ProblemSpec(t=64, r=64, s=64, n=1, ring=Z32, N=8, straggler_budget=2)
    p = P.plan(spec, objective="latency")
    assert "Plan[latency]" in p.summary()
    rng = np.random.default_rng(0)
    A, B = Z32.random(rng, (64, 64), device="cpu"), Z32.random(rng, (64, 64), device="cpu")
    C = P.coded_matmul(A, B, p, backend="local", device="cpu")
    assert torch.equal(C, Z32.matmul(A, B))
    # examples/quickstart.py's batched spec: 4 of 8 workers die
    spec2 = P.ProblemSpec(t=64, r=64, s=64, n=2, ring=Z32, N=8, straggler_budget=4)
    p2 = P.plan(spec2, objective="upload")
    As, Bs = Z32.random(rng, (2, 64, 64), device="cpu"), Z32.random(rng, (2, 64, 64), device="cpu")
    mask = torch.tensor([True, False, False, True, True, False, False, True])
    Cs = P.coded_matmul(As, Bs, p2, mask=mask, device="cpu")
    for i in range(2):
        assert torch.equal(Cs[i], Z32.matmul(As[i], Bs[i]))
