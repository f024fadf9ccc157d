"""repro_torch's ElasticStream and replan_batch held against repro's (JAX
on the CPU), bit for bit, on the cases of tests/test_elastic.py: the stream
re-chunks a batch of 8x8x8 products over Z_2^32 as the pool shrinks, picks
the reference's schemes, and decodes the direct products."""
import numpy as np
import pytest

import jax.numpy as jnp

import repro.cdmm as J
import repro.runtime.elastic as JR
from repro.core.galois import make_ring as jmake
import repro_torch.cdmm as P
import repro_torch.runtime.elastic as PR
from repro_torch.core.galois import from_numpy, make_ring as tmake, to_numpy


@pytest.mark.parametrize("module", [JR, PR], ids=["repro", "repro_torch"])
def test_replan_batch(module):
    assert module.replan_batch(256, 16) == 16
    assert module.replan_batch(256, 15) == 18
    assert module.replan_batch(7, 2) == 4
    for g, live in [(1, 1), (5, 3), (100, 7), (8, 8), (9, 24)]:
        assert module.replan_batch(g, live) == JR.replan_batch(g, live)
    with pytest.raises(ValueError, match="at least one survivor"):
        module.replan_batch(256, 0)
    with pytest.raises(ValueError, match="at least one survivor"):
        module.replan_batch(256, -3)
    with pytest.raises(ValueError, match="global_batch"):
        module.replan_batch(0, 4)


def test_stream_rescales_like_reference(monkeypatch):
    # the port reads no calibration: hold it against the reference's
    # analytic planner (its committed calibration would pick other schemes)
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    Jz, Tz = jmake(2, 32, ()), tmake(2, 32, ())
    rng = np.random.default_rng(4)
    As, Bs = np.asarray(Jz.random(rng, (6, 8, 8))), np.asarray(Jz.random(rng, (6, 8, 8)))
    jst = J.ElasticStream(8, 8, 8, Jz, group_size=8)
    pst = P.ElasticStream(8, 8, 8, Tz, group_size=8, device="cpu")
    tA, tB = from_numpy(As, Tz, "cpu"), from_numpy(Bs, Tz, "cpu")
    expect = np.stack([to_numpy(Tz.matmul(tA[i], tB[i])) for i in range(6)])
    replans = []
    for live in (16, 9):
        jC = np.asarray(jst.step(jnp.asarray(As), jnp.asarray(Bs), live=live))
        pC = to_numpy(pst.step(tA, tB, live=live))
        np.testing.assert_array_equal(pC, jC)
        np.testing.assert_array_equal(pC, expect)
        assert pst.last_replan == jst.last_replan
        per = pst.last_replan[1]
        jsch, tsch = jst._schemes[per], pst._schemes[per]
        assert (tsch.name, tsch.partition, tsch.batch) == (jsch.name, jsch.partition, jsch.batch)
        replans.append(pst.last_replan)
    assert replans == [(2, 3), (1, 6)]
    with pytest.raises(P.NotEnoughResponders):
        pst.step(tA, tB, live=7)
