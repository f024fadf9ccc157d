"""repro_torch.cdmm.elastic held against repro.cdmm.elastic (JAX on the
CPU), bit for bit, at the shapes of tests/test_elastic.py.

The same numpy membership traces feed both packages' ``ElasticBackend``:
the decoded product and the ``ElasticStats`` fields (dispatched workers,
the live set decoded from, responders, virtual time to R and to all) must
be equal, and with tracing on so must the spans of one traced call (times
excluded).  Then the edge cases (exactly R, fewer than R, the decode-op
cache, the all-live fast path).  ``ElasticStream`` and ``replan_batch``:
tests/test_torch_elastic_stream.py.
"""
import zlib
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.cdmm as J
import repro.obs as jobs
from repro.core import WorkerTrace as JTrace
from repro.core.galois import make_ring as jmake
import repro_torch.cdmm as P
import repro_torch.obs as pobs
from repro_torch.core import WorkerTrace as PTrace
from repro_torch.core.galois import from_numpy, make_ring as tmake, to_numpy

# one feasible configuration per family, as tests/test_elastic.py's CASES:
# (name, ring spec, batch n, (u, v, w), packing n)
CASES = [
    ("ep", (2, 32, (3,)), 1, (2, 2, 1), 1),
    ("plain", (2, 32, ()), 1, (2, 2, 1), 1),
    ("ep_rmfe1", (2, 32, ()), 1, (2, 2, 1), 2),
    ("ep_rmfe2", (2, 32, ()), 1, (2, 2, 1), 2),
    ("batch_ep_rmfe", (2, 32, ()), 2, (2, 2, 1), 2),
    ("gcsa", (2, 32, ()), 2, (1, 1, 1), 2),
]
N = 8

_schemes: dict = {}


def _pair(case):
    """(reference scheme, port scheme on the CPU), built once per module so
    the reference's jitted worker closures and decode operators are reused."""
    name = case[0]
    if name not in _schemes:
        _, ring_spec, n, (u, v, w), pack = case
        jspec = J.ProblemSpec(8, 8, 8, n=n, ring=jmake(*ring_spec), N=N)
        tspec = P.ProblemSpec(8, 8, 8, n=n, ring=tmake(*ring_spec), N=N)
        _schemes[name] = (J.get_scheme(name).build(jspec, u, v, w, pack),
                          P.get_scheme(name).build(tspec, u, v, w, pack, device="cpu"))
    return _schemes[name]


def _inputs(js, ts, seed):
    rng = np.random.default_rng(seed)
    shape_a, shape_b = (8, 8), (8, 8)
    if js.batch > 1:
        shape_a, shape_b = (js.batch, *shape_a), (js.batch, *shape_b)
    a = np.asarray(js.base.random(rng, shape_a))
    b = np.asarray(js.base.random(rng, shape_b))
    return (jnp.asarray(a), jnp.asarray(b)), (from_numpy(a, ts.base, "cpu"), from_numpy(b, ts.base, "cpu"))


def _trace_arrays(rng, R):
    """Random (join, leave, compute) with at least R responders: late joins,
    leavers halfway through their compute, heavy-tailed slow workers."""
    while True:
        join = rng.uniform(0.0, 2.0, N)
        compute = 1.0 + 3.0 * (rng.uniform(1e-6, 1.0, N) ** -0.5 - 1.0)
        compute = np.where(rng.uniform(size=N) < 0.3, 10.0 * compute, compute)
        leave = np.where(rng.uniform(size=N) < 0.25, join + 0.5 * compute, np.inf)
        if np.isfinite(np.where(join + compute <= leave, 1.0, np.inf)).sum() >= R:
            return join, leave, compute


STAT_FIELDS = ("fast_path", "dispatched", "live_idx", "n_responders", "time_to_R_ms",
               "time_to_all_ms")


def _run_both(js, ts, arrays, inputs, mask=None, **kw):
    """One call of each package's backend on the same trace arrays (None: no
    trace) and mask; returns (port C, reference C, port stats, reference stats)."""
    (ja, jb), (ta, tb) = inputs
    jeb = J.ElasticBackend(trace=None if arrays is None else JTrace(*arrays))
    peb = P.ElasticBackend(trace=None if arrays is None else PTrace(*arrays))
    jC = jeb(js, ja, jb, None if mask is None else jnp.asarray(mask), **kw)
    pC = peb(ts, ta, tb, None if mask is None else torch.from_numpy(mask), **kw)
    return to_numpy(pC), np.asarray(jC), peb, jeb


def _assert_same(pC, jC, peb, jeb):
    np.testing.assert_array_equal(pC, jC)
    for f in STAT_FIELDS:
        assert getattr(peb.last_stats, f) == getattr(jeb.last_stats, f), f


# ------------------------------------------------------------ random traces


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_traced_calls_match_reference(case):
    js, ts = _pair(case)
    inputs = _inputs(js, ts, 11)
    # crc32, not hash(): PYTHONHASHSEED must not change the traces
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    # two traces for the paper's batch code, one for each other family (a
    # reference call that meets a new live set compiles its decode, ~1-3 s)
    for _ in range(2 if case[0] == "batch_ep_rmfe" else 1):
        pC, jC, peb, jeb = _run_both(js, ts, _trace_arrays(rng, js.R), inputs)
        _assert_same(pC, jC, peb, jeb)
        st = peb.last_stats
        assert not st.fast_path and len(st.live_idx) == ts.R
        assert st.time_to_R_ms <= st.time_to_all_ms
    # the direct product, over the port's data ring
    (_, _), (ta, tb) = inputs
    direct = (torch.stack([ts.base.matmul(ta[i], tb[i]) for i in range(ts.batch)])
              if ts.batch > 1 else ts.base.matmul(ta, tb))
    np.testing.assert_array_equal(pC, to_numpy(direct))


# --------------------------------------------------- straggler edge cases


def test_exactly_R_live_decodes():
    js, ts = _pair(CASES[0])
    inputs = _inputs(js, ts, 0)
    live = np.zeros(N, bool)
    live[np.array([1, 3, 4, 6, 7])[: ts.R]] = True
    arrays = tuple(np.asarray(a) for a in (np.zeros(N), np.full(N, np.inf), np.zeros(N)))
    pC, jC, peb, jeb = _run_both(js, ts, arrays, inputs, mask=live)
    _assert_same(pC, jC, peb, jeb)
    assert peb.last_stats.live_idx == tuple(np.flatnonzero(live))


def test_fewer_than_R_live_raises_in_both():
    js, ts = _pair(CASES[0])
    (ja, jb), (ta, tb) = _inputs(js, ts, 0)
    live = np.zeros(N, bool)
    live[: ts.R - 1] = True
    with pytest.raises(J.NotEnoughResponders) as want:
        J.ElasticBackend()(js, ja, jb, mask=jnp.asarray(live))
    with pytest.raises(P.NotEnoughResponders) as got:
        P.ElasticBackend()(ts, ta, tb, mask=torch.from_numpy(live))
    assert str(got.value) == str(want.value)
    with pytest.raises(P.NotEnoughResponders, match=f"needs R={ts.R}"):
        P.decode_responses(ts, {0: ta})


def test_all_live_fast_path_matches_reference():
    js, ts = _pair(CASES[0])
    inputs = _inputs(js, ts, 1)
    pC, jC, peb, jeb = _run_both(js, ts, None, inputs)
    _assert_same(pC, jC, peb, jeb)
    assert peb.last_stats.fast_path and peb.last_stats.live_idx == tuple(range(ts.R))
    # coded_matmul(..., backend="elastic") is the registered entry point
    (_, _), (ta, tb) = inputs
    C = P.coded_matmul(ta, tb, ts, backend="elastic", device="cpu")
    np.testing.assert_array_equal(to_numpy(C), jC)
    # a mask, even all-live, takes the event loop
    pC, jC, peb, jeb = _run_both(js, ts, None, inputs, mask=np.ones(N, bool))
    _assert_same(pC, jC, peb, jeb)
    assert not peb.last_stats.fast_path


def test_decode_op_cache_across_two_live_sets():
    js, ts = _pair(CASES[0])
    inputs = _inputs(js, ts, 2)
    m1, m2 = np.ones(N, bool), np.ones(N, bool)
    m1[[0, 2]] = False
    m2[[1, 5]] = False
    sets = []
    for m in (m1, m2):
        pC, jC, peb, jeb = _run_both(js, ts, None, inputs, mask=m)
        _assert_same(pC, jC, peb, jeb)
        sets.append(peb.last_stats.live_idx)
    assert sets[0] != sets[1]
    cache = ts.__dict__["_decode_ops"]
    assert set(cache) >= set(sets)
    size, op_before = len(cache), cache[sets[0]]
    pC, jC, peb, jeb = _run_both(js, ts, None, inputs, mask=m1)
    assert len(cache) == size and cache[sets[0]] is op_before
    _assert_same(pC, jC, peb, jeb)


def test_use_kernel_argument():
    js, ts = _pair(CASES[0])
    (_, _), (ta, tb) = _inputs(js, ts, 3)
    # ignored on the CPU, as the reference ignores it off the TPU
    for use_kernel in (None, True, False):
        C = P.ElasticBackend(trace=PTrace.all_live(N), use_kernel=use_kernel)(ts, ta, tb)
        assert torch.equal(C, ts.base.matmul(ta, tb))
    # on the card False would pin a plain version: it raises instead
    on_card = SimpleNamespace(name="ep", code=SimpleNamespace(device=torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="use_kernel=False"):
        P.worker_closures(on_card, use_kernel=False)


# ------------------------------------------------------------ tracing spans


def _span_keys(spans):
    keep = ("wid", "share", "R", "responders")
    return Counter(
        (s.name, s.component, tuple(sorted(s.tags)),
         tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(s.tags.items())
               if k in keep))
        for s in spans
    )


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "all_live"])
def test_spans_match_reference(traced):
    js, ts = _pair(CASES[4])  # batch_ep_rmfe
    (ja, jb), (ta, tb) = _inputs(js, ts, 4)
    arrays = (np.zeros(N), np.full(N, np.inf), np.array([1, 50, 1, 40, 1, 1, 1, 1.0]))
    mask = np.array([True, True, False, True, True, False, True, True])
    jeb = J.ElasticBackend(trace=JTrace(*arrays) if traced else None)
    peb = P.ElasticBackend(trace=PTrace(*arrays) if traced else None)
    keys = []
    for mod, eb, call in ((jobs, jeb, lambda: jeb(js, ja, jb, jnp.asarray(mask) if traced else None)),
                          (pobs, peb, lambda: peb(ts, ta, tb, torch.from_numpy(mask) if traced else None))):
        mod.set_enabled(True)
        mod.tracer().clear()
        try:
            call()
            if traced:  # the dead and slow workers' compute spans too
                if hasattr(eb, "drain"):
                    eb.drain()
                else:
                    eb._pool.shutdown(wait=True)
            keys.append(_span_keys(list(mod.tracer()._spans)))
        finally:
            mod.set_enabled(None)
            mod.tracer().clear()
    assert keys[1] == keys[0]
    if traced:
        assert peb.last_stats.live_idx == (0, 4, 6, 7)
        assert sum(n for k, n in keys[1].items() if k[0] == "compute") == N
        assert sum(n for k, n in keys[1].items() if k[0] == "encode") == N


def test_local_backend_spans_match_reference():
    js, ts = _pair(CASES[0])
    (ja, jb), (ta, tb) = _inputs(js, ts, 5)
    keys = []
    # the reference jitted: its spans are host-side, recorded while tracing
    # (eager, its many small ops take ~6 s)
    jlocal = jax.jit(lambda a, b: J.LocalSimBackend()(js, a, b))
    for mod, call in ((jobs, lambda: jlocal(ja, jb)),
                      (pobs, lambda: P.LocalSimBackend()(ts, ta, tb))):
        mod.set_enabled(True)
        mod.tracer().clear()
        try:
            call()
            keys.append(_span_keys(list(mod.tracer()._spans)))
        finally:
            mod.set_enabled(None)
            mod.tracer().clear()
    assert keys[1] == keys[0] and sum(keys[1].values()) == 3
