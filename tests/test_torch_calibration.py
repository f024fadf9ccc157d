"""repro_torch.cdmm.calibrate held against repro.cdmm.calibrate: the same
rows fit to equal payloads (both fit in plain Python floats in the same
order, so equality is exact), equal timelines give equal rows, plan
rankings are the reference's with calibration off, with one given
CalibrationSet and under time_to_R's calibrated tie-break, and the
reference's JAX/CPU ``benchmarks/calibration.json`` is never card data."""
import json
from pathlib import Path

import numpy as np
import pytest

import repro.cdmm as J
import repro.obs as jobs
import repro_torch.cdmm as P
import repro_torch.obs as pobs
from repro.cdmm import calibrate as jcal
from repro.core.galois import make_ring as jmake
from repro_torch.cdmm import calibrate as pcal
from repro_torch.core.galois import make_ring as tmake
from repro_torch.settings import PORT_NOOPS

REF_CALIBRATION = Path(__file__).resolve().parents[1] / "benchmarks" / "calibration.json"
H100 = "cuda|NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def no_ambient_calibration(monkeypatch):
    """Tests pin their calibration; no file may leak into plan() here."""
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    for mod in (jcal, pcal):
        mod.invalidate_calibration_cache()
    yield
    for mod in (jcal, pcal):
        mod.invalidate_calibration_cache()


def _rows(seed: int, n: int = 60):
    """Timed rows of every stage and two backends, plus rows fit_rows must
    skip (untimed, unknown stage, featureless, zero feature)."""
    rng = np.random.default_rng(seed)
    stages = list(pcal.STAGE_FEATURES.items())
    rows = []
    for i in range(n):
        stage, (feature, _) = stages[i % len(stages)]
        x = float(rng.integers(1, 10**9))
        backend = ("local", "elastic", "pool")[int(rng.integers(0, 3))]
        rows.append({"name": f"r{i}_{stage}", "us": float(x * rng.uniform(1e-6, 1e-3)),
                     "derived": {feature: x, "backend": backend}})
    rows += [{"name": "u_encode", "us": 0.0, "derived": {"encode_ops": 5.0}},
             {"name": "v_setup", "us": 9.0, "derived": {"encode_ops": 5.0}},
             {"name": "w_decode", "us": 9.0, "derived": {}},
             {"name": "z_worker", "us": 9.0, "derived": {"worker_ops": 0.0}}]
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_rows_payload_equals_reference(seed):
    rows = _rows(seed)
    want = jcal.fit_rows(rows).to_payload()
    got = pcal.fit_rows(rows, device="cpu").to_payload()
    assert want["device"] == "cpu"  # the reference's jax.default_backend() here
    assert got == want
    # and both read each other's files
    assert pcal.CalibrationSet.from_payload(want).to_payload() == want


def _spans(pkg, trace_id):
    Span = pkg.Span
    spec = [("encode", "pool", 0.0, 0.004), ("send", "pool", 0.004, 0.010),
            ("encode", "pool", 0.010, 0.013), ("compute", "worker", 0.011, 0.020),
            ("compute", "worker", 0.012, 0.031), ("recv", "pool", 0.031, 0.033),
            ("wait_R", "pool", 0.013, 0.031), ("decode", "pool", 0.033, 0.036),
            ("gather", "shard_map", 0.02, 0.03)]
    return pkg.Timeline(trace_id, [Span(trace_id=trace_id, name=n, component=c, t_start=a,
                                        t_end=b, tags={}) for n, c, a, b in spec])


@pytest.mark.parametrize("backend", ["pool", "local", "shard_map"])
def test_rows_from_timeline_equal_reference(backend):
    jspec = J.ProblemSpec(64, 64, 64, n=2, ring=jmake(2, 32, ()), N=8)
    tspec = P.ProblemSpec(64, 64, 64, n=2, ring=tmake(2, 32, ()), N=8)
    jcost = J.plan(jspec, calibration=False).best.costs
    tcost = P.plan(tspec, calibration=False).best.costs
    assert vars(tcost) == vars(jcost)
    want = jcal.rows_from_timeline(_spans(jobs, "t1"), jcost, backend=backend)
    got = pcal.rows_from_timeline(_spans(pobs, "t1"), tcost, backend=backend)
    assert got == want and {r["name"].rsplit("_", 1)[-1] for r in got} == {
        "encode", "worker", "comm", "decode"}
    assert pcal.fit_rows(got, device="cpu").to_payload() == jcal.fit_rows(want).to_payload()


def _ranking(p):
    return [(c.scheme, c.u, c.v, c.w, c.n, c.costs.R) for c in p.candidates]


def _sets(payload):
    return jcal.CalibrationSet.from_payload(payload), pcal.CalibrationSet.from_payload(payload)


FULL = {"version": 1, "device": None, "backends": {
    "local": {"coef": {"encode": 2.0, "compute": 1.0, "decode": 1.5, "comm": 0.25}},
    "elastic": {"coef": {"encode": 9.0, "compute": 0.5, "decode": 3.0, "comm": 0.0}}}}
SPECS = [(32, 32, 32, 4, 16), (64, 64, 64, 2, 8), (64, 64, 64, 1, 8)]


@pytest.mark.parametrize("t,r,s,n,N", SPECS)
@pytest.mark.parametrize("objective", ["latency", "amortized", "time_to_R", "upload"])
def test_plan_rankings_equal_reference(t, r, s, n, N, objective):
    jspec = J.ProblemSpec(t, r, s, n=n, ring=jmake(2, 32, ()), N=N)
    tspec = P.ProblemSpec(t, r, s, n=n, ring=tmake(2, 32, ()), N=N)
    jset, pset = _sets(FULL)
    for kw in ({"calibration": False}, {"calibration": jset, "backend": "local"},
               {"calibration": jset, "backend": "elastic"}, {"calibration": jset, "backend": "pool"}):
        pkw = dict(kw, calibration=pset) if kw["calibration"] is not False else kw
        jp, tp = J.plan(jspec, objective, **kw), P.plan(tspec, objective, **pkw)
        assert _ranking(tp) == _ranking(jp), kw
        if objective != "time_to_R":  # its latency draws are not the reference's bits
            assert [c.score for c in tp.candidates] == [c.score for c in jp.candidates]
    # REPRO_CALIBRATION=off (the fixture) is the analytic ranking
    assert _ranking(P.plan(tspec, objective)) == _ranking(J.plan(jspec, objective))


def test_time_to_R_calibrated_tiebreak_equals_reference():
    from math import log1p

    from repro_torch.cdmm.planner import expected_time_to_R

    jspec = J.ProblemSpec(16, 16, 16, n=2, ring=jmake(2, 32, ()), N=8)
    tspec = P.ProblemSpec(16, 16, 16, n=2, ring=tmake(2, 32, ()), N=8)
    payload = {"version": 1, "backends": {"local": {"coef": {"decode": 1000.0}}}}
    jset, pset = _sets(payload)
    tp = P.plan(tspec, "time_to_R", calibration=pset)
    assert _ranking(tp) == _ranking(J.plan(jspec, "time_to_R", calibration=jset))
    for c in tp.candidates:
        assert c.score == expected_time_to_R(c.costs.N, c.costs.R) + 1e-6 * log1p(
            c.costs.decode_ops * 1000.0)
    # a calibration that flips latency's winner flips the port's too
    enc = {"version": 1, "backends": {"local": {"coef": {"encode": 1.0}}}}
    comp = {"version": 1, "backends": {"local": {"coef": {"compute": 1.0}}}}
    big = P.ProblemSpec(32, 32, 32, n=4, ring=tmake(2, 32, ()), N=16)
    best = [P.plan(big, calibration=_sets(x)[1]).best.scheme for x in (enc, comp)]
    assert best[0] in ("gcsa", "gcsa_general") and best[1] == "batch_ep_rmfe"


def test_reference_calibration_is_never_card_data(monkeypatch):
    """benchmarks/calibration.json holds the reference's JAX/CPU fit: on the
    card's device kind it does not match, so an auto-load falls back."""
    ref = pcal.load_calibration(REF_CALIBRATION, cache=False)
    assert ref is not None and ref.device == "cpu"
    assert not ref.matches_device(H100) and ref.matches_device("cpu")
    assert pcal.DEFAULT_CALIBRATION_PATH != jcal.DEFAULT_CALIBRATION_PATH
    spec = P.ProblemSpec(16, 16, 16, n=2, ring=tmake(2, 32, ()), N=8)
    monkeypatch.setenv("REPRO_CALIBRATION", str(REF_CALIBRATION))
    monkeypatch.setattr(pcal, "device_kind", lambda device=None: H100)
    analytic = [c.score for c in P.plan(spec, calibration=False).candidates]
    assert [c.score for c in P.plan(spec).candidates] == analytic
    # on the device kind it was fitted on it would apply (all four terms)
    monkeypatch.setattr(pcal, "device_kind", lambda device=None: "cpu")
    pcal.invalidate_calibration_cache()
    assert [c.score for c in P.plan(spec).candidates] != analytic


def test_autoload_needs_every_term_and_reads_the_setting(tmp_path, monkeypatch):
    spec = P.ProblemSpec(16, 16, 16, n=2, ring=tmake(2, 32, ()), N=8)
    analytic = [c.score for c in P.plan(spec, calibration=False).candidates]
    partial = tmp_path / "partial.json"
    pcal.save_calibration(pcal.CalibrationSet.from_payload(
        {"version": 1, "device": "cpu", "backends": {"local": {"coef": {"encode": 123.0}}}}),
        partial)
    monkeypatch.setenv("REPRO_CALIBRATION", str(partial))
    assert pcal.load_calibration() is not None
    assert [c.score for c in P.plan(spec).candidates] == analytic
    for off in ("off", "0", "none", ""):
        monkeypatch.setenv("REPRO_CALIBRATION", off)
        assert pcal.load_calibration(cache=False) is None
    assert "calibration" not in PORT_NOOPS
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "backends": {"local": {"coef": {"quantum": 1.0}}}}))
    assert pcal.load_calibration(bad, cache=False) is None
    assert pcal.load_calibration(tmp_path / "missing.json", cache=False) is None


def test_measure_rows_fits_on_the_cpu():
    """The port's own rows: traced local and elastic requests at a tiny
    size, fitted (a CPU fit, never written as card data)."""
    rows = pcal.measure_rows(points=(("batch_ep_rmfe", (), 2, (16, 32)), ("ep", (3,), 1, (16, 32))),
                             runs=1, device="cpu")
    backends = {r["derived"]["backend"] for r in rows}
    stages = {r["name"].rsplit("_", 1)[-1] for r in rows}
    assert backends == {"local", "elastic"} and stages == {"encode", "worker", "decode"}
    cal = pcal.fit_rows(rows, device="cpu")
    assert cal.device == "cpu" and set(cal.backends) == {"local", "elastic"}
    assert all(v > 0 for c in cal.backends.values() for v in c.coef.values())


def test_cli_fits_a_rows_file(tmp_path):
    rows = _rows(5)
    src, out = tmp_path / "rows.json", tmp_path / "calibration.json"
    src.write_text(json.dumps(rows))
    assert pcal.main(["--bench", str(src), "--out", str(out), "--device", "cpu"]) == 0
    got = pcal.load_calibration(out, cache=False).to_payload()
    assert got == jcal.fit_rows(rows).to_payload()
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    assert pcal.main(["--bench", str(empty), "--out", str(out), "--device", "cpu"]) == 1
