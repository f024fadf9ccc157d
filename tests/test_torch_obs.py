"""repro_torch's jax-free telemetry core (settings, stats, obs.trace,
obs.metrics, obs.export, obs.health) held against repro's.

The pool-free cases of tests/test_obs.py and tests/test_metrics.py, each
run once per package (``pkg`` is parametrized over ``repro`` and
``repro_torch``), then cross-package checks: the same recordings give equal
snapshots and expositions, and ``describe()`` prints the same text, so one
environment configures both packages and their reports can be diffed.
"""
import importlib
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PACKAGES = ("repro", "repro_torch")


def _load(name: str) -> SimpleNamespace:
    mods = {m: importlib.import_module(f"{name}.{m}") for m in ("settings", "stats")}
    for m in ("trace", "metrics", "export", "health"):
        mods[m] = importlib.import_module(f"{name}.obs.{m}")
    return SimpleNamespace(name=name, obs=importlib.import_module(f"{name}.obs"), **mods)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """One package's telemetry modules; tracing off and a clean ring buffer
    before and after every test."""
    p = _load(request.param)
    p.obs.set_enabled(None)
    p.obs.tracer().clear()
    yield p
    p.obs.set_enabled(None)
    p.obs.tracer().clear()


# --------------------------------------------------------------------------
# span model (tests/test_obs.py)
# --------------------------------------------------------------------------


def test_span_and_timeline_json_roundtrip(pkg):
    Span, Timeline = pkg.trace.Span, pkg.trace.Timeline
    s = Span("t-1", "compute", "worker", 10.0, 10.5, {"wid": 3, "ok": True})
    assert s.duration_s == pytest.approx(0.5)
    assert Span.from_json(json.loads(json.dumps(s.to_json()))) == s
    tl = Timeline("t-1", [s])
    back = Timeline.from_json(json.loads(json.dumps(tl.to_json())))
    assert back.trace_id == "t-1" and back.spans == [s]
    assert tl.wall_s == pytest.approx(0.5)
    assert tl.by_component("worker") == [s]
    assert tl.by_component("pool") == []


def test_trace_ids_are_process_unique(pkg):
    ids = {pkg.obs.new_trace_id("x") for _ in range(100)}
    assert len(ids) == 100
    assert all(i.startswith("x-") for i in ids)


def test_now_is_monotone_and_epoch_aligned(pkg):
    a = pkg.obs.now()
    b = pkg.obs.now()
    assert b >= a
    assert abs(a - time.time()) < 1.0


def test_tracer_ring_buffer_bounded_and_filtered(pkg):
    tr = pkg.trace.Tracer(capacity=4)
    ctx_a = pkg.trace.TraceContext.new("a")
    ctx_b = pkg.trace.TraceContext.new("b")
    for i in range(6):
        ctx = ctx_a if i % 2 == 0 else ctx_b
        tr.add(ctx, f"s{i}", "pool", float(i), float(i) + 0.1)
    assert len(tr) == 4  # oldest two evicted
    got = tr.spans(ctx_a.trace_id)
    assert all(s.trace_id == ctx_a.trace_id for s in got)
    merged = tr.timeline(ctx_a.trace_id, ctx_b.trace_id)
    assert len(merged.spans) == 4
    starts = [s.t_start for s in merged.spans]
    assert starts == sorted(starts)


def test_tracer_add_none_ctx_is_noop(pkg):
    tr = pkg.trace.Tracer(capacity=8)
    assert tr.add(None, "x", "pool", 0.0, 1.0) is None
    assert len(tr) == 0


def test_span_contextmanager_nesting_sets_parent_tag(pkg):
    tr = pkg.trace.Tracer(capacity=8)
    ctx = pkg.trace.TraceContext.new("t")
    with tr.span(ctx, "outer", "pool"):
        with tr.span(ctx, "inner", "pool") as tags:
            tags["extra"] = 7
    spans = {s.name: s for s in tr.spans(ctx.trace_id)}
    assert spans["inner"].tags["parent"] == "outer"
    assert spans["inner"].tags["extra"] == 7
    assert "parent" not in spans["outer"].tags
    assert spans["outer"].t_start <= spans["inner"].t_start
    assert spans["inner"].t_end <= spans["outer"].t_end
    assert ctx.stack == []


def test_enablement_gates_context_creation(pkg):
    pkg.obs.set_enabled(False)
    assert pkg.obs.maybe_context("t") is None
    pkg.obs.set_enabled(True)
    ctx = pkg.obs.maybe_context("t", request_id=5)
    assert ctx is not None and ctx.request_id == 5
    pkg.obs.set_enabled(None)  # fall back to the (unset) env setting
    assert pkg.obs.maybe_context("t") is None


def test_wire_roundtrip_restamps_trace_id_and_tags(pkg):
    spans = [pkg.trace.Span("ignored", "compute", "worker", 1.0, 2.0, {"pid": 42})]
    wire = pkg.obs.spans_to_wire(spans)
    assert "trace_id" not in wire[0]
    back = pkg.obs.spans_from_wire(wire, "t-9", wid=3, share=1)
    assert back[0].trace_id == "t-9"
    assert back[0].tags == {"pid": 42, "wid": 3, "share": 1}
    assert back[0].t_start == 1.0 and back[0].t_end == 2.0


# --------------------------------------------------------------------------
# exporters (tests/test_obs.py)
# --------------------------------------------------------------------------


def _sample_timeline(pkg):
    Span = pkg.trace.Span
    return pkg.trace.Timeline("t-1", [
        Span("t-1", "encode", "pool", 0.0, 0.1, {"share": 0}),
        Span("t-1", "send", "pool", 0.1, 0.2, {"wid": 0, "share": 0}),
        Span("t-1", "compute", "worker", 0.2, 0.6, {"wid": 0}),
        Span("t-1", "compute", "worker", 0.25, 0.7, {"wid": 1}),
        Span("t-1", "decode", "pool", 0.7, 0.8, {}),
    ])


def test_chrome_trace_export_structure(pkg):
    doc = json.loads(pkg.obs.to_chrome_trace(_sample_timeline(pkg)))
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == 5
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] > 0
    names = [e for e in events if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in names)
    assert len({e["tid"] for e in xs if e["name"] == "compute"}) == 2


def test_prometheus_export_counters_hist_gauges(pkg):
    snap = pkg.stats.namespaced("pool", {
        "requests": 3,
        "wall_ms_hist": {"<=1": 1, "<=5": 2, "inf": 3},
        "wall_ms_p50": 2.0,
        "wall_ms_p99": 5.0,
        "transport": "pack",
    })
    text = pkg.obs.to_prometheus(snap)
    assert "# HELP repro_pool_requests" in text
    assert "# TYPE repro_pool_requests counter" in text
    assert "repro_pool_requests 3" in text
    assert 'le="1"' in text and 'le="+Inf"' in text
    assert "# TYPE repro_pool_wall_ms histogram" in text
    assert "repro_pool_wall_ms_bucket" in text
    assert "repro_pool_wall_ms_count 6" in text
    assert "repro_pool_wall_ms_p50 2.0" in text
    assert "transport" not in text
    pkg.obs.parse_prometheus(text)


def test_validate_timeline_accepts_good_rejects_bad(pkg):
    good = _sample_timeline(pkg).to_json()
    validate = pkg.obs.validate_timeline
    assert validate(good, min_workers=2, require_components=("pool", "worker")) == []
    assert validate({"trace_id": "t", "spans": []})
    backwards = {"trace_id": "t", "spans": [
        {"trace_id": "t", "name": "x", "component": "pool",
         "t_start": 2.0, "t_end": 1.0, "tags": {}},
    ]}
    assert any("ends before" in p for p in validate(backwards))
    assert any("worker" in p for p in validate(good, min_workers=3))
    assert any("serve" in p for p in validate(good, require_components=("serve",)))


# --------------------------------------------------------------------------
# settings (tests/test_obs.py, tests/test_metrics.py)
# --------------------------------------------------------------------------


def test_settings_defaults_and_parsing(pkg):
    settings = pkg.settings
    assert settings.get("trace", env={}) is False
    assert settings.get_bool("trace", env={"REPRO_TRACE": "yes"}) is True
    assert settings.get_bool("trace", env={"REPRO_TRACE": "0"}) is False
    assert settings.get_int("trace_buffer", env={}) == 8192
    assert settings.get_int("trace_buffer", env={"REPRO_TRACE_BUFFER": "16"}) == 16
    assert settings.get("calibration", env={}) is None


def test_settings_legacy_fallback_warns_once(pkg):
    settings = pkg.settings
    settings._WARNED.discard("REPRO_POOL_WORKERS")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert settings.get_int("dist_workers", env={"REPRO_POOL_WORKERS": "5"}) == 5
        assert settings.get_int("dist_workers", env={"REPRO_POOL_WORKERS": "5"}) == 5
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1
    assert "REPRO_POOL_WORKERS" in str(deps[0].message)
    assert settings.get_int("dist_workers", env={
        "REPRO_POOL_WORKERS": "5", "REPRO_DIST_WORKERS": "7",
    }) == 7


def test_settings_describe_lists_every_knob(pkg):
    text = pkg.settings.describe()
    for s in pkg.settings.SETTINGS.values():
        assert s.env in text
    assert "REPRO_POOL_WORKERS" in text


def test_settings_cli_lists_telemetry_knobs(pkg):
    env = {**os.environ, "PYTHONPATH": str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, "-m", f"{pkg.name}.settings"],
        capture_output=True, text=True, env=env, check=True, timeout=60,
    ).stdout
    for knob in ("REPRO_OBS_HTTP_PORT", "REPRO_HEDGE_FACTOR",
                 "REPRO_HEALTH_EWMA", "REPRO_OBS_RETENTION"):
        assert knob in out, f"{knob} missing from settings listing"


# --------------------------------------------------------------------------
# unified stats schema (tests/test_obs.py)
# --------------------------------------------------------------------------


def test_namespaced_prefixes_and_aliases(pkg):
    snap = pkg.stats.namespaced("serve", {"submitted": 3, "wait_ms_p50": 1.0})
    assert snap["serve_submitted"] == 3
    pkg.settings._WARNED.discard("stats:submitted")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert snap["submitted"] == 3
        assert snap["submitted"] == 3
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1
    assert "submitted" in snap and "serve_submitted" in snap
    assert snap.get("nope", 9) == 9
    with pytest.raises(KeyError):
        snap["serve_nope"]


def test_namespaced_is_idempotent(pkg):
    once = pkg.stats.namespaced("pool", {"requests": 1})
    twice = pkg.stats.namespaced("pool", once)
    assert dict(twice) == {"pool_requests": 1}


def test_merge_snapshots_preserves_aliases(pkg):
    merged = pkg.stats.merge_snapshots(
        pkg.stats.namespaced("serve", {"submitted": 2}),
        pkg.stats.namespaced("pool", {"requests": 1}),
    )
    assert isinstance(merged, pkg.stats.StatsSnapshot)
    assert merged["serve_submitted"] == 2 and merged["pool_requests"] == 1
    assert merged["requests"] == 1


# --------------------------------------------------------------------------
# instruments (tests/test_metrics.py)
# --------------------------------------------------------------------------


def test_counter_accumulates_and_keeps_ints(pkg):
    c = pkg.metrics.Counter("requests")
    for _ in range(3):
        c.inc()
    c.inc(2)
    assert c.value == 5 and isinstance(c.value, int)
    c.inc(0.5)
    assert c.value == 5.5


def test_gauge_plain_and_labeled_snapshots(pkg):
    Gauge = pkg.metrics.Gauge
    g = Gauge("mean_fill")
    g.set(3.5)
    assert g.snapshot_items() == {"mean_fill": 3.5}
    h = Gauge("worker_health", label="wid")
    h.set(1.0, key=0)
    h.set(0.25, key=3)
    assert h.snapshot_items() == {"worker_health_by_wid": {"0": 1.0, "3": 0.25}}
    h.clear_labels(keep=[3])
    assert h.snapshot_items() == {"worker_health_by_wid": {"3": 0.25}}
    with pytest.raises(ValueError):
        g.set(1.0, key=7)


def test_series_retention_capacity_quantile_and_clear(pkg):
    Series = pkg.metrics.Series
    s = Series("rtt", retention_s=5.0)
    now = time.monotonic()
    s.add(1.0, t=now - 10.0)
    s.add(2.0, t=now)
    assert s.values() == [2.0]
    small = Series("rtt", retention_s=1e6, capacity=4)
    for v in range(6):
        small.add(float(v))
    assert len(small) == 4 and small.values() == [2.0, 3.0, 4.0, 5.0]
    assert small.quantile(0.0) == 2.0
    assert small.quantile(0.95) == 5.0
    small.clear()
    assert len(small) == 0 and small.quantile(0.5) is None


def _recorded_registry(pkg):
    reg = pkg.metrics.MetricsRegistry("pool")
    reg.counter("requests", doc="requests accepted").inc(4)
    reg.gauge("oddness", doc="an unsuffixed gauge").set(4.2)
    reg.gauge("worker_health", label="wid").set(0.5, key=1)
    for v in (0.3, 2.0, 7.5, 120.0, 5000.0):
        reg.histogram("wall_ms").observe(v)
    series = reg.series("share_ms")
    for v in range(10):
        series.add(float(v))
    return reg


def test_registry_snapshot_prefixes_types_docs_and_extras(pkg):
    reg = _recorded_registry(pkg)
    assert reg.counter("requests") is reg.counter("requests")
    snap = reg.snapshot(extra={"derived": 7})
    assert snap["pool_requests"] == 4
    assert snap["pool_derived"] == 7
    assert snap["pool_worker_health_by_wid"] == {"1": 0.5}
    assert snap["pool_share_ms_window_count"] == 10
    assert snap["pool_share_ms_window_p50"] == 5.0
    assert snap._types["pool_requests"] == "counter"
    assert snap._types["pool_oddness"] == "gauge"
    assert "requests accepted" in snap._docs["pool_requests"]
    text = pkg.obs.to_prometheus(snap)
    assert "# TYPE repro_pool_oddness gauge" in text
    assert "# HELP repro_pool_requests requests accepted" in text
    pkg.obs.parse_prometheus(text)


def test_prometheus_label_values_escape_and_roundtrip(pkg):
    weird = 'we"ird\\wid\nx'
    text = pkg.obs.to_prometheus({"pool_worker_health_by_wid": {weird: 0.5}})
    fams = pkg.obs.parse_prometheus(text)
    ((_, labels, value),) = fams["repro_pool_worker_health"]["samples"]
    assert labels["wid"] == weird and value == 0.5


def test_prometheus_collision_guard_keeps_first_key(pkg):
    text = pkg.obs.to_prometheus({"wall.ms": 1, "wall_ms": 2})
    assert text.count("# TYPE repro_wall_ms ") == 1
    assert "collision" in text
    fams = pkg.obs.parse_prometheus(text)
    assert [s[2] for s in fams["repro_wall_ms"]["samples"]] == [1.0]


def test_prometheus_histograms_are_cumulative(pkg):
    snap = {"pool_wall_ms_hist": {"<=1": 1, "<=5": 2, "inf": 3}, "pool_wall_ms_sum": 12.5}
    fam = pkg.obs.parse_prometheus(pkg.obs.to_prometheus(snap))["repro_pool_wall_ms"]
    assert fam["type"] == "histogram"
    buckets = {labels["le"]: v for n, labels, v in fam["samples"] if n.endswith("_bucket")}
    assert buckets == {"1": 1.0, "5": 3.0, "+Inf": 6.0}
    by_name = {n: v for n, labels, v in fam["samples"] if not labels}
    assert by_name["repro_pool_wall_ms_sum"] == 12.5
    assert by_name["repro_pool_wall_ms_count"] == 6.0


@pytest.mark.parametrize("bad", [
    'dup 1\ndup 2\n',
    '# TYPE h histogram\nh_bucket{le="1"} 1\nh_count 1\n',
    '# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 3\nh_count 4\n',
    'metric{l="unterminated} 1\n',
    'metric nope\n',
], ids=["duplicate", "no_inf", "not_cumulative", "count_drift", "bad_label", "bad_value"])
def test_parse_prometheus_rejects_malformed(pkg, bad):
    with pytest.raises(ValueError):
        pkg.obs.parse_prometheus(bad)


# --------------------------------------------------------------------------
# health scoring + hedge deadline (tests/test_metrics.py)
# --------------------------------------------------------------------------


def test_health_scores_normalize_rtt_against_pool_median(pkg):
    ht = pkg.health.HealthTracker()
    for _ in range(5):
        ht.record_share(0, 10.0)
        ht.record_share(1, 100.0)
    s = ht.scores()
    assert s[0] == 1.0
    assert s[1] == pytest.approx(55.0 / 100.0)
    assert s[1] > 0 and s[1] > pkg.health.DISPATCH_THRESHOLD


def test_health_heartbeat_jitter_lowers_score(pkg):
    ht = pkg.health.HealthTracker(alpha=0.5)
    t = 100.0
    for k in range(12):
        ht.record_heartbeat(0, t=t + 0.5 * k)
    stutter = 100.0
    for k in range(12):
        stutter += 0.1 if k % 2 else 0.9
        ht.record_heartbeat(1, t=stutter)
    s = ht.scores()
    assert s[0] == 1.0
    assert s[1] < s[0]


def test_health_reset_scores_keeps_share_window(pkg):
    ht = pkg.health.HealthTracker()
    for _ in range(10):
        ht.record_share(0, 10.0)
    assert ht.scores()
    ht.reset_scores()
    assert ht.scores() == {}
    assert ht.score(0) == 1.0
    assert len(ht.share_ms) == 10


def test_hedge_deadline_gating_and_floor(pkg):
    ht = pkg.health.HealthTracker(min_hedge_samples=8)
    assert ht.hedge_deadline_ms(2.0) is None
    for _ in range(7):
        ht.record_share(0, 10.0)
    assert ht.hedge_deadline_ms(2.0) is None
    ht.record_share(0, 10.0)
    time.sleep(0.06)  # past the deadline quantile's staleness TTL
    assert ht.hedge_deadline_ms(0.0) is None
    assert ht.hedge_deadline_ms(2.0) == pytest.approx(20.0)
    ht.clear_window()
    assert ht.hedge_deadline_ms(2.0) is None
    for _ in range(8):
        ht.record_share(0, 1e-4)
    time.sleep(0.06)
    assert ht.hedge_deadline_ms(2.0) == 1.0


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------


def test_describe_and_knobs_equal_across_packages():
    ref, port = _load("repro"), _load("repro_torch")
    assert port.settings.describe() == ref.settings.describe()
    assert port.settings.SETTINGS.keys() == ref.settings.SETTINGS.keys()
    for name, s in ref.settings.SETTINGS.items():
        assert vars(port.settings.SETTINGS[name]) == vars(s)
    env = {"REPRO_TRACE": "on", "REPRO_TRACE_BUFFER": "32", "REPRO_HEDGE_FACTOR": "1.5"}
    for name in ref.settings.SETTINGS:
        assert port.settings.get(name, env=env) == ref.settings.get(name, env=env)
    # the port reads the tracing, pool, HTTP-plane, hedging and calibration
    # knobs; the traced-decode-check and conformance knobs are listed no-ops
    assert port.settings.PORT_NOOPS == {"debug_solve", "conformance_inproc"}
    assert port.settings.PORT_NOOPS < set(ref.settings.SETTINGS)


def test_snapshots_and_expositions_equal_across_packages():
    ref, port = _load("repro"), _load("repro_torch")
    snaps = [_recorded_registry(p).snapshot(extra={"derived": 7}) for p in (ref, port)]
    assert dict(snaps[1]) == dict(snaps[0])
    assert snaps[1]._types == snaps[0]._types and snaps[1]._docs == snaps[0]._docs
    assert port.obs.to_prometheus(snaps[1]) == ref.obs.to_prometheus(snaps[0])
    extra = [p.stats.namespaced("serve", {"submitted": 2, "wall_ms_hist": {"<=1": 1, "inf": 1}})
             for p in (ref, port)]
    merged = [p.stats.merge_snapshots(s, e) for p, s, e in zip((ref, port), snaps, extra)]
    assert dict(merged[1]) == dict(merged[0])
    tl = [_sample_timeline(p) for p in (ref, port)]
    assert port.obs.to_json(tl[1]) == ref.obs.to_json(tl[0])
    assert port.obs.to_chrome_trace(tl[1]) == ref.obs.to_chrome_trace(tl[0])
