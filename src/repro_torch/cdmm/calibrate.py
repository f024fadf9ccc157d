"""Planner calibration: fit measured wall-time coefficients per backend —
counterpart of ``repro.cdmm.calibrate``, with the same JSON payload.

:func:`fit_rows` takes rows of ``{"name": ..._<stage>, "us": ..., "derived":
{<feature>: x, "backend": ...}}`` (stage ``encode``/``worker``/``decode``/
``comm`` with features ``encode_ops``/``worker_ops``/``decode_ops``/
``comm_elems``), fits one coefficient per term by least squares through the
origin, and :func:`save_calibration` persists the result.  ``plan(spec,
objective="latency")`` then scores candidates by *predicted wall time*

    t_us = c_enc * encode_ops + c_comp * worker_ops
         + c_dec * decode_ops + c_comm * (upload + download)

falling back to the analytic op-count proxy whenever no calibration applies
(missing file, unknown backend, a partial fit, another device, or
``REPRO_CALIBRATION=off``).  ``"time_to_R"`` keeps the straggler
order statistic as its leading term and swaps its log-compressed tie-break
for the calibrated serial master work.

The port's rows come from its own ``obs`` spans (:func:`rows_from_timeline`;
:func:`measure_rows` runs traced requests and collects them); the
reference's benchmark rows are not ported.  The default file is the port's
own ``src/repro_torch/cdmm/calibration.json``: the reference's
``benchmarks/calibration.json`` holds JAX/CPU coefficients, and
:meth:`CalibrationSet.matches_device` refuses it on a card (device kinds are
``cuda|<card name>`` or ``cpu``, ``repro_torch.device.device_kind``).

    python -m repro_torch.cdmm.calibrate [--out PATH]                  # measure on the card, fit, write
    python -m repro_torch.cdmm.calibrate --device cpu --sizes 32,64 --out build/calibration.json
    python -m repro_torch.cdmm.calibrate --bench ROWS.json --out PATH   # fit given rows
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .. import settings
from ..core.ep_codes import EPCosts
from ..device import device_kind

__all__ = [
    "Calibration",
    "CalibrationSet",
    "COEF_NAMES",
    "DEFAULT_CALIBRATION_PATH",
    "fit_rows",
    "invalidate_calibration_cache",
    "load_calibration",
    "measure_rows",
    "rows_from_timeline",
    "save_calibration",
]

DEFAULT_CALIBRATION_PATH = Path(__file__).resolve().with_name("calibration.json")
CALIBRATION_VERSION = 1

# stage-row suffix -> (feature key in the row's derived dict, coef name)
STAGE_FEATURES: Dict[str, Tuple[str, str]] = {
    "encode": ("encode_ops", "encode"),
    "worker": ("worker_ops", "compute"),
    "decode": ("decode_ops", "decode"),
    "comm": ("comm_elems", "comm"),
}
COEF_NAMES = ("encode", "compute", "decode", "comm")


@dataclass(frozen=True)
class Calibration:
    """Fitted us-per-unit coefficients for one backend.

    ``coef[name]`` multiplies the matching EPCosts term; a term never
    observed in the fit keeps coefficient 0.0 (it then contributes nothing
    to predictions)."""

    backend: str
    coef: Dict[str, float]
    nrows: int = 0
    r2: Dict[str, float] = field(default_factory=dict)

    def predict_us(self, costs: EPCosts) -> float:
        """Predicted serial wall time (us) of one coded execution."""
        c = self.coef
        return (
            c.get("encode", 0.0) * costs.encode_ops
            + c.get("compute", 0.0) * costs.worker_ops
            + c.get("decode", 0.0) * costs.decode_ops
            + c.get("comm", 0.0) * (costs.upload + costs.download)
        )

    def serial_master_us(self, costs: EPCosts) -> float:
        """Master-side serial work only (encode + decode + communication):
        the piece an elastic master cannot overlap with worker compute."""
        c = self.coef
        return (
            c.get("encode", 0.0) * costs.encode_ops
            + c.get("decode", 0.0) * costs.decode_ops
            + c.get("comm", 0.0) * (costs.upload + costs.download)
        )


@dataclass(frozen=True)
class CalibrationSet:
    """Per-backend calibrations with a fallback chain: the exact backend
    name, then "local", then None (the caller keeps the analytic proxy).

    ``device`` is the device kind the fit was measured on
    (``repro_torch.device.device_kind``): coefficients of one machine must
    not rank plans on another.  ``None`` means device-agnostic (hand-built
    sets, explicit overrides)."""

    backends: Dict[str, Calibration]
    device: Optional[str] = None

    def for_backend(self, backend: str = "local") -> Optional[Calibration]:
        cal = self.backends.get(backend)
        if cal is None:
            cal = self.backends.get("local")
        return cal

    def matches_device(self, device=None) -> bool:
        """Do these coefficients describe ``device`` (None: the one the
        port runs on by default, the card when there is one)?"""
        if self.device is None:
            return True
        return self.device == device_kind(device)

    def to_payload(self) -> dict:
        return {
            "version": CALIBRATION_VERSION,
            "device": self.device,
            "backends": {
                name: {"coef": cal.coef, "nrows": cal.nrows, "r2": cal.r2}
                for name, cal in sorted(self.backends.items())
            },
        }

    @classmethod
    def from_payload(cls, payload: Mapping) -> "CalibrationSet":
        if payload.get("version") != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration version {payload.get('version')!r} != {CALIBRATION_VERSION}"
            )
        backends = {}
        for name, entry in payload.get("backends", {}).items():
            coef = {k: float(v) for k, v in entry["coef"].items()}
            bad = set(coef) - set(COEF_NAMES)
            if bad:
                raise ValueError(f"unknown coefficient(s) {sorted(bad)}")
            backends[name] = Calibration(
                backend=name,
                coef=coef,
                nrows=int(entry.get("nrows", 0)),
                r2={k: float(v) for k, v in entry.get("r2", {}).items()},
            )
        return cls(backends=backends, device=payload.get("device"))


def _stage_of(name: str) -> Optional[str]:
    tail = name.rsplit("_", 1)[-1]
    return tail if tail in STAGE_FEATURES else None


def fit_rows(rows: Iterable[Mapping], device=None) -> CalibrationSet:
    """Fit per-backend coefficients from stage rows.

    A row participates when it is timed (``us > 0``), its name ends in a
    known stage suffix, and its ``derived`` dict carries that stage's
    feature and a ``backend`` tag.  Each coefficient is the least-squares
    slope through the origin, ``sum(us * x) / sum(x^2)``, in the reference's
    float arithmetic and order.  The set's device is ``device_kind(device)``
    (None: the card when there is one, else the CPU).
    """
    samples: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    nrows: Dict[str, int] = {}
    for row in rows:
        us = float(row.get("us", 0.0))
        stage = _stage_of(str(row.get("name", "")))
        if us <= 0.0 or stage is None:
            continue
        derived = row.get("derived", {})
        feature_key, coef_name = STAGE_FEATURES[stage]
        if feature_key not in derived:
            continue
        x = float(derived[feature_key])
        if x <= 0.0:
            continue
        backend = str(derived.get("backend", "local"))
        samples.setdefault((backend, coef_name), []).append((x, us))
        nrows[backend] = nrows.get(backend, 0) + 1

    backends: Dict[str, Calibration] = {}
    for backend in sorted(nrows):
        coef: Dict[str, float] = {}
        r2: Dict[str, float] = {}
        for name in COEF_NAMES:
            pts = samples.get((backend, name), [])
            if not pts:
                continue
            sxx = sum(x * x for x, _ in pts)
            sxy = sum(x * y for x, y in pts)
            c = max(sxy / sxx, 0.0) if sxx > 0 else 0.0
            coef[name] = c
            sy = sum(y for _, y in pts) / len(pts)
            ss_res = sum((y - c * x) ** 2 for x, y in pts)
            ss_tot = sum((y - sy) ** 2 for _, y in pts)
            r2[name] = round(1.0 - ss_res / ss_tot, 4) if ss_tot > 0 else 1.0
        backends[backend] = Calibration(backend=backend, coef=coef, nrows=nrows[backend], r2=r2)
    return CalibrationSet(backends=backends, device=device_kind(device))


# trace span name -> (stage suffix, how durations aggregate)
_TRACE_STAGES: Dict[str, Tuple[str, str]] = {
    "encode": ("encode", "sum"),  # per-share encodes are serial master work
    "compute": ("worker", "each"),  # one observation per worker matmul
    "decode": ("decode", "sum"),
    "send": ("comm", "sum"),  # wire time both directions pools into comm
    "recv": ("comm", "sum"),
}


def rows_from_timeline(timeline, costs: EPCosts, backend: str = "pool") -> List[Dict]:
    """Fit-compatible rows from one traced request's measured spans.

    Encode/decode/wire spans sum into one serial observation each (what the
    master spent); each ``compute`` span is its own observation of
    ``worker_ops``.  Feed several timelines' rows to :func:`fit_rows`.
    """
    feature_of = {
        "encode": float(costs.encode_ops),
        "worker": float(costs.worker_ops),
        "decode": float(costs.decode_ops),
        "comm": float(costs.upload + costs.download),
    }
    sums: Dict[str, float] = {}
    rows: List[Dict] = []

    def _row(stage: str, us: float) -> Dict:
        feature_key, _ = STAGE_FEATURES[stage]
        return {
            "name": f"trace_{backend}_{stage}",
            "us": us,
            "derived": {feature_key: feature_of[stage], "backend": backend},
        }

    for span in timeline.spans:
        mapped = _TRACE_STAGES.get(span.name)
        if mapped is None:
            continue
        stage, mode = mapped
        us = span.duration_s * 1e6
        if us <= 0.0 or feature_of[stage] <= 0.0:
            continue
        if mode == "each":
            rows.append(_row(stage, us))
        else:
            sums[stage] = sums.get(stage, 0.0) + us
    for stage, us in sorted(sums.items()):
        rows.append(_row(stage, us))
    return rows


# (family, data ring degrees over Z_2^32, batch n, t = r = s) of
# measure_rows: the main path's families at three sizes each
MEASURE_POINTS = (
    ("batch_ep_rmfe", (), 2, (512, 1024, 2048)),
    ("ep", (3,), 1, (512, 1024, 2048)),
    ("ep_rmfe1", (), 1, (512, 1024, 2048)),
)


def _local_timeline(scheme, A, B, sync):
    """One ``local`` request with its encode / compute / decode spans, each
    closed after the device finished (the backend's own spans time the
    host's enqueue of asynchronous launches)."""
    from ..obs import trace as obs
    from .backends import decode_from, encode_all, live_indices

    ctx = obs.TraceContext.new("calibrate")
    tracer = obs.tracer()
    sync()
    with tracer.span(ctx, "encode", "local", scheme=scheme.name):
        FA, GB = encode_all(scheme, A, B)
        sync()
    with tracer.span(ctx, "compute", "local", N=int(scheme.N)):
        H = scheme.worker_compute(FA, GB)
        sync()
    with tracer.span(ctx, "decode", "local", scheme=scheme.name):
        decode_from(scheme, H, live_indices(scheme, None))
        sync()
    return tracer.timeline(ctx.trace_id)


def measure_rows(points=MEASURE_POINTS, *, N: int = 8, backends=("local", "elastic"),
                 runs: int = 3, device=None, seed: int = 0) -> List[Dict]:
    """Run traced requests of each (family, ring, n, sizes) point on ``device``
    (None: the card) through each backend and return their rows.

    ``local``: stage spans closed after a device synchronize.  ``elastic``:
    its traced event loop's own spans (per-worker encode, compute to the
    worker's CUDA event, decode) under an all-live trace.  The first run of
    each point warms up and is dropped.
    """
    import numpy as np
    import torch

    from ..core.galois import make_ring
    from ..core.straggler import WorkerTrace
    from ..device import resolve_device
    from ..obs import trace as obs
    from .api import ProblemSpec
    from .elastic import ElasticBackend
    from .planner import plan

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed)
    was = obs.enabled()
    obs.set_enabled(True)
    rows: List[Dict] = []
    try:
        for family, degrees, n, sizes in points:
            ring = make_ring(2, 32, tuple(degrees))
            for size in sizes:
                spec = ProblemSpec(size, size, size, n=n, ring=ring, N=N, straggler_budget=2)
                p = plan(spec, schemes=[family], calibration=False)
                costs, scheme = p.best.costs, p.instantiate(device=dev)
                shape = (n,) if n > 1 else ()
                A = ring.random(rng, (*shape, size, size), device=dev)
                B = ring.random(rng, (*shape, size, size), device=dev)
                for backend in backends:
                    for run in range(runs + 1):
                        if backend == "local":
                            tl = _local_timeline(scheme, A, B, sync)
                        else:
                            obs.tracer().clear()
                            with ElasticBackend(trace=WorkerTrace.all_live(N)) as be:
                                be(scheme, A, B)
                                be.drain()
                            sync()
                            spans = list(obs.tracer()._spans)  # this request's only
                            tl = obs.Timeline(spans[0].trace_id, spans)
                        if run:
                            rows.extend(rows_from_timeline(tl, costs, backend=backend))
                del A, B
                obs.tracer().clear()
    finally:
        obs.set_enabled(was)
    return rows


def save_calibration(cal: CalibrationSet, path: Optional[Path] = None) -> Path:
    p = Path(path) if path else DEFAULT_CALIBRATION_PATH
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(cal.to_payload(), f, indent=1, sort_keys=True)
        f.write("\n")
    return p


_LOADED: Dict[str, Optional[CalibrationSet]] = {}


def load_calibration(path: Optional[Path] = None, *, cache: bool = True
                     ) -> Optional[CalibrationSet]:
    """Load the calibration, or None when unavailable.

    Resolution order: explicit ``path``, the ``REPRO_CALIBRATION`` setting
    (``off``/``0``/``none``/empty disables calibration: the deterministic
    analytic proxy), then ``DEFAULT_CALIBRATION_PATH``.  Parsed files are
    memoized per path; an unreadable or malformed file reads as None."""
    if path is None:
        env = settings.get("calibration")
        if env is not None:
            if str(env).strip().lower() in ("", "0", "off", "none"):
                return None
            path = Path(env)
        else:
            path = DEFAULT_CALIBRATION_PATH
    key = str(path)
    if cache and key in _LOADED:
        return _LOADED[key]
    result: Optional[CalibrationSet] = None
    try:
        with open(path) as f:
            result = CalibrationSet.from_payload(json.load(f))
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        result = None  # analytic fallback: never fail a plan() over this
    if cache:
        _LOADED[key] = result
    return result


def invalidate_calibration_cache() -> None:
    _LOADED.clear()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default=None,
                    help="fit these stage rows (a JSON list, the reference's benchmark row "
                         "format) instead of measuring")
    ap.add_argument("--device", default=None, help="where to measure (default: the card)")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated t = r = s of every family (default: 512,1024,2048)")
    ap.add_argument("--out", default=str(DEFAULT_CALIBRATION_PATH),
                    help="calibration JSON to write")
    args = ap.parse_args(argv)
    if args.bench:
        with open(args.bench) as f:
            rows = json.load(f)
    else:
        points = MEASURE_POINTS
        if args.sizes:
            sizes = tuple(int(x) for x in args.sizes.split(","))
            points = tuple((fam, deg, n, sizes) for fam, deg, n, _ in MEASURE_POINTS)
        rows = measure_rows(points, device=args.device)
    cal = fit_rows(rows, device=args.device)
    if not cal.backends:
        print("no calibratable rows (need timed stage rows with cost features)")
        return 1
    out = save_calibration(cal, Path(args.out))
    for name, c in sorted(cal.backends.items()):
        print(f"{name}: {c.coef} (n={c.nrows}, r2={c.r2})")
    print(f"wrote {out} (device {cal.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
