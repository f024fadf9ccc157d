"""Cost-model planner: enumerate registered schemes x partitions, rank them.

Counterpart of ``repro.cdmm.planner`` on the analytic proxy.  ``plan(spec,
objective)`` walks every registered family and every EP partition (u, v, w)
the straggler budget admits (R = uvw + w - 1 bounds u, v by R and w by
(R+1)/2), plus RMFE packing factors n <= MAX_PACKING for the single-DMM
variants, scores the analytic cost models and returns a ranked
:class:`Plan`.  Enumeration never builds a scheme; only
``Plan.instantiate()`` pays the host-side Vandermonde / RMFE setup.

Objectives: ``"threshold"`` (R), ``"download"``, ``"upload"``,
``"latency"`` (encode + worker + decode ops + upload + download elements),
``"amortized"`` (the same proxy compared across batch arities: a
batched spec also admits the single families, priced per request) and
``"time_to_R"``: the elastic backend finishes at the R-th fastest
response, so the score is the Monte-Carlo mean of the R-th order statistic
of N heavy-tailed worker latencies (``core.straggler.straggler_latencies``,
256 trials, fixed seed) plus a log-compressed serial-work tie-break.

The port's latency draws are not the reference's bits, but its rankings are
the reference's: every candidate of one plan shares ``spec.N``, and each
trial's sorted row is monotone in R, so the order depends only on R and the
tie-break, which is the same arithmetic in both packages.

``calibration`` grounds ``"latency"``, ``"amortized"`` and ``"time_to_R"``
in measured wall-time coefficients (``repro_torch.cdmm.calibrate``), with
the reference's semantics: None auto-loads the port's own
``cdmm/calibration.json`` (used only when it was fitted on this device and
covers every cost term; ``REPRO_CALIBRATION=off`` disables it), False keeps
the analytic proxy, and a pinned :class:`CalibrationSet` applies as given.
Without a calibration the rankings are the reference's analytic ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from math import log1p
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.ep_codes import EPCosts
from ..core.straggler import straggler_latencies
from ..device import resolve_device
from .api import CdmmScheme, ProblemSpec, get_scheme, registered_schemes

__all__ = ["plan", "Plan", "PlanCandidate", "OBJECTIVES", "MAX_PACKING", "expected_time_to_R"]

_LATENCY_TRIALS = 256


@lru_cache(maxsize=32)
def _sorted_latency_sample(N: int) -> np.ndarray:
    """(trials, N) rows of sorted straggler latencies, fixed seed (the
    planner must be deterministic run to run)."""
    lat = torch.stack([straggler_latencies(k, N) for k in range(_LATENCY_TRIALS)])
    return np.sort(lat.numpy().astype(float), axis=1)


def expected_time_to_R(N: int, R: int) -> float:
    """E[R-th order statistic of N worker latencies] in model-ms: the
    expected wall-clock at which an elastic master can decode."""
    return float(_sorted_latency_sample(N)[:, R - 1].mean())


def _latency_proxy(c: EPCosts) -> float:
    return c.encode_ops + c.worker_ops + c.decode_ops + c.upload + c.download


OBJECTIVES: Dict[str, callable] = {
    "threshold": lambda c: float(c.R),
    "download": lambda c: c.download,
    "upload": lambda c: c.upload,
    "latency": _latency_proxy,
    # per-request cost at batch fill: batch families' costs are already
    # amortized over the n products one execution carries
    "amortized": _latency_proxy,
    # expected elastic completion; the serial-work proxy breaks ties among
    # configurations with equal (N, R), log-compressed so it stays orders of
    # magnitude below any E[t_R] gap while remaining monotone in the work
    "time_to_R": lambda c: (
        expected_time_to_R(c.N, c.R)
        + 1e-6 * log1p(c.encode_ops + c.decode_ops + c.upload + c.download)
    ),
}


# objectives whose analytic form is replaced by measured coefficients when a
# calibration applies (the rest are pure counts, already exact)
_CALIBRATED_OBJECTIVES = ("latency", "time_to_R", "amortized")


def _calibrated_score_fn(objective: str, cal: "Calibration"):
    """Measured-wall-time score for one objective, or None to keep the
    analytic proxy (the calibration carries no coefficients)."""
    if not cal.coef:
        return None
    if objective in ("latency", "amortized"):
        return cal.predict_us
    if objective == "time_to_R":
        # E[t_R] is in model-ms, the fitted serial master work in machine-us:
        # the measured term stays a log-compressed tie-break, so that the
        # objective keeps rewarding straggler resilience
        return lambda c: (
            expected_time_to_R(c.N, c.R) + 1e-6 * log1p(cal.serial_master_us(c))
        )
    return None


@dataclass(frozen=True)
class PlanCandidate:
    """One feasible (scheme, partition, packing) configuration, scored."""

    scheme: str
    u: int
    v: int
    w: int
    n: int  # packing/batch factor handed to the family's build
    costs: EPCosts
    score: float

    def instantiate(self, spec: ProblemSpec, device=None) -> CdmmScheme:
        return get_scheme(self.scheme).build(
            spec, self.u, self.v, self.w, self.n, device=device
        )


@dataclass(frozen=True)
class Plan:
    """Ranked feasible configurations for one ProblemSpec."""

    spec: ProblemSpec
    objective: str
    candidates: Tuple[PlanCandidate, ...]
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def best(self) -> PlanCandidate:
        return self.candidates[0]

    def by_scheme(self, name: str) -> Optional[PlanCandidate]:
        """Best-ranked candidate of a given scheme family, if any."""
        for c in self.candidates:
            if c.scheme == name:
                return c
        return None

    def instantiate(self, rank: int = 0, device=None) -> CdmmScheme:
        """Build (and memoize per device) the executable scheme at ``rank``;
        its tables live on ``device`` (None: CUDA)."""
        dev = resolve_device(device)
        key = (rank, str(dev))
        if key not in self._cache:
            self._cache[key] = self.candidates[rank].instantiate(self.spec, dev)
        return self._cache[key]

    def summary(self, limit: int = 8) -> str:
        lines = [
            f"Plan[{self.objective}] for {self.spec.n}x "
            f"({self.spec.t}x{self.spec.r})@({self.spec.r}x{self.spec.s}) "
            f"over {self.spec.ring}, N={self.spec.N} "
            f"(straggler budget {self.spec.straggler_budget}"
            + (f", privacy_t={self.spec.privacy_t}" if self.spec.privacy_t else "")
            + "):"
        ]
        for i, c in enumerate(self.candidates[:limit]):
            lines.append(
                f"  #{i} {c.scheme:<14} (u,v,w)=({c.u},{c.v},{c.w}) n={c.n} "
                f"R={c.costs.R} m_eff={c.costs.m_eff:.1f} "
                f"up={c.costs.upload:.3g} down={c.costs.download:.3g} "
                f"score={c.score:.3g}"
            )
        return "\n".join(lines)


MAX_PACKING = 8  # RMFE packing factors searched for single-DMM variants


def _divisors(x: int, cap: int) -> List[int]:
    return [d for d in range(1, min(x, cap) + 1) if x % d == 0]


def _packing_candidates(spec: ProblemSpec, fam) -> Iterable[int]:
    if fam.packing is not None:
        # family-supplied enumeration of the 4th build/predict parameter
        # (gcsa_general: group sizes kappa dividing the batch)
        return tuple(fam.packing(spec))
    if fam.batched:
        return (spec.n,)
    # internal packing factors for the single-DMM RMFE variants; n=1 covers
    # the unpacked families (their predicts reject n != 1 / n < 2 anyway)
    dims = (set(_divisors(spec.r, cap=MAX_PACKING))
            | set(_divisors(spec.s, cap=MAX_PACKING)))
    return sorted(dims)


def plan(
    spec: ProblemSpec,
    objective: str = "latency",
    schemes: Optional[Sequence[str]] = None,
    top_k: Optional[int] = None,
    calibration: Union[None, bool, "CalibrationSet"] = None,
    backend: str = "local",
) -> Plan:
    """Rank every feasible (scheme, u, v, w, n) configuration for ``spec``.

    ``schemes`` restricts the search to the named families (default: all
    registered families matching the spec's batch arity); ``top_k`` caps the
    ranking.  Raises ``ValueError`` when no configuration satisfies
    R <= N - straggler_budget.  With ``privacy_t > 0`` only configurations
    whose costs advertise ``privacy_t >= spec.privacy_t`` (the secure
    families) are feasible: a plan never downgrades a privacy requirement.

    ``calibration``: None auto-loads the port's calibration file (applied
    only when fitted on this device with every cost term), False forces the
    analytic proxy, a :class:`CalibrationSet` pins the coefficients.
    ``backend`` selects whose coefficients apply ("local" is the fallback).
    """
    spec.validate()
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; one of {sorted(OBJECTIVES)}"
        )
    score_fn = OBJECTIVES[objective]
    if objective in _CALIBRATED_OBJECTIVES and calibration is not False:
        # imported here: ``python -m repro_torch.cdmm.calibrate`` runs it as __main__
        from .calibrate import COEF_NAMES, CalibrationSet, load_calibration

        pinned = isinstance(calibration, CalibrationSet)
        cal_set = calibration if pinned else load_calibration()
        cal = cal_set.for_backend(backend) if cal_set is not None else None
        if cal is not None and not pinned:
            # an auto-loaded file must describe this hardware and cover every
            # cost term: a partial fit would score the missing term as free
            if not cal_set.matches_device() or set(cal.coef) != set(COEF_NAMES):
                cal = None
        if cal is not None:
            score_fn = _calibrated_score_fn(objective, cal) or score_fn

    requested = registered_schemes()
    if schemes is not None:
        requested = {name: get_scheme(name) for name in schemes}
    # single families serve n=1 specs, batch families n>1; "amortized" also
    # admits the single families for a batched spec
    if objective == "amortized":
        families = {
            name: fam for name, fam in requested.items()
            if spec.n > 1 or not fam.batched
        }
    else:
        families = {
            name: fam for name, fam in requested.items()
            if fam.batched == (spec.n > 1)
        }
    if not families:
        kind = "a batched" if spec.n > 1 else "a single-product"
        serving = sorted(
            name for name, fam in registered_schemes().items()
            if fam.batched == (spec.n > 1)
        )
        raise ValueError(
            f"none of the schemes {sorted(requested)} serves {kind} spec "
            f"(n={spec.n}); families that do: {serving}"
        )

    budgeted_R = spec.N - spec.straggler_budget
    found: List[PlanCandidate] = []
    for name, fam in sorted(families.items()):
        for n in _packing_candidates(spec, fam):
            for u in _divisors(spec.t, cap=budgeted_R):
                for v in _divisors(spec.s, cap=budgeted_R):
                    for w in _divisors(spec.r, cap=(budgeted_R + 1) // 2):
                        costs = fam.predict(spec, u, v, w, n)
                        if costs is None or costs.R > budgeted_R:
                            continue
                        if costs.privacy_t < spec.privacy_t:
                            continue  # never hand back an insecure scheme
                        found.append(PlanCandidate(
                            name, u, v, w, n, costs, score_fn(costs)
                        ))

    if not found:
        privacy = (
            f" meeting privacy_t={spec.privacy_t} (secure schemes need "
            f"R >= 2*privacy_t + 1 and N + 1 exceptional points)"
            if spec.privacy_t > 0 else ""
        )
        raise ValueError(
            f"no feasible scheme for {spec}: every registered configuration"
            f"{privacy} needs R > N - straggler_budget = {budgeted_R}"
        )
    found.sort(key=lambda c: (c.score, c.costs.R, c.scheme, c.u, c.v, c.w, c.n))
    if top_k is not None:
        found = found[:top_k]
    return Plan(spec, objective, tuple(found))
