"""CDMM: unified scheme API, cost-model planner, local execution backend —
counterpart of ``repro.cdmm``.  The front door is three calls::

    spec = ProblemSpec(t, r, s, n=batch, ring=Z32, N=workers)
    p = plan(spec, objective="download")
    C = coded_matmul(A, B, p, backend="local", mask=liveness)

Secure plans (``privacy_t > 0``) also take ``key=`` (an int) for the masks.
"""
from .api import (
    BatchRMFEAdapter,
    CdmmScheme,
    CSAAdapter,
    EPCosts,
    EPRMFE1Adapter,
    EPRMFE2Adapter,
    EPSchemeAdapter,
    GCSAGeneralAdapter,
    PlainCDMMAdapter,
    ProblemSpec,
    SchemeFamily,
    SecureBatchRMFEAdapter,
    SecureEPAdapter,
    get_scheme,
    register_scheme,
    registered_schemes,
)
from .backends import (
    LocalSimBackend,
    coded_matmul,
    decode_from,
    encode_all,
    get_backend,
    live_indices,
)
from .planner import OBJECTIVES, Plan, PlanCandidate, plan

__all__ = [
    "CdmmScheme", "EPCosts", "ProblemSpec", "SchemeFamily",
    "get_scheme", "register_scheme", "registered_schemes",
    "EPSchemeAdapter", "PlainCDMMAdapter", "EPRMFE1Adapter",
    "EPRMFE2Adapter", "BatchRMFEAdapter", "CSAAdapter", "GCSAGeneralAdapter",
    "SecureEPAdapter", "SecureBatchRMFEAdapter",
    "plan", "Plan", "PlanCandidate", "OBJECTIVES",
    "coded_matmul", "get_backend", "LocalSimBackend",
    "live_indices", "encode_all", "decode_from",
]
