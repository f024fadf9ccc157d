"""CDMM: unified scheme API, cost-model planner, execution backends and
the quantized int8 plane — counterpart of ``repro.cdmm``.  The front door
is three calls::

    spec = ProblemSpec(t, r, s, n=batch, ring=Z32, N=workers)
    p = plan(spec, objective="download")
    C = coded_matmul(A, B, p, backend="local", mask=liveness)

Backends: ``"local"`` (sync, every worker in one batched launch) and
``"elastic"`` (event-driven master that decodes at the R-th response and
tolerates join/leave/slowdown; ``repro_torch.cdmm.elastic``).  Secure plans
(``privacy_t > 0``) also take ``key=`` (an int) for the masks.
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
    register_backend,
)
from .elastic import (
    ElasticBackend,
    ElasticStats,
    ElasticStream,
    NotEnoughResponders,
    decode_responses,
    worker_closures,
)
from .planner import OBJECTIVES, Plan, PlanCandidate, expected_time_to_R, plan
from .quantized import CodedQuantMatmul, lift_i8_to_ring, quantize_int8, unlift_to_i32

__all__ = [
    "CdmmScheme", "EPCosts", "ProblemSpec", "SchemeFamily",
    "get_scheme", "register_scheme", "registered_schemes",
    "EPSchemeAdapter", "PlainCDMMAdapter", "EPRMFE1Adapter",
    "EPRMFE2Adapter", "BatchRMFEAdapter", "CSAAdapter", "GCSAGeneralAdapter",
    "SecureEPAdapter", "SecureBatchRMFEAdapter",
    "plan", "Plan", "PlanCandidate", "OBJECTIVES", "expected_time_to_R",
    "coded_matmul", "get_backend", "register_backend", "LocalSimBackend",
    "live_indices", "encode_all", "decode_from",
    "ElasticBackend", "ElasticStats", "ElasticStream", "NotEnoughResponders",
    "decode_responses", "worker_closures",
    "CodedQuantMatmul", "quantize_int8", "lift_i8_to_ring", "unlift_to_i32",
]
