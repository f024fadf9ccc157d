"""Core: CDMM over Galois rings via RMFE, in PyTorch (counterpart of
``repro.core``)."""
from .galois import (
    Ring,
    find_irreducible_gfp,
    fold_in,
    from_numpy,
    is_irreducible_gfp,
    make_ring,
    to_numpy,
)
from .rmfe import BasicRMFE, ConcatRMFE, build_rmfe
from .ep_codes import (
    EPCode,
    EPCosts,
    PlainCDMM,
    ep_cost_model,
    secure_recovery_threshold,
    smallest_embedding_ext,
)
from .batch_rmfe import BatchEPRMFE
from .single_rmfe import EPRMFE_I, EPRMFE_II
from .gcsa import CSACode, GCSACode, gcsa_cost_model, gr_solve
from .secure import SecureBatchEPRMFE, SecureEP, SecureEPCode, smallest_secure_ext
from .straggler import (
    MembershipEvents,
    WorkerTrace,
    sample_trace,
    select_workers,
    simulate_stragglers,
    straggler_latencies,
)

__all__ = [
    "Ring", "make_ring", "find_irreducible_gfp", "is_irreducible_gfp",
    "fold_in", "to_numpy", "from_numpy",
    "BasicRMFE", "ConcatRMFE", "build_rmfe",
    "EPCode", "PlainCDMM", "ep_cost_model", "EPCosts",
    "secure_recovery_threshold", "smallest_embedding_ext",
    "BatchEPRMFE", "EPRMFE_I", "EPRMFE_II",
    "CSACode", "GCSACode", "gcsa_cost_model", "gr_solve",
    "SecureEPCode", "SecureEP", "SecureBatchEPRMFE", "smallest_secure_ext",
    "select_workers", "simulate_stragglers", "straggler_latencies",
    "MembershipEvents", "WorkerTrace", "sample_trace",
]
