"""repro_torch.serve: continuous-batching serving over the pool runtime —
the port's counterpart of ``repro.serve``.

The subsystem that makes the paper's batch half load-bearing in
production shape: concurrent same-``ProblemSpec`` requests coalesce into
one ``batch_ep_rmfe`` / ``ep_rmfe_secure`` codeword (dynamic fill, padded
final batch, per-request slices out of the decoded batch), governed by a
latency/throughput policy and the planner's ``"amortized"`` objective.

    pool = LocalPool(workers=6)                       # on the card
    with ServeScheduler(pool.master, CoalescePolicy(max_wait_ms=10)) as s:
        futs = [s.submit(A, B, spec=spec) for (A, B) in requests]
        results = [f.result() for f in futs]          # tensors on the card
        print(s.stats.snapshot()["serve_mean_fill"])
"""
from .coalescer import BatchCoalescer, CoalescePolicy
from .engine import ServeScheduler
from .stats import ServeStats

__all__ = [
    "BatchCoalescer",
    "CoalescePolicy",
    "ServeScheduler",
    "ServeStats",
]
